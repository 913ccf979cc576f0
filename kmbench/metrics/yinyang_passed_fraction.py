"""Yinyang's filter: the rows that passed it (the program's
``yinyang.passed`` counter, every valid row on a dense iteration) over
the valid rows (``yinyang.rows``) times the loop's iterations, summed
over the traced calls.  Serves every ``yinyang_passed_fraction.<cell>``
entry."""

from kmbench import spans as S


def read(run):
    recs = S.records(run)
    if recs is None:
        return None
    passed = offered = 0
    for r in recs:
        its = S.samples([r], "yinyang.passed")
        rows = S.samples([r], "yinyang.rows")
        if its and rows:
            passed += sum(its)
            offered += rows[0] * len(its)
    return passed / offered if offered else None
