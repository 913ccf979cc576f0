"""Yinyang's bound refreshes: the rows whose lower bounds a refresh
recomputed (the program's ``yinyang.refreshed_rows``, the bound init's n
rows included: the init is the loop's first iteration, a dense refresh)
over the valid rows (``yinyang.rows``) times the loop's iterations (its
``yinyang.passed`` samples), summed over the traced calls: the share of
the bound state the loop rewrites, 1 where every iteration rewrote all
of it.  Serves every ``yinyang_refreshed_fraction.<cell>`` entry."""

from kmbench import spans as S


def read(run):
    recs = S.records(run)
    if recs is None:
        return None
    refreshed = offered = 0
    for r in recs:
        its = S.samples([r], "yinyang.passed")
        rows = S.samples([r], "yinyang.rows")
        done = S.samples([r], "yinyang.refreshed_rows")
        if its and rows and done:
            refreshed += sum(done)
            offered += rows[0] * len(its)
    return refreshed / offered if offered else None
