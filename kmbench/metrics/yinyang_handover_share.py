"""Yinyang's Lloyd handover: the loop's iterations run on the Lloyd path
after a handover (the program's ``yinyang.handed_over`` samples, 1 each)
over the loop's iterations (its ``yinyang.passed`` samples, one an
iteration on either path), summed over the traced calls.  A program with
the handover records one ``yinyang.handed_over`` sample of 0 as its loop
starts, so it reads 0 where nothing was handed over; an older program
records none, and the metric reads nothing.  Serves every
``yinyang_handover_share.<cell>`` entry."""

from kmbench import spans as S


def read(run):
    recs = S.records(run)
    if recs is None:
        return None
    handed = its = 0
    marked = False
    for r in recs:
        passed = S.samples([r], "yinyang.passed")
        over = S.samples([r], "yinyang.handed_over")
        marked = marked or bool(over)
        if passed and over:
            handed += sum(over)
            its += len(passed)
    return handed / its if marked and its else None
