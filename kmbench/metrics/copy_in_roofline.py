"""The copy of host samples onto the cards: the bytes of the samples (n f
at the configuration's dtype's size) over the time of each traced call's
``kmt.prepare`` span (the program's checks, the row cut, each shard's
copy and its first passes on its card), as a share of the frozen
``roofline.host_copy_bound``: every card's host link at its peak, in %.
For cells whose samples are host memory.  Serves every
``copy_in_roofline.<cell>`` entry."""

from kmbench import roofline as R
from kmbench import spans as S


def read(run):
    prep = S.spans(run, "kmt.prepare")
    seconds = sum(e - s for s, e in prep) / 1e9
    if not prep or seconds <= 0:
        return None
    cfg = run.cell.config
    bound_s = R.host_copy_bound(int(cfg["samples"]), int(cfg["features"]),
                                cfg["dtype"], run.cell.chips)["ms"] / 1e3
    return 100.0 * bound_s * len(prep) / seconds
