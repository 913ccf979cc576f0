"""B3 (``kmt_knn_walk``, device kernel ``walk_kernel``) against its
operations bound: 2 f operations per examined (query, member) pair at
the storage dtype's rate (frozen ``walk_ops_bound``), the pairs being
the program's ``calculated F of all the distances`` times n^2, over the
summed device time of the walk's launches in the traced calls."""

from kmbench import roofline as R
from kmbench import trace as T
from kmbench.harness import examined_fraction


def read(run):
    cfg = run.cell.config
    n, f = int(cfg["samples"]), int(cfg["features"])
    launches, seconds = T.kernel_time(run.device_events, "walk_kernel",
                                      run.spans)
    if not launches or seconds <= 0:
        return None
    bound_s = 0.0
    for c in run.calls:
        frac = examined_fraction(c.lines)
        if frac is None:
            return None
        bound_s += R.walk_ops_bound(frac * n * n, f, cfg["dtype"])["ms"] / 1e3
    return 100.0 * bound_s / seconds
