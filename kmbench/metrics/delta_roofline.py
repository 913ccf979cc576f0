"""The sparse iteration's delta (``kmt_delta_sum``) against its bound:
the frozen ``delta_sum_bound(m, f, k, dtype)`` summed over the moved
rows m of each sparse Lloyd iteration (the program's
``lloyd.moved_rows`` counter; m = 0 launches nothing), over the device
time of the delta's kernels, in %.  Those are the ``seg_*`` kernels that
start after a ``kmt.delta_sum`` span opens and before the next
``assign_kernel`` starts (or the call's span ends): the wrapper's checks
read the device first, so nothing else of the loop is in flight there,
and B1's own ``seg_*`` kernels follow an ``assign_kernel``.  For cells
where Lloyd runs alone on one card.  Serves every
``delta_roofline.<cell>`` entry."""

from kmbench import roofline as R
from kmbench import spans as S
from kmbench import trace as T


def delta_seconds(run) -> float:
    total = 0
    for s0, s1 in S.spans(run, "kmt.delta_sum"):
        call_end = next(c1 for c0, c1 in run.spans if c0 <= s0 <= c1)
        for e in S.started_in(run, s0, call_end):
            name = T.kernel_name(e.name)
            if name.startswith("assign_kernel"):
                break
            if name.startswith("seg_"):
                total += e.end - e.start
    return total / 1e9


def read(run):
    recs = S.records(run)
    if recs is None:
        return None
    cfg = run.cell.config
    f, k = int(cfg["features"]), int(cfg["clusters"])
    bound_s = sum(R.delta_sum_bound(m, f, k, cfg["dtype"])["ms"]
                  for m in S.samples(recs, "lloyd.moved_rows") if m) / 1e3
    seconds = delta_seconds(run)
    if bound_s <= 0 or seconds <= 0:
        return None
    return 100.0 * bound_s / seconds
