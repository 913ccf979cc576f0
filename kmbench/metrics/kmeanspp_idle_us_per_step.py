"""API, prepare and init: the device's idle time inside the program's
``kmt.init`` spans over the k-means++ / AFK-MC2 steps its ``init.steps``
counter reports (k - 1 a call), in us a step over all the traced calls.
Serves every ``kmeanspp_idle_us_per_step.<cell>`` entry."""

from kmbench import spans as S


def read(run):
    recs = S.records(run)
    init = S.spans(run, "kmt.init")
    if recs is None or not init:
        return None
    steps = sum(S.samples(recs, "init.steps"))
    return S.idle_ns(run, init) / 1e3 / steps if steps > 0 else None
