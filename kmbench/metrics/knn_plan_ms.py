"""The kNN plan (relabel, pack, radii, the replicas): from each
``kmt.knn.plan`` span's start to the later of its end and the end of the
last device operation that started inside it (within the call's span),
in ms, the mean over the traced calls.  The plan's last reads of the
device (the radii's masks) drain what it launched before them, so what
it leaves queued is the few small kernels after them, which may start
past the span's end and then go uncounted.  Serves every
``knn_plan_ms.<cell>`` entry."""

from kmbench import spans as S


def read(run):
    vals = []
    for s0, s1 in S.spans(run, "kmt.knn.plan"):
        call_end = next(c1 for c0, c1 in run.spans if c0 <= s0 <= c1)
        end = max([s1] + [min(e.end, call_end)
                          for e in S.started_in(run, s0, s1)])
        vals.append((end - s0) / 1e6)
    return sum(vals) / len(vals) if vals else None
