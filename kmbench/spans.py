"""What a traced run reads of the program's own instruments: its ``kmt.``
spans, which are host events of the trace, and the counter records that
``kmcuda_torch.utils.profiling`` keeps of the calls made under a
session.  A program without them (an older one) gives no span and no
record, and every function here then reads nothing (None).
"""

import bisect

from kmbench import trace as T


def records(run):
    """The counter records of the traced calls, in call order: the
    program's last ``len(run.spans)`` records, each paired with the call
    span holding its midpoint.  None where the program keeps none, or
    where their count or kinds disagree with the traced calls."""
    try:
        from kmcuda_torch.utils import profiling
    except ImportError:
        return None
    kept = getattr(profiling, "records", None)
    n = len(run.spans)
    recs = kept()[-n:] if kept is not None and n else []
    if len(recs) != n:
        return None
    kind = run.cell.traffic.get("call")
    for (s0, s1), r in zip(run.spans, recs):
        if r.get("kind") != kind or r.get("end_ns") is None:
            return None
        if not s0 <= (r["start_ns"] + r["end_ns"]) // 2 <= s1:
            return None
    return recs


def samples(recs, name: str) -> list:
    """The values of counter ``name`` over the records, in order."""
    return [v for r in recs for c, v in r["counters"] if c == name]


def spans(run, name: str) -> list:
    """[(start, end), ...] ns of the host spans ``name`` inside the traced
    calls' spans, by start."""
    return [(e.start, e.end) for e in run.host_events
            if e.name == name and any(s0 <= e.start and e.end <= s1
                                      for s0, s1 in run.spans)]


def idle_ns(run, intervals):
    """Nanoseconds of ``intervals`` (merged where they overlap) in which no
    operation ran on the device: each card's, the mean over the cell's
    cards."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], end))
        else:
            merged.append((start, end))
    total = sum(end - start for start, end in merged)
    return total - T.busy_ns(run.device_events, merged, run.cell.chips)


def started_in(run, t0: int, t1: int) -> list:
    """The device events that start inside [t0, t1), by start."""
    starts = [e.start for e in run.device_events]
    return run.device_events[bisect.bisect_left(starts, t0):
                             bisect.bisect_left(starts, t1)]
