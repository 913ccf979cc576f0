"""What a traced run reads from ``torch.profiler``: device intervals, the
harness's own call spans, the busy share and the breakdown.

Events are read in memory from the profiler's Kineto results (no trace
file).  Device and host timestamps share one clock, in nanoseconds.  A
device event keeps the index of its card: over several cards a busy or
idle time is each card's own, averaged over the cards.
"""

import bisect
import re
from typing import NamedTuple

#: the name of the harness's span around one call (``record_function``)
CALL_SPAN = "kmbench.call"
#: host events of the profiler's own bookkeeping, which name no work
PROFILER_OWN = ("Activity Buffer Request",)


class Event(NamedTuple):
    name: str
    start: int       # ns
    end: int         # ns
    device: int = 0  # the card's index, for a device event


def events(prof) -> tuple:
    """(device events, host events) of a finished ``torch.profiler``
    session, each a list of :class:`Event` sorted by start.  The device's
    copies of ``record_function`` ranges (such as the harness's span:
    ranges, not work) and the profiler's own bookkeeping are left out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        ev = Event(name, start, start + e.duration_ns())
        if e.device_type() == cuda:
            if name != CALL_SPAN and not _annotation(e):
                dev.append(ev._replace(device=e.device_index()))
        elif name not in PROFILER_OWN:
            host.append(ev)
    dev.sort(key=lambda e: e.start)
    host.sort(key=lambda e: e.start)
    return dev, host


def _annotation(e) -> bool:
    """Whether a Kineto event is a ``record_function`` range (on the
    device, its "gpu_user_annotation" copy), where this torch tells."""
    kind = getattr(e, "activity_type", None)
    if kind is not None and "annotation" in str(kind()):
        return True
    user = getattr(e, "is_user_annotation", None)
    return bool(user and user())


def union_ns(intervals) -> int:
    """Length of the union of (start, end) intervals (the copy of
    ``chip_profile.union_us``)."""
    total, cur_s, cur_e = 0, None, None
    for start, end in sorted(intervals):
        if cur_e is None or start > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def clip(intervals, spans) -> list:
    """The parts of ``intervals`` that lie inside one of ``spans``."""
    out = []
    for s0, s1 in spans:
        for start, end in intervals:
            lo, hi = max(start, s0), min(end, s1)
            if hi > lo:
                out.append((lo, hi))
    return out


def kernel_name(name: str) -> str:
    """A device event's short name: the kernel's own name and template
    argument (``assign_kernel<float>``), or the copy or set as the
    profiler names it."""
    m = re.search(r"(\w+_kernel)(<[\w:]+>)?", name)
    return "".join(m.groups("")) if m else name.split(" (")[0][:80]


def by_card(device_events) -> dict:
    """{card index: its device events}, by index."""
    out = {}
    for e in device_events:
        out.setdefault(e.device, []).append(e)
    return dict(sorted(out.items()))


def busy_ns(device_events, spans, cards=1):
    """Nanoseconds inside ``spans`` in which some operation ran on a card:
    each card's own, the mean over ``cards`` cards (or over the cards that
    ran something, where more did)."""
    per = busy_ns_per_card(device_events, spans)
    if len(per) <= 1 and cards <= 1:
        return sum(per.values())
    return sum(per.values()) / max(cards, len(per))


def busy_ns_per_card(device_events, spans) -> dict:
    """{card index: nanoseconds inside ``spans`` in which some operation
    ran on that card}."""
    return {d: union_ns(clip([(e.start, e.end) for e in ev], spans))
            for d, ev in by_card(device_events).items()}


def device_ops(device_events, spans, top=10, cards=1) -> list:
    """[[name, seconds], ...]: the device operations inside ``spans`` that
    took the most time, summed by :func:`kernel_name` (and over the cards:
    over several, a name says on how many cards it ran)."""
    by, on = {}, {}
    for start, end, name, dev in ((max(e.start, s0), min(e.end, s1), e.name,
                                   e.device)
                                  for s0, s1 in spans for e in device_events
                                  if e.end > s0 and e.start < s1):
        key = kernel_name(name)
        by[key] = by.get(key, 0) + (end - start)
        on.setdefault(key, set()).add(dev)
    if cards > 1:
        by = {"%s (%d cards)" % (k, len(on[k])): v for k, v in by.items()}
    return [[k, v / 1e9] for k, v in
            sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(device_events, host_events, spans, top=10, cards=1) -> list:
    """[[name, seconds], ...]: the device's idle time inside ``spans``,
    summed by what the host was doing at the middle of each gap (the
    innermost host event that covers it, else ``host: no torch op``);
    over several cards, each card's gaps, the mean over the cards."""
    groups = list(by_card(device_events).values()) or [[]]
    n = max(cards, len(groups))
    by = {}
    for ev in groups:
        for key, v in _gaps_by_host(ev, host_events, spans).items():
            by[key] = by.get(key, 0) + v
    if n > len(groups):  # a card that ran nothing was idle throughout
        whole = _gaps_by_host([], host_events, spans)
        for key, v in whole.items():
            by[key] = by.get(key, 0) + v * (n - len(groups))
    if n > 1:
        by = {k: v / n for k, v in by.items()}
    return [[k, v / 1e9] for k, v in
            sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def _gaps_by_host(device_events, host_events, spans) -> dict:
    busy = sorted(clip([(e.start, e.end) for e in device_events], spans))
    gaps = []
    for s0, s1 in spans:
        cur = s0
        for start, end in busy:
            if end <= s0 or start >= s1:
                continue
            if start > cur:
                gaps.append((cur, start))
            cur = max(cur, end)
        if s1 > cur:
            gaps.append((cur, s1))
    starts = [e.start for e in host_events]
    by = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid)
        best = None
        # the innermost covering event started last among those that cover
        for e in reversed(host_events[max(0, i - 400):i]):
            if e.end >= mid and e.name != CALL_SPAN:
                best = e.name
                break
        key = best or "host: no torch op"
        by[key] = by.get(key, 0) + (g1 - g0)
    return by


def first_start(device_events, name_part: str, t0: int, t1: int):
    """Start (ns) of the first device event inside [t0, t1] whose name
    holds ``name_part``, or None."""
    i = bisect.bisect_left([e.start for e in device_events], t0)
    for e in device_events[i:]:
        if e.start > t1:
            return None
        if name_part in e.name:
            return e.start
    return None


def kernel_time(device_events, name_part: str, spans) -> tuple:
    """(launches, seconds) of the device events that start inside
    ``spans`` and whose name holds ``name_part``.  (A span's end may read
    a little before its last kernel's: the two clocks are matched only so
    closely.)"""
    n, t = 0, 0
    for s0, s1 in spans:
        for e in device_events:
            if s0 <= e.start < s1 and name_part in e.name:
                n += 1
                t += e.end - e.start
    return n, t / 1e9


def idle_percent(run):
    """100 - the device's busy share of the traced calls' spans."""
    if run.window_s <= 0 or not run.device_events:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)


def loop_ms_per_iteration(run, kernel="assign_kernel"):
    """ms from each call's first ``kernel`` start to its span's end, over
    the iterations its lines report, over all the traced calls."""
    from kmbench.harness import iterations

    total, its = 0, 0
    for (s0, s1), call in zip(run.spans, run.calls):
        t = first_start(run.device_events, kernel, s0, s1)
        if t is None:
            return None
        total += s1 - t
        its += iterations(call.lines)
    return total / 1e6 / its if its else None


def assign_roofline(run):
    """B2 (``kmt_assign``, device kernel ``assign_kernel``) against its
    bound: launches times the frozen ``assign_bound(rows, f, k, dtype)``
    over the summed device time of its launches in the traced calls, in
    %.  It holds for Lloyd calls, where every launch scores all the rows
    of its card: all n on one card; over several, card i's row shard (the
    program's cut: n // cards rows, one more on the first n % cards).
    Yinyang's launches score a subset: its cells do not list it."""
    from kmbench import roofline as R

    cfg = run.cell.config
    n, f, k = int(cfg["samples"]), int(cfg["features"]), int(cfg["clusters"])
    chips = run.cell.chips
    groups = ({0: run.device_events} if chips <= 1
              else by_card(run.device_events))
    work, seconds = 0.0, 0.0
    for card, ev in groups.items():
        launches, t = kernel_time(ev, "assign_kernel", run.spans)
        if not launches:
            continue
        rows = n // chips + (card < n % chips)
        work += launches * R.assign_bound(rows, f, k, cfg["dtype"])["ms"] / 1e3
        seconds += t
    if not work or seconds <= 0:
        return None
    return 100.0 * work / seconds


def mfu(run):
    """The whole call's share of the cards' peak, in %: the Lloyd
    assignments' products, 2 n k f operations an iteration over the
    iteration lines of the traced calls, at the storage dtype's peak rate
    (frozen ``roofline.PEAK_OPS_PER_S``: bf16 tensor cores, or
    fp32-grade products) times the cell's cards, over the calls' whole
    spans (init and the host's time included).  It bounds what any one
    kernel's roofline share can buy end to end."""
    from kmbench import roofline as R
    from kmbench.harness import iterations

    cfg = run.cell.config
    its = sum(iterations(c.lines) for c in run.calls)
    seconds = sum(s1 - s0 for s0, s1 in run.spans) / 1e9
    if not its or seconds <= 0:
        return None
    kind = "bf16" if cfg["dtype"] == "bfloat16" else "fp32 product"
    ops = 2.0 * int(cfg["samples"]) * int(cfg["clusters"]) * \
        int(cfg["features"]) * its
    return 100.0 * ops / (R.PEAK_OPS_PER_S[kind] * max(1, run.cell.chips)) \
        / seconds


def prepare_init_s(run):
    """API, prepare and init: per traced call, the seconds from the
    harness's span's start to the start of the call's first
    ``assign_kernel`` on the card (its first Lloyd or draft iteration);
    the mean over the calls."""
    vals = []
    for s0, s1 in run.spans:
        t = first_start(run.device_events, "assign_kernel", s0, s1)
        if t is None:
            return None
        vals.append((t - s0) / 1e9)
    return sum(vals) / len(vals) if vals else None
