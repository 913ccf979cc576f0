"""Yinyang's bound refresh (``ops/yinyang._refresh``: the group-panel
product and the write of the lower bounds) against its bound: the frozen
bound of :func:`refresh_bound` summed over the program's
``yinyang.refreshed_rows`` samples, over the device time of the
operations the host put on the card inside the ``kmt.yinyang.refresh``
spans of the traced calls, in %.  Serves every
``yinyang_refresh_roofline.<cell>`` entry; one card.

The card runs a span's operations long after the host left it (the host
runs ahead by as much as the launch queue holds), so they are not found
by their device times.  A span's operations are found by count: from the
last host call before the span that waited for the card (a sync: the
card was idle when it returned), the host's launches are numbered in
order, and the card's operations that start after that sync, taken in
the stream's order, are numbered alike; those whose numbers the span's
launches hold are the refresh's.  A stretch from one sync to the next
whose launches and operations differ in number is not read (a launch the
trace does not show); where no refresh can be read the metric reads
nothing.
"""

import bisect
import sys

from kmbench import roofline as R
from kmbench import spans as S

SPAN = "kmt.yinyang.refresh"
COUNTER = "yinyang.refreshed_rows"
#: host calls that put one operation on the card's stream
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
            "cudaMemcpy", "cudaMemset")
#: host calls that return once the card has run all it was given
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")
#: the Yinyang group count of a call with no ``yinyang_t`` keyword
DEFAULT_YINYANG_T = 0.1
#: (n, G) fp32 lower bounds above this many bytes are stored in bf16
BOUNDS_F32_MAX_BYTES = 1 << 31


def refresh_bound(rows: int, n: int, f: int, k: int, groups: int,
                  dtype_name: str) -> dict:
    """The refresh of ``rows`` rows' lower bounds against ``k`` centroids
    in ``groups`` groups, samples (n, f) stored as ``dtype_name``: the
    exact product of each row with every centroid, 2 rows k f operations
    at the fp32-product rate (counted at k, not at the padded group
    panel, so that the bound is the same whatever implements it); one
    read of the rows and of the fp32 centroids, one write of the rows'
    (rows, groups) lower bounds, stored in bf16 above
    :data:`BOUNDS_F32_MAX_BYTES` of fp32 bounds at n rows."""
    size = {"float32": 4, "bfloat16": 2}[dtype_name]
    l_size = 2 if 4 * n * groups > BOUNDS_F32_MAX_BYTES else 4
    nbytes = rows * f * size + 4 * k * f + rows * groups * l_size
    return R.bound(nbytes, {"fp32 product": 2.0 * rows * k * f})


def refresh_device_ns(run) -> list:
    """[device ns or None, ...]: for each ``kmt.yinyang.refresh`` span of
    the traced calls, in order, the summed time of its operations on the
    card; None where its stretch between two syncs does not read."""
    host = run.host_events
    l_starts = [e.start for e in host if e.name in LAUNCHES]
    syncs = [e for e in host if e.name in SYNCS]
    dev = sorted(run.device_events, key=lambda e: e.start)
    d_starts = [e.start for e in dev]
    refreshes = S.spans(run, SPAN)
    out = []
    for c0, c1 in run.spans:
        for s0, s1 in refreshes:
            if not c0 <= s0 <= c1:
                continue
            before = [e.end for e in syncs if c0 <= e.end <= s0]
            after = [e for e in syncs if s1 <= e.start <= c1]
            if not before or not after:
                out.append(None)
                continue
            anchor, nxt = max(before), min(after, key=lambda e: e.start)
            first = bisect.bisect_right(l_starts, anchor)
            m = bisect.bisect_left(l_starts, s0) - first
            n = bisect.bisect_right(l_starts, s1) - first - m
            # a sync that is a launch too (cudaMemcpy) puts its own copy
            total = (bisect.bisect_left(l_starts, nxt.start) - first
                     + (nxt.name in LAUNCHES))
            d0 = bisect.bisect_left(d_starts, anchor)
            ops = dev[d0:bisect.bisect_right(d_starts, nxt.end)]
            if len(ops) != total:
                out.append(None)
                continue
            out.append(sum(e.end - e.start for e in ops[m:m + n]))
    return out


def read(run):
    if run.cell.chips != 1:
        return None
    recs = S.records(run)
    if recs is None:
        return None
    rows = S.samples(recs, COUNTER)
    times = refresh_device_ns(run)
    if not rows or len(rows) != len(times):
        return None
    cfg, kw = run.cell.config, run.cell.traffic.get("kwargs", {})
    n, f, k = int(cfg["samples"]), int(cfg["features"]), int(cfg["clusters"])
    groups = int(float(kw.get("yinyang_t", DEFAULT_YINYANG_T)) * k)
    bound_s = seconds = 0.0
    unread = 0
    for r, t in zip(rows, times):
        if t is None:
            unread += 1
        elif r:
            bound_s += refresh_bound(r, n, f, k, groups,
                                     cfg["dtype"])["ms"] / 1e3
            seconds += t / 1e9
    if unread:
        print("kmbench: %s: %d of %d refreshes not read (launches and "
              "device operations differ in number between their syncs)"
              % (SPAN, unread, len(rows)), file=sys.stderr, flush=True)
    if bound_s <= 0 or seconds <= 0:
        return None
    return 100.0 * bound_s / seconds
