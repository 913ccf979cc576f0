"""The Lloyd kernel entries and their plain-torch twins.

- :func:`fused_lloyd_pass` (B1) — scores, rescored argmin, reassignment
  count and the full centroid segment sum in one pass; replaces
  ``kmcuda_tpu/ops/assign_pallas.py:_kernel``.
- :func:`assign_only_pass` (B2) — the same without the segment sum;
  replaces ``_kernel_assign_only``.
- :func:`delta_sum` — the centroid delta of a sparse iteration's moved
  rows (``csrc/segment.cu:kmt_delta_sum``, the segment sum run once over
  the list's 2 m signed entries); replaces the JAX package's ``compact.delta_compacted``, XLA
  work on the TPU, whose port :func:`compact.delta_compacted` is its
  plain twin.

On a CUDA tensor each wrapper launches the hand-written kernels of
``csrc/assign.cu`` (B2) and ``csrc/segment.cu`` (the segment sum), built
at first use (see ``ops._build``); B1 is the B2 kernel followed by the
segment-sum kernels, so the two give bitwise equal assignments, best
scores and counts.  On a CPU tensor — and only there —
the wrapper runs the plain twin (``*_reference``), which the CPU tests
hold against the JAX package and ``chip_smoke.py`` holds the kernels
against on the card.  Any other device raises.
"""

import typing

import torch

from kmcuda_torch import config
from kmcuda_torch.ops import _build
from kmcuda_torch.ops import compact as C
from kmcuda_torch.ops import distance as D
from kmcuda_torch.ops.assign import pad_clusters, rescore_table
from kmcuda_torch.utils.errors import KMTPUInvalidArguments

#: kernel launches per entry; a wrapper adds one where it launches
LAUNCHES = {"fused_lloyd_pass": 0, "assign_only_pass": 0, "delta_sum": 0}

#: the plain twins score this many (row, centroid) pairs per chunk
REFERENCE_CHUNK_ELEMENTS = 1 << 26
#: the segment sum's threads per block (``csrc/segment.cu``)
SEGMENT_THREADS = 256
#: the segment sum's reduction cuts the sorted rows into at most this many
#: chunks, of at least SEGMENT_MIN_CHUNK rows
SEGMENT_MAX_CHUNKS = 4096
SEGMENT_MIN_CHUNK = 64
#: the count table may hold this many entries whatever the entries
SEGMENT_TABLE = 1 << 21
#: table entries one block of the table's scan takes (``csrc/segment.cu``)
SEGMENT_SCAN_TILE = 4096


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_args(x, valid, prev_assign, centroids, k: int) -> None:
    for name, t in (("x", x), ("valid", valid), ("prev_assign", prev_assign),
                    ("centroids", centroids)):
        if not isinstance(t, torch.Tensor):
            raise TypeError("%s must be a torch.Tensor" % name)
        if t.device != x.device:
            raise KMTPUInvalidArguments(
                "%s is on %s, x on %s" % (name, t.device, x.device))
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise KMTPUInvalidArguments(
            "x must be (n, f) float32 or bfloat16, got %s %s"
            % (tuple(x.shape), x.dtype))
    n, f = x.shape
    if not 1 <= n <= config.MAX_SAMPLES or not 1 <= k < 2**31 - 1:
        raise KMTPUInvalidArguments(
            "need 1 <= n <= %d (the segment sum's row ids are int32) and 1 "
            "<= k < 2**31 - 1, got n=%d, k=%d" % (config.MAX_SAMPLES, n, k))
    if valid.shape != (n,) or valid.dtype != torch.bool:
        raise KMTPUInvalidArguments("valid must be (n,) bool")
    if prev_assign.shape != (n,) or prev_assign.dtype != torch.int32:
        raise KMTPUInvalidArguments("prev_assign must be (n,) int32")
    if centroids.shape != (k, f) or centroids.dtype != torch.float32:
        raise KMTPUInvalidArguments(
            "centroids must be (%d, %d) float32, got %s %s"
            % (k, f, tuple(centroids.shape), centroids.dtype))
    for name, t in (("x", x), ("valid", valid), ("prev_assign", prev_assign)):
        if not t.is_contiguous():
            raise KMTPUInvalidArguments("%s must be contiguous" % name)
    if x.device.type not in ("cpu", "cuda"):
        raise KMTPUInvalidArguments("unsupported device %s" % x.device)


class SegmentPlan(typing.NamedTuple):
    """The cut of ``kmt_segment_sum`` / ``kmt_delta_sum`` at one shape: what
    the kernel takes, and the scratch it needs (the kernel refuses scratch
    shorter than its own count)."""

    rows: int           # entries per placement block, a multiple of 256
    chunk: int          # sorted positions per reduction chunk
    tx: int             # threads across a row's features (divides 256)
    int_scratch: int    # int32: table and its total, tile sums, permutation,
                        # sorted ids
    float_scratch: int  # fp32: two partial rows per chunk


def _pow2_at_least(v: int) -> int:
    return 1 << max(0, int(v) - 1).bit_length()


def segment_plan(n: int, f: int, k: int, itemsize: int,
                 sides: int = 1) -> SegmentPlan:
    """The segment sum's cut for ``sides`` runs of n entries (1: B1' over
    the n rows of x (n, f); 2: the delta's two sides of n moved rows) of
    ``itemsize`` bytes and k clusters: a pure function of the shape, so the
    summation order (hence the sums) repeats bitwise.  Reduction chunks
    hold at least SEGMENT_MIN_CHUNK positions and there are at most
    SEGMENT_MAX_CHUNKS, so the partials stay within 2 * 4096 * f floats;
    the placement cuts each side into blocks of ``rows`` >= 1024 entries,
    as many as keep the (k, blocks) count table within max(entries,
    SEGMENT_TABLE) entries (plus a block a side per cluster): at least k
    entries a block where the entries pass SEGMENT_TABLE, as B1' always
    had, and more blocks when they are few beside k.  The blocks move no
    position, so the sums do not depend on ``rows``."""
    entries = sides * n
    cap = max(entries, SEGMENT_TABLE)
    rows = 256 * -(-max(1024, -(-k * entries // cap)) // 256)
    table = k * sides * -(-n // rows)
    chunk = max(SEGMENT_MIN_CHUNK,
                _pow2_at_least(-(-entries // SEGMENT_MAX_CHUNKS)))
    tx = min(SEGMENT_THREADS,
             max(32, _pow2_at_least(-(-f // (16 // itemsize)))))
    return SegmentPlan(rows, chunk, tx,
                       table + 1 + -(-table // SEGMENT_SCAN_TILE)
                       + 2 * entries,
                       2 * -(-entries // chunk) * f)


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), as fp32 with its low 13 mantissa bits zero: what PTX's
    ``cvt.rna.tf32.f32`` gives.  Non-finite values pass through."""
    bits = v.contiguous().view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(v), r, v)


def tf32_split(v: torch.Tensor) -> tuple:
    """(hi, lo) of fp32 ``v`` for 3xTF32 products: hi = tf32(v), lo =
    tf32(v - hi); v - hi is exact, so hi + lo differs from v by at most
    the rounding of lo (2**-11 relative to lo).  The kernel splits x
    tiles the same way with ``cvt.rna.tf32.f32``."""
    hi = tf32_round(v)
    return hi, tf32_round(v - hi)


def _launch_assign(lib, x, valid, prev_assign, centroids, k, metric,
                   stream):
    n, f = x.shape
    panel, c_sq = pad_clusters(centroids, x.dtype)
    # fp32 storage: the kernel's 3xTF32 products take the panel split
    panel, panel_lo = ((panel, None) if x.dtype == torch.bfloat16
                       else tf32_split(panel))
    ctab = rescore_table(centroids)
    aid = torch.empty((n,), dtype=torch.int32, device=x.device)
    best = torch.empty((n,), dtype=torch.float32, device=x.device)
    changed = torch.zeros((1,), dtype=torch.int32, device=x.device)
    code = lib.kmt_assign(
        x.data_ptr(), panel.data_ptr(),
        None if panel_lo is None else panel_lo.data_ptr(), c_sq.data_ptr(),
        ctab.data_ptr(), valid.data_ptr(), prev_assign.data_ptr(),
        aid.data_ptr(), best.data_ptr(), changed.data_ptr(), n, f, k,
        int(x.dtype == torch.bfloat16),
        int(metric == D.DistanceMetric.COSINE), stream)
    _build.check(lib, code, "kmt_assign")
    return aid, best, changed[0]


def launch_segment_sum(lib, x, aid, k, stream):
    """``kmt_segment_sum`` of x over ``aid``: (sums (k, f) fp32, counts
    (k,) int32).  The second half of :func:`fused_lloyd_pass`; counts no
    launch of its own."""
    n, f = x.shape
    plan = segment_plan(n, f, k, x.element_size())
    sums = torch.empty((k, f), dtype=torch.float32, device=x.device)
    counts = torch.empty((k,), dtype=torch.int32, device=x.device)
    iscratch = torch.empty((plan.int_scratch,), dtype=torch.int32,
                           device=x.device)
    fscratch = torch.empty((plan.float_scratch,), dtype=torch.float32,
                           device=x.device)
    code = lib.kmt_segment_sum(
        x.data_ptr(), aid.data_ptr(), iscratch.data_ptr(),
        fscratch.data_ptr(), sums.data_ptr(), counts.data_ptr(), n, f, k,
        plan.rows, plan.chunk, plan.tx, plan.int_scratch, plan.float_scratch,
        int(x.dtype == torch.bfloat16), stream)
    _build.check(lib, code, "kmt_segment_sum")
    return sums, counts


def assign_only_pass(x, valid, prev_assign, centroids, *, n_clusters: int,
                     metric: D.DistanceMetric):
    """B2: returns (assign (n,) int32, best (n,) fp32, changed () int32)."""
    _check_args(x, valid, prev_assign, centroids, n_clusters)
    if x.device.type == "cpu":
        return assign_only_pass_reference(
            x, valid, prev_assign, centroids, n_clusters=n_clusters,
            metric=metric)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        out = _launch_assign(lib, x, valid, prev_assign, centroids,
                             n_clusters, metric, stream)
    LAUNCHES["assign_only_pass"] += 1
    return out


def fused_lloyd_pass(x, valid, prev_assign, centroids, *, n_clusters: int,
                     metric: D.DistanceMetric):
    """B1: returns (assign (n,) int32, best (n,) fp32, sums (K, F) fp32,
    counts (K,) int32, changed () int32) — the full segment sum of the
    fresh assignment, which the Lloyd loop normalizes."""
    _check_args(x, valid, prev_assign, centroids, n_clusters)
    if x.device.type == "cpu":
        return fused_lloyd_pass_reference(
            x, valid, prev_assign, centroids, n_clusters=n_clusters,
            metric=metric)
    k = n_clusters
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        aid, best, changed = _launch_assign(
            lib, x, valid, prev_assign, centroids, k, metric, stream)
        sums, counts = launch_segment_sum(lib, x, aid, k, stream)
    LAUNCHES["fused_lloyd_pass"] += 1
    return aid, best, sums, counts, changed


def _check_delta_args(x, rows, assign_new, assign_old, k: int) -> None:
    for name, t in (("x", x), ("rows", rows), ("assign_new", assign_new),
                    ("assign_old", assign_old)):
        if not isinstance(t, torch.Tensor):
            raise TypeError("%s must be a torch.Tensor" % name)
        if t.device != x.device:
            raise KMTPUInvalidArguments(
                "%s is on %s, x on %s" % (name, t.device, x.device))
    if x.device.type not in ("cpu", "cuda"):
        raise KMTPUInvalidArguments("unsupported device %s" % x.device)
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise KMTPUInvalidArguments(
            "x must be (n, f) float32 or bfloat16, got %s %s"
            % (tuple(x.shape), x.dtype))
    n = x.shape[0]
    if not 1 <= n <= config.MAX_SAMPLES or not 1 <= k < 2**31 - 1:
        raise KMTPUInvalidArguments(
            "need 1 <= n <= %d and 1 <= k < 2**31 - 1, got n=%d, k=%d"
            % (config.MAX_SAMPLES, n, k))
    if rows.dim() != 1 or rows.dtype != torch.int32:
        raise KMTPUInvalidArguments("rows must be (m,) int32, got %s %s"
                                    % (tuple(rows.shape), rows.dtype))
    for name, t in (("assign_new", assign_new), ("assign_old", assign_old)):
        if t.shape != (n,) or t.dtype != torch.int32:
            raise KMTPUInvalidArguments("%s must be (%d,) int32" % (name, n))
    for name, t in (("x", x), ("rows", rows), ("assign_new", assign_new),
                    ("assign_old", assign_old)):
        if not t.is_contiguous():
            raise KMTPUInvalidArguments("%s must be contiguous" % name)
    if 2 * rows.numel() > 2**31 - 1:
        raise KMTPUInvalidArguments(
            "rows: the delta's 2 m entries are int32 positions, got m=%d"
            % rows.numel())
    if rows.numel() == 0:
        return
    # the list's order and range and the listed ids' range, one device read
    r = rows.long()
    inside = r.clamp(0, n - 1)
    ids = torch.stack([assign_new[inside], assign_old[inside]])
    ascending, first, last, low, high = torch.stack([
        (r[1:] > r[:-1]).all(), r[0], r[-1], ids.min(), ids.max()]).tolist()
    if not ascending or first < 0 or last >= n:
        raise KMTPUInvalidArguments(
            "rows must ascend strictly within [0, %d)" % n)
    if low < 0 or high > k:
        raise KMTPUInvalidArguments(
            "the listed rows' ids must lie in [0, %d] (%d is no cluster), "
            "got [%d, %d]" % (k, k, low, high))


def delta_sum(x, rows, assign_new, assign_old, *, n_clusters: int):
    """The centroid delta of the moved rows ``rows`` (ascending (m,) int32
    row ids of x): (d_sums (K, F) fp32, d_counts (K,) int32), where a row
    adds x_r to cluster ``assign_new[r]`` and subtracts it from
    ``assign_old[r]``; id K (an invalid row) is no cluster.  On a CUDA
    tensor ``kmt_delta_sum`` (the summation order a pure function of the
    list, its ids, f and K; m = 0 launches nothing); on a CPU tensor the
    plain twin, ``compact.delta_compacted`` over the list."""
    k = n_clusters
    _check_delta_args(x, rows, assign_new, assign_old, k)
    m = rows.numel()
    if x.device.type == "cpu":
        return C.delta_compacted(x, assign_new, assign_old, rows, m,
                                 n_clusters=k)
    if m == 0:
        return (torch.zeros((k, x.shape[1]), dtype=torch.float32,
                            device=x.device),
                torch.zeros((k,), dtype=torch.int32, device=x.device))
    lib = _build.library()
    with torch.cuda.device(x.device):
        out = launch_delta_sum(lib, x, rows, assign_new, assign_old, k,
                               torch.cuda.current_stream().cuda_stream)
    LAUNCHES["delta_sum"] += 1
    return out


def launch_delta_sum(lib, x, rows, assign_new, assign_old, k, stream):
    """``kmt_delta_sum`` over m >= 1 checked rows: (d_sums (k, f) fp32,
    d_counts (k,) int32).  The launch of :func:`delta_sum`, without its
    checks; counts no launch of its own."""
    n, f = x.shape
    m = rows.numel()
    plan = segment_plan(m, f, k, x.element_size(), sides=2)
    d_sums = torch.empty((k, f), dtype=torch.float32, device=x.device)
    d_counts = torch.empty((k,), dtype=torch.int32, device=x.device)
    iscratch = torch.empty((plan.int_scratch,), dtype=torch.int32,
                           device=x.device)
    fscratch = torch.empty((plan.float_scratch,), dtype=torch.float32,
                           device=x.device)
    code = lib.kmt_delta_sum(
        x.data_ptr(), rows.data_ptr(), assign_new.data_ptr(),
        assign_old.data_ptr(), iscratch.data_ptr(), fscratch.data_ptr(),
        d_sums.data_ptr(), d_counts.data_ptr(), n, m, f, k, plan.rows,
        plan.chunk, plan.tx, plan.int_scratch, plan.float_scratch,
        int(x.dtype == torch.bfloat16), stream)
    _build.check(lib, code, "kmt_delta_sum")
    return d_sums, d_counts


def assign_only_pass_reference(x, valid, prev_assign, centroids, *,
                               n_clusters: int, metric: D.DistanceMetric):
    """Plain twin of :func:`assign_only_pass`, from ``ops.distance``."""
    k = n_clusters
    panel, c_sq = pad_clusters(centroids, x.dtype)
    c_ext = rescore_table(centroids)
    chunk = max(1, REFERENCE_CHUNK_ELEMENTS // k)
    aids, bests = [], []
    for start in range(0, x.shape[0], chunk):
        xb = x[start:start + chunk]
        s = D.scores(xb, panel.T, c_sq, metric)
        best, aid, _d2 = D.argmin_rescored(s, k, xb, c_ext)
        aids.append(aid)
        bests.append(best)
    aid = torch.where(valid, torch.cat(aids),
                      torch.tensor(k, dtype=torch.int32, device=x.device))
    changed = (aid != prev_assign).sum(dtype=torch.int32)
    return aid, torch.cat(bests), changed


def near_ties(x, centroids, metric: D.DistanceMetric):
    """(n,) bool: rows where fp32 sums in another order may rightly pick
    another centroid than the plain twin, because one of the assignment's
    comparisons is within rounding: consecutive plain top-3 scores within
    1e-5 * max(1, |s1|) of each other (s1 vs s2 orders the candidates, s2
    vs s3 picks the second), or the rescore's exact squared distances of
    the two candidates within 1e-5 * max(1, d2).  For bf16 the last is not
    implied by the first: the scores use the bf16-rounded panel, the
    rescore the fp32 centroids."""
    k = centroids.shape[0]
    if k < 2:
        return torch.zeros((x.shape[0],), dtype=torch.bool, device=x.device)
    panel, c_sq = pad_clusters(centroids, x.dtype)
    c_ext = rescore_table(centroids)
    chunk = max(1, REFERENCE_CHUNK_ELEMENTS // k)
    out = []
    for start in range(0, x.shape[0], chunk):
        xb = x[start:start + chunk]
        s = D.scores(xb, panel.T, c_sq, metric)
        top, idx = torch.topk(s, min(3, k), dim=1, largest=False)
        tie = ((top[:, 1:] - top[:, :-1])
               <= 1e-5 * top[:, :1].abs().clamp(min=1)).any(dim=1)
        diff = xb.float()[:, None, :] - c_ext[idx[:, :2]]
        d2 = torch.sum(diff * diff, dim=-1)
        out.append(tie | ((d2[:, 1] - d2[:, 0]).abs()
                          <= 1e-5 * d2.min(dim=1).values.clamp(min=1)))
    return torch.cat(out)


def segment_sum_reference(x, aid, k: int):
    """(sums (K, F) fp32, counts (K,) int32) of x over the rows with
    aid < k."""
    keep = aid < k
    idx = aid[keep].long()
    sums = torch.zeros((k, x.shape[1]), dtype=torch.float32, device=x.device)
    sums.index_add_(0, idx, x[keep].float())
    counts = torch.bincount(idx, minlength=k).to(torch.int32)
    return sums, counts


def fused_lloyd_pass_reference(x, valid, prev_assign, centroids, *,
                               n_clusters: int, metric: D.DistanceMetric):
    """Plain twin of :func:`fused_lloyd_pass`."""
    aid, best, changed = assign_only_pass_reference(
        x, valid, prev_assign, centroids, n_clusters=n_clusters,
        metric=metric)
    sums, counts = segment_sum_reference(x, aid, n_clusters)
    return aid, best, sums, counts, changed
