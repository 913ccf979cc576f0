"""Triangle-inequality-pruned exact kNN search, the port of
``kmcuda_tpu.ops.knn_prune``.

The unit of search is a *query chunk* and a *member tile*.  Members are
laid out cluster-sorted and packed (:func:`packed_layout`, no per-cluster
padding; a tile may span cluster boundaries and carries its (cluster,
tile) incidences).  A tile's pruning bound for a chunk is the min over
its clusters c of (min over the chunk's queries q of d(q, center_c)) -
R(c).  Each chunk visits tiles most-promising-first and stops once the
next tile's bound exceeds every query's running kth distance.

- :func:`tours` is pass 1: the bounds and the visit order of every chunk
  of a batch, in plain torch (one fp32 product per slab, TF32 off, even
  for bf16 storage; a stable sort, so tiles that share a bound keep tile
  order);
- pass 2 is the walk of ``ops.knn_kernels`` (B3): the hand-written CUDA
  kernel on a CUDA tensor, its plain twin on a CPU tensor;
- :func:`rescore` gives the kk surviving candidates the exact
  subtract-square distance and selects the k nearest.

Cosine in bf16 storage ranks by one measure in all three: the angle of
the chord of the stored rows, 2 asin(|q - m| / 2), in which the rescore
returns its distances.  bf16 rows of unit vectors are not of unit norm
(1 +- ~2^-8), and for near neighbours 1 - cos is far below that, so the
angle of the dot product would be mostly rounding.  fp32 cosine ranks by
the angle of the dot, as the JAX package does.

Exactness: all bounds live in true-distance space with a downward slack
on the tile bound and an upward margin on every walk distance, so
rounding can only weaken pruning.  The walk tracks candidates as packed
positions (its (distance, id) tie-break is lexicographic in packed id
space); the rescore relabels them to original sample ids.
"""

import numpy as np
import torch

from kmcuda_torch.ops import distance as D

INF = float("inf")

#: relative slack absorbing dot-form rounding in the pruning inequalities
SLACK = 1e-5

#: the bf16 storage envelope: every walk distance's chord
#: t = sqrt(|m|^2 - 2 q.m + |q|^2) is raised by sqrt(EPS_ENV (|q|^2 +
#: |m|^2)).  The products of bf16 values are exact in fp32; the dot's fp32
#: sum over f features, the two fp32 row norms and the two adds leave
#: t^2 within (f + 2) 2^-23 (|q|^2 + |m|^2) of |q - m|^2, and pass 1's
#: chord to a centroid (fp32 products) errs the same way, and an error e
#: in a square moves its root by at most sqrt(e).  The envelope covers
#: both at once, so tau stays above the exact k-th distance and no tile
#: with a neighbour is cut: for cosine rows (every norm within 2^-7 of 1)
#: while 4 (f + 2) 2^-23 (2 + 2^-6) <= 2^-8 (2 - 2^-6), f <= 7,900 (a
#: worst case: fp32 sums round far below it); for L2 it is the JAX
#: package's envelope.  fp32 storage has none: SLACK covers its rounding
EPS_ENV = 2.0 ** -8

#: bound of tiles that must never be visited; any bound >= STOP_BOUND ends
#: the walk regardless of the running kth distance (fp32 values, as in the
#: JAX package)
BIG_BOUND = float(np.float32(1e29))
STOP_BOUND = float(np.float32(1e28))

#: pass 1 scores at most this many (query, centroid) pairs at a time
BOUND_ELEMENTS = 1 << 25
#: the rescore gathers at most this many candidate feature values at a time
RESCORE_ELEMENTS = 1 << 26


def chord_measure(dtype, metric) -> bool:
    """True where the walk and pass 1 rank cosine neighbours by the angle
    of the chord (bf16 storage), not by the angle of the dot product."""
    return metric == D.DistanceMetric.COSINE and dtype == torch.bfloat16


def select_k(d, idx, kk: int):
    """Ascending (distance, id)-lexicographic kk-smallest selection per row.

    ``torch.topk`` does not promise the lowest index first on ties, so the
    order is built explicitly: a stable sort by id, then a stable sort by
    distance.  NaNs sort last.  Returns (dists (n, kk), ids (n, kk))."""
    o = torch.argsort(idx, dim=1, stable=True)
    d = torch.gather(d, 1, o)
    idx = torch.gather(idx, 1, o)
    o = torch.argsort(d, dim=1, stable=True)[:, :kk]
    return torch.gather(d, 1, o), torch.gather(idx, 1, o)


def candidate_kk(k_neighbors: int, n_members: int) -> int:
    """Running candidate-buffer width: k plus slack so near-boundary
    candidates survive the dot-form ranking until the exact rescore."""
    return min(k_neighbors + max(16, k_neighbors // 2), n_members)


def merge_block(best_d, best_i, d, id_base: int, kk: int):
    """Merge an ascending (distance, id) top-kk buffer with a scored block
    whose ids are ``id_base + column``: the lexicographic top-kk of both."""
    ids = torch.arange(id_base, id_base + d.shape[1], dtype=best_i.dtype,
                       device=d.device)
    return select_k(torch.cat([best_d, d], dim=1),
                    torch.cat([best_i, ids.expand(d.shape[0], -1)], dim=1),
                    kk)


def exact_rescore(qb, bi, xm, metric, k_neighbors: int, orig_pos=None):
    """Cancellation-free exact rescore of kk candidate ids (bi < 0 marks an
    empty slot) and the final top-k_neighbors selection, in packed id space.
    With ``orig_pos`` the ids come back as original sample ids.  Slots
    without a finite distance come back as -1.  Returns (ids (n, k) int32,
    distances (n, k) fp32)."""
    cand = torch.clamp(bi, min=0)
    diff = qb[:, None, :].float() - xm[cand.long()].float()
    chord = torch.sqrt(torch.sum(diff * diff, dim=-1))
    if metric == D.DistanceMetric.L2:
        d_exact = chord
    else:
        d_exact = 2.0 * torch.arcsin(torch.clamp(chord * 0.5, 0.0, 1.0))
    d_exact = torch.where(bi < 0, INF, d_exact)
    d_sorted, i_sorted = select_k(d_exact, cand, k_neighbors)
    if orig_pos is not None:
        i_sorted = orig_pos[i_sorted.long()]
    i_sorted = torch.where(torch.isfinite(d_sorted), i_sorted, -1)
    return i_sorted.to(torch.int32), d_sorted


def rescore(xq, bi, xm, metric, k_neighbors: int, orig_pos=None):
    """:func:`exact_rescore` in row batches, so the (rows, kk, f) gather
    stays within RESCORE_ELEMENTS (a one-shot gather at 1M x 32 x 256 fp32
    would be 33 GB)."""
    rows = max(1, RESCORE_ELEMENTS // (bi.shape[1] * xq.shape[1]))
    parts = [exact_rescore(xq[s:s + rows], bi[s:s + rows], xm, metric,
                           k_neighbors, orig_pos)
             for s in range(0, xq.shape[0], rows)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def packed_layout(a_sorted, *, k: int, tile_m: int, n_tiles: int):
    """Packed member layout plan.

    a_sorted: (n,) cluster ids in ascending order (k = invalid, sorted to
    the end, so valid members are a prefix).  Rows past n up to
    ``n_tiles * tile_m`` are filler; the caller guarantees a whole filler
    tile at the end.  Returns inc_c (n_tiles + k,) int64 — cluster of each
    (cluster, tile) incidence, k = unused slot; inc_t (n_tiles + k,) int64
    — its tile (unused slots point at the filler tile n_tiles - 1); and
    tile_nvalid (n_tiles,) int32 — real members per tile."""
    dev = a_sorted.device
    a = a_sorted.long()
    szk = torch.bincount(a[a < k], minlength=k)
    end_m = torch.cumsum(szk, 0)
    off_m = end_m - szk
    t0 = off_m // tile_m
    t1 = torch.clamp(end_m - 1, min=0) // tile_m
    span = torch.where(szk > 0, t1 - t0 + 1, 0)
    slot_end = torch.cumsum(span, 0)
    iota_l = torch.arange(n_tiles + k, device=dev)
    cidx = torch.searchsorted(slot_end, iota_l, right=True)
    ok = iota_l < slot_end[k - 1]
    cc = torch.clamp(cidx, max=k - 1)
    slot_start = slot_end[cc] - span[cc]
    inc_t = torch.where(ok, t0[cc] + (iota_l - slot_start), n_tiles - 1)
    inc_c = torch.where(ok, cc, k)
    n_valid = (a < k).sum()
    tile_ids = torch.arange(n_tiles, device=dev)
    tile_nvalid = torch.clamp(n_valid - tile_ids * tile_m, 0, tile_m)
    return inc_c, inc_t, tile_nvalid.to(torch.int32)


def tours(xq, xq_sq, q_assign, c_rank, r_ext, inc_c, inc_t, *,
          n_clusters: int, metric, chunk: int, n_tiles: int, group: int):
    """Pass 1 over a batch of query chunks: every chunk's tile bounds,
    sorted ascending (stable), with the tile order.

    Returns (sorted_min (nchunks, n_tiles + group - 1) fp32, tile_order
    (same) int32, n_steps (nchunks,) int32, n_qvalid (nchunks,) int32).  A
    grouped walk's tail repeats the filler tile n_tiles - 1 at BIG_BOUND;
    n_steps covers the bounds below STOP_BOUND."""
    k = n_clusters
    nb = xq.shape[0]
    nchunks = nb // chunk
    c_safe = torch.where(torch.isfinite(c_rank), c_rank, 0.0)
    c_safe_sq = torch.sum(c_safe * c_safe, dim=1)
    qv = q_assign < k
    chord = chord_measure(xq.dtype, metric)
    slab = chunk * max(1, BOUND_ELEMENTS // (chunk * max(k, 1)))
    u_parts = []
    for s in range(0, nb, slab):
        prod = D.matmul_f32(xq[s:s + slab], c_safe.T)
        if metric == D.DistanceMetric.L2 or chord:
            dd = torch.sqrt(torch.clamp(
                c_safe_sq[None, :] - 2.0 * prod + xq_sq[s:s + slab, None],
                min=0.0))
        else:
            dd = torch.arccos(torch.clamp(prod, -1.0, 1.0))
        dd = torch.where(qv[s:s + slab, None], dd, INF)
        u_parts.append(dd.view(-1, chunk, k).amin(dim=1))
    u_all = torch.cat(u_parts)                              # (nchunks, k)
    inc_cc = torch.clamp(inc_c, max=k - 1)
    if chord:
        # the chord is a metric whatever the rows' norms, so the bound is
        # taken there, |q - c| - R(c) <= |q - m|, then turned into the
        # angle 2 asin(t / 2), which rises with t (and is convex: the
        # angles' own triangle inequality would need unit norms, which
        # bf16 rows lack).  R(c) is the chord of the radius, 2 sin(r / 2)
        # with a few ulps' margin; a radius past 3 (a chord past 1.99,
        # where r's clamp at pi may hide a longer chord) bounds nothing
        r_chord = torch.where(r_ext < 3.0,
                              2.0 * torch.sin(0.5 * r_ext) * (1.0 + 2 ** -20),
                              INF)
        vals = torch.clamp(u_all[:, inc_cc] - r_chord[inc_cc][None, :],
                           min=0.0)
        vals = 2.0 * torch.arcsin(torch.clamp(0.5 * vals, max=1.0))
    else:
        vals = u_all[:, inc_cc] - r_ext[inc_cc][None, :]    # (nchunks, L)
    vals = vals - SLACK * (1.0 + vals.abs())
    vals = torch.where(torch.isfinite(vals) & (inc_c < k)[None, :], vals,
                       BIG_BOUND)
    tb = torch.full((nchunks, n_tiles), BIG_BOUND, device=xq.device)
    tb.scatter_reduce_(1, inc_t[None, :].expand(nchunks, -1), vals, "amin",
                       include_self=True)
    sorted_min, tile_order = torch.sort(tb, dim=1, stable=True)
    tile_order = tile_order.to(torch.int32)
    if group > 1:
        sorted_min = torch.cat([sorted_min, torch.full(
            (nchunks, group - 1), BIG_BOUND, device=xq.device)], dim=1)
        tile_order = torch.cat([tile_order, torch.full(
            (nchunks, group - 1), n_tiles - 1, dtype=torch.int32,
            device=xq.device)], dim=1)
    count_lt = (sorted_min < STOP_BOUND).sum(dim=1)
    n_steps = ((count_lt + group - 1) // group).to(torch.int32)
    n_qvalid = qv.view(nchunks, chunk).sum(dim=1, dtype=torch.int32)
    return sorted_min, tile_order, n_steps, n_qvalid


def walk_inputs(xq, xq_sq, q_assign, xm, xm_sq, m_spos, c_rank, r_ext,
                inc_c, inc_t, tile_nvalid, chunk_base: int, *,
                k_neighbors: int, n_clusters: int, metric, chunk: int,
                tile_m: int, group: int, n_batch_chunks: int):
    """Pass 1 for one batch of query chunks: the arguments of
    ``knn_kernels.walk`` (and of its twin) as (args, kwargs).

    xq/xq_sq/q_assign: the packed queries — rows, fp32 squared norms,
    cluster id (k = invalid); on one device they are the member rows.
    xm/xm_sq/m_spos: (M, F) packed members, their squared norms and sorted
    positions (-1 = invalid or filler).  c_rank: (k, F) fp32 rank-space
    centroids (NaN rows are dead clusters).  r_ext: (k,) cluster radii.
    inc_c/inc_t/tile_nvalid: the :func:`packed_layout` plan.  The batch
    covers rows [chunk_base * chunk, (chunk_base + n_batch_chunks) *
    chunk)."""
    nm = xm.shape[0]
    nb = n_batch_chunks * chunk
    row_base = chunk_base * chunk
    xq = xq[row_base:row_base + nb]
    xq_sq = xq_sq[row_base:row_base + nb]
    q_assign = q_assign[row_base:row_base + nb]
    q_pos = torch.arange(row_base, row_base + nb, dtype=torch.int32,
                         device=xq.device)
    sorted_min, tile_order, n_steps, n_qvalid = tours(
        xq, xq_sq, q_assign, c_rank, r_ext, inc_c, inc_t,
        n_clusters=n_clusters, metric=metric, chunk=chunk,
        n_tiles=nm // tile_m, group=group)
    args = (xq, xq_sq, q_pos, q_assign < n_clusters, n_qvalid, n_steps,
            tile_order, sorted_min, tile_nvalid, xm, xm_sq, m_spos)
    kw = dict(k_neighbors=k_neighbors, kk=candidate_kk(k_neighbors, nm),
              chunk=chunk, tile_m=tile_m, group=group, metric=metric,
              eps_env=0.0 if xq.dtype == torch.float32 else EPS_ENV)
    return args, kw


def search(xq, xq_sq, q_assign, xm, xm_sq, m_spos, orig_pos, c_rank, r_ext,
           inc_c, inc_t, tile_nvalid, chunk_base: int, *, k_neighbors: int,
           n_clusters: int, metric, chunk: int, tile_m: int, group: int,
           n_batch_chunks: int):
    """Pruned search over one batch of query chunks of the packed layout:
    :func:`walk_inputs`, the walk, :func:`rescore`.  The arguments are
    those of :func:`walk_inputs`, plus orig_pos: (M,) packed position ->
    original id.

    Returns (neighbors (rows, k) int32 original ids, -1 where none;
    distances (rows, k) fp32 ascending; examined (n_batch_chunks,) int64
    — (query, member) distances the walk computed per chunk)."""
    from kmcuda_torch.ops import knn_kernels as KK

    args, kw = walk_inputs(
        xq, xq_sq, q_assign, xm, xm_sq, m_spos, c_rank, r_ext, inc_c, inc_t,
        tile_nvalid, chunk_base, k_neighbors=k_neighbors,
        n_clusters=n_clusters, metric=metric, chunk=chunk, tile_m=tile_m,
        group=group, n_batch_chunks=n_batch_chunks)
    bi, examined, _steps = KK.walk(*args, **kw)
    nbr, dist = rescore(args[0], bi, xm, metric, k_neighbors, orig_pos)
    return nbr, dist, examined
