"""Exact k-nearest neighbours over a clustered data set, the port of
``kmcuda_tpu.models.knn``.

Members are cluster-sorted and packed (``ops.knn_prune.packed_layout``),
and the packed rows serve as the queries too.  Clusters are relabeled
along a greedy nearest-neighbour tour of their centers (past
``KNN_TOUR_MAX_K`` clusters, a projection sort), so the clusters of one
query chunk sit close together and its pruning bound stays tight.  The
search runs in host batches of ``KNN_QUERY_BATCH`` queries and keeps the
reference's ``calculated %f of all the distances`` line.  A brute-force
search serves when there is no cluster structure to prune with (k < 2)
or fewer than 2 * LANE samples.

Nothing is padded: n_pad == n.  (The JAX package pads n to its device
mesh, which changes the layout's sizes but not the neighbours.)

Over row shards the plan is built on the leader from the gathered rows,
replicated to every shard's device, and the query chunks are cut into
contiguous per-shard ranges; each device searches its own range, and the
results are gathered to the leader in shard order.  A chunk's walk and
rescore do not depend on the other chunks, so the neighbours do not
depend on the cut.
"""

import typing

import numpy as np
import torch

from kmcuda_torch import config
from kmcuda_torch.ops import distance as D
from kmcuda_torch.ops import knn_prune as KP
from kmcuda_torch.utils import profiling as P

INF = float("inf")
#: the brute-force search scores this many query rows at a time
BRUTE_QUERY_ROWS = 1024
#: the radii pass reads at most this many feature values at a time
RADII_ELEMENTS = 1 << 24


def _search(xq, xq_sq, xm, m_valid, *, k: int, metric, tile_m: int):
    """Brute-force exact top-k (plain torch): every query against every
    member tile, dot-form distances, self and invalid members masked, a
    lexicographic top-kk merge per tile, then the exact rescore.  bf16
    cosine ranks by the chord, whose angle the rescore returns
    (``knn_prune.chord_measure``).  Returns (neighbors (n, k) int32,
    distances (n, k) fp32) ascending."""
    nl = xq.shape[0]
    nm = xm.shape[0]
    dev = xq.device
    rank = (D.DistanceMetric.L2 if KP.chord_measure(xq.dtype, metric)
            else metric)
    xm_sq = D.row_sq_norms(xm)
    kk = KP.candidate_kk(k, nm)
    bi = torch.empty((nl, kk), dtype=torch.int32, device=dev)
    for q0 in range(0, nl, BRUTE_QUERY_ROWS):
        qb = xq[q0:q0 + BRUTE_QUERY_ROWS]
        qsq = xq_sq[q0:q0 + BRUTE_QUERY_ROWS, None]
        qid = torch.arange(q0, q0 + qb.shape[0], device=dev)[:, None]
        best_d = torch.full((qb.shape[0], kk), INF, device=dev)
        best_i = torch.full((qb.shape[0], kk), -1, dtype=torch.int32,
                            device=dev)
        for m0 in range(0, nm, tile_m):
            msl = slice(m0, m0 + tile_m)
            s = D.scores(qb, xm[msl].T, xm_sq[msl], rank)
            d = D.finalize_distance(s, qsq, rank)
            mid = torch.arange(m0, m0 + s.shape[1], device=dev)[None, :]
            d = torch.where((qid == mid) | ~m_valid[msl][None, :], INF, d)
            if bool((d.min(dim=1).values <= best_d[:, kk - 1]).any()):
                best_d, best_i = KP.merge_block(best_d, best_i, d, m0, kk)
        bi[q0:q0 + qb.shape[0]] = best_i
    return KP.rescore(xq, bi, xm, metric, k)


def _sanitize_assign(valid, assign, *, n_clusters: int):
    """Cluster ids with k marking an invalid row (non-finite features, or
    an id outside [0, k))."""
    k = n_clusters
    a = assign.long()
    return torch.where(valid & (a >= 0) & (a < k), a, k)


def _sanitize_and_cd(valid, assign, centroids, *, n_clusters: int, metric):
    """Sanitized cluster ids and the cluster-center distance matrix (it
    only feeds the greedy relabeling tour)."""
    cf = centroids.float()
    return (_sanitize_assign(valid, assign, n_clusters=n_clusters),
            D.pairwise_distance(cf, cf, metric))


def _radii(xm, q_assign, c_rank, *, k: int, metric):
    """Cluster radii: the exact subtract-square distance of each member to
    its own centroid, max per cluster.  Empty clusters keep radius 0."""
    m_total, f = xm.shape
    c_ext = torch.cat([c_rank.float(),
                       torch.zeros((1, f), device=xm.device)])
    c_ext = torch.where(torch.isfinite(c_ext), c_ext, 0.0)
    rows = max(1, RADII_ELEMENTS // f)
    d_own = torch.empty((m_total,), device=xm.device)
    for s in range(0, m_total, rows):
        ab = q_assign[s:s + rows].long()
        diff = xm[s:s + rows].float() - c_ext[torch.clamp(ab, max=k)]
        chord = torch.sqrt(torch.sum(diff * diff, dim=-1))
        if metric == D.DistanceMetric.L2:
            d = chord
        else:
            d = 2.0 * torch.arcsin(torch.clamp(chord * 0.5, 0.0, 1.0))
        d_own[s:s + rows] = torch.where(ab < k, d, 0.0)
    keep = q_assign < k
    return torch.zeros((k,), device=xm.device).scatter_reduce_(
        0, q_assign[keep].long(), d_own[keep], "amax", include_self=True)


def _rank_from_perm(a, perm, k: int):
    rank = torch.empty((k,), dtype=torch.int64, device=a.device)
    rank[perm] = torch.arange(k, device=a.device)
    b = torch.where(a < k, rank[torch.clamp(a, max=k - 1)], k)
    return b, torch.argsort(b, stable=True), perm


def _tour_relabel(a, cd):
    """Relabel clusters along a greedy nearest-neighbour tour of the
    cluster centers, starting at cluster 0: k sequential argmins (lowest
    index on ties), run on the host over the (k, k) fp32 matrix.  Only the
    pruning depends on it, never the neighbours.  Returns (b, sorder,
    perm): rank-space cluster ids, the stable sort permutation by rank,
    and the rank -> original-cluster permutation."""
    k = cd.shape[0]
    big = KP.BIG_BOUND
    cdx = torch.where(torch.isfinite(cd), cd, big)
    cdx = cdx + big * torch.eye(k, device=cd.device)
    cdx = cdx.cpu().numpy()
    visited = np.zeros((k,), bool)
    perm = np.zeros((k,), np.int64)
    cur = 0
    for i in range(k):
        visited[cur] = True
        perm[i] = cur
        cur = int(np.argmin(np.where(visited, np.float32(np.inf),
                                     cdx[cur])))
    return _rank_from_perm(a, torch.from_numpy(perm).to(a.device), k)


def _proj_relabel(a, cents):
    """Large-k relabeling: sort the centers by their projection onto the
    centroid cloud's principal direction (8 power iterations).  Dead (NaN)
    clusters sort last."""
    cf = cents.float()
    alive = torch.isfinite(cf).all(dim=1)
    cz = torch.where(alive[:, None], cf, 0.0)
    n_alive = torch.clamp(alive.float().sum(), min=1.0)
    mean = cz.sum(dim=0) / n_alive
    cc = torch.where(alive[:, None], cf - mean[None, :], 0.0)
    v = torch.ones((cf.shape[1], 1), device=cf.device)
    v = v / torch.linalg.norm(v)
    for _ in range(8):
        w = D.matmul_f32(cc.T, D.matmul_f32(cc, v))
        v = w / torch.clamp(torch.linalg.norm(w), min=1e-30)
    key = torch.where(alive, D.matmul_f32(cc, v)[:, 0], INF)
    return _rank_from_perm(a, torch.argsort(key, stable=True), cf.shape[0])


def _pack_members(x, sorder, b_sorted, *, k: int, m_total: int):
    """The packed member array: the cluster-sorted rows plus zero filler to
    ``m_total``.  Invalid rows (cluster id k, sorted to the tail) and the
    filler keep m_spos = -1."""
    n, f = x.shape
    xm = x.new_zeros((m_total, f))
    torch.index_select(x, 0, sorder, out=xm[:n])
    m_spos = torch.full((m_total,), -1, dtype=torch.int32, device=x.device)
    m_spos[:n] = torch.where(
        b_sorted < k, torch.arange(n, dtype=torch.int32, device=x.device),
        -1)
    q_assign = torch.full((m_total,), k, dtype=torch.int32, device=x.device)
    q_assign[:n] = b_sorted
    return xm, m_spos, q_assign


def _pick_tile_m(n: int, k: int) -> int:
    """Member-tile rows: a power of two near half the mean cluster size,
    clamped to [128, 1024], so most tiles hold one cluster."""
    avg = max(1, n // max(1, k))
    tile_m = 128
    while tile_m * 2 <= min(1024, avg // 2):
        tile_m *= 2
    return tile_m


class SearchPlan(typing.NamedTuple):
    """The packed layout, its shape parameters and the pruning tables."""

    tile_m: int
    q_chunk: int
    n_tiles: int
    m_total: int
    group: int
    xm: torch.Tensor           # (m_total, F) packed cluster-sorted members
    m_spos: torch.Tensor       # (m_total,) int32 sorted position, -1 invalid
    q_assign: torch.Tensor     # (m_total,) int32 cluster id, k = invalid
    r_ext: torch.Tensor        # (k,) fp32 cluster radii (rank space)
    c_rank: torch.Tensor       # (k, F) fp32 rank-space centroids
    inc_c: torch.Tensor        # (n_tiles + k,) int64 incidence cluster
    inc_t: torch.Tensor        # (n_tiles + k,) int64 incidence tile
    tile_nvalid: torch.Tensor  # (n_tiles,) int32 members per tile
    sorder: torch.Tensor       # (n,) int64 sorted order -> original row


def plan_pruned(p, centroids, assignments) -> SearchPlan:
    """Lay out the packed search structures: relabel, sort, pack, radii,
    on the leader from the problem's gathered rows (``assignments`` a
    whole (n,) tensor).

    The layout holds the sorted rows plus at least one whole filler tile
    (the grouped walk's tail re-visits tile n_tiles - 1, which must hold
    no members), rounded to whole query chunks and tiles."""
    tile_m = _pick_tile_m(p.n, p.k)
    q_chunk = min(config.KNN_TILE_Q, tile_m)
    row_quant = int(np.lcm(q_chunk, tile_m))
    m_total = int(-(-(p.n + tile_m) // row_quant) * row_quant)
    n_tiles = m_total // tile_m
    group = max(1, min(config.KNN_TILE_GROUP_ROWS // tile_m,
                       max(1, n_tiles // 16)))
    x, valid = p.topo.gather(p.xs), p.topo.gather(p.valids)
    cents = centroids.float().to(p.device)
    assignments = assignments.to(p.device)
    if p.k <= config.KNN_TOUR_MAX_K:
        a, cd = _sanitize_and_cd(valid, assignments, cents,
                                 n_clusters=p.k, metric=p.metric)
        b, sorder, perm = _tour_relabel(a, cd)
    else:
        a = _sanitize_assign(valid, assignments, n_clusters=p.k)
        b, sorder, perm = _proj_relabel(a, cents)
    b_sorted = b[sorder]
    inc_c, inc_t, tile_nvalid = KP.packed_layout(
        b_sorted, k=p.k, tile_m=tile_m, n_tiles=n_tiles)
    xm, m_spos, q_assign = _pack_members(x, sorder, b_sorted, k=p.k,
                                         m_total=m_total)
    c_rank = cents[perm]
    radii = _radii(xm, q_assign, c_rank, k=p.k, metric=p.metric)
    return SearchPlan(tile_m, q_chunk, n_tiles, m_total, group, xm, m_spos,
                      q_assign, radii, c_rank, inc_c, inc_t, tile_nvalid,
                      sorder)


def plan_on(plan: SearchPlan, device) -> SearchPlan:
    """The plan with its tables on ``device`` (a peer copy, or the plan
    itself on its own device)."""
    return SearchPlan(*(f.to(device) if isinstance(f, torch.Tensor) else f
                        for f in plan))


def orig_positions(plan: SearchPlan) -> torch.Tensor:
    """(m_total,) int32 packed position -> original sample id, -1 for
    invalid rows and filler."""
    return torch.where(
        plan.m_spos >= 0,
        plan.sorder[torch.clamp(plan.m_spos, min=0).long()], -1
    ).to(torch.int32)


def _batch_kw(plan: SearchPlan, n_batch_chunks: int, k_neighbors: int,
              n_clusters: int, metric) -> dict:
    return dict(k_neighbors=k_neighbors, n_clusters=n_clusters,
                metric=metric, chunk=plan.q_chunk, tile_m=plan.tile_m,
                group=plan.group, n_batch_chunks=n_batch_chunks)


def search_batch(plan: SearchPlan, chunk_base: int, n_batch_chunks: int, *,
                 k_neighbors: int, n_clusters: int, metric, xm_sq=None,
                 orig_pos=None):
    """``knn_prune.search`` over chunks [chunk_base, chunk_base +
    n_batch_chunks) of the plan's layout, whose packed rows are both the
    queries and the members."""
    sq = D.row_sq_norms(plan.xm) if xm_sq is None else xm_sq
    if orig_pos is None:
        orig_pos = orig_positions(plan)
    return KP.search(plan.xm, sq, plan.q_assign, plan.xm, sq, plan.m_spos,
                     orig_pos, plan.c_rank, plan.r_ext, plan.inc_c,
                     plan.inc_t, plan.tile_nvalid, chunk_base,
                     **_batch_kw(plan, n_batch_chunks, k_neighbors,
                                 n_clusters, metric))


def batch_walk_inputs(plan: SearchPlan, chunk_base: int,
                      n_batch_chunks: int, *, k_neighbors: int,
                      n_clusters: int, metric):
    """The walk's (args, kwargs) for the same batch as
    :func:`search_batch` (``knn_prune.walk_inputs``)."""
    sq = D.row_sq_norms(plan.xm)
    return KP.walk_inputs(plan.xm, sq, plan.q_assign, plan.xm, sq,
                          plan.m_spos, plan.c_rank, plan.r_ext, plan.inc_c,
                          plan.inc_t, plan.tile_nvalid, chunk_base,
                          **_batch_kw(plan, n_batch_chunks, k_neighbors,
                                      n_clusters, metric))


def run(problem, centroids, assignments, k_neighbors: int):
    """k-NN of every sample, pruned by the k-means structure.  Returns
    (neighbors (n, k) int32, -1 for invalid rows; distances (n, k) fp32),
    on the leader.
    """
    p = problem
    valid = p.topo.gather(p.valids)
    if centroids is None or p.k < 2 or p.n < 2 * config.LANE:
        x = p.topo.gather(p.xs)
        nbr, dist = _search(x, p.topo.gather(p.x_sqs), x, valid,
                            k=k_neighbors, metric=p.metric,
                            tile_m=config.KNN_TILE_M)
        P.count("knn.examined", p.n * p.n)
        P.count("knn.queries", p.n)
        p.logger.info("calculated 1.000000 of all the distances")
        return nbr, dist

    with P.span("kmt.knn.plan"):
        plan = plan_pruned(p, centroids, assignments)
        nchunks = plan.m_total // plan.q_chunk
        k_batch = min(nchunks,
                      max(1, config.KNN_QUERY_BATCH // plan.q_chunk))
        # each shard searches a contiguous range of query chunks on its
        # device, over its replica of the plan
        ranges = p.topo.split(nchunks)
        replicas = {}
        for dev in p.topo.devices[:len(ranges)]:
            if dev not in replicas:
                rp = plan_on(plan, dev)
                replicas[dev] = (rp, D.row_sq_norms(rp.xm),
                                 orig_positions(rp))
    n_batches = sum(-(-(c1 - c0) // k_batch) for c0, c1 in ranges)
    parts_n, parts_d, ex_parts = [], [], []
    for (c0, c1), dev in zip(ranges, p.topo.devices):
        rp, sq, orig_pos = replicas[dev]
        for base in range(c0, c1, k_batch):
            with P.span("kmt.knn.batch"):
                nbp, dsb, ex = search_batch(
                    rp, base, min(k_batch, c1 - base),
                    k_neighbors=k_neighbors, n_clusters=p.k,
                    metric=p.metric, xm_sq=sq, orig_pos=orig_pos)
                parts_n.append(nbp)
                parts_d.append(dsb)
                ex_parts.append(ex.sum())
                if p.logger.verbosity > 1 and n_batches > 1:
                    p.logger.debug(
                        "knn: batch %d/%d (%d distances examined)"
                        % (len(ex_parts), n_batches, int(ex_parts[-1])))
    with P.span("kmt.knn.finalize"):
        # examined counts add as int64: exact in any order
        examined = int(torch.stack([e.to(p.device) for e in ex_parts]).sum())
        P.count("knn.examined", examined)
        P.count("knn.queries", p.n)
        p.logger.debug("knn: search total (%d batches)" % n_batches)
        frac = examined / float(p.n) ** 2
        # the reference's progress line
        p.logger.info("calculated %f of all the distances" % min(frac, 1.0))
        return _finalize(p.topo.gather(parts_n), p.topo.gather(parts_d),
                         plan.sorder, valid)


def _finalize(nbr, dist, sorder, valid):
    """Packed-order results -> original-order (n, k) outputs; invalid rows
    come out as (-1, +inf)."""
    n = sorder.shape[0]
    packed_of_orig = torch.empty_like(sorder)
    packed_of_orig[sorder] = torch.arange(n, device=sorder.device)
    out_n = torch.where(valid[:, None], nbr[packed_of_orig], -1)
    out_d = torch.where(valid[:, None], dist[packed_of_orig], INF)
    return out_n, out_d
