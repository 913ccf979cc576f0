"""The kNN walk kernel entry (B3) and its plain-torch twin.

:func:`walk` replaces ``kmcuda_tpu/ops/knn_pallas.py:walk`` (body
``_kernel``, merge ``_extract_k``).  For every query chunk of a batch it
walks the chunk's tour of member-tile groups most-promising-first, with
the early stop on the running kth distance tau; scores the members in dot
form, turns the scores into true distances with the SLACK margin and the
bf16 envelope, masks self and padding, merges the lexicographic
(distance, id) top-kk, and counts the distances it examined.

On a CUDA tensor the wrapper launches the hand-written kernel of
``csrc/knn_walk.cu`` (built at first use, see ``ops._build``).  On a CPU
tensor — and only there — it runs :func:`walk_reference`, the JAX
package's XLA walk (``kmcuda_tpu/ops/knn_prune.py:search`` pass 2) in
plain torch, which the CPU tests hold against the JAX package and
``chip_smoke.py`` holds the kernel against on the card.  Any other device
raises.
"""

import numpy as np
import torch

from kmcuda_torch.ops import _build
from kmcuda_torch.ops import distance as D
from kmcuda_torch.ops import knn_prune as KP
from kmcuda_torch.utils.errors import KMTPUInvalidArguments

#: kernel launches per entry; the wrapper adds one where it launches
LAUNCHES = {"knn_walk": 0}

#: members per sub-tile of the kernel; tile_m must be a multiple
KERNEL_TILE_N = 64

INF = float("inf")
#: fp32(1 + SLACK), the upward margin on every walk distance
INFLATE = float(np.float32(1.0 + KP.SLACK))
#: the bf16 storage envelope, cosine form: fp32(sqrt(2 * 2^-8))
COS_ENV = float(np.float32(np.sqrt(2.0 * 2.0 ** -8)))


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def smem_buffer_bytes(dtype) -> int:
    """The largest (distance, id) buffer of a chunk, kk * chunk * 8 bytes,
    that the kernel keeps in shared memory for this storage dtype (what
    its ring leaves of 227 KB, from the kernel library); a larger one goes
    to a global scratch."""
    return int(_build.library().kmt_knn_walk_smem_buffer_bytes(
        int(dtype == torch.bfloat16)))


def _check_args(xq, xq_sq, q_pos, q_valid, n_qvalid, n_steps, tile_order,
                sorted_min, tile_nvalid, xm, xm_sq, m_spos, k_neighbors,
                kk, chunk, tile_m, group, eps_env):
    named = (("xq", xq), ("xq_sq", xq_sq), ("q_pos", q_pos),
             ("q_valid", q_valid), ("n_qvalid", n_qvalid),
             ("n_steps", n_steps), ("tile_order", tile_order),
             ("sorted_min", sorted_min), ("tile_nvalid", tile_nvalid),
             ("xm", xm), ("xm_sq", xm_sq), ("m_spos", m_spos))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError("%s must be a torch.Tensor" % name)
        if t.device != xq.device:
            raise KMTPUInvalidArguments(
                "%s is on %s, xq on %s" % (name, t.device, xq.device))
        if not t.is_contiguous():
            raise KMTPUInvalidArguments("%s must be contiguous" % name)
    if xq.device.type not in ("cpu", "cuda"):
        raise KMTPUInvalidArguments("unsupported device %s" % xq.device)
    if xq.dim() != 2 or xq.dtype not in (torch.float32, torch.bfloat16) \
            or xm.dtype != xq.dtype or xm.dim() != 2 \
            or xm.shape[1] != xq.shape[1]:
        raise KMTPUInvalidArguments(
            "xq and xm must be (rows, f) float32 or bfloat16 of one dtype")
    nb, _f = xq.shape
    nm = xm.shape[0]
    if chunk < 1 or nb % chunk or tile_m % KERNEL_TILE_N or tile_m < 1 \
            or nm % tile_m or group < 1:
        raise KMTPUInvalidArguments(
            "need rows %% chunk == 0, tile_m %% %d == 0 and M %% tile_m == 0"
            % KERNEL_TILE_N)
    if not 1 <= k_neighbors <= kk or nm >= 2**31:
        raise KMTPUInvalidArguments("need 1 <= k_neighbors <= kk, M < 2**31")
    if eps_env not in (0.0, 2.0 ** -8):
        raise KMTPUInvalidArguments("eps_env must be 0 or 2**-8")
    nchunks = nb // chunk
    nt = nm // tile_m
    for name, t, shape, dtype in (
            ("xq_sq", xq_sq, (nb,), torch.float32),
            ("q_pos", q_pos, (nb,), torch.int32),
            ("q_valid", q_valid, (nb,), torch.bool),
            ("n_qvalid", n_qvalid, (nchunks,), torch.int32),
            ("n_steps", n_steps, (nchunks,), torch.int32),
            ("tile_order", tile_order, (nchunks, nt + group - 1),
             torch.int32),
            ("sorted_min", sorted_min, (nchunks, nt + group - 1),
             torch.float32),
            ("tile_nvalid", tile_nvalid, (nt,), torch.int32),
            ("xm_sq", xm_sq, (nm,), torch.float32),
            ("m_spos", m_spos, (nm,), torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise KMTPUInvalidArguments(
                "%s must be %s %s, got %s %s" % (
                    name, shape, dtype, tuple(t.shape), t.dtype))


def walk(xq, xq_sq, q_pos, q_valid, n_qvalid, n_steps, tile_order,
         sorted_min, tile_nvalid, xm, xm_sq, m_spos, *, k_neighbors: int,
         kk: int, chunk: int, tile_m: int, group: int, metric,
         eps_env: float = 0.0):
    """B3: the walk over a batch of query chunks.

    xq (nb, f): batch queries (packed layout); xq_sq/q_pos/q_valid (nb,):
    fp32 squared norms, packed positions (int32), validity.
    n_qvalid/n_steps (nchunks,): valid queries and walk-step bound per
    chunk.  tile_order/sorted_min (nchunks, nt + group - 1): the chunk
    tours from ``knn_prune.tours``.  tile_nvalid (nt,): members per tile.
    xm/xm_sq/m_spos (M, f)/(M,)/(M,): the packed members.

    Returns (bi (nb, kk) int32 candidate packed positions, ascending by
    walk distance and id, -1 for an empty slot; examined (nchunks,) int64;
    steps (nchunks,) int32 walk steps taken)."""
    _check_args(xq, xq_sq, q_pos, q_valid, n_qvalid, n_steps, tile_order,
                sorted_min, tile_nvalid, xm, xm_sq, m_spos, k_neighbors, kk,
                chunk, tile_m, group, eps_env)
    kw = dict(k_neighbors=k_neighbors, kk=kk, chunk=chunk, tile_m=tile_m,
              group=group, metric=metric, eps_env=eps_env)
    if xq.device.type == "cpu":
        return walk_reference(xq, xq_sq, q_pos, q_valid, n_qvalid, n_steps,
                              tile_order, sorted_min, tile_nvalid, xm, xm_sq,
                              m_spos, **kw)
    nb, f = xq.shape
    nchunks = nb // chunk
    dev = xq.device
    in_smem = kk * chunk * 8 <= smem_buffer_bytes(xq.dtype)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        bi = torch.empty((nb, kk), dtype=torch.int32, device=dev)
        examined = torch.empty((nchunks,), dtype=torch.int64, device=dev)
        steps = torch.empty((nchunks,), dtype=torch.int32, device=dev)
        n_scratch = 1 if in_smem else nchunks * kk * chunk
        scratch_d = torch.empty((n_scratch,), dtype=torch.float32,
                                device=dev)
        scratch_i = torch.empty((n_scratch,), dtype=torch.int32, device=dev)
        code = lib.kmt_knn_walk(
            xq.data_ptr(), xq_sq.data_ptr(), q_pos.data_ptr(),
            q_valid.data_ptr(), n_qvalid.data_ptr(), n_steps.data_ptr(),
            tile_order.data_ptr(), sorted_min.data_ptr(),
            tile_nvalid.data_ptr(), xm.data_ptr(), xm_sq.data_ptr(),
            m_spos.data_ptr(), bi.data_ptr(), examined.data_ptr(),
            steps.data_ptr(), scratch_d.data_ptr(), scratch_i.data_ptr(),
            nchunks, f, chunk, tile_order.shape[1], kk, k_neighbors, tile_m,
            group, int(xq.dtype == torch.bfloat16),
            int(metric == D.DistanceMetric.COSINE), int(eps_env > 0.0),
            int(in_smem), stream)
        _build.check(lib, code, "kmt_knn_walk")
    LAUNCHES["knn_walk"] += 1
    return bi, examined, steps


#: a walk's fp32 dot products may differ from the exact ones by this much
#: relative to sum_j |q_j m_j| (8 fp32 ulps of a sum in [1, 2): the
#: kernel's fresh-accumulator stages, 3xTF32 or bf16, summed rounded to
#: nearest, and cuBLAS's fp32 product alike; the bound
#: tests/test_torch_tf32.py holds the 3xTF32 products to)
DOT_ROUNDING = 2.0 ** -20


def walk_tie(q, self_pos, ids, xm, m_spos):
    """True when a full kk-wide candidate buffer of one cosine query row
    (packed ids, -1 empty) is the top kk of the exact cosine walk up to
    the products' rounding at its edge.  The exact walk ranks every real
    member but the query itself (``m_spos`` >= 0, packed position !=
    ``self_pos``) by its fp64 dot with the query, from the stored values
    (the walk's distance, acos of the dot with the SLACK margin and the
    bf16 envelope, falls as the dot rises).  With every dot free to move
    by ``DOT_ROUNDING * sum_j |q_j m_j|``, each buffered member must reach
    the kk-th largest dot, and each member that stays above it must be
    buffered.  This holds the buffer against an exact search of all the
    members, not against the plain twin."""
    kk = ids.numel()
    real = m_spos >= 0
    real[self_pos] = False
    if bool((ids < 0).any()) or torch.unique(ids).numel() < kk \
            or not bool(real[ids.long()].all()) or int(real.sum()) < kk:
        return False
    m = xm[real].double()
    qd = q.double()
    dot = m @ qd
    delta = DOT_ROUNDING * (m.abs() @ qd.abs())
    hi, lo = dot + delta, dot - delta
    edge_hi = torch.topk(hi, kk).values[-1]
    edge_lo = torch.topk(lo, kk).values[-1]
    held = torch.zeros_like(real)
    held[ids.long()] = True
    held = held[real]
    return bool((hi[held] >= edge_lo).all()
                and (held | (lo <= edge_hi)).all())


def exact_hits(q, self_pos, neighbours, xm, m_spos):
    """Tie-aware hits of each row of ``neighbours`` ((sides, k) packed ids,
    -1 empty) for query ``q`` against the exact k nearest members by fp64
    distance of the stored rows (the rescore's measure: L2, or for cosine
    the chord, whose angle the rescore takes) over every real member but
    the query itself (``m_spos`` >= 0, packed position != ``self_pos``):
    slot i of a side's sorted distances counts when it is within rtol 1e-6
    of the exact i-th.  Returns one count per side."""
    kn = neighbours.shape[1]
    d = torch.linalg.norm(xm.double() - q.double(), dim=1)
    d[(m_spos < 0) | torch.isnan(d)] = INF
    d[self_pos] = INF
    true_prof = torch.topk(d, kn, largest=False).values
    got = torch.where(neighbours >= 0, d[neighbours.clamp(min=0).long()],
                      torch.full_like(true_prof, INF))
    got_prof = torch.sort(got, dim=1).values
    return (got_prof <= true_prof * (1.0 + 1e-6)).sum(dim=1).tolist()


def compare_walks(args, kw) -> dict:
    """:func:`walk` against :func:`walk_reference` on the same (args,
    kwargs) — ``knn_prune.walk_inputs`` of one batch — after the shared
    exact rescore (in packed id space).  Raises AssertionError unless:

    - every chunk's examined count is equal, or the step where the two
      walks part has its bound within 1e-5 relative of the twin's tau
      (each such chunk is printed with its gap);
    - final neighbour ids are equal, except in rows whose fp64 distance
      profiles (the ids' true distances, sorted) agree to rtol 1e-6 (ties),
      and, for bf16 cosine alone, in rows where each side's candidate
      buffer is the exact walk's top kk up to the products' rounding
      (:func:`walk_tie`, against an fp64 search of all the members; each
      such row is printed with both sides' hits among the exact fp64
      neighbours, :func:`exact_hits`).  bf16 cosine ranks by the angle of
      the dot in the walk and by the chord of the stored rows in the
      rescore, which are not of unit norm, so the two orders disagree by
      more than kk - k places (ROADMAP §C6): one ulp of a dot at the
      buffer's edge decides which of two right buffers a side keeps, and
      so a neighbour;
    - distances agree to rtol 1e-6 where the ids are equal.

    Returns {"max_abs_err", "tie_rows", "edge_rows", "edge_hits" (kernel,
    twin), "chunks_differ", "examined"}."""
    xq, q_pos, xm, m_spos = args[0], args[2], args[9], args[11]
    sorted_min = args[7]
    metric, kn, group = kw["metric"], kw["k_neighbors"], kw["group"]
    edge_ok = (xq.dtype == torch.bfloat16
               and metric == D.DistanceMetric.COSINE)
    bi_k, ex_k, st_k = walk(*args, **kw)
    trace = []
    bi_r, ex_r, st_r = walk_reference(*args, **kw, tau_trace=trace)
    ex_k, ex_r = ex_k.cpu(), ex_r.cpu()
    st_k, st_r = st_k.cpu(), st_r.cpu()
    for c in torch.nonzero(ex_k != ex_r)[:, 0].tolist():
        s = int(min(st_k[c], st_r[c]))
        b = float(sorted_min[c, s * group])
        tau = trace[c][s]
        gap = abs(b - tau) / max(abs(tau), 1e-30)
        print("chunk %d: examined %d (kernel, %d steps) vs %d (plain, %d "
              "steps); bound %.9g vs tau %.9g at step %d, gap %.3g relative"
              % (c, int(ex_k[c]), int(st_k[c]), int(ex_r[c]), int(st_r[c]),
                 b, tau, s, gap), flush=True)
        if not gap <= 1e-5:
            raise AssertionError("chunk %d: examined counts differ off a "
                                 "bound-vs-tau tie" % c)
    n_k, d_k = KP.rescore(xq, bi_k, xm, metric, kn)
    n_r, d_r = KP.rescore(xq, bi_r, xm, metric, kn)
    rows = torch.nonzero((n_k != n_r).any(dim=1))[:, 0]
    hits = [0, 0]
    edge_rows = 0
    for r in rows.tolist():
        q = xq[r].double()
        prof = [torch.sort(torch.linalg.norm(
            xm[ids.long()].double() - q, dim=1)).values
            for ids in (n_k[r], n_r[r])]
        if torch.allclose(prof[0], prof[1], rtol=1e-6, atol=0):
            continue
        if not edge_ok:
            raise AssertionError("row %d: neighbours differ off fp64 ties"
                                 % r)
        for side, ids in (("kernel", bi_k[r]), ("plain twin", bi_r[r])):
            if not walk_tie(xq[r], int(q_pos[r]), ids, xm, m_spos):
                raise AssertionError(
                    "row %d: neighbours differ off fp64 ties, and the %s's "
                    "candidate buffer is not the exact walk's top kk up to "
                    "the products' rounding" % (r, side))
        edge_rows += 1
        h = exact_hits(xq[r], int(q_pos[r]),
                       torch.stack([n_k[r], n_r[r]]), xm, m_spos)
        hits = [hits[0] + h[0], hits[1] + h[1]]
        print("row %d: both candidate buffers are the exact walk's top kk "
              "up to a tie within the products' rounding at their edge; "
              "fp64 neighbour profiles end %s (kernel) vs %s (plain); %d "
              "vs %d of %d exact fp64 neighbours"
              % (r, ["%.7g" % v for v in prof[0][-2:].tolist()],
                 ["%.7g" % v for v in prof[1][-2:].tolist()], h[0], h[1],
                 kn), flush=True)
    same = (n_k == n_r) & torch.isfinite(d_r)
    torch.testing.assert_close(d_k[same], d_r[same], rtol=1e-6, atol=0)
    err = float((d_k[same] - d_r[same]).abs().max()) if bool(same.any()) \
        else 0.0
    return {"max_abs_err": err, "tie_rows": int(rows.numel()),
            "edge_rows": edge_rows, "edge_hits": tuple(hits),
            "chunks_differ": int((ex_k != ex_r).sum()),
            "examined": int(ex_r.sum())}


def walk_reference(xq, xq_sq, q_pos, q_valid, n_qvalid, n_steps, tile_order,
                   sorted_min, tile_nvalid, xm, xm_sq, m_spos, *,
                   k_neighbors: int, kk: int, chunk: int, tile_m: int,
                   group: int, metric, eps_env: float = 0.0,
                   tau_trace=None):
    """Plain twin of :func:`walk`: a Python loop over chunks and steps.

    Step r covers tiles ``tile_order[r*group : r*group + group]`` and runs
    only while ``sorted_min[r*group] <= tau`` and the bound is below
    STOP_BOUND; tau is the max over the chunk of the running buffer's
    column k_neighbors - 1, recomputed after each step.  Valid rows start
    at (+inf, -1), invalid ones at (-inf, -1), so they never raise tau.
    Each step with an improving row merges the lexicographic (distance, id)
    top-kk of buffer and block.  When ``tau_trace`` is a list, it receives
    per chunk the list of tau values each step decision saw."""
    nb = xq.shape[0]
    nchunks = nb // chunk
    dev = xq.device
    order = tile_order.cpu().long()
    bound = sorted_min.cpu()
    steps_max = n_steps.cpu()
    nq = n_qvalid.cpu().long()
    nval = tile_nvalid.cpu().long()
    iota_m = torch.arange(tile_m, device=dev)
    bi_out = torch.empty((nb, kk), dtype=torch.int32, device=dev)
    examined = torch.zeros((nchunks,), dtype=torch.int64)
    steps = torch.zeros((nchunks,), dtype=torch.int32)
    for c in range(nchunks):
        rows = slice(c * chunk, (c + 1) * chunk)
        qb = xq[rows]
        qsq = xq_sq[rows, None]
        qp = q_pos[rows, None]
        best_d = torch.full((chunk, kk), INF, device=dev)
        best_d[~q_valid[rows]] = -INF
        best_i = torch.full((chunk, kk), -1, dtype=torch.int32, device=dev)
        tau = float(best_d[:, k_neighbors - 1].max())
        trace = []
        s = 0
        while s < int(steps_max[c]):
            r = s * group
            b = float(bound[c, r])
            trace.append(tau)
            if not (b <= tau and b < KP.STOP_BOUND):
                break
            js = order[c, r:r + group]
            mpos = (js.to(dev)[:, None] * tile_m + iota_m).reshape(-1)
            msq = xm_sq[mpos][None, :]
            prod = D.matmul_f32(qb, xm[mpos].T)
            if metric == D.DistanceMetric.L2:
                d = torch.sqrt(torch.clamp(msq - 2.0 * prod + qsq, min=0.0))
            else:
                d = torch.arccos(torch.clamp(prod, -1.0, 1.0))
            d = d * INFLATE
            if eps_env > 0.0:
                if metric == D.DistanceMetric.L2:
                    d = d + torch.sqrt(eps_env * (qsq + msq))
                else:
                    d = d + COS_ENV
            d = torch.where((qp == mpos[None, :])
                            | (m_spos[mpos][None, :] < 0), INF, d)
            if bool((d.min(dim=1).values <= best_d[:, kk - 1]).any()):
                ids = mpos.to(torch.int32).expand(chunk, -1)
                best_d, best_i = KP.select_k(torch.cat([best_d, d], dim=1),
                                             torch.cat([best_i, ids], dim=1),
                                             kk)
            tau = float(best_d[:, k_neighbors - 1].max())
            examined[c] += int(nval[js].sum()) * int(nq[c])
            s += 1
        steps[c] = s
        bi_out[rows] = best_i
        if tau_trace is not None:
            tau_trace.append(trace)
    return bi_out, examined.to(dev), steps.to(dev)
