"""The Yinyang k-means loop, the port of ``kmcuda_tpu.ops.yinyang``.

State per sample: an upper bound ``u`` on the distance to its assigned
centroid and per-group lower bounds ``l[g]`` on the distance to every
*other* centroid of group g.  Both are stored in drift-absolute
coordinates, as in the JAX package: ``acc[g]`` accumulates group g's max
centroid drift (rounded up), the current lower bound is ``l - acc[g]`` and
the current upper bound ``u + acc[ga]``, with ``ga`` the group of the
assigned centroid; every conversion carries a 2.4e-7 relative margin
toward soundness.  A sample whose current ``u`` is below all of its
current ``l`` provably keeps its assignment (the global filter; ``>=``
keeps a knife-edge tie a candidate).

Every assignment goes through the Lloyd kernels (``ops.assign_kernels``)
against the full centroid panel in natural column order, and the running
(sums, counts) continue the accumulation stream of
``ops.assign.lloyd_run``, so the trajectory is bitwise Lloyd's:

- the arm is ``compact.predict_dense`` of the previous count, as in Lloyd;
- dense arm: B1 over all rows; its fixed-order segment sum replaces the
  sums;
- sparse arm: the candidates' ``u`` is tightened to the exact distance to
  the own centroid, the survivors go through B2 gathered, the rest are
  proven unmoved; the moved rows, in ascending order — the prefix
  Lloyd's stable partition gives — go to ``compact.delta_compacted`` and
  the delta is added.

This rests on B2 assigning a row the same whether it is launched over all
rows or a gathered subset: each row's scores are its own in-order fma
chain and its top-2 merge and rescore are its own lanes'.

Rows the kernel assigned get fresh bounds: ``u`` from the exact
subtract-square distance with an upward margin, ``l`` from one fp32
product against the capacity-balanced (G, cap) group panel with the own
slot excluded and a downward margin.  The JAX package's one-hot table
lookups (a TPU workaround for small-table gathers) are plain gathers here.
"""

from typing import NamedTuple

import torch

from kmcuda_torch import config
from kmcuda_torch.ops import assign_kernels as K
from kmcuda_torch.ops import compact as C
from kmcuda_torch.ops import distance as D

#: the group-minima product runs over row chunks of at most this many
#: (row, panel slot) elements, bounding its fp32 scratch to 256 MB
BOUND_CHUNK_ELEMENTS = 1 << 26

#: relative margin of every bound coordinate conversion (as the JAX loop)
BOUND_MARGIN = 2.4e-7


class GroupLayout(NamedTuple):
    """The capacity-balanced centroid groups of ``models.yinyang``."""

    group_of: torch.Tensor   # (k,) int64; `groups` for a dead centroid
    flat_slot: torch.Tensor  # (k+1,) int64 panel slot g * cap + j
    pad_src: torch.Tensor    # (G, cap) int64 centroid of each slot
    pad_pen: torch.Tensor    # (G, cap) fp32: 0 real slot, PAD_PENALTY pad
    cap: int


class YinyangStep(NamedTuple):
    """One iteration: ``c_used`` are the centroids its assignment was
    computed against; ``u``, ``l``, ``ga``, ``acc`` the stored bounds (see
    :func:`current_bounds`)."""

    c_used: torch.Tensor
    assign: torch.Tensor
    changed: int
    candidates: int
    passed: int
    u: torch.Tensor
    l: torch.Tensor
    ga: torch.Tensor
    acc: torch.Tensor


class _Tables(NamedTuple):
    c_ext: torch.Tensor      # (k+1, F) fp32, dead rows and row k zero
    c_row: torch.Tensor      # c_ext rounded to the storage dtype, in fp32
    c_sq_ext: torch.Tensor   # (k+1,) fp32, PAD_PENALTY for dead rows
    panel_t: torch.Tensor    # (F, G*cap) storage dtype group panel
    bias: torch.Tensor       # (G*cap,) fp32


def exact_drift(c_new, c_old, metric):
    """Per-centroid movement distance; 0 for a NaN (dead) centroid, which
    stays empty.  Cosine takes the geodesic 2 asin(chord / 2)."""
    diff = c_new - c_old
    chord = torch.sqrt(torch.sum(diff * diff, dim=1))
    if metric == D.DistanceMetric.L2:
        drift = chord
    else:
        drift = 2.0 * torch.arcsin(torch.clamp(chord * 0.5, 0.0, 1.0))
    return torch.where(torch.isfinite(drift), drift, torch.zeros_like(drift))


def current_bounds(u, l, ga, acc):
    """The stored bounds in current coordinates: (u (n,), l (n, G))."""
    c2 = acc[ga]
    u_now = (u + c2) + BOUND_MARGIN * (u.abs() + c2)
    l_now = (l - acc) - BOUND_MARGIN * (l.abs() + acc)
    return u_now, l_now


def _tables(c_new, layout, dtype, metric) -> _Tables:
    """NaN-free lookup tables of the centroids: dead rows become zeros
    (with a penalty in the L2 bias), so no NaN reaches a bound."""
    f = c_new.shape[1]
    zero = torch.zeros((1, f), dtype=torch.float32, device=c_new.device)
    c_raw = torch.cat([c_new, zero])
    c_ext = torch.where(torch.isfinite(c_raw), c_raw, 0.0)
    c_sq_raw = torch.cat([D.row_sq_norms(c_new), zero[0, :1]])
    c_sq_ext = torch.where(torch.isfinite(c_sq_raw), c_sq_raw,
                           config.PAD_PENALTY)
    src = layout.pad_src.reshape(-1)
    pen = layout.pad_pen.reshape(-1)
    if metric == D.DistanceMetric.L2:
        panel = c_ext[src] * -2.0
        bias = c_sq_ext[src] + pen
    else:
        panel = -c_ext[src]
        bias = pen
    return _Tables(c_ext, c_ext.to(dtype).float(), c_sq_ext,
                   panel.to(dtype).T, bias)


def _u_store(u_exact, c2):
    """An exact upper bound in group-absolute coordinates."""
    return (u_exact - c2) + BOUND_MARGIN * (u_exact + c2)


def _tighten(xb, xsqb, ab, t: _Tables, eps, metric):
    """Exact distance of each row to its own centroid, rounded up by the
    rowwise-dot margin (the row sum rounds unlike the kernel's product)."""
    prod = torch.sum(xb.float() * t.c_row[ab], dim=1)
    if metric == D.DistanceMetric.L2:
        score = t.c_sq_ext[ab] - 2.0 * prod
        score = score + eps * (xsqb + score.abs())
    else:
        score = -prod + eps
    score = torch.where(torch.isfinite(score), score, config.PAD_PENALTY)
    return D.finalize_distance(score, xsqb, metric)


def _refresh(x, x_sq, aid, rows, state, t: _Tables, layout, metric):
    """Fresh exact bounds for ``rows`` (ascending int64 ids) under their
    new assignment ``aid``; writes ``state`` = (u, l, ga, acc) in place."""
    u, l, ga, acc = state
    groups, cap = layout.pad_src.shape
    f = x.shape[1]
    eps = D.rounding_eps(x.dtype)
    u_eps = f * 2.0 ** -22
    step = max(1, BOUND_CHUNK_ELEMENTS // (groups * cap))
    for start in range(0, rows.numel(), step):
        r = rows[start:start + step]
        xb = x[r]
        a = aid[r].long()
        diff = xb.float() - t.c_ext[a]
        # upward margin on the elementwise fp32 sum of f squares
        d2 = torch.sum(diff * diff, dim=1) * (1.0 + u_eps)
        if metric == D.DistanceMetric.L2:
            u_new = torch.sqrt(d2)
        else:
            u_new = 2.0 * torch.arcsin(
                torch.clamp(torch.sqrt(d2) * 0.5, 0.0, 1.0))
        own = layout.flat_slot[a]
        g_new = own // cap
        sp = D.matmul_f32(xb, t.panel_t) + t.bias
        sp = torch.where(torch.isfinite(sp), sp, config.PAD_PENALTY)
        sp.scatter_(1, own[:, None], config.PAD_PENALTY)
        l_sc = sp.view(-1, groups, cap).amin(dim=2)
        l_new = D.finalize_distance(l_sc, x_sq[r][:, None], metric)
        # downward margin: the panel product rounds unlike the kernel's
        l_new = l_new - eps * (1.0 + l_new)
        u[r] = _u_store(u_new, acc[g_new])
        l[r] = l_new + acc
        ga[r] = g_new


def yy_run(x, x_sq, valid, assign, c_used, sums, counts, prev_changed: int,
           layout: GroupLayout, *, n_clusters: int, metric):
    """The Yinyang main loop from a Lloyd draft's last step: its
    assignment, the centroids it was computed against, its running
    (sums, counts) and reassignment count.  Yields a :class:`YinyangStep`
    per iteration until the caller stops iterating.

    The first iteration has no bounds yet: every valid row is a candidate
    and goes through the kernel untightened, which fills every bound."""
    k = n_clusters
    n = x.shape[0]
    groups, cap = layout.pad_src.shape
    dev = x.device
    eps = D.rounding_eps(x.dtype)
    real = layout.pad_pen == 0
    u = torch.zeros((n,), dtype=torch.float32, device=dev)
    l = torch.zeros((n, groups), dtype=torch.float32, device=dev)
    ga = torch.zeros((n,), dtype=torch.int64, device=dev)
    acc = torch.zeros((groups,), dtype=torch.float32, device=dev)
    all_rows = torch.arange(n, device=dev)
    n_valid = int(valid.sum())
    c_cur = c_used.float()
    first = True
    kw = dict(n_clusters=k, metric=metric)
    while True:
        c_new = D.normalize_centroids(sums, counts.float(), metric)
        drift = exact_drift(c_new, c_cur, metric)
        acc = (acc + torch.where(real, drift[layout.pad_src], 0.0).amax(1)
               ) * (1.0 + 2.0 ** -20)
        t = _tables(c_new, layout, x.dtype, metric)
        u_now, l_now = current_bounds(u, l, ga, acc)
        lmin = l_now.amin(dim=1)
        cand = valid if first else valid & (u_now >= lmin)
        n_cand = int(cand.sum())
        dense = C.predict_dense(prev_changed, n)
        if dense:
            aid, _best, sums, counts, changed_t = K.fused_lloyd_pass(
                x, valid, assign, c_new, **kw)
            rows = all_rows
        else:
            rows = torch.nonzero(cand).squeeze(1)
            if not first:
                ab = assign[rows].long()
                u_ex = _tighten(x[rows], x_sq[rows], ab, t, eps, metric)
                u[rows] = _u_store(u_ex, acc[layout.flat_slot[ab] // cap])
                rows = rows[u_ex >= lmin[rows]]
            aid, changed_t = assign, 0
            if rows.numel():
                aid_r, _best, changed_t = K.assign_only_pass(
                    x[rows], valid[rows], assign[rows], c_new, **kw)
                aid = assign.index_copy(0, rows, aid_r)
        changed = int(changed_t)
        if not dense:
            order = rows[aid[rows] != assign[rows]]
            d_sums, d_counts = C.delta_compacted(x, aid, assign, order,
                                                 changed, n_clusters=k)
            sums = sums + d_sums
            counts = counts + d_counts
        _refresh(x, x_sq, aid, rows, (u, l, ga, acc), t, layout, metric)
        passed = n_valid if dense else rows.numel()
        yield YinyangStep(c_new, aid, changed, n_cand, passed, u, l, ga, acc)
        assign, c_cur, prev_changed, first = aid, c_new, changed, False
