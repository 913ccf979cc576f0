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
keeps a knife-edge tie a candidate).  B2 picks its top 2 by scores
against the centroids rounded to the storage dtype and rescores them
exactly, so in bf16 storage ``u`` bounds both the bf16-scored and the
exact distance from above and ``l`` both from below: every fresh bound
carries the bf16 panel's envelope (:func:`panel_envelope`), which the JAX
package's bounds lack.  Cosine bounds in bf16 storage are angles of
x / |x|, which bf16 leaves off the unit sphere.

Every assignment goes through the Lloyd kernels (``ops.assign_kernels``)
against the full centroid panel in natural column order, and the running
(sums, counts) continue the accumulation stream of
``ops.assign.lloyd_run``, so the trajectory is bitwise Lloyd's.  Two
decisions are made apart each iteration:

- the *sum arm* is ``compact.predict_dense`` of the previous count, as in
  Lloyd: B1 over all rows, whose segment sum replaces the sums, or the
  moved rows, in ascending order, into ``assign_kernels.delta_sum``, whose
  delta is added;
- the *bound path*: dense on the first iteration, when the controller has
  revoked the sparse branch (:class:`Schedule`), or when more than
  ``YY_DENSE_FRACTION`` of the rows are candidates.  A dense path is
  exactly Lloyd's iteration: B1, or B2 over all rows ungathered.  A
  sparse path tightens the candidates' ``u`` to the exact distance to the
  own centroid (unless the tighten is backed off) and runs B2 gathered on
  the survivors; the rest are proven unmoved.  Where the sum arm is dense
  as well, B1 assigns every row (its sums replace the running ones) and
  the survivors' ids are read from it.  B2 assigns a row the same whether
  it is launched over all rows or a gathered subset: each row's scores
  are its own in-order fma chain and its top-2 merge and rescore are its
  own lanes'.

The bounds of the rows a path assigned are then kept in one of four
iteration variants, chosen as the JAX package chooses them:

- *dense refresh*: fresh (u, l) for every row, on a backoff period that
  doubles up to ``YY_REFRESH_BACKOFF_MAX`` while each refresh is followed
  by another dense iteration;
- *dense plain*: u refreshed exactly for every row, l kept: one Lloyd pass
  and an elementwise pass;
- *sparse refresh*: fresh (u, l) for the passed rows, when the extra
  candidates that stale bounds admitted reach ``YY_SPARSE_REFRESH_SURCHARGE``
  times the previous passed count;
- *sparse keep*: u refreshed exactly for the passed rows, l kept.

An iteration that kept l gives every moved row fresh (u, l) (the moved-row
patch): its stored l excludes its old centroid, now a competitor.  Fresh u
is the exact subtract-square distance with an upward margin; fresh l one
fp32 product against the capacity-balanced (G, cap) group panel with the
own slot excluded and a downward margin.  The JAX package's one-hot table
lookups (a TPU workaround for small-table gathers) are plain gathers here.

Over row shards (``parallel.devices``) the bounds, the filter, the
tighten, the survivors, the refreshes and the patch are each shard's own,
on its device; the centroids, drift and tables are built on the leader and
broadcast.  The candidate and survivor counts and the (sums, counts,
reassignments) are reduced in shard order, as the JAX loop's psums, and
the schedule decides on the global counts, once per iteration.
"""

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from kmcuda_torch import config
from kmcuda_torch.ops import assign_kernels as K
from kmcuda_torch.ops import compact as C
from kmcuda_torch.ops import distance as D
from kmcuda_torch.parallel.devices import Topology, as_shards, shaped_like
from kmcuda_torch.utils import profiling as P

#: every elementwise bound pass runs over row chunks of at most this many
#: elements of its widest temporary, bounding its fp32 scratch to 256 MB
BOUND_CHUNK_ELEMENTS = 1 << 26

#: relative margin of every bound coordinate conversion (as the JAX loop)
BOUND_MARGIN = 2.4e-7

#: the iteration variants, as ``YinyangStep.variant`` names them
VARIANTS = ("dense plain", "dense refresh", "sparse keep", "sparse refresh")

#: the rounding of a centroid entry to bf16 for B2's panel (round to
#: nearest, 8 significant bits): |c'_i - c_i| <= 2^-8 |c_i|
PANEL_ROUNDING = 2.0 ** -8


class GroupLayout(NamedTuple):
    """The capacity-balanced centroid groups of ``models.yinyang``."""

    group_of: torch.Tensor   # (k,) int64; `groups` for a dead centroid
    flat_slot: torch.Tensor  # (k+1,) int64 panel slot g * cap + j
    pad_src: torch.Tensor    # (G, cap) int64 centroid of each slot
    pad_pen: torch.Tensor    # (G, cap) fp32: 0 real slot, PAD_PENALTY pad
    cap: int

    def to(self, device) -> "GroupLayout":
        return GroupLayout(*(t.to(device) for t in self[:4]), self.cap)


@dataclasses.dataclass
class Schedule:
    """The loop's schedule, carried across its iterations and across the
    controller's windows: never reset at a window boundary.  The driver
    grants or revokes ``sparse_ok`` between windows; the rest is the JAX
    loop's backoff state (``limits[8:16]`` there)."""

    sparse_ok: bool = True
    refresh_in: int = 0      # dense iterations left before a refresh
    period: int = 1          # the dense refresh period
    tskip: int = 0           # sparse iterations left with the tighten off
    tperiod: int = 1         # the tighten's skip period
    cand_mark: int = 0       # candidates right after the last refresh
    acc_extra: int = 0       # extra candidates summed since then
    prev_passed: int = 0     # the previous iteration's passed count
    ref_any: bool = False    # the previous iteration refreshed l


class YinyangStep(NamedTuple):
    """One iteration: ``c_used`` are the centroids its assignment was
    computed against; ``u``, ``l``, ``ga``, ``acc`` the stored bounds (see
    :func:`current_bounds`); ``variant`` one of :data:`VARIANTS`;
    ``patched`` the moved rows the patch gave fresh bounds; ``sums``,
    ``counts`` the running accumulation after it, on the leader (what
    ``ops.assign.lloyd_run`` resumes from)."""

    c_used: torch.Tensor
    assign: torch.Tensor
    changed: int
    candidates: int
    passed: int
    u: torch.Tensor
    l: torch.Tensor
    ga: torch.Tensor
    acc: torch.Tensor
    variant: str
    patched: int
    sums: torch.Tensor
    counts: torch.Tensor


class _Tables(NamedTuple):
    c_ext: torch.Tensor      # (k+1, F) fp32, dead rows and row k zero
    c_row: torch.Tensor      # c_ext rounded to the storage dtype, in fp32
    c_sq_ext: torch.Tensor   # (k+1,) fp32, PAD_PENALTY for dead rows
    panel_t: torch.Tensor    # (F, G*cap) storage dtype group panel
    bias: torch.Tensor       # (G*cap,) fp32
    c_norm: torch.Tensor     # (k+1,) fp32 |c_ext| rows, 0 for dead rows
    g_norm: torch.Tensor     # (G,) fp32 max of c_norm over a group's slots

    def to(self, device) -> "_Tables":
        return _Tables(*(t.to(device) for t in self))


def filter_dense(n_cand: int, n: int) -> bool:
    """More than ``YY_DENSE_FRACTION`` of the ``n`` rows are candidates:
    the filter's own count sends the iteration down the dense path."""
    return bool(np.float32(n_cand)
                > np.float32(config.YY_DENSE_FRACTION) * np.float32(n))


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


def lower_cast(v, dtype):
    """Store lower bounds ``v`` (fp32) in ``dtype``.  bf16 rounds to
    nearest, so shift down by one bf16 ulp first: a stored lower bound
    never exceeds ``v`` (the JAX ``lower_cast``)."""
    if dtype == torch.float32:
        return v
    return (v - v.abs() * 2.0 ** -8).to(dtype)


def _u_now(u, ga, acc):
    """The stored upper bounds in current coordinates, (n,) fp32."""
    c2 = acc[ga]
    return (u + c2) + BOUND_MARGIN * (u.abs() + c2)


def current_bounds(u, l, ga, acc):
    """The stored bounds in current coordinates: (u (n,), l (n, G)), fp32
    whatever l's storage dtype."""
    lf = l.float()
    return (_u_now(u, ga, acc),
            (lf - acc) - BOUND_MARGIN * (lf.abs() + acc))


def _lmin_now(l, acc):
    """min over the groups of the current lower bounds, (n,) fp32: with
    t = l - acc (1 + m), per row min_g t - m (max_g |t| + max_g acc (1 +
    m)), never above the minimum of :func:`current_bounds`' l (|l| <= |t|
    + acc (1 + m)); in row chunks, one write and one read of t each."""
    acc_m = acc * (1.0 + BOUND_MARGIN)
    slack = BOUND_MARGIN * acc_m.max()
    step = max(1, BOUND_CHUNK_ELEMENTS // l.shape[1])
    out = torch.empty((l.shape[0],), dtype=torch.float32, device=l.device)
    for start in range(0, l.shape[0], step):
        # a bf16 l promotes to fp32 in the subtraction itself
        lo, hi = torch.aminmax(l[start:start + step] - acc_m, dim=1)
        out[start:start + step] = (
            lo - BOUND_MARGIN * torch.maximum(lo.abs(), hi.abs()) - slack)
    return out


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
    c_norm = torch.sqrt(D.row_sq_norms(c_ext))
    return _Tables(c_ext, c_ext.to(dtype).float(), c_sq_ext,
                   panel.to(dtype).T, bias, c_norm,
                   c_norm[layout.pad_src].amax(dim=1))


def panel_envelope(dtype, metric, f: int) -> float:
    """The coefficient e of the bf16 storage envelope: every score that
    B2 or a bound pass computes against the bf16 panel is within e |x| |c|
    of the exact score against the fp32 centroid c, in score space.  0 for
    fp32 storage, whose scores the relative ``rounding_eps`` margins cover.

    The panel holds c' = bf16(c), so |x.(c' - c)| <= PANEL_ROUNDING |x| |c|
    (Cauchy-Schwarz).  Each computed product (B2's, and the rowwise or
    matmul sums here) adds at most f 2^-24 (1 + 2^-8) |x| |c| of fp32
    accumulation (x is stored in bf16 already, so its products are exact
    up to that), below f 2^-22 |x| |c| for both sums at once.  The L2
    score |c|^2 - 2 x.c' doubles both; the cosine score is -x.c'.  The
    error is absolute in score space: where d^2 is small against
    |x| |c| (rows far from the origin, near their centroid) it is far
    above a margin relative to the distance, so a filter without it drops
    rows that B2 moves."""
    if dtype == torch.float32:
        return 0.0
    e = PANEL_ROUNDING + f * 2.0 ** -22
    return 2.0 * e if metric == D.DistanceMetric.L2 else e


def _x_norm(x_sq):
    """|x| of the rows, never 0 (a divisor below)."""
    return torch.sqrt(x_sq).clamp(min=torch.finfo(torch.float32).tiny)


def _finalize(score, x_sq, metric, env: float):
    """``D.finalize_distance``; under a bf16 envelope the cosine distance
    is the angle of x / |x| to the centroid (acos(-score / |x|)), a metric
    on the sphere whatever bf16's rounding did to |x|, in which B2's order
    (by -x.c, for one row) is the angle's."""
    if env and metric == D.DistanceMetric.COSINE:
        return torch.arccos(torch.clamp(-score / _x_norm(x_sq), -1.0, 1.0))
    return D.finalize_distance(score, x_sq, metric)


def _u_store(u_exact, c2):
    """An exact upper bound in group-absolute coordinates."""
    return (u_exact - c2) + BOUND_MARGIN * (u_exact + c2)


def _tighten(xb, xsqb, ab, t: _Tables, eps, metric):
    """Distance of each row to its own centroid from the panel score,
    rounded up by the rowwise-dot margin (the row sum rounds unlike the
    kernel's product) and, in bf16 storage, by the envelope: an upper
    bound on both the bf16-scored and the exact distance."""
    prod = torch.sum(xb.float() * t.c_row[ab], dim=1)
    if metric == D.DistanceMetric.L2:
        score = t.c_sq_ext[ab] - 2.0 * prod
        score = score + eps * (xsqb + score.abs())
    else:
        score = -prod + eps
    env = panel_envelope(xb.dtype, metric, xb.shape[1])
    if env:
        score = score + env * _x_norm(xsqb) * t.c_norm[ab]
    score = torch.where(torch.isfinite(score), score, config.PAD_PENALTY)
    return _finalize(score, xsqb, metric, env)


def _exact_u(xb, xsqb, a, t: _Tables, metric):
    """Exact distance of rows ``xb`` to the centroids ``a`` (subtract and
    square, no cancellation), rounded up by f * 2^-22 relative, above the
    fp32 sum's rounding at any feature count.  In bf16 storage it also
    bounds the bf16-scored distance: the squared chord widened by the
    envelope (cosine: the chord of x / |x|, whose square is 2 - 2 cos,
    widened by twice the envelope's cosine)."""
    env = panel_envelope(xb.dtype, metric, xb.shape[1])
    cosine = metric == D.DistanceMetric.COSINE
    if env and cosine:
        xb = xb.float() / _x_norm(xsqb)[:, None]
    chord = torch.linalg.vector_norm(xb - t.c_ext[a], dim=1)
    if env:
        widen = 2.0 * env if cosine else env * _x_norm(xsqb)
        chord = torch.sqrt(chord * chord + widen * t.c_norm[a])
    chord = chord * (1.0 + xb.shape[1] * 2.0 ** -22)
    if not cosine:
        return chord
    return 2.0 * torch.arcsin(torch.clamp(chord * 0.5, 0.0, 1.0))


def _row_chunk(rows, start: int, step: int):
    """Chunk [start, start + step) of ``rows`` (ascending int64 ids), or
    that slice of all the rows when ``rows`` is None."""
    if rows is None:
        return slice(start, start + step)
    return rows[start:start + step]


def _n_rows(x, rows) -> int:
    return x.shape[0] if rows is None else rows.numel()


def _refresh(x, x_sq, aid, rows, state, t: _Tables, layout, metric):
    """Fresh exact (u, l, ga) for ``rows`` (ascending int64 ids, None for
    all) under their new assignment ``aid``; writes ``state`` = (u, l, ga,
    acc) in place.  One span ``kmt.yinyang.refresh``, the rows it
    refreshes counted as ``yinyang.refreshed_rows``."""
    u, l, ga, acc = state
    groups, cap = layout.pad_src.shape
    eps = D.rounding_eps(x.dtype)
    env = panel_envelope(x.dtype, metric, x.shape[1])
    step = max(1, BOUND_CHUNK_ELEMENTS // (groups * cap))
    n_rows = _n_rows(x, rows)
    with P.span("kmt.yinyang.refresh"):
        P.count("yinyang.refreshed_rows", n_rows)
        for start in range(0, n_rows, step):
            with P.span("kmt.yinyang.bounds"):
                r = _row_chunk(rows, start, step)
                xb = x[r]
                xsqb = x_sq[r][:, None]
                a = aid[r].long()
                u_new = _exact_u(xb, xsqb[:, 0], a, t, metric)
                own = layout.flat_slot[a]
                g_new = own // cap
                sp = D.matmul_f32(xb, t.panel_t) + t.bias
                torch.nan_to_num_(sp, nan=config.PAD_PENALTY,
                                  posinf=config.PAD_PENALTY,
                                  neginf=config.PAD_PENALTY)
                sp.scatter_(1, own[:, None], config.PAD_PENALTY)
                l_sc = sp.view(-1, groups, cap).amin(dim=2)
                if env:   # below both the bf16-scored and the exact score
                    l_sc = l_sc - env * _x_norm(xsqb) * t.g_norm
                l_new = _finalize(l_sc, xsqb, metric, env)
                # downward margin: the panel product rounds unlike the
                # kernel's
                l_new = l_new - eps * (1.0 + l_new)
                u[r] = _u_store(u_new, acc[g_new])
                l[r] = lower_cast(l_new + acc, l.dtype)
                ga[r] = g_new


def _refresh_u(x, x_sq, aid, rows, state, t: _Tables, layout, metric):
    """Exact u and the group ga of ``rows`` (None for all) under ``aid``;
    l is kept (a plain pass).  Writes ``state`` in place."""
    u, _l, ga, acc = state
    cap = layout.cap
    step = max(1, BOUND_CHUNK_ELEMENTS // x.shape[1])
    for start in range(0, _n_rows(x, rows), step):
        with P.span("kmt.yinyang.bounds"):
            r = _row_chunk(rows, start, step)
            a = aid[r].long()
            g_new = layout.flat_slot[a] // cap
            u[r] = _u_store(_exact_u(x[r], x_sq[r], a, t, metric), acc[g_new])
            ga[r] = g_new


def yy_run(x, x_sq, valid, assign, c_used, sums, counts, prev_changed: int,
           layout: GroupLayout, *, n_clusters: int, metric, sched=None,
           bounds_dtype=torch.float32):
    """The Yinyang main loop from a Lloyd draft's last step: its
    assignment, the centroids it was computed against, its running
    (sums, counts) and reassignment count.  Yields a :class:`YinyangStep`
    per iteration until the caller stops iterating.  ``sched`` is the
    :class:`Schedule` the caller's controller steers (a fresh one when
    None); ``bounds_dtype`` the storage of l (fp32 or bf16).

    ``x``, ``x_sq``, ``valid`` and ``assign`` are tensors (one shard) or
    lists of per-shard tensors, as ``ops.assign.lloyd_run`` takes them; a
    step's ``assign``, ``u``, ``l`` and ``ga`` take the same form.

    The first iteration has no bounds yet: it refreshes every bound, on
    the dense path (on the sparse one in a triage mode, every valid row a
    candidate)."""
    k = n_clusters
    xs, xsqs = as_shards(x), as_shards(x_sq)
    valids, assigns = as_shards(valid), as_shards(assign)
    topo = Topology.of(xs)
    d = topo.n
    n = sum(t.shape[0] for t in xs)
    groups, cap = layout.pad_src.shape
    dtype = xs[0].dtype
    eps = D.rounding_eps(dtype)
    layout = layout.to(topo.leader)
    lays = [layout.to(dev) for dev in topo.devices]
    real = layout.pad_pen == 0
    s = Schedule() if sched is None else sched
    debug = int(config.YY_DEBUG_MODE)
    backoff_max = int(config.YY_REFRESH_BACKOFF_MAX)
    us = [torch.zeros((t.shape[0],), dtype=torch.float32, device=t.device)
          for t in xs]
    ls = [torch.zeros((t.shape[0], groups), dtype=bounds_dtype,
                      device=t.device) for t in xs]
    gas = [torch.zeros((t.shape[0],), dtype=torch.int64, device=t.device)
           for t in xs]
    acc = torch.zeros((groups,), dtype=torch.float32, device=topo.leader)
    n_valid = sum(topo.read([v.sum() for v in valids]))
    c_cur = c_used.float().to(topo.leader)
    sums, counts = sums.to(topo.leader), counts.to(topo.leader)
    first = True
    kw = dict(n_clusters=k, metric=metric)
    while True:
        with P.span("kmt.yinyang.filter"):
            c_new = D.normalize_centroids(sums, counts.float(), metric)
            drift = exact_drift(c_new, c_cur, metric)
            acc = (acc + torch.where(real, drift[layout.pad_src], 0.0).amax(1)
                   ) * (1.0 + 2.0 ** -20)
            t = _tables(c_new, layout, dtype, metric)
            ts = [t.to(dev) for dev in topo.devices]
            accs = topo.broadcast(acc)
            cs = topo.broadcast(c_new)
            states = list(zip(us, ls, gas, accs))
            lmins = [_lmin_now(l, a) for l, a in zip(ls, accs)]
            # no bounds yet; triage distrusts the filter
            if first or debug == 1:
                cands, n_cand = valids, n_valid
            else:
                cands = [v & (_u_now(u, ga, a) >= lm) for v, u, ga, a, lm in
                         zip(valids, us, gas, accs, lmins)]
                n_cand = sum(topo.read([c.sum() for c in cands]))
            sum_dense = C.predict_dense(prev_changed, n)
            # the triage modes exercise the sparse path in every iteration
            dense = not debug and (first or not s.sparse_ok
                                   or filter_dense(n_cand, n))

            # ---- the schedule (kmcuda_tpu/ops/yinyang.py:669-705) ------
            if s.ref_any:
                period = min(s.period * 2, backoff_max) if dense else 1
            else:
                period = s.period
            refresh = dense and s.refresh_in <= 0 and not s.ref_any
            tighten = s.tskip <= 0
            acc_now = s.acc_extra + max(n_cand - s.cand_mark, 0)
            sparse_refresh = (not dense and not s.ref_any and (
                s.cand_mark == 0
                or np.float32(acc_now)
                >= np.float32(config.YY_SPARSE_REFRESH_SURCHARGE)
                * np.float32(min(s.prev_passed, n_cand))))
            if debug:   # triage tightens and refreshes every bound it touches
                sparse_refresh, tighten = True, True

            # ---- the survivors of a sparse path, per shard --------------
            rowss = [None] * d
            if not dense:
                for i in range(d):
                    rows = torch.nonzero(cands[i]).squeeze(1)
                    if tighten:
                        ab = assigns[i][rows].long()
                        u_ex = _tighten(xs[i][rows], xsqs[i][rows], ab, ts[i],
                                        eps, metric)
                        us[i][rows] = _u_store(
                            u_ex, accs[i][lays[i].flat_slot[ab] // cap])
                        if debug != 2:   # triage mode 2 distrusts the tighten
                            rows = rows[u_ex >= lmins[i][rows]]
                    rowss[i] = rows

        with P.span("kmt.yinyang.assign"):
            # ---- assignment: exactly Lloyd's iteration, or B2 gathered -
            moved = None
            if sum_dense:
                outs = [K.fused_lloyd_pass(xi, vi, ai, ci, **kw)
                        for xi, vi, ai, ci in zip(xs, valids, assigns, cs)]
                aids = [o[0] for o in outs]
                sums = topo.reduce([o[2] for o in outs])
                counts = topo.reduce([o[3] for o in outs])
                per = topo.read([o[4] for o in outs])
            elif dense:
                outs = [K.assign_only_pass(xi, vi, ai, ci, **kw)
                        for xi, vi, ai, ci in zip(xs, valids, assigns, cs)]
                aids = [o[0] for o in outs]
                per = topo.read([o[2] for o in outs])
                moved = [torch.nonzero(aid != a).squeeze(1)
                         for aid, a in zip(aids, assigns)]
            else:
                aids, per, moved = list(assigns), [0] * d, []
                launched = []
                for i, rows in enumerate(rowss):
                    a_r = assigns[i][rows]
                    if rows.numel():
                        aid_r, _best, changed_t = K.assign_only_pass(
                            xs[i][rows], valids[i][rows], a_r, cs[i], **kw)
                        aids[i] = assigns[i].index_copy(0, rows, aid_r)
                        launched.append((i, changed_t))
                        moved.append(rows[aid_r != a_r])
                    else:
                        moved.append(rows)
                for (i, _), ch in zip(launched, topo.read(
                        [c for _, c in launched]) if launched else []):
                    per[i] = ch
            changed = sum(per)
            if moved is not None:
                deltas = [K.delta_sum(xi, mv.to(torch.int32), aid, a,
                                      n_clusters=k)
                          for xi, aid, a, mv in zip(xs, aids, assigns, moved)]
                sums = sums + topo.reduce([dl[0] for dl in deltas])
                counts = counts + topo.reduce([dl[1] for dl in deltas])
            passed = n_valid if dense else sum(r.numel() for r in rowss)

        # ---- bounds: the four variants, then the moved-row patch --------
        refreshed = refresh or sparse_refresh
        for i in range(d):
            if refreshed:
                _refresh(xs[i], xsqs[i], aids[i], rowss[i], states[i], ts[i],
                         lays[i], metric)
            else:
                _refresh_u(xs[i], xsqs[i], aids[i], rowss[i], states[i],
                           ts[i], lays[i], metric)
        patched = 0
        if not refreshed and changed:
            for i in range(d):
                if not per[i]:
                    continue
                mv = (torch.nonzero(aids[i] != assigns[i]).squeeze(1)
                      if moved is None else moved[i])
                _refresh(xs[i], xsqs[i], aids[i], mv, states[i], ts[i],
                         lays[i], metric)
            patched = changed
        variant = VARIANTS[(0 if dense else 2) + int(refreshed)]

        # ---- schedule update (:722-731, :809-825) ----------------------
        s.refresh_in = ((period if refresh else s.refresh_in - 1) if dense
                        else 0)
        if s.ref_any:
            s.cand_mark = n_cand
        s.acc_extra = 0 if s.ref_any or refreshed else acc_now
        if not dense and tighten:
            if np.float32(n_cand - passed) >= (
                    np.float32(config.YY_TIGHTEN_MIN_PRUNE)
                    * np.float32(n_cand)):
                s.tskip, s.tperiod = 0, 1
            else:
                s.tskip, s.tperiod = s.tperiod, min(s.tperiod * 2,
                                                    backoff_max)
        elif not dense:
            s.tskip -= 1
        s.period = period
        s.prev_passed = passed
        s.ref_any = refreshed
        yield YinyangStep(c_new, shaped_like(x, aids), changed, n_cand,
                          passed, shaped_like(x, us), shaped_like(x, ls),
                          shaped_like(x, gas), acc, variant, patched, sums,
                          counts)
        assigns, c_cur, prev_changed, first = aids, c_new, changed, False
