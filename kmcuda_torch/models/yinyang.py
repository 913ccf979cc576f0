"""Yinyang k-means driver, the port of ``kmcuda_tpu.models.yinyang``.

1. Lloyd draft (``ops.assign.lloyd_run``) until at most
   ``YINYANG_DRAFT_REASSIGNMENTS`` of the samples move in an iteration.
2. The centroids are clustered into G groups by k-means (k-means++, then
   Lloyd at ``YINYANG_GROUP_TOLERANCE``, through the same kernels), then
   capacity-balanced into a padded (G, cap) layout.  The grouping only
   affects speed, never results.
3. The Yinyang loop (``ops.yinyang.yy_run``), continuing the draft's
   accumulation stream.

One :class:`models.lloyd.Driver` spans draft and loop, so a Yinyang run
stops at the iteration a Lloyd run of the same trajectory stops at, with
the same assignments, centroids and iteration lines.

Not ported: the JAX package's wall-clock controller (probe segments,
sparse-branch revocation, the ``YY_MIN_REMAINING`` budget gates), its
adaptive refresh and tighten backoff, and bf16 lower-bound storage.  They
change wall time and memory, never results; without the budget gate a
short run enters the Yinyang loop where the JAX package hands it to
Lloyd.
"""

import time

import numpy as np
import torch

from kmcuda_torch import config
from kmcuda_torch.models import initialization as I
from kmcuda_torch.models import lloyd as L
from kmcuda_torch.models.problem import prepare
from kmcuda_torch.ops import assign as A
from kmcuda_torch.ops import distance as D
from kmcuda_torch.ops import yinyang as YY
from kmcuda_torch.utils.logging import Logger


def _group_cap(k: int, groups: int) -> int:
    """Per-group centroid capacity: 1.15 k / G rounded up to even, at
    least 2 (the JAX package's choice, so both plan the same layout)."""
    cap = max(2, int(np.ceil(1.15 * k / groups)))
    return int(-(-cap // 2) * 2)


def _group_kmeans(centroids, groups: int, metric, gen):
    """k-means++ and Lloyd over the (k, F) centroids as samples (dead
    rows invalid), on their device.  Returns (group_of (k,) int64 — the
    invalid marker ``groups`` for a dead centroid, prefs (k, <= 8) int64 —
    the nearest groups in ascending distance), both numpy."""
    sub = prepare(centroids, groups, metric, centroids.device, Logger(0))
    c0 = I._init_plus_plus(sub, gen)
    g_cent, g_assign, _best, _it, _ch = L.run(
        sub, c0, sub.assign0, config.YINYANG_GROUP_TOLERANCE)
    dists = D.pairwise_distance(sub.x, g_cent, metric)
    dists = torch.where(torch.isfinite(dists), dists, float("inf"))
    prefs = torch.topk(-dists, min(8, groups), dim=1).indices
    return (g_assign.cpu().numpy().astype(np.int64),
            prefs.cpu().numpy().astype(np.int64))


def balance_groups(group_of, prefs, groups: int, cap: int):
    """Capacity balancing of a grouping, as the JAX ``_group_centroids``:
    each group keeps its first ``cap`` members in ascending centroid id;
    the overflow, in ascending id, moves to its nearest group with room
    (``prefs``), else to the emptiest group.

    Returns (group_of (k,) int32, flat_slot (k+1,) int32 — the panel slot
    g * cap + j of each centroid, slots ascending by id within a group,
    pad_src (G, cap) int32 — the centroid of each slot, 0 for a pad,
    pad_pen (G, cap) fp32 — 0 for a real slot, PAD_PENALTY for a pad)."""
    group_of = np.array(group_of, dtype=np.int64)
    k = group_of.shape[0]

    def ranked(gof):
        vidx = np.flatnonzero(gof < groups)      # ascending; dead out
        order = np.argsort(gof[vidx], kind="stable")
        sg = gof[vidx][order]
        rank = np.arange(len(sg)) - np.searchsorted(sg, np.arange(groups))[sg]
        return vidx[order], sg, rank

    cids, sg, rank = ranked(group_of)
    sizes = np.minimum(np.bincount(sg, minlength=groups), cap)
    for c in np.sort(cids[rank >= cap]):
        for g in prefs[c]:
            if sizes[g] < cap:
                break
        else:
            g = int(np.argmin(sizes))
        sizes[g] += 1
        group_of[c] = g

    cids, sg, rank = ranked(group_of)
    pad_src = np.zeros((groups, cap), dtype=np.int32)
    pad_pen = np.full((groups, cap), config.PAD_PENALTY, dtype=np.float32)
    flat_slot = np.zeros((k + 1,), dtype=np.int32)
    pad_src[sg, rank] = cids
    pad_pen[sg, rank] = 0.0
    flat_slot[cids] = sg * cap + rank
    return group_of.astype(np.int32), flat_slot, pad_src, pad_pen


def _group_centroids(centroids, groups: int, metric, gen) -> YY.GroupLayout:
    """Group k-means, then capacity balancing, as a layout on the
    centroids' device."""
    group_of, prefs = _group_kmeans(centroids, groups, metric, gen)
    cap = _group_cap(centroids.shape[0], groups)
    group_of, flat_slot, pad_src, pad_pen = balance_groups(
        group_of, prefs, groups, cap)
    dev = centroids.device
    return YY.GroupLayout(
        group_of=torch.from_numpy(group_of).long().to(dev),
        flat_slot=torch.from_numpy(flat_slot).long().to(dev),
        pad_src=torch.from_numpy(pad_src).long().to(dev),
        pad_pen=torch.from_numpy(pad_pen).to(dev), cap=cap)


def run(problem, centroids, assignments, tolerance, groups: int,
        max_iterations=None, seed: int = 0):
    """Full Yinyang: draft Lloyd -> centroid grouping -> Yinyang loop.

    Returns (centroids, assignments, best_scores_or_None, iterations);
    the centroids are the ones the assignments were computed against."""
    p = problem
    if groups * _group_cap(p.k, groups) >= 2 ** 24:
        # the JAX package's limit (its slot lookup is an fp32 matvec); both
        # packages run Lloyd past it
        p.logger.warning(
            "yinyang: flat slot ids (%d) exceed the fp32 exact-integer "
            "range at %d clusters; running Lloyd instead"
            % (groups * _group_cap(p.k, groups), p.k))
        c, a, best, iters, _ = L.run(p, centroids, assignments, tolerance,
                                     max_iterations=max_iterations)
        return c, a, best, iters
    p.logger.debug(
        "yinyang: %d groups; draft Lloyd until < %.0f%% reassignments"
        % (groups, config.YINYANG_DRAFT_REASSIGNMENTS * 100))
    t0 = time.perf_counter()
    drv = L.Driver(p.logger, int(config.YINYANG_DRAFT_REASSIGNMENTS * p.n),
                   max_iterations)
    step = L.drive(drv, A.lloyd_run(p.x, p.valid, assignments, centroids,
                                    n_clusters=p.k, metric=p.metric))
    drv.tol = int(tolerance * p.n)
    if not drv.keep_going():
        drv.finish()
        return step.c_used, step.assign, step.best, drv.done
    t1 = time.perf_counter()
    p.logger.debug("yinyang: draft phase %.3f s (%d iterations)"
                   % (t1 - t0, drv.done))

    # the grouping's k-means++ draws from its own stream of the seed (the
    # JAX package folds 0x77 into the key)
    layout = _group_centroids(step.c_used, groups, p.metric,
                              I.generator((int(seed) << 8) | 0x77))
    p.logger.debug("yinyang: group capacity %d (padding %.0f%%)"
                   % (layout.cap, 100.0 * (groups * layout.cap - p.k) / p.k))
    t2 = time.perf_counter()
    p.logger.debug("yinyang: grouping phase %.3f s" % (t2 - t1))

    loop = YY.yy_run(p.x, p.x_sq, p.valid, step.assign, step.c_used,
                     step.sums, step.counts, step.changed, layout,
                     n_clusters=p.k, metric=p.metric)
    for ys in loop:
        more = drv.absorb(ys.changed)
        p.logger.debug("yinyang: %d candidates, %d samples passed the "
                       "global filter" % (ys.candidates, ys.passed))
        if not more:
            break
    loop.close()
    drv.finish()
    p.logger.debug("yinyang: main loop %.3f s (%d iterations total)"
                   % (time.perf_counter() - t2, drv.done))
    return ys.c_used, ys.assign, None, drv.done
