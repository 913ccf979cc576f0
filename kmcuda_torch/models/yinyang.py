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

The JAX package's wall-clock controller (``YY_WALL_CONTROLLER``) decides
what runs, never what comes out: budget gates hand a run with fewer than
``YY_MIN_REMAINING`` iterations (before the draft, or left after it) to
Lloyd, and the loop runs in windows of iterations whose walls decide
whether it may take its sparse branch (:func:`run`).  The port's
controller adds one arm, the Lloyd handover (:func:`_controlled_loop`):
where a fresh bound refresh prunes nothing it continues on the Lloyd loop,
and comes back by the walls it measures.  Above
``YY_BOUNDS_F32_MAX_BYTES`` of fp32 lower bounds they are stored in bf16.

Over row shards the draft and the loop run each shard's passes and reduce
in shard order (``ops.assign``, ``ops.yinyang``); the grouping runs on the
leader over the centroids, and the gates and the controller decide on the
global counts, on the host.
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
from kmcuda_torch.parallel.devices import shaped_like
from kmcuda_torch.utils import profiling as P
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
    with P.span("kmt.yinyang.layout"):
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


@P.spanned("kmt.yinyang.grouping")
def _group_centroids(centroids, groups: int, metric, gen) -> YY.GroupLayout:
    """Group k-means, then capacity balancing, as a layout on the
    centroids' device."""
    group_of, prefs = _group_kmeans(centroids, groups, metric, gen)
    with P.span("kmt.yinyang.layout"):
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
    """Full Yinyang (:func:`_run`); ``assignments`` is a whole (n,) tensor
    or a list of per-shard ones, and the returned assignments and best
    scores take its form."""
    c, a, best, iters = _run(problem, centroids,
                             problem.per_shard(assignments), tolerance,
                             groups, max_iterations, seed)
    return (c, shaped_like(assignments, a),
            None if best is None else shaped_like(assignments, best), iters)


def _run(problem, centroids, assignments, tolerance, groups: int,
         max_iterations, seed: int):
    """Full Yinyang: draft Lloyd -> centroid grouping -> Yinyang loop,
    under the wall-clock controller (``config.YY_WALL_CONTROLLER``).

    The controller times windows of loop iterations on the host clock,
    after the per-iteration sync the loop already pays.  The first
    iteration (a full bound refresh) is a window of its own and is never
    judged; then windows of ``YY_PROBE_ITERS`` grow 4x up to
    ``YY_WINDOW_MAX_ITERS``.  A sparse-heavy window slower per iteration
    than the Lloyd floor (from the draft, or from a forced-dense window
    when the draft measured none) times ``YY_BAILOUT_MARGIN`` revokes the
    sparse branch; it is re-probed after ``YY_REPROBE_ITERS`` dense
    iterations, the interval doubling up to ``YY_REPROBE_ITERS_MAX``.
    Where a fresh refresh prunes nothing the run goes on as Lloyd for a
    while (the handover, :func:`_controlled_loop`).

    Returns (centroids, assignments, best_scores_or_None, iterations);
    the centroids are the ones the assignments were computed against."""
    p = problem
    budget = min(config.DEFAULT_MAX_ITERATIONS if max_iterations is None
                 else int(max_iterations), config.DEFAULT_MAX_ITERATIONS)
    if groups * _group_cap(p.k, groups) >= 2 ** 24:
        # the JAX package's limit (its slot lookup is an fp32 matvec); both
        # packages run Lloyd past it
        p.logger.warning(
            "yinyang: flat slot ids (%d) exceed the fp32 exact-integer "
            "range at %d clusters; running Lloyd instead"
            % (groups * _group_cap(p.k, groups), p.k))
        c, a, best, iters, _ = L.run(p, centroids, assignments, tolerance,
                                     max_iterations=budget)
        return c, a, best, iters
    ctl = bool(config.YY_WALL_CONTROLLER)
    if ctl and budget < config.YY_MIN_REMAINING:
        # the pre-draft budget gate: the draft IS Lloyd, so this is the
        # same trajectory without the draft/loop hand-over
        p.logger.debug(
            "yinyang: budget %d < YY_MIN_REMAINING=%d; running the Lloyd "
            "driver outright (identical results)"
            % (budget, config.YY_MIN_REMAINING))
        c, a, _best, iters, _ = L.run(p, centroids, assignments, tolerance,
                                      max_iterations=budget)
        return c, a, None, iters
    p.logger.debug(
        "yinyang: %d groups; draft Lloyd until < %.0f%% reassignments"
        % (groups, config.YINYANG_DRAFT_REASSIGNMENTS * 100))
    t0 = time.perf_counter()
    with P.span("kmt.yinyang.draft"):
        drv = L.Driver(p.logger,
                       int(config.YINYANG_DRAFT_REASSIGNMENTS * p.n), budget)
        steps = A.lloyd_run(p.xs, p.valids, assignments, centroids,
                            n_clusters=p.k, metric=p.metric)
        walls = []
        step = L.drive(drv, steps, walls)
    # the draft's seconds per iteration after its first (which may build
    # the kernels): the controller's Lloyd floor
    lloyd_spi = (sum(walls[1:]) / (len(walls) - 1) if len(walls) > 1
                 else None)
    drv.tol = int(tolerance * p.n)
    if not drv.keep_going():
        steps.close()
        drv.finish()
        return step.c_used, step.assign, step.best, drv.done
    if ctl and drv.cap - drv.done < config.YY_MIN_REMAINING:
        # the post-draft budget gate: finish on the draft's own Lloyd loop
        p.logger.debug(
            "yinyang: %d iterations left < YY_MIN_REMAINING=%d; "
            "finishing on the Lloyd path (identical results)"
            % (drv.cap - drv.done, config.YY_MIN_REMAINING))
        step = L.drive(drv, steps)
        steps.close()
        drv.finish()
        return step.c_used, step.assign, step.best, drv.done
    # dropped, not only closed: a closed generator keeps its frame's
    # locals while it lives on some CPython 3.12 releases
    steps.close()
    del steps
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
    bounds_dtype = torch.float32
    if p.n * groups * 4 > config.YY_BOUNDS_F32_MAX_BYTES:
        bounds_dtype = torch.bfloat16
        p.logger.debug("yinyang: bf16 lower-bound storage (%d MB)"
                       % (p.n * groups * 2 // 2**20))

    def open_loop(start, sched):
        """A Yinyang loop from ``start``, a Lloyd step (the draft's, or
        the last of a handover): its first iteration is the bound init."""
        return YY.yy_run(p.xs, p.x_sqs, p.valids, start.assign, start.c_used,
                         start.sums, start.counts, start.changed, layout,
                         n_clusters=p.k, metric=p.metric, sched=sched,
                         bounds_dtype=bounds_dtype)

    # no Lloyd floor from the draft (it ran one iteration): the first
    # judged window runs dense and measures it before sparse may run
    floor_probe = ctl and lloyd_spi is None
    # the controller holds the draft's last step alone, so that it goes
    # with the first loop
    start = [step]
    del step
    last = _controlled_loop(p, drv, start, open_loop, ctl, lloyd_spi,
                            floor_probe)
    drv.finish()
    p.logger.debug("yinyang: main loop %.3f s (%d iterations total)"
                   % (time.perf_counter() - t2, drv.done))
    return last.c_used, last.assign, None, drv.done


@P.spanned("kmt.yinyang.loop")
def _controlled_loop(p, drv, start: list, open_loop, ctl: bool, lloyd_spi,
                     floor_probe: bool):
    """Feed Yinyang loops (``open_loop(step, sched)``, from a Lloyd step:
    first the draft's last, popped from ``start``) to ``drv`` (a
    ``lloyd.Driver``), in the controller's windows, until it stops;
    returns the last step, a ``YinyangStep`` or, on the Lloyd path, a
    ``LloydStep``.  Each loop iteration, the loop's step and
    ``drv.absorb``, is one span ``kmt.yinyang.iteration`` with its
    counters.

    The Lloyd handover (``YY_LLOYD_HANDOVER``, an arm of the controller,
    off in the triage modes): an iteration right after a full dense
    refresh (the bound init included) whose filter still leaves more than
    ``YY_DENSE_FRACTION`` of the rows candidates, with the bounds at
    their tightest, shows they prune nothing.  The loop is closed (its
    bounds freed) and ``ops.assign.lloyd_run`` continues its accumulation
    stream, each iteration one span ``kmt.yinyang.lloyd`` counted
    ``yinyang.handed_over`` 1 and ``yinyang.passed`` the valid rows, until
    the Lloyd walls reach 2^j times the refresh iteration's wall less the
    Lloyd floor (j: the handovers before this one); then a new loop
    starts from the Lloyd step on the same grouping, its windows afresh.
    Counts decide the handover and walls the return; neither decides what
    comes out.  A closed loop and its steps are dropped before the next
    one allocates, so a re-entry does not raise the memory peak."""
    P.count("yinyang.rows", p.n_valid)
    # the arm's mark: a record without it is of a program without it
    P.count("yinyang.handed_over", 0)
    hand = ctl and config.YY_LLOYD_HANDOVER and not config.YY_DEBUG_MODE
    reprobe_after = config.YY_REPROBE_ITERS
    since_revoke = handovers = 0
    sched = YY.Schedule(sparse_ok=not floor_probe)
    step = start.pop()
    while True:
        loop = open_loop(step, sched)
        del step   # its best scores: the loop keeps what it needs
        window = 1 if ctl else None
        judged = handover = False
        refresh_wall = None   # the previous iteration's, a dense refresh's
        more = True
        while more and not handover:
            t_w = time.perf_counter()
            its = sparse = 0
            while more and its != window:
                t_i = time.perf_counter()
                ys = None   # the last step's running sums go before the next
                with P.span("kmt.yinyang.iteration"):
                    ys = next(loop)
                    more = drv.absorb(ys.changed)
                    P.count("yinyang.candidates", ys.candidates)
                    P.count("yinyang.passed", ys.passed)
                    P.count("yinyang.patched", ys.patched)
                    if p.logger.verbosity > 1:
                        p.logger.debug(
                            "yinyang: %d candidates, %d samples passed the "
                            "global filter" % (ys.candidates, ys.passed))
                        p.logger.debug(
                            "yinyang: %s iteration, %d moved rows patched"
                            % (ys.variant, ys.patched))
                its += 1
                sparse += ys.variant.startswith("sparse")
                handover = (hand and more and refresh_wall is not None
                            and YY.filter_dense(ys.candidates, p.n))
                if handover:
                    break
                refresh_wall = (time.perf_counter() - t_i
                                if ys.variant == "dense refresh" else None)
            wall = time.perf_counter() - t_w
            p.logger.debug("yinyang: segment of %d iterations in %.3f s"
                           % (its, wall))
            if handover or not (more and ctl):
                continue
            spi = wall / its
            frac_sparse = sparse / its
            if not judged:
                judged = True     # the first iteration's full refresh
                window = config.YY_PROBE_ITERS
                continue
            if frac_sparse <= 0.25:
                # a dense window measures what revoking the sparse branch
                # costs: the freshest floor
                lloyd_spi = spi
            grow = min(window * 4, config.YY_WINDOW_MAX_ITERS)
            if floor_probe:
                floor_probe = False
                sched.sparse_ok = True
                window = config.YY_PROBE_ITERS
            elif sched.sparse_ok:
                if (frac_sparse >= 0.5 and lloyd_spi is not None
                        and spi > lloyd_spi * config.YY_BAILOUT_MARGIN):
                    p.logger.debug(
                        "yinyang: sparse branch revoked (%.3g s/it vs Lloyd "
                        "%.3g)" % (spi, lloyd_spi))
                    sched.sparse_ok = False
                    since_revoke = 0
                window = grow
            else:
                since_revoke += its
                window = grow
                if since_revoke >= reprobe_after:
                    p.logger.debug(
                        "yinyang: re-probing the sparse branch after %d "
                        "dense iterations" % since_revoke)
                    sched.sparse_ok = True
                    window = config.YY_PROBE_ITERS
                    reprobe_after = min(reprobe_after * 2,
                                        config.YY_REPROBE_ITERS_MAX)
        loop.close()
        del loop   # see _run: dropped, not only closed
        if not handover:
            return ys
        p.logger.debug(
            "yinyang: handing over to Lloyd (%d candidates of %d rows "
            "after a full refresh of %.3f s)"
            % (ys.candidates, p.n, refresh_wall))
        steps = A.lloyd_run(
            p.xs, p.valids, ys.assign,
            D.normalize_centroids(ys.sums, ys.counts.float(), p.metric),
            n_clusters=p.k, metric=p.metric,
            resume=(ys.sums, ys.counts, ys.changed))
        del ys    # the closed loop's bounds go with its last step
        budget = 2 ** handovers
        handovers += 1
        spent, its = 0.0, 0
        while more:
            t_i = time.perf_counter()
            with P.span("kmt.yinyang.lloyd"):
                step = next(steps)
                more = drv.absorb(step.changed)
                P.count("yinyang.handed_over", 1)
                P.count("yinyang.passed", p.n_valid)
            spent += time.perf_counter() - t_i
            its += 1
            floor = spent / its if lloyd_spi is None else lloyd_spi
            if spent >= budget * (refresh_wall - floor):
                break
        steps.close()
        del steps
        if not more:
            return step
        p.logger.debug("yinyang: back on the bound path after %d Lloyd "
                       "iterations in %.3f s" % (its, spent))
        sched = YY.Schedule(sparse_ok=sched.sparse_ok)
