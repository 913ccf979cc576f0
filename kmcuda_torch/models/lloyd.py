"""Lloyd k-means driver: stop rules, progress lines, average distance.

The port of ``kmcuda_tpu.models.lloyd`` around the host loop
``ops.assign.lloyd_run``.  Logs ``iteration N: M reassignments`` after
every iteration, like the reference's ``check_changed``.  The stop rules
are those of the reference's ``_SegmentDriver`` (:class:`Driver`): always
run the first iteration, then continue while the count exceeds
``int(tolerance * n)``, the iteration cap is not reached and the count
keeps improving (``STAGNATION_PATIENCE``).  A host loop has no segments.
"""

import time

import torch

from kmcuda_torch import config
from kmcuda_torch.ops import assign as A
from kmcuda_torch.ops import distance as D
from kmcuda_torch.parallel.devices import shaped_like
from kmcuda_torch.utils import profiling as P

#: rows per step of the average-distance pass (bounds its gather)
DISTANCE_CHUNK = 1 << 16


def _patience() -> int:
    """STAGNATION_PATIENCE=None disables the stagnation stop."""
    p = config.STAGNATION_PATIENCE
    return A.INT32_MAX if p is None else int(p)


def new_assignments(problem) -> list:
    """The 'never assigned' vectors (id == k, the invalid marker), one per
    shard.  Nothing writes them in place, so the prepared ones are
    shared."""
    return problem.assign0s


class Driver:
    """Stop rules of a convergence loop, one iteration at a time: logs
    the iteration line, counts the budget and carries the stagnation
    counters (mark, stale).  One driver spans a Yinyang run's draft and
    main loop, so it stops at the iteration a Lloyd run of the same
    trajectory stops at; only ``tol`` changes at the hand-over."""

    def __init__(self, logger, tol_count: int, max_iterations=None,
                 iter_offset: int = 0):
        if max_iterations is None:
            max_iterations = config.DEFAULT_MAX_ITERATIONS
        self.logger = logger
        self.tol = int(tol_count)
        self.cap = min(int(max_iterations), config.DEFAULT_MAX_ITERATIONS)
        self.offset = iter_offset
        self.done = 0
        self.last = 0
        self.mark, self.stale = A.INT32_MAX, 0

    def absorb(self, changed: int) -> bool:
        """Log one finished iteration; True = keep iterating."""
        self.done += 1
        self.last = changed
        self.logger.iteration(self.offset + self.done, changed)
        self.mark, self.stale = A.stagnation_update(changed, self.mark,
                                                    self.stale)
        return self.keep_going()

    def keep_going(self) -> bool:
        """The stop rule on the last count, against the current ``tol``."""
        return (self.last > self.tol and self.done < self.cap
                and self.stale < _patience())

    def finish(self) -> None:
        """Once stopped: say so if the stagnation rule stopped the loop."""
        if self.last > self.tol and self.done < self.cap:
            self.logger.info(
                "stopping: reassignments stagnated at %d (churn floor above "
                "the tolerance; see STAGNATION_PATIENCE)" % self.last)


def drive(driver, steps, walls=None):
    """Feed ``steps`` (an ``ops.assign.lloyd_run`` generator) to the
    driver until it stops; returns the last ``LloydStep``.  The generator
    stays open: a Yinyang run may continue its accumulation stream.
    ``walls``, a list, gets each iteration's seconds on the host clock,
    read after the count's sync.  Each iteration, the generator's step and
    ``Driver.absorb``, is one span ``kmt.lloyd.iteration``."""
    t = time.perf_counter()
    more = True
    while more:
        with P.span("kmt.lloyd.iteration"):
            step = next(steps)
            more = driver.absorb(step.changed)
            if walls is not None:
                now = time.perf_counter()
                walls.append(now - t)
                t = now
    return step


@P.spanned("kmt.lloyd")
def run(problem, centroids, assignments, tolerance, max_iterations=None,
        iter_offset=0):
    """Iterate Lloyd until reassignments <= tolerance * n.

    ``assignments`` is a whole (n,) tensor or a list of per-shard ones;
    the returned assignments and best scores take its form.  Returns
    (centroids, assignments, best_scores, iterations, last_changed); the
    centroids are the ones the returned assignments were computed against
    (the reference also stops before re-adjusting).
    """
    p = problem
    drv = Driver(p.logger, int(tolerance * p.n), max_iterations, iter_offset)
    steps = A.lloyd_run(p.xs, p.valids, p.per_shard(assignments), centroids,
                        n_clusters=p.k, metric=p.metric)
    step = drive(drv, steps)
    steps.close()
    drv.finish()
    return (step.c_used, shaped_like(assignments, step.assign),
            shaped_like(assignments, step.best), drv.done, drv.last)


def mean_assigned_distance(problem, centroids, assignments) -> float:
    """Mean exact distance of the valid samples to their assigned centroid
    (the reference's kmeans_cuda_calc_average_distance), accumulated in
    fp32 per shard, the shards' sums added in shard order on the leader."""
    p = problem
    f = p.features
    zero_row = torch.zeros((1, f), dtype=torch.float32, device=p.device)
    c_ext = torch.cat([centroids.float().to(p.device), zero_row])
    c_sq_ext = torch.sum(c_ext * c_ext, dim=1)
    c_sq_ext[-1] = 0.0
    partials = []
    for shard, assign in zip(p.shards, p.per_shard(assignments)):
        dev = shard.x.device
        c_e, c_sq_e = c_ext.to(dev), c_sq_ext.to(dev)
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for start in range(0, shard.x.shape[0], DISTANCE_CHUNK):
            end = start + DISTANCE_CHUNK
            a = assign[start:end].long()
            prod = torch.sum(shard.x[start:end].float() * c_e[a], dim=1)
            if p.metric == D.DistanceMetric.L2:
                score = c_sq_e[a] - 2.0 * prod
            else:
                score = -prod
            d = D.finalize_distance(score, shard.x_sq[start:end], p.metric)
            acc = acc + torch.sum(torch.where(shard.valid[start:end], d,
                                              torch.zeros_like(d)))
        partials.append(acc)
    return float(p.topo.reduce(partials) / p.n_valid)
