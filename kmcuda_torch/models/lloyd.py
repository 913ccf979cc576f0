"""Lloyd k-means driver: stop rules, progress lines, average distance.

The port of ``kmcuda_tpu.models.lloyd`` around the host loop
``ops.assign.lloyd_run``.  Logs ``iteration N: M reassignments`` after
every iteration, like the reference's ``check_changed``.  The stop rules
are those of the reference's ``_SegmentDriver``: always run the first
iteration, then continue while the count exceeds ``int(tolerance * n)``,
the iteration cap is not reached and the count keeps improving
(``STAGNATION_PATIENCE``).  A host loop has no segments.
"""

import torch

from kmcuda_torch import config
from kmcuda_torch.ops import assign as A
from kmcuda_torch.ops import distance as D

#: rows per step of the average-distance pass (bounds its gather)
DISTANCE_CHUNK = 1 << 16


def _patience() -> int:
    """STAGNATION_PATIENCE=None disables the stagnation stop."""
    p = config.STAGNATION_PATIENCE
    return A.INT32_MAX if p is None else int(p)


def new_assignments(problem) -> torch.Tensor:
    """The 'never assigned' vector (id == k, the invalid marker).  Nothing
    writes it in place, so the prepared one is shared."""
    return problem.assign0


def run(problem, centroids, assignments, tolerance, max_iterations=None,
        iter_offset=0):
    """Iterate Lloyd until reassignments <= tolerance * n.

    Returns (centroids, assignments, best_scores, iterations,
    last_changed); the centroids are the ones the returned assignments
    were computed against (the reference also stops before re-adjusting).
    """
    p = problem
    if max_iterations is None:
        max_iterations = config.DEFAULT_MAX_ITERATIONS
    cap = min(int(max_iterations), config.DEFAULT_MAX_ITERATIONS)
    tol_count = int(tolerance * p.n)
    patience = _patience()
    mark, stale = A.INT32_MAX, 0
    it = 0
    steps = A.lloyd_run(p.x, p.valid, assignments, centroids,
                        n_clusters=p.k, metric=p.metric)
    for c_used, _c_next, assignments, best, changed in steps:
        it += 1
        p.logger.iteration(iter_offset + it, changed)
        mark, stale = A.stagnation_update(changed, mark, stale)
        if not (changed > tol_count and it < cap and stale < patience):
            break
    steps.close()
    if changed > tol_count and it < cap:
        p.logger.info(
            "stopping: reassignments stagnated at %d (churn floor above the "
            "tolerance; see STAGNATION_PATIENCE)" % changed)
    return c_used, assignments, best, it, changed


def mean_assigned_distance(problem, centroids, assignments) -> float:
    """Mean exact distance of the valid samples to their assigned centroid
    (the reference's kmeans_cuda_calc_average_distance), accumulated in
    fp32."""
    p = problem
    f = p.features
    zero_row = torch.zeros((1, f), dtype=torch.float32, device=p.device)
    c_ext = torch.cat([centroids.float(), zero_row])
    c_sq_ext = torch.sum(c_ext * c_ext, dim=1)
    c_sq_ext[-1] = 0.0
    acc = torch.zeros((), dtype=torch.float32, device=p.device)
    for start in range(0, p.n, DISTANCE_CHUNK):
        end = start + DISTANCE_CHUNK
        a = assignments[start:end].long()
        prod = torch.sum(p.x[start:end].float() * c_ext[a], dim=1)
        if p.metric == D.DistanceMetric.L2:
            score = c_sq_ext[a] - 2.0 * prod
        else:
            score = -prod
        d = D.finalize_distance(score, p.x_sq[start:end], p.metric)
        acc = acc + torch.sum(torch.where(p.valid[start:end], d,
                                          torch.zeros_like(d)))
    return float(acc / p.n_valid)
