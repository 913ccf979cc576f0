"""Panel build, stagnation rule and the churn-adaptive Lloyd loop.

The port of the parts of ``kmcuda_tpu.ops.assign`` that the Lloyd path
runs.  :func:`lloyd_run` is a host loop around the two kernel entries of
``ops.assign_kernels`` (the TPU version is the on-device while-loop
``lloyd_run_pallas``): high-churn iterations run the fused pass, whose full
segment sum REPLACES the running sums; low-churn iterations run the
assignment-only pass plus the compacted delta of the moved rows, which is
ADDED to them.  The arm is chosen from the previous iteration's count.
Each iteration pays one host sync, to read its reassignment count — the
same sync the reference kmcuda pays in ``check_changed``.
"""

import numpy as np
import torch

from kmcuda_torch.ops import compact as C
from kmcuda_torch.ops import distance as D

INT32_MAX = int(np.iinfo(np.int32).max)


def pad_clusters(centroids: torch.Tensor, storage_dtype) -> tuple:
    """Score panel of the centroids.

    Returns (panel (K, F) storage dtype, c_sq (K,) fp32).  For bf16
    storage the panel is the centroids rounded to bf16, while ``c_sq``
    comes from the unrounded fp32 centroids, as in the reference.  Unlike
    the TPU version nothing is padded to a lane multiple — the kernels
    mask their own ragged edge — so there is no pad penalty and no id
    map: column j is centroid j.
    """
    c = centroids.float()
    panel = c.to(storage_dtype).contiguous()
    return panel, D.row_sq_norms(c)


def rescore_table(centroids: torch.Tensor) -> torch.Tensor:
    """(k+1, F) fp32 centroid table for the exact top-2 rescore: non-finite
    entries zeroed elementwise, row k zeros.  Every assignment path builds
    it the same way."""
    cf = centroids.float()
    cf = torch.cat([cf, torch.zeros((1, cf.shape[1]), dtype=torch.float32,
                                    device=cf.device)])
    return torch.where(torch.isfinite(cf), cf, torch.zeros_like(cf))


def stagnation_update(changed: int, mark: int, stale: int) -> tuple:
    """A new best resets the stale counter only when it beats the mark by
    at least mark/64 (~1.6%): a reduced-precision churn floor that creeps
    down slower than that is stagnation."""
    if changed < mark - (mark >> 6):
        return changed, 0
    return mark, stale + 1


def lloyd_run(x, valid, assign, centroids, *, n_clusters: int,
              metric: D.DistanceMetric):
    """Iterate Lloyd; yields (c_used, c_next, assign, best, changed) once
    per iteration and runs until the caller stops iterating.

    ``c_used`` are the centroids this iteration's assignment was computed
    against and ``c_next`` their update; ``changed`` is a host int.  The
    first iteration is always dense (the previous count starts at int32
    max), so the running sums exist before any sparse iteration adds to
    them.
    """
    # imported here: assign_kernels imports this module's panel builders
    from kmcuda_torch.ops import assign_kernels as K

    k = n_clusters
    n = x.shape[0]
    c_cur = centroids.float()
    sums = counts = None
    prev_changed = INT32_MAX
    while True:
        if C.predict_dense(prev_changed, n):
            aid, best, sums, counts, changed_t = K.fused_lloyd_pass(
                x, valid, assign, c_cur, n_clusters=k, metric=metric)
            c_next = D.normalize_centroids(sums, counts.float(), metric)
            changed = int(changed_t)
        else:
            aid, best, changed_t = K.assign_only_pass(
                x, valid, assign, c_cur, n_clusters=k, metric=metric)
            # the iteration's one sync: the count is also the compacted
            # walk's trip count
            changed = int(changed_t)
            order, _ = C.stable_partition(aid != assign)
            d_sums, d_counts = C.delta_compacted(
                x, aid, assign, order, changed, n_clusters=k)
            sums = sums + d_sums
            counts = counts + d_counts
            c_next = D.normalize_centroids(sums, counts.float(), metric)
        yield c_cur, c_next, aid, best, changed
        assign, c_cur, prev_changed = aid, c_next, changed
