"""Stable compaction + incremental centroid updates, in plain torch.

The port of ``kmcuda_tpu.ops.compact``.  At low churn the Lloyd loop
(``ops.assign.lloyd_run``) takes the reassigned rows in ascending order
(:func:`moved_rows`, the rows :func:`stable_partition` compacts to the
front) and adds only their delta to the running centroid sums — work
proportional to the number of moved rows.  The
delta is ``ops.assign_kernels.delta_sum``: the hand-written
``kmt_delta_sum`` on a CUDA tensor, :func:`delta_compacted` here (its
plain twin, the JAX package's chunked one-hot product, a plain
``torch.matmul`` in fp32) on a CPU one.  The dense/compacted choice is
:func:`predict_dense` of the *previous* iteration's count, a pure function
of the trajectory.
"""

import numpy as np
import torch

from kmcuda_torch import config
from kmcuda_torch.ops.distance import matmul_f32
from kmcuda_torch.utils import profiling as P


def predict_dense(prev_changed: int, n_total: int) -> bool:
    """Dense when the previous iteration's reassignment count exceeded
    ``DELTA_DENSE_FRACTION`` of all samples, compared in fp32 exactly as
    the reference does.  A fresh start passes int32 max."""
    return bool(np.float32(prev_changed)
                > np.float32(config.DELTA_DENSE_FRACTION)
                * np.float32(n_total))


def stable_partition(mask: torch.Tensor):
    """Permutation that moves ``mask`` rows to the front, preserving order.

    Returns (order (n,) int64, n_true () int64 tensor): ``order[j]`` is the
    original index of the row at compacted position j.  No host sync."""
    keys = torch.logical_not(mask).to(torch.uint8)
    order = torch.sort(keys, stable=True).indices
    return order, mask.sum()


@P.spanned("kmt.moved_rows")
def moved_rows(assign_new: torch.Tensor,
               assign_old: torch.Tensor) -> torch.Tensor:
    """The rows whose assignment changed, ascending, int32: the rows
    ``stable_partition(assign_new != assign_old)`` puts first, in its
    order, without sorting n keys.  Sizing the list reads the device."""
    return torch.nonzero(assign_new != assign_old).squeeze(1).to(torch.int32)


def chunk_delta(xb, anew, aold, d_sums, d_counts):
    """Accumulate one chunk's one-hot-difference centroid delta; returns the
    new (d_sums (K, F) fp32, d_counts (K,) int32).  Id ``k`` (invalid)
    matches no cluster and contributes nothing."""
    k = d_counts.shape[0]
    cluster_ids = torch.arange(k, device=xb.device, dtype=anew.dtype)
    oh_new = anew[:, None] == cluster_ids[None, :]
    oh_old = aold[:, None] == cluster_ids[None, :]
    d_oh = oh_new.float() - oh_old.float()
    d_sums = d_sums + matmul_f32(d_oh.T, xb)
    d_counts = d_counts + (oh_new.sum(0, dtype=torch.int32)
                           - oh_old.sum(0, dtype=torch.int32))
    return d_sums, d_counts


def delta_compacted(x, assign_new, assign_old, order, n_changed: int, *,
                    n_clusters: int, chunk: int = config.DEFAULT_SAMPLE_CHUNK):
    """Centroid-sum/count deltas from the reassigned rows only.

    ``order`` comes from ``stable_partition(assign_new != assign_old)`` and
    ``n_changed`` is its host-side count.  Walks ceil(n_changed / chunk)
    gathered chunks.  Returns (d_sums (K, F) fp32, d_counts (K,) int32).
    """
    f = x.shape[1]
    d_sums = torch.zeros((n_clusters, f), dtype=torch.float32,
                         device=x.device)
    d_counts = torch.zeros((n_clusters,), dtype=torch.int32, device=x.device)
    for base in range(0, int(n_changed), chunk):
        idx = order[base:min(base + chunk, int(n_changed))]
        d_sums, d_counts = chunk_delta(
            x[idx], assign_new[idx], assign_old[idx], d_sums, d_counts)
    return d_sums, d_counts
