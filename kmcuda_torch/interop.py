"""State carried across from the JAX package.

``kmcuda_tpu`` returns numpy arrays (fp32 or fp16 centroids, uint32
assignments with the invalid marker k).  :func:`state_from_jax` turns them
into this package's tensors, e.g. to hand JAX centroids to
``kmeans_torch(..., init=centroids)``; :func:`plan_from_jax` turns a kNN
layout plan of ``kmcuda_tpu.models.knn.plan_pruned`` into this package's
``SearchPlan``, so both searches can run on one layout; and
:func:`groups_from_jax` turns the Yinyang grouping of
``kmcuda_tpu.models.yinyang._group_centroids`` into this package's
``GroupLayout``, so both Yinyang loops can run on one grouping.  None
imports JAX: they take anything ``numpy.asarray`` takes.
"""

import numpy as np
import torch


def state_from_jax(centroids, assignments=None, *, device):
    """Returns (centroids (k, F) fp32 tensor, assignments (n,) int32 tensor
    or None), both on ``device``.  Assignment ids, including the invalid
    marker k, are kept as they are."""
    cent = torch.tensor(np.asarray(centroids, dtype=np.float32),
                        device=device)
    if assignments is None:
        return cent, None
    a = np.asarray(assignments).astype(np.int64)
    if a.size and (a.min() < 0 or a.max() > np.iinfo(np.int32).max):
        raise ValueError("assignment ids do not fit int32")
    return cent, torch.tensor(a, dtype=torch.int32, device=device)


def _tensor(arr, dtype, device) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        # numpy holds JAX's bf16 as its own dtype: move the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.tensor(a.astype(np.int64) if a.dtype.kind in "ui" else a,
                        device=device).to(dtype)


def plan_from_jax(plan, *, device):
    """The port's ``models.knn.SearchPlan`` from a JAX ``SearchPlan``, on
    ``device``: the same layout in the port's dtypes (int64 index tables,
    int32 positions and cluster ids, the members in their storage
    dtype)."""
    from kmcuda_torch.models.knn import SearchPlan

    xm = np.asarray(plan.xm)
    return SearchPlan(
        tile_m=int(plan.tile_m), q_chunk=int(plan.q_chunk),
        n_tiles=int(plan.n_tiles), m_total=int(plan.m_total),
        group=int(plan.group),
        xm=_tensor(xm, torch.bfloat16 if xm.dtype.name == "bfloat16"
                   else torch.float32, device),
        m_spos=_tensor(plan.m_spos, torch.int32, device),
        q_assign=_tensor(plan.q_assign, torch.int32, device),
        r_ext=_tensor(plan.r_ext, torch.float32, device),
        c_rank=_tensor(plan.c_rank, torch.float32, device),
        inc_c=_tensor(plan.inc_c, torch.int64, device),
        inc_t=_tensor(plan.inc_t, torch.int64, device),
        tile_nvalid=_tensor(plan.tile_nvalid, torch.int32, device),
        sorder=_tensor(plan.sorder, torch.int64, device))


def groups_from_jax(group_of, flat_slot, pad_src, pad_pen, cap, *, device):
    """The port's ``ops.yinyang.GroupLayout`` on ``device`` from the
    (group_of, flat_slot, pad_src, pad_pen, cap) a JAX grouping returns."""
    from kmcuda_torch.ops.yinyang import GroupLayout

    return GroupLayout(
        group_of=_tensor(group_of, torch.int64, device),
        flat_slot=_tensor(flat_slot, torch.int64, device),
        pad_src=_tensor(pad_src, torch.int64, device),
        pad_pen=_tensor(pad_pen, torch.float32, device), cap=int(cap))
