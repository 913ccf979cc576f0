"""Panel build, stagnation rule and the churn-adaptive Lloyd loop.

The port of the parts of ``kmcuda_tpu.ops.assign`` that the Lloyd path
runs.  :func:`lloyd_run` is a host loop around the kernel entries of
``ops.assign_kernels`` (the TPU version is the on-device while-loop
``lloyd_run_pallas``): high-churn iterations run the fused pass, whose full
segment sum REPLACES the running sums; low-churn iterations run the
assignment-only pass plus the delta of the moved rows (``delta_sum``, over
the ascending list ``compact.moved_rows``), which is ADDED to them.  The
arm is chosen from the previous iteration's count.  Each iteration pays
one host sync, to read its reassignment count — the same sync the
reference kmcuda pays in ``check_changed`` — and a sparse one two more:
sizing the moved-row list and ``delta_sum``'s check of it.

The loop runs over row shards (``parallel.devices``): every iteration
launches each shard's pass on its device, then reduces the shards' sums,
counts and reassignment counts on the leader in shard order, normalizes
there and broadcasts the centroids.  One shard is the same loop with
identity reductions.
"""

from typing import NamedTuple

import numpy as np
import torch

from kmcuda_torch.ops import compact as C
from kmcuda_torch.ops import distance as D
from kmcuda_torch.parallel.devices import Topology, as_shards, shaped_like
from kmcuda_torch.utils import profiling as P

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


class LloydStep(NamedTuple):
    """One iteration of :func:`lloyd_run`: ``c_used`` are the centroids
    its assignment was computed against, ``c_next`` their update from the
    running (``sums``, ``counts``), ``changed`` the host-side reassignment
    count.  The last step is the accumulation state a Yinyang loop
    continues from."""

    c_used: torch.Tensor
    c_next: torch.Tensor
    assign: torch.Tensor
    best: torch.Tensor
    changed: int
    sums: torch.Tensor
    counts: torch.Tensor


def lloyd_run(x, valid, assign, centroids, *, n_clusters: int,
              metric: D.DistanceMetric, resume=None):
    """Iterate Lloyd; yields a :class:`LloydStep` once per iteration and
    runs until the caller stops iterating.

    ``x``, ``valid`` and ``assign`` are tensors (one shard) or lists of
    per-shard tensors, shard i on its own device; a step's ``assign`` and
    ``best`` take the same form, its centroids and running (sums, counts)
    live on the leader (shard 0's device).  The first iteration is always
    dense (the previous count starts at int32 max), so the running sums
    exist before any sparse iteration adds to them.

    ``resume`` = (sums, counts, changed) continues another loop's
    accumulation stream instead: ``assign`` is that loop's last
    assignment, ``centroids`` the update of its running (sums, counts),
    and its reassignment count ``changed`` picks the first sum arm, so
    the iterations are bitwise the ones the loop would have run.
    """
    # imported here: assign_kernels imports this module's panel builders
    from kmcuda_torch.ops import assign_kernels as K

    k = n_clusters
    xs, valids, assigns = as_shards(x), as_shards(valid), as_shards(assign)
    topo = Topology.of(xs)
    n = sum(t.shape[0] for t in xs)
    kw = dict(n_clusters=k, metric=metric)
    c_cur = centroids.float().to(topo.leader)
    sums = counts = None
    prev_changed = INT32_MAX
    if resume is not None:
        sums, counts, prev_changed = resume
        sums, counts = sums.to(topo.leader), counts.to(topo.leader)
    while True:
        cs = topo.broadcast(c_cur)
        if C.predict_dense(prev_changed, n):
            outs = [K.fused_lloyd_pass(xi, vi, ai, ci, **kw)
                    for xi, vi, ai, ci in zip(xs, valids, assigns, cs)]
            sums = topo.reduce([o[2] for o in outs])
            counts = topo.reduce([o[3] for o in outs])
            c_next = D.normalize_centroids(sums, counts.float(), metric)
            changed = sum(topo.read([o[4] for o in outs]))
            P.count("lloyd.dense", 1)
        else:
            outs = [K.assign_only_pass(xi, vi, ai, ci, **kw)
                    for xi, vi, ai, ci in zip(xs, valids, assigns, cs)]
            changed = sum(topo.read([o[2] for o in outs]))
            moved = [C.moved_rows(o[0], ai) for ai, o in zip(assigns, outs)]
            P.count("lloyd.moved_rows", sum(r.numel() for r in moved))
            deltas = [K.delta_sum(xi, rows, o[0], ai, n_clusters=k)
                      for xi, rows, ai, o in zip(xs, moved, assigns, outs)]
            del moved   # held across the yield, it would raise the peak
            sums = sums + topo.reduce([d[0] for d in deltas])
            counts = counts + topo.reduce([d[1] for d in deltas])
            c_next = D.normalize_centroids(sums, counts.float(), metric)
        aids = [o[0] for o in outs]
        yield LloydStep(c_cur, c_next, shaped_like(x, aids),
                        shaped_like(x, [o[1] for o in outs]), changed, sums,
                        counts)
        assigns, c_cur, prev_changed = aids, c_next, changed
