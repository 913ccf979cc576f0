"""Metric math in plain torch, the port of ``kmcuda_tpu.ops.distance``.

For *assignment* the per-sample constant |x|^2 is irrelevant, so clusters
are ranked by a monotone score:

- L2:      score = |c|^2 - 2 <x, c>        (= d^2 - |x|^2)
- angular: score = -<x, c>                 (= -cos d)

Every product is taken in fp32: bf16 operands are cast to fp32 first (the
cast is exact, and it matches XLA's ``preferred_element_type=float32``;
torch's bf16 matmul would return bf16), and CUDA products run with TF32
off, matching the reference's ``Precision.HIGHEST``.
"""

import enum

import torch

from kmcuda_torch import config


class DistanceMetric(enum.IntEnum):
    """Value-compatible with KMCUDADistanceMetric."""

    L2 = 0
    COSINE = 1


#: string -> enum map for wrappers, like the reference's ``metrics`` dict.
metrics = {
    "euclidean": DistanceMetric.L2,
    "L2": DistanceMetric.L2,
    "l2": DistanceMetric.L2,
    "cos": DistanceMetric.COSINE,
    "cosine": DistanceMetric.COSINE,
    "angular": DistanceMetric.COSINE,
}


def disable_tf32() -> None:
    """Full-fp32 products on CUDA: TF32 keeps about three decimal digits
    and would move assignments away from the reference's
    ``Precision.HIGHEST``.  Called before every CUDA product here."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in fp32 whatever the storage dtype."""
    if a.is_cuda:
        disable_tf32()
    return a.float() @ b.float()


def row_sq_norms(x: torch.Tensor) -> torch.Tensor:
    """|x_i|^2 per row, fp32 accumulation regardless of storage dtype."""
    xf = x.float()
    return torch.sum(xf * xf, dim=-1)


def scores(x_block, c_t, c_sq, metric: DistanceMetric):
    """Monotone distance scores of a sample block against all centroids.

    Args:
      x_block: (B, F) samples (fp32 or bf16).
      c_t:     (F, K) centroids, transposed, storage dtype.
      c_sq:    (K,) fp32 centroid squared norms (ignored for cosine).
    Returns (B, K) fp32 scores; non-finite scores (a NaN centroid is an
    empty cluster) become ``PAD_PENALTY`` so they never win.  The port
    pads no cluster columns, so the reference's additive pad penalty has
    no counterpart here.
    """
    prod = matmul_f32(x_block, c_t)
    if metric == DistanceMetric.L2:
        s = c_sq[None, :] - 2.0 * prod
    else:
        s = -prod
    return torch.where(torch.isfinite(s), s,
                       torch.full_like(s, config.PAD_PENALTY))


def finalize_distance(score, x_sq, metric: DistanceMetric):
    """Convert a score back to the true distance (sqrt for L2, acos for
    angular); ``x_sq`` broadcasts against ``score``."""
    if metric == DistanceMetric.L2:
        return torch.sqrt(torch.clamp(score + x_sq, min=0.0))
    return torch.arccos(torch.clamp(-score, -1.0, 1.0))


def argmin_lowest_index(score, fill: int):
    """Argmin over the cluster axis, ties broken by the lowest centroid id
    (the column index: the port keeps centroids in their natural order).
    Returns (best_score (B,) fp32, best_id (B,) int32)."""
    best = torch.min(score, dim=1, keepdim=True).values
    cols = torch.arange(score.shape[1], dtype=torch.int32,
                        device=score.device)
    ids = torch.where(score <= best, cols[None, :],
                      torch.tensor(fill, dtype=torch.int32,
                                   device=score.device))
    return best[:, 0], torch.min(ids, dim=1).values


def argmin_rescored(score, k: int, xb, c_ext):
    """Exact top-2 rescore: take the matmul's two best candidates and pick
    between them by the cancellation-free subtract-square distance, whose
    rounding is row-local (see ``kmcuda_tpu.ops.distance.argmin_rescored``).

    Args:
      score:    (B, k) fp32 from :func:`scores`.
      k:        cluster count (also the fill id).
      xb:       (B, F) sample rows (storage dtype; cast exactly to fp32).
      c_ext:    (k+1, F) fp32 centroids, non-finite entries zeroed, row k
                zeros.
    Returns (best (B,) fp32 matmul score of the winner, aid (B,) int32,
    d2 (B,) fp32 exact squared distance of the winner, +inf when no
    eligible centroid exists).
    """
    big = config.PAD_PENALTY * 0.5   # compared in fp32, as the reference
    inf = float("inf")
    s1, a1 = argmin_lowest_index(score, k)
    cols = torch.arange(score.shape[1], dtype=torch.int32,
                        device=score.device)
    smask = torch.where(cols[None, :] == a1[:, None],
                        torch.full_like(score, inf), score)
    s2, a2 = argmin_lowest_index(smask, k)
    xf = xb.float()

    def d2_of(aid, s_raw):
        rows = c_ext[torch.clamp(aid, max=k).long()]
        diff = xf - rows
        d2 = torch.sum(diff * diff, dim=-1)
        return torch.where((aid >= k) | (s_raw >= big),
                           torch.full_like(d2, inf), d2)

    d2a = d2_of(a1, s1)
    d2b = d2_of(a2, s2)
    take_b = (d2b < d2a) | ((d2b == d2a) & (a2 < a1))
    aid = torch.where(take_b, a2, a1)
    best = torch.where(take_b, s2, s1)
    return best, aid, torch.minimum(d2a, d2b)


def normalize_centroids(sums, counts, metric: DistanceMetric):
    """Mean for L2, L2-renormalization for angular.  Empty clusters yield
    NaN centroids by design (the reference documents it as a feature).
    ``counts`` is a float tensor."""
    empty = counts <= 0
    one = torch.ones((), dtype=sums.dtype, device=sums.device)
    if metric == DistanceMetric.L2:
        out = sums / torch.where(empty, one, counts)[:, None]
    else:
        norms = torch.sqrt(torch.sum(sums * sums, dim=1, keepdim=True))
        out = sums / torch.where(empty[:, None], one, norms)
    return torch.where(empty[:, None],
                       torch.full_like(out, float("nan")), out)
