"""Prepared problem state: upload, storage dtype, NaN hygiene.

The port of ``kmcuda_tpu.models.problem.prepare``.  Rows with any
non-finite value are marked invalid once and zeroed, so no kernel ever
sees a NaN; they keep the invalid id k.  fp16 and bf16 input is stored as
bf16, fp32 and fp64 input as fp32.  Nothing is padded: the kernels mask
their own ragged edge, so the row count stays n.
"""

import dataclasses

import numpy as np
import torch

from kmcuda_torch.ops.distance import DistanceMetric, row_sq_norms
from kmcuda_torch.utils.errors import KMTPUInvalidArguments


@dataclasses.dataclass
class Problem:
    """Device-resident, cleaned inputs."""

    logger: object
    n: int
    features: int
    k: int
    metric: DistanceMetric
    device: torch.device
    dtype: torch.dtype    # storage dtype (float32 or bfloat16)
    x: torch.Tensor       # (n, F) cleaned, storage dtype
    x_sq: torch.Tensor    # (n,) fp32 squared norms
    valid: torch.Tensor   # (n,) bool
    assign0: torch.Tensor  # (n,) int32 all k: 'never assigned'
    n_valid: int


def storage_dtype_for(dtype) -> torch.dtype:
    """fp16/bf16 -> bf16 storage; fp32/fp64 -> fp32."""
    if dtype in (torch.float16, torch.bfloat16):
        return torch.bfloat16
    if dtype in (torch.float32, torch.float64):
        return torch.float32
    raise KMTPUInvalidArguments(
        "samples dtype must be float16/bfloat16/float32/float64, got %s"
        % dtype)


def _as_tensor(samples) -> torch.Tensor:
    """Host array -> CPU tensor sharing its memory."""
    arr = np.ascontiguousarray(samples)
    if arr.dtype not in (np.float16, np.float32, np.float64):
        raise KMTPUInvalidArguments(
            "numpy samples must be float16/float32/float64 (bfloat16 as a "
            "torch.Tensor), got %s" % arr.dtype)
    return torch.from_numpy(arr)


def prepare(samples, k: int, metric: DistanceMetric, device: torch.device,
            logger, donate: bool = False) -> Problem:
    """Move the samples to ``device`` in their storage dtype and clean them.

    The caller's data is never written unless ``donate`` is set and
    ``samples`` is a tensor that is already contiguous and in its storage
    dtype on ``device``: then invalid rows are zeroed in place instead of
    in a copy.
    """
    is_tensor = isinstance(samples, torch.Tensor)
    src = samples if is_tensor else _as_tensor(samples)
    n, features = src.shape
    dtype = storage_dtype_for(src.dtype)
    x = src.to(device=device, dtype=dtype).contiguous()
    owned = x.data_ptr() != src.data_ptr() or (is_tensor and donate)
    valid = torch.isfinite(x).all(dim=1)
    n_valid = int(valid.sum())
    if n_valid < n:
        invalid = torch.logical_not(valid)[:, None]
        x = x.masked_fill_(invalid, 0) if owned else x.masked_fill(invalid, 0)
    x_sq = row_sq_norms(x)
    assign0 = torch.full((n,), k, dtype=torch.int32, device=device)
    logger.debug("prepared problem: n=%d, features=%d, k=%d, dtype=%s, "
                 "device=%s, valid=%d"
                 % (n, features, k, str(dtype).replace("torch.", ""),
                    device, n_valid))
    # the JAX package's split plan (one line per device; here one device
    # holds rows [0, n) as one chunk) and, at verbosity 3, its allocation map
    logger.debug("plan: %s rows [0, %d) (1 chunks, %.1f MB samples)"
                 % (device, n, x.numel() * x.element_size() / 2**20))
    for name, arr in (("x", x), ("x_sq", x_sq), ("valid", valid),
                      ("assign0", assign0)):
        logger.trace("alloc %-8s %-14s %-9s %8.1f MB sharded over 1"
                     % (name, tuple(arr.shape),
                        str(arr.dtype).replace("torch.", ""),
                        arr.numel() * arr.element_size() / 2**20))
    return Problem(logger=logger, n=n, features=features, k=k, metric=metric,
                   device=device, dtype=dtype, x=x, x_sq=x_sq, valid=valid,
                   assign0=assign0, n_valid=n_valid)
