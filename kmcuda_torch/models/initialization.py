"""Centroid initialization: random and import.

The port of ``kmcuda_tpu.models.initialization`` for the two methods the
Lloyd slice carries.  ``random`` draws k distinct *valid* rows with a CPU
``torch.Generator`` seeded from ``seed``, so CPU and GPU runs pick the same
rows; it cannot reproduce the JAX package's ``jax.random`` draws.
k-means++ and AFK-MC2 are not ported yet (ROADMAP §A4).
"""

import enum

import numpy as np
import torch

from kmcuda_torch.utils.errors import KMTPUInvalidArguments


class InitMethod(enum.IntEnum):
    """Value-compatible with KMCUDAInitMethod."""

    RANDOM = 0
    PLUS_PLUS = 1
    AFKMC2 = 2
    IMPORT = 3


#: string -> enum map, mirroring the reference's ``init_methods``.
init_methods = {
    "kmeans++": InitMethod.PLUS_PLUS,
    "k-means++": InitMethod.PLUS_PLUS,
    "afkmc2": InitMethod.AFKMC2,
    "afk-mc2": InitMethod.AFKMC2,
    "random": InitMethod.RANDOM,
}


def _imported(problem, imported) -> torch.Tensor:
    if isinstance(imported, torch.Tensor):
        cent = imported.to(device=problem.device, dtype=torch.float32)
    else:
        cent = torch.tensor(np.asarray(imported, dtype=np.float32),
                            device=problem.device)
    if tuple(cent.shape) != (problem.k, problem.features):
        raise KMTPUInvalidArguments(
            "imported centroids must have shape (%d, %d), got %s"
            % (problem.k, problem.features, (tuple(cent.shape),)))
    return cent


def _random(problem, seed: int) -> torch.Tensor:
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    rows = torch.nonzero(problem.valid.cpu()).squeeze(1)
    pick = torch.randperm(rows.numel(), generator=gen)[:problem.k]
    return problem.x[rows[pick].to(problem.device)].float()


def init_centroids(problem, method: InitMethod, seed: int,
                   imported=None) -> torch.Tensor:
    """Returns (k, F) fp32 centroids on the problem's device."""
    if method == InitMethod.IMPORT:
        return _imported(problem, imported)
    if method == InitMethod.RANDOM:
        problem.logger.info("performing random centroid initialization...")
        return _random(problem, seed)
    if method in (InitMethod.PLUS_PLUS, InitMethod.AFKMC2):
        raise NotImplementedError(
            "init method %s is not ported yet (ROADMAP §A4)" % method.name)
    raise KMTPUInvalidArguments("unknown init method %r" % (method,))
