"""libKMTPU on PyTorch and CUDA: the port of ``kmcuda_tpu`` to one GPU.

The same call shape as ``kmcuda_tpu`` and the reference kmcuda binding:
:func:`kmeans_torch` (alias ``kmeans_cuda``) and :func:`knn_torch` (alias
``knn_cuda``).  Lloyd k-means runs through hand-written CUDA kernels
(``csrc/assign.cu``, built with ``nvcc`` at first use) on a CUDA tensor,
and through their plain-torch twins on a CPU tensor.  What is not ported
yet raises ``NotImplementedError`` naming its ROADMAP item.
"""

from kmcuda_torch.utils.errors import (
    KMTPUResult,
    KMTPUError,
    KMTPUInvalidArguments,
    KMTPUNoSuchDevice,
    KMTPUMemoryAllocationFailure,
    KMTPURuntimeError,
    KMTPUMemoryCopyError,
)
from kmcuda_torch.ops.distance import DistanceMetric
from kmcuda_torch.models.initialization import InitMethod
from kmcuda_torch.api import kmeans_torch, knn_torch

#: bf16 storage with fp32 accumulation serves fp16 input on every card
#: this package builds for (sm_90a).
supports_fp16 = True

# the reference binding's names, so kmcuda call sites keep working
kmeans_cuda = kmeans_torch
knn_cuda = knn_torch

__version__ = "0.1.0"

__all__ = [
    "kmeans_torch",
    "knn_torch",
    "kmeans_cuda",
    "knn_cuda",
    "supports_fp16",
    "DistanceMetric",
    "InitMethod",
    "KMTPUResult",
    "KMTPUError",
    "KMTPUInvalidArguments",
    "KMTPUNoSuchDevice",
    "KMTPUMemoryAllocationFailure",
    "KMTPURuntimeError",
    "KMTPUMemoryCopyError",
]
