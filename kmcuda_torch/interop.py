"""State carried across from the JAX package.

``kmcuda_tpu`` returns numpy arrays (fp32 or fp16 centroids, uint32
assignments with the invalid marker k).  :func:`state_from_jax` turns them
into this package's tensors, e.g. to hand JAX centroids to
``kmeans_torch(..., init=centroids)``.  It imports nothing of JAX: it takes
anything ``numpy.asarray`` takes.
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
