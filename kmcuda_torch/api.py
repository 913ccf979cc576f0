"""Public API: kmeans_torch / knn_torch.

The call shape of ``kmcuda_tpu.api`` and of the reference binding:

    kmeans_torch(samples, clusters, tolerance=0.01, init="k-means++",
                 yinyang_t=0.1, metric="L2", average_distance=False,
                 seed=None, device=0, verbosity=0, max_iterations=None,
                 donate_samples=False)
        -> (centroids, assignments[, average_distance])

Devices are explicit, with no fallback:
- a ``torch.Tensor`` runs on its own device and comes back as tensors on
  that device (centroids fp32, or the input dtype for fp16/bf16 input;
  assignments ``torch.int32``, because torch has almost no uint32
  arithmetic);
- a numpy array runs on the CUDA device the ``device`` bitmask selects and
  comes back as numpy (assignments ``uint32``); with no CUDA device it
  raises :class:`KMTPUNoSuchDevice`.

Ported so far: Lloyd with random or imported init, L2 and angular, fp32
and fp16/bf16 input (bf16 storage, fp32 accumulation).  k-means++ and
AFK-MC2 init, Yinyang and kNN raise ``NotImplementedError`` naming their
ROADMAP item; ``yinyang_t > 0`` runs Lloyd, whose results Yinyang equals.
"""

import time

import numpy as np
import torch

from kmcuda_torch import config
from kmcuda_torch.models import initialization as I
from kmcuda_torch.models import lloyd as L
from kmcuda_torch.models.problem import prepare
from kmcuda_torch.ops.distance import DistanceMetric, disable_tf32, metrics
from kmcuda_torch.parallel.devices import device_for
from kmcuda_torch.utils import validation as V
from kmcuda_torch.utils.errors import KMTPUInvalidArguments
from kmcuda_torch.utils.logging import Logger


def _parse_metric(metric):
    if isinstance(metric, DistanceMetric):
        return metric
    if isinstance(metric, int) and not isinstance(metric, bool):
        try:
            return DistanceMetric(metric)
        except ValueError:
            raise KMTPUInvalidArguments("unknown metric %r" % metric)
    if isinstance(metric, str):
        try:
            return metrics[metric]
        except KeyError:
            raise KMTPUInvalidArguments("unknown metric %r" % metric)
    raise TypeError("metric must be a string or DistanceMetric")


def _parse_init(init):
    """str | ("afkmc2", m) | array -> (method, m, imported)."""
    if isinstance(init, str):
        try:
            return I.init_methods[init], 0, None
        except KeyError:
            raise KMTPUInvalidArguments("unknown init method %r" % init)
    if isinstance(init, (tuple, list)):
        if not init or not isinstance(init[0], str):
            raise TypeError("init tuple must start with a method name")
        try:
            method = I.init_methods[init[0]]
        except KeyError:
            raise KMTPUInvalidArguments("unknown init method %r" % init[0])
        m = 0
        if len(init) > 1:
            if init[1] is not None and int(init[1]) < 0:
                raise KMTPUInvalidArguments("init parameter must be >= 0")
            m = int(init[1]) if init[1] is not None else 0
        return method, m, None
    if hasattr(init, "shape"):
        return I.InitMethod.IMPORT, 0, init
    raise TypeError("init must be a string, tuple or array, got %r" % (init,))


def _check_cosine(problem):
    """Probe 3 samples for unit norm, like the reference."""
    n = problem.n
    idx = sorted({0, n // 2, n - 1})
    probe = problem.x_sq[idx].cpu().numpy()
    if not V.check_cosine_normalized(probe):
        raise KMTPUInvalidArguments(
            "the angular distance metric requires samples to be normalized "
            "(unit L2 norm); probe norms^2 were %s" % (probe,))


def kmeans_torch(samples, clusters, tolerance=0.01, init="k-means++",
                 yinyang_t=config.DEFAULT_YINYANG_T, metric="L2",
                 average_distance=False, seed=None, device=0, verbosity=0,
                 max_iterations=None, donate_samples=False):
    """K-means clustering.  See the module docstring for the contract.

    donate_samples=True lets the library zero invalid rows of a tensor
    ``samples`` in place (when it is already contiguous and in its storage
    dtype) instead of in a copy."""
    n, _features, k = V.check_kmeans_args(
        samples, clusters, tolerance, yinyang_t, seed, device)
    metric_e = _parse_metric(metric)
    init_e, _afkmc2_m, imported = _parse_init(init)
    logger = Logger(verbosity)
    dev = device_for(samples, int(device), logger)
    if dev.type == "cuda":
        disable_tf32()
    problem = prepare(samples, k, metric_e, dev, logger,
                      donate=bool(donate_samples))
    if metric_e == DistanceMetric.COSINE:
        _check_cosine(problem)
    if problem.n_valid < k:
        raise KMTPUInvalidArguments(
            "only %d finite samples for %d clusters" % (problem.n_valid, k))
    if seed is None:
        seed = int(time.time())

    centroids = I.init_centroids(problem, init_e, seed, imported=imported)
    assignments = L.new_assignments(problem)
    if int(yinyang_t * k) > 0 and tolerance < config.YINYANG_MIN_TOLERANCE:
        logger.info("yinyang is not ported yet (ROADMAP §A5); running "
                    "Lloyd, whose results Yinyang equals")
    centroids, assignments, _best, iters, _ = L.run(
        problem, centroids, assignments, tolerance,
        max_iterations=max_iterations)
    logger.debug("finished in %d iterations" % iters)
    ad = (L.mean_assigned_distance(problem, centroids, assignments)
          if average_distance else None)

    if isinstance(samples, torch.Tensor):
        out_c = centroids
        if problem.dtype == torch.bfloat16:
            out_c = out_c.to(samples.dtype)
        out_a = assignments
    else:
        out_c = centroids.cpu().numpy()
        if problem.dtype == torch.bfloat16:
            out_c = out_c.astype(samples.dtype)
        out_a = assignments.cpu().numpy().astype(np.uint32)
    if not average_distance:
        return out_c, out_a
    return out_c, out_a, ad


def knn_torch(k, samples, centroids, assignments, metric="L2", device=0,
              verbosity=0, donate_samples=False):
    """Exact k-nearest-neighbors: not ported yet."""
    raise NotImplementedError("knn is not ported yet (ROADMAP §A6)")
