"""Public API: kmeans_torch / knn_torch.

The call shape of ``kmcuda_tpu.api`` and of the reference binding:

    kmeans_torch(samples, clusters, tolerance=0.01, init="k-means++",
                 yinyang_t=0.1, metric="L2", average_distance=False,
                 seed=None, device=0, verbosity=0, max_iterations=None,
                 donate_samples=False)
        -> (centroids, assignments[, average_distance])

    knn_torch(k, samples, centroids, assignments, metric="L2", device=0,
              verbosity=0, donate_samples=False)
        -> neighbors

Devices are explicit, with no fallback (``parallel.devices.topology_for``):
- a ``torch.Tensor`` runs on its own device and comes back as tensors on
  that device (centroids fp32, or the input dtype for fp16/bf16 input;
  assignments and neighbours ``torch.int32``, because torch has almost no
  uint32 arithmetic; a neighbour row of a non-finite sample is -1); a
  ``device`` bitmask that selects several devices scatters its rows over
  them, and the results still come back on the tensor's device;
- a numpy array runs on the CUDA devices the ``device`` bitmask selects
  (0 = all of them) and comes back as numpy (assignments and neighbours
  ``uint32``, the neighbour sentinel 0xFFFFFFFF); with no CUDA device it
  raises :class:`KMTPUNoSuchDevice`.

Over several devices one process drives them all: the samples are cut
into contiguous row shards, one per device, and the sums and counts are
added on the first device in shard order, so a call repeats bitwise on a
given device set.

Ported: Lloyd and Yinyang with random, k-means++, AFK-MC2 or imported
init, and the pruned exact kNN, for L2 and angular, fp32 and fp16/bf16
input (bf16 storage, fp32 accumulation).  ``KMTPU_PROFILE=<dir>`` traces
the compute span of either call (``utils.profiling``); under any
``torch.profiler`` session a call carries ``kmt.`` spans and leaves a
counter record (``utils.profiling.records``).
"""

import time

import numpy as np
import torch

from kmcuda_torch import config
from kmcuda_torch.models import initialization as I
from kmcuda_torch.models import knn as KNN
from kmcuda_torch.models import lloyd as L
from kmcuda_torch.models import yinyang as Y
from kmcuda_torch.models.problem import prepare
from kmcuda_torch.ops.distance import DistanceMetric, disable_tf32, metrics
from kmcuda_torch.parallel.devices import topology_for
from kmcuda_torch.utils import validation as V
from kmcuda_torch.utils.errors import KMTPUInvalidArguments
from kmcuda_torch.utils.logging import Logger
from kmcuda_torch.utils import profiling as P


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


def _tf32_off(topo) -> None:
    """A call on CUDA devices runs its products with TF32 off."""
    if any(d.type == "cuda" for d in topo.devices):
        disable_tf32()


def _check_cosine(problem):
    """Probe 3 samples for unit norm, like the reference."""
    n = problem.n
    idx = torch.tensor(sorted({0, n // 2, n - 1}))
    probe = problem.take(problem.x_sqs, idx).cpu().numpy()
    if not V.check_cosine_normalized(probe):
        raise KMTPUInvalidArguments(
            "the angular distance metric requires samples to be normalized "
            "(unit L2 norm); probe norms^2 were %s" % (probe,))


@P.public_call("kmeans")
def kmeans_torch(samples, clusters, tolerance=0.01, init="k-means++",
                 yinyang_t=config.DEFAULT_YINYANG_T, metric="L2",
                 average_distance=False, seed=None, device=0, verbosity=0,
                 max_iterations=None, donate_samples=False):
    """K-means clustering.  See the module docstring for the contract.

    donate_samples=True lets the library zero invalid rows of a tensor
    ``samples`` in place (when it is already contiguous and in its storage
    dtype) instead of in a copy."""
    with P.span("kmt.prepare"):
        n, _features, k = V.check_kmeans_args(
            samples, clusters, tolerance, yinyang_t, seed, device)
        metric_e = _parse_metric(metric)
        init_e, afkmc2_m, imported = _parse_init(init)
        logger = Logger(verbosity)
        topo = topology_for(samples, int(device), logger)
        _tf32_off(topo)
        problem = prepare(samples, k, metric_e, topo, logger,
                          donate=bool(donate_samples))
        topo = problem.topo
        if metric_e == DistanceMetric.COSINE:
            _check_cosine(problem)
        if problem.n_valid < k:
            raise KMTPUInvalidArguments(
                "only %d finite samples for %d clusters"
                % (problem.n_valid, k))
    if seed is None:
        seed = int(time.time())

    # the profiler window covers init, iterations and average distance, the
    # span the reference brackets with cudaProfilerStart/Stop
    with P.profile_window(logger, topo.leader, "kmeans"):
        centroids = I.init_centroids(problem, init_e, seed,
                                     afkmc2_m=afkmc2_m, imported=imported)
        assignments = L.new_assignments(problem)
        if verbosity > 1:
            # the memory lines once the working set is resident, where the
            # JAX package prints its per-device memory stats
            for line in topo.memory_report():
                logger.debug(line)
        groups = int(yinyang_t * k)
        if groups > 0 and tolerance < config.YINYANG_MIN_TOLERANCE:
            centroids, assignments, _best, iters = Y.run(
                problem, centroids, assignments, tolerance, groups,
                max_iterations=max_iterations, seed=seed)
        else:
            centroids, assignments, _best, iters, _ = L.run(
                problem, centroids, assignments, tolerance,
                max_iterations=max_iterations)
        logger.debug("finished in %d iterations" % iters)
        ad = (L.mean_assigned_distance(problem, centroids, assignments)
              if average_distance else None)

    with P.span("kmt.output"):
        if isinstance(samples, torch.Tensor):
            out_c = centroids.to(samples.device)
            if problem.dtype == torch.bfloat16:
                out_c = out_c.to(samples.dtype)
            out_a = topo.gather(assignments, samples.device)
        else:
            out_c = centroids.cpu().numpy()
            if problem.dtype == torch.bfloat16:
                out_c = out_c.astype(samples.dtype)
            out_a = topo.gather(assignments, "cpu").numpy().astype(np.uint32)
    if not average_distance:
        return out_c, out_a
    return out_c, out_a, ad


def _knn_assignments(assignments, device) -> torch.Tensor:
    """int64 cluster ids on ``device`` from an int tensor (the port's
    int32) or anything ``numpy.asarray`` takes (the reference's uint32)."""
    if isinstance(assignments, torch.Tensor):
        return assignments.to(device=device, dtype=torch.int64)
    return torch.from_numpy(
        np.asarray(assignments).astype(np.int64)).to(device)


@P.public_call("knn")
def knn_torch(k, samples, centroids, assignments, metric="L2", device=0,
              verbosity=0, donate_samples=False):
    """Exact k-nearest neighbours of every sample, pruned by the k-means
    structure (``centroids``, ``assignments``).  Returns (n, k) neighbour
    indices sorted by ascending distance, excluding the sample itself.
    Rows with non-finite features (k-means gave them the id
    ``len(centroids)``) come back as -1 in the int32 tensor a tensor input
    gets, and as 0xFFFFFFFF in the uint32 array a numpy input gets."""
    with P.span("kmt.prepare"):
        n, _features, k, n_clusters = V.check_knn_args(
            k, samples, centroids, assignments, device)
        metric_e = _parse_metric(metric)
        logger = Logger(verbosity)
        topo = topology_for(samples, int(device), logger)
        _tf32_off(topo)
        problem = prepare(samples, n_clusters, metric_e, topo, logger,
                          donate=bool(donate_samples))
        topo = problem.topo
        dev = topo.leader
        if metric_e == DistanceMetric.COSINE:
            _check_cosine(problem)
        if isinstance(centroids, torch.Tensor):
            cents = centroids.to(device=dev, dtype=torch.float32)
        else:
            cents = torch.tensor(np.asarray(centroids, dtype=np.float32),
                                 device=dev)
    if verbosity > 1:
        for line in topo.memory_report():
            logger.debug(line)
    with P.profile_window(logger, dev, "knn"):
        nbr, _dist = KNN.run(problem, cents,
                             _knn_assignments(assignments, dev), k)
    with P.span("kmt.output"):
        if isinstance(samples, torch.Tensor):
            return nbr.to(samples.device)
        return nbr.cpu().numpy().astype(np.uint32)
