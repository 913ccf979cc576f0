"""Argument validation, the same checks as ``kmcuda_tpu.utils.validation``.

Bad types raise TypeError, bad values ValueError (as
:class:`KMTPUInvalidArguments`).  ``samples`` may be a numpy array or a
``torch.Tensor``: only ``.shape`` is read.
"""

import numbers

import numpy as np

from kmcuda_torch import config
from kmcuda_torch.utils.errors import KMTPUInvalidArguments


def check_samples(samples):
    """Shape sanity for the sample matrix; returns (n, features)."""
    shape = getattr(samples, "shape", None)
    if shape is None or len(shape) != 2:
        raise TypeError("samples must be a 2D array, got %r" % (samples,))
    n, features = int(shape[0]), int(shape[1])
    if features == 0:
        raise KMTPUInvalidArguments("features_size may not be 0")
    if features > config.MAX_FEATURES:
        raise KMTPUInvalidArguments(
            "features_size must be <= %d" % config.MAX_FEATURES)
    if n > config.MAX_SAMPLES:
        raise KMTPUInvalidArguments(
            "too many samples: %d > %d (row ids are int32)"
            % (n, config.MAX_SAMPLES))
    return n, features


def check_kmeans_args(samples, clusters, tolerance, yinyang_t, seed, device):
    n, features = check_samples(samples)
    if isinstance(clusters, bool) or not isinstance(clusters, numbers.Integral):
        raise TypeError("clusters must be an integer, got %r" % (clusters,))
    clusters = int(clusters)
    if not 2 <= clusters <= config.MAX_CLUSTERS:
        raise KMTPUInvalidArguments(
            "clusters must be in [2, %d], got %d"
            % (config.MAX_CLUSTERS, clusters))
    if clusters * features > config.MAX_CLUSTERS_X_FEATURES:
        raise KMTPUInvalidArguments("clusters * features is too large")
    if n < clusters:
        raise KMTPUInvalidArguments(
            "samples_size (%d) must be >= clusters_size (%d)" % (n, clusters))
    if not isinstance(tolerance, numbers.Real):
        raise TypeError("tolerance must be a float")
    if not 0 <= float(tolerance) <= 1:
        raise KMTPUInvalidArguments("tolerance must be in [0, 1]")
    if not isinstance(yinyang_t, numbers.Real):
        raise TypeError("yinyang_t must be a float")
    if not 0 <= float(yinyang_t) <= 0.5:
        raise KMTPUInvalidArguments("yinyang_t must be in [0, 0.5]")
    if seed is not None and not isinstance(seed, numbers.Integral):
        raise TypeError("seed must be an integer")
    if not isinstance(device, numbers.Integral) or int(device) < 0:
        raise TypeError("device must be a non-negative integer bitmask")
    return n, features, clusters


def check_knn_args(k, samples, centroids, assignments, device):
    n, features = check_samples(samples)
    if isinstance(k, bool) or not isinstance(k, numbers.Integral):
        raise TypeError("k must be an integer, got %r" % (k,))
    k = int(k)
    if k <= 0:
        raise KMTPUInvalidArguments("k must be positive")
    if k >= n:
        raise KMTPUInvalidArguments("k must be < number of samples")
    cshape = getattr(centroids, "shape", None)
    if cshape is None or len(cshape) != 2:
        raise TypeError("centroids must be a 2D array")
    if int(cshape[1]) != features:
        raise KMTPUInvalidArguments(
            "centroids features (%d) != samples features (%d)"
            % (int(cshape[1]), features))
    ashape = getattr(assignments, "shape", None)
    if ashape is None or len(ashape) != 1:
        raise TypeError("assignments must be a 1D array")
    if int(ashape[0]) != n:
        raise KMTPUInvalidArguments(
            "assignments size (%d) != samples size (%d)" % (int(ashape[0]), n))
    if not isinstance(device, numbers.Integral) or int(device) < 0:
        raise TypeError("device must be a non-negative integer bitmask")
    return n, features, k, int(cshape[0])


def check_cosine_normalized(x_sq_probe) -> bool:
    """The reference probes 3 samples for unit L2 norm within
    [0.99999, 1.00001] before angular runs."""
    return bool(np.all(np.abs(np.asarray(x_sq_probe) - 1.0) <= 1e-5))
