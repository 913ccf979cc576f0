"""R binding of the port (r/kmtputorch), as tests/test_r.py tests r/kmtpu.

1. The testthat suite (r/kmtputorch/tests/test-kmtputorch.R) run with
   Rscript, on the CPU (``KMTPU_PLATFORM=cpu``) where there is no CUDA
   card; skipped where Rscript, testthat, reticulate or kmcuda_torch is
   missing.
2. The marshalling the R layer performs, checked from Python on CPU
   tensors from an imported start against ``kmeans_tpu`` / ``knn_tpu`` on
   the same start: list members rbind-ed, doubles to float32, 1-based ids
   both ways, and NA for the neighbours of a non-finite row, which arrive
   as -1 from an int32 tensor and as 0xFFFFFFFF from the JAX package's
   uint32 array.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from kmcuda_tpu import kmeans_tpu, knn_tpu
from kmcuda_torch import kmeans_torch, knn_torch

torch.set_num_threads(2)

R_TEST = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                      "r", "kmtputorch", "tests", "test-kmtputorch.R")


def _r_available():
    rscript = shutil.which("Rscript")
    if rscript is None:
        return None
    probe = subprocess.run(
        [rscript, "-e",
         "library(testthat); library(reticulate); "
         "stopifnot(reticulate::py_module_available('kmcuda_torch'))"],
        capture_output=True, timeout=120)
    return rscript if probe.returncode == 0 else None


def test_r_testthat_suite():
    rscript = _r_available()
    if rscript is None:
        pytest.skip("Rscript with testthat+reticulate+kmcuda_torch "
                    "not available")
    env = dict(os.environ)
    if not torch.cuda.is_available():
        env["KMTPU_PLATFORM"] = "cpu"
    res = subprocess.run([rscript, os.path.abspath(R_TEST)], env=env,
                         capture_output=True, text=True, timeout=1800)
    assert res.returncode == 0, res.stdout + res.stderr


def _one_based(ids):
    """What ``.one_based`` in r/kmtputorch/R/kmtputorch.R does: ids as
    doubles, the kNN sentinel (-1 or 0xFFFFFFFF) as NA (NaN here), + 1."""
    ids = np.asarray(ids).astype(np.float64)
    return np.where((ids < 0) | (ids >= 4294967295), np.nan, ids + 1)


@pytest.mark.parametrize("metric", ["L2", "cos"])
def test_r_contract_from_python(metric):
    rng = np.random.RandomState(42)
    parts = [rng.rand(3000, 4), rng.rand(3000, 4)]   # doubles, like R
    stacked = np.vstack(parts).astype(np.float32)    # .flatten_samples
    if metric == "cos":
        stacked /= np.linalg.norm(stacked, axis=1, keepdims=True)
    bad = [17, 4001]
    stacked[bad[0], 1] = np.nan
    stacked[bad[1]] = np.inf
    k = 20
    good = np.setdiff1d(np.arange(6000), bad)
    c0 = stacked[np.random.RandomState(5).choice(good, k, replace=False)]
    kw = dict(tolerance=0.01, yinyang_t=0, metric=metric)

    c, a = kmeans_torch(torch.from_numpy(stacked), k,
                        init=torch.from_numpy(c0), **kw)
    c_ref, a_ref = kmeans_tpu(stacked, k, init=c0, device=1, **kw)
    a_r = _one_based(a.numpy())                      # 1-based out
    np.testing.assert_array_equal(a_r, _one_based(a_ref))
    np.testing.assert_allclose(c.numpy(), c_ref, rtol=1e-5, atol=1e-6)
    assert (a_r[bad] == k + 1).all()
    assert a_r[good].min() >= 1 and a_r[good].max() <= k

    # knn: R hands back 1-based ids, the wrapper subtracts 1 (an int32
    # tensor on the CPU route) and maps the result back through .one_based
    nb = knn_torch(5, torch.from_numpy(stacked), c,
                   torch.from_numpy((a_r - 1).astype(np.int32)),
                   metric=metric)
    nb_ref = knn_tpu(5, stacked, c_ref, (a_r - 1).astype(np.uint32),
                     metric=metric, device=1)
    assert nb.dtype == torch.int32 and (nb.numpy()[bad] == -1).all()
    assert (np.asarray(nb_ref)[bad] == 0xFFFFFFFF).all()
    nb_r, nb_ref_r = _one_based(nb.numpy()), _one_based(nb_ref)
    assert np.isnan(nb_r[bad]).all() and np.isnan(nb_ref_r[bad]).all()
    assert not np.isnan(nb_r[good]).any()
    assert nb_r[good].min() >= 1 and nb_r[good].max() <= 6000
    assert not (nb_r == np.arange(1, 6001)[:, None]).any()
    differ = np.nonzero((nb_r[good] != nb_ref_r[good]).any(axis=1))[0]
    x64 = stacked.astype(np.float64)
    for r in good[differ]:                           # fp64 ties only
        d = [np.sort(np.linalg.norm(x64[(n[r] - 1).astype(np.int64)] - x64[r],
                                    axis=1)) for n in (nb_r, nb_ref_r)]
        np.testing.assert_allclose(d[0], d[1], rtol=1e-6)
