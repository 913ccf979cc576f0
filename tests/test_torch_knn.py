"""The port's public ``knn_cuda`` on CPU tensors against the JAX package's
``knn_tpu(..., device=1)``, on the cases of tests/test_knn.py, from the
same clustering (JAX's ``kmeans_tpu``, handed across as numpy).

On the CPU the port runs the walk's plain twin.  The JAX package pads n to
its device mesh (13,000 -> 14,336 rows on one device), the port pads
nothing, so the two layouts differ in size and the examined fractions
differ slightly; the neighbours do not.  Tolerance: neighbour lists equal
except where their fp64 distance profiles agree to rtol 1e-6 (ties), and
the sklearn tie budgets of tests/test_knn.py.
"""

import re

import numpy as np
import pytest
import torch
from scipy.spatial.distance import cdist
from sklearn.neighbors import NearestNeighbors

from kmcuda_tpu import kmeans_tpu, knn_tpu
from kmcuda_torch import config, knn_cuda
from kmcuda_torch.models import knn as TK

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def samples():
    """The blob mixture of tests/test_knn.py."""
    rng = np.random.RandomState(0)
    arr = np.empty((13000, 2), dtype=np.float32)
    arr[:2000] = rng.rand(2000, 2) + [0, 0.5]
    arr[2000:4000] = rng.rand(2000, 2) + [0, 1.5]
    arr[4000:6000] = rng.rand(2000, 2) - [0, 0.5]
    arr[6000:8000] = rng.rand(2000, 2) + [0.5, 0]
    arr[8000:10000] = rng.rand(2000, 2) - [0.5, 0]
    arr[10000:] = rng.rand(3000, 2) * 5 - [2, 2]
    return arr


@pytest.fixture(scope="module")
def clustered(samples):
    return kmeans_tpu(samples, 50, seed=777, tolerance=0.01, yinyang_t=0)


def _port(kn, x, c, a, **kw):
    """knn_cuda on CPU tensors; returns (neighbors as numpy int64, log)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        nb = knn_cuda(kn, torch.tensor(x), torch.tensor(c),
                      torch.from_numpy(np.asarray(a).astype(np.int32)), **kw)
    assert nb.dtype == torch.int32
    return nb.numpy().astype(np.int64), buf.getvalue()


def _fraction(log):
    return [float(m) for m in re.findall(r"^calculated (\S+) of all the "
                                         r"distances$", log, re.M)][-1]


def _assert_equal_off_ties(x, got, want):
    """Neighbour lists equal, except rows whose fp64 distance profiles
    agree to rtol 1e-6 (ties); returns the number of such rows."""
    want = np.asarray(want).astype(np.int64)
    want = np.where(want == 0xFFFFFFFF, -1, want)
    np.testing.assert_array_equal(got < 0, want < 0)
    bad = np.nonzero((got != want).any(axis=1))[0]
    x64 = x.astype(np.float64)
    for r in bad:
        dg = np.linalg.norm(x64[got[r]] - x64[r], axis=1)
        dw = np.linalg.norm(x64[want[r]] - x64[r], axis=1)
        np.testing.assert_allclose(np.sort(dg), np.sort(dw), rtol=1e-6)
    return len(bad)


def _sklearn(x, k):
    return NearestNeighbors(n_neighbors=k).fit(x).kneighbors()[1]


@pytest.fixture(scope="module")
def port10(samples, clustered):
    return _port(10, samples, *clustered, verbosity=1)


def test_small_k_matches_jax_and_sklearn(samples, clustered, port10):
    got, _log = port10
    assert got.shape == (13000, 10)
    _assert_equal_off_ties(samples, got,
                           knn_tpu(10, samples, *clustered, device=1))
    assert (got != _sklearn(samples, 10)).sum() <= 4   # tie budget


def test_no_self(port10):
    got, _log = port10
    assert not (got == np.arange(len(got))[:, None]).any()


def test_examined_fraction_golden(port10):
    """The 13K fixture's examined fraction stays in the JAX package's
    golden band (tests/test_knn.py: 0.286 +- 0.03)."""
    assert _fraction(port10[1]) == pytest.approx(0.286, abs=0.03)


def test_bad_k(samples, clustered):
    x = torch.tensor(samples)
    c, a = torch.tensor(clustered[0]), torch.tensor(
        clustered[1].astype(np.int32))
    with pytest.raises(ValueError):
        knn_cuda(0, x, c, a)
    with pytest.raises(ValueError):
        knn_cuda(13000, x, c, a)
    with pytest.raises(TypeError):
        knn_cuda("ten", x, c, a)
    with pytest.raises(TypeError):
        knn_cuda(3, x, c, a[:, None])


def test_query_batching_invariant(samples, clustered, port10, monkeypatch):
    monkeypatch.setattr(config, "KNN_QUERY_BATCH", 1024)
    got, log = _port(10, samples, *clustered, verbosity=1)
    np.testing.assert_array_equal(got, port10[0])
    assert _fraction(log) == _fraction(port10[1])


def test_k_exceeds_cluster_size():
    """256 neighbours from clusters of 200: kk = 384, past the TPU
    kernel's 256, and every query needs several clusters."""
    rng = np.random.RandomState(1)
    x = np.concatenate([rng.rand(200, 2) + [3 * i, 0] for i in range(30)]
                       ).astype(np.float32)
    c, a = kmeans_tpu(x, 30, seed=2, tolerance=0.01, yinyang_t=0)
    got, _log = _port(256, x, c, a)
    _assert_equal_off_ties(x, got, knn_tpu(256, x, c, a, device=1))


def test_duplicate_ties_grouped_walk():
    """Exact lowest-id tie-break under a grouped walk: 50 copies of each of
    100 points, so every neighbour list is all ties; the result must be the
    (distance, id)-lexicographic brute force."""
    rng = np.random.RandomState(9)
    x = np.repeat(rng.rand(100, 3).astype(np.float32) * 4.0, 50, axis=0)
    x = x[rng.permutation(len(x))]
    c, a = kmeans_tpu(x, 20, seed=3, tolerance=0.01, yinyang_t=0)
    tile_m = TK._pick_tile_m(len(x), 20)
    n_tiles = -(-(len(x) + tile_m) // tile_m)
    assert min(config.KNN_TILE_GROUP_ROWS // tile_m, n_tiles // 16) > 1
    got, _log = _port(12, x, c, a)
    d = cdist(x, x)
    np.fill_diagonal(d, np.inf)
    np.testing.assert_array_equal(
        got, np.argsort(d, axis=1, kind="stable")[:, :12])


def test_nan_rows_sentinel(samples, clustered):
    x = samples.copy()
    x[7] = np.nan
    x[4242, 0] = np.inf
    c, a = clustered
    got, _log = _port(5, x, c, a)
    assert (got[7] == -1).all() and (got[4242] == -1).all()
    valid = np.ones(len(x), bool)
    valid[[7, 4242]] = False
    assert (got[valid] >= 0).all()
    assert not np.isin(got[valid], [7, 4242]).any()
    want = knn_tpu(5, x, c, a, device=1)
    xc = np.where(np.isfinite(x), x, 0)
    _assert_equal_off_ties(xc, got, want)


def test_cosine_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(3000, 8).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    c, a = kmeans_tpu(x, 16, seed=7, metric="cos", tolerance=0.01,
                      yinyang_t=0, device=1)
    got, _log = _port(5, x, c, a, metric="cos")
    want = np.asarray(knn_tpu(5, x, c, a, metric="cos", device=1))
    # the rescore's angles tie where the L2 chords do
    _assert_equal_off_ties(x, got, want)


def test_fp16_input_bf16_storage(samples):
    """fp16 input runs with bf16 storage: the sorted distance profile over
    the bf16-rounded values equals brute force's (bf16 puts this 2D
    fixture on a coarse grid, full of exact ties)."""
    x16 = samples.astype(np.float16)
    c, a = kmeans_tpu(x16, 50, seed=777, tolerance=0.01, yinyang_t=0)
    nb = knn_cuda(10, torch.from_numpy(x16), torch.tensor(c),
                  torch.from_numpy(a.astype(np.int32)))
    xb = torch.from_numpy(x16).to(torch.bfloat16).float().numpy()
    rows = np.arange(len(xb))[:, None]
    d_got = np.linalg.norm(xb[rows] - xb[nb.numpy()], axis=2)
    d_ref = np.linalg.norm(xb[rows] - xb[_sklearn(xb, 10)], axis=2)
    np.testing.assert_allclose(np.sort(d_got, 1), np.sort(d_ref, 1),
                               rtol=1e-3, atol=1e-5)


def test_brute_force_below_two_lanes_matches_jax():
    """Under 2 * 128 samples both packages search by brute force."""
    rng = np.random.RandomState(4)
    x = rng.rand(200, 5).astype(np.float32)
    c, a = kmeans_tpu(x, 4, seed=1, tolerance=0.01, yinyang_t=0)
    got, log = _port(6, x, c, a, verbosity=1)
    assert _fraction(log) == 1.0
    _assert_equal_off_ties(x, got, knn_tpu(6, x, c, a, device=1))


def test_tensor_and_numpy_io(samples, clustered, monkeypatch):
    """A tensor gets an int32 tensor (-1 sentinel); a numpy array gets
    uint32 numpy (0xFFFFFFFF) — here run on the CPU by handing the call
    the CPU device the bitmask would pick on a card."""
    from kmcuda_torch.parallel import devices

    x = samples[:3000].copy()
    x[3] = np.nan
    c, a = clustered[0], clustered[1][:3000]
    monkeypatch.setattr(devices, "select_devices",
                        lambda *_a, **_k: [torch.device("cpu")])
    out = knn_cuda(4, x, c, a)
    assert isinstance(out, np.ndarray) and out.dtype == np.uint32
    assert (out[3] == 0xFFFFFFFF).all()
    t = knn_cuda(4, torch.from_numpy(x), torch.tensor(c),
                 torch.from_numpy(a.astype(np.int32)))
    assert t.dtype == torch.int32 and (t[3] == -1).all()
    np.testing.assert_array_equal(out.astype(np.int64),
                                  t.numpy().astype(np.uint32))
