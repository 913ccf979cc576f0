"""The JAX package's scale tier (tests/test_scale.py) in the port.

- Size math (the counterpart of tests/test_scale.py:73) at the reference's
  overflow shape, 167,772,160 x 8 fp32 with k=50, at bench.py's 8,000,000
  x 256 bf16 with k=1024, and at 9,000,000 x 256 bf16, past 2**31
  elements: validation passes the shape through unclipped (the row cut
  at the overflow shape is in ``test_torch_multidevice.py``), and the
  segment sum's cut stays within int32 scratch, within its chunk cap and equal to the scratch its kernel counts
  for itself (``csrc/segment.cu:launch_segment``).  A row count of 2**31
  or more, where the segment sum's int32 row ids would wrap, is refused
  before any launch, by the one limit ``config.MAX_SAMPLES``.
- k=16,384 kNN (tests/test_scale.py:97), past ``KNN_TOUR_MAX_K``, so the
  projection-sort relabel runs, with no threshold patched: ``knn_cuda`` on
  CPU tensors gives ``knn_tpu``'s neighbours up to fp64 distance ties
  (rtol 1e-5, as the JAX test) and sklearn's distances.  The JAX fixture
  has 2 k rows; here n = 6144 rows of it, k stays 16,384: at this k about
  half of all distances are examined, so the CPU walk's time grows as n^2.
- k=2048 with Yinyang (tests/test_scale.py:136): from one imported start
  (2048 rows of the fixture picked by RandomState(2)) the port and
  ``kmeans_tpu`` give identical assignments and iteration lines, centroids
  within rtol 1e-5 / atol 1e-6, and the port's Yinyang equals its Lloyd
  bitwise.  The 3 iterations hold one dense refresh, which filters no
  row; run on to convergence from the same start, later sparse iterations
  filter rows and Yinyang still equals Lloyd.
- The reference's overflow run itself (tests/test_scale.py:35) on the
  card, marked ``gpu``; it skips without a CUDA device.  JAX is imported
  inside the CPU tests only, so on a machine without it the card test runs
  alone: ``python -m pytest --noconftest -q -m gpu tests/test_torch_scale.py``.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from kmcuda_torch import KMTPUInvalidArguments, config, kmeans_cuda, knn_cuda
from kmcuda_torch.models import knn as TK
from kmcuda_torch.ops import assign_kernels as K
from kmcuda_torch.ops import distance as D
from kmcuda_torch.utils import validation as V

torch.set_num_threads(2)

REF_N, REF_F, REF_K = 167_772_160, 8, 50     # tests/test_scale.py:27, :43
#: (n, f, k, itemsize) of the scale runs: the reference's overflow run,
#: bench.py's 8M config and a run past 2**31 elements
SCALE_SHAPES = {
    "overflow_167m_fp32": (REF_N, REF_F, REF_K, 4),
    "bench_8m_bf16": (8_000_000, 256, 1024, 2),
    "past_2_31_9m_bf16": (9_000_000, 256, 1024, 2),
}
#: rows of the k=16,384 kNN fixture (the JAX test's 2 k, cut; k is not)
KNN_ROWS = 6144


class _Shape:
    """What validation reads of a sample matrix: its shape."""

    def __init__(self, *shape):
        self.shape = shape
        self.dtype = np.float32


def test_size_math_beyond_uint32():
    n, features, clusters = V.check_kmeans_args(
        _Shape(REF_N, REF_F), clusters=REF_K, tolerance=0.142,
        yinyang_t=0.0, seed=3, device=0)
    assert (n, features, clusters) == (REF_N, REF_F, REF_K)
    assert n * features * 4 > 2**32           # bytes: the point of the run


@pytest.mark.parametrize("shape", SCALE_SHAPES.values(),
                         ids=SCALE_SHAPES.keys())
def test_segment_plan_at_scale(shape):
    n, f, k, itemsize = shape
    plan = K.segment_plan(n, f, k, itemsize)
    nb = -(-n // plan.rows)
    nchunks = -(-n // plan.chunk)
    # the scratch launch_segment counts for itself and refuses less of
    assert plan.int_scratch == k * nb + k + 1 + 2 * n
    assert plan.float_scratch == 2 * nchunks * f
    assert plan.int_scratch < 2**31
    assert nchunks <= K.SEGMENT_MAX_CHUNKS
    # the cut launch_segment takes: rows >= k in warps, tx divides the
    # block, feature slabs and chunk groups within the grid's limits
    assert plan.rows >= k and plan.rows % 32 == 0
    assert plan.chunk >= K.SEGMENT_MIN_CHUNK
    assert K.SEGMENT_THREADS % plan.tx == 0
    assert -(-f // (plan.tx * (16 // itemsize))) <= 65535
    assert -(-nchunks // (K.SEGMENT_THREADS // plan.tx)) <= 0x7fffffff
    assert n <= config.MAX_SAMPLES


def test_rows_past_int32_refused_before_any_launch():
    big = 2**31
    with pytest.raises(KMTPUInvalidArguments, match="int32"):
        V.check_kmeans_args(_Shape(big, REF_F), clusters=REF_K,
                            tolerance=0.142, yinyang_t=0.0, seed=3, device=0)
    with pytest.raises(KMTPUInvalidArguments, match="int32"):
        V.check_knn_args(4, _Shape(big, REF_F), _Shape(REF_K, REF_F),
                         _Shape(big), 0)
    assert V.check_samples(_Shape(big - 1, REF_F)) == (big - 1, REF_F)
    K.reset_launch_counts()
    # meta tensors: shapes without memory; the public calls and the
    # kernel wrappers refuse them on their row count alone
    x = torch.empty((big, REF_F), device="meta")
    with pytest.raises(KMTPUInvalidArguments, match="int32"):
        kmeans_cuda(x, REF_K, tolerance=0.142, yinyang_t=0, seed=3)
    with pytest.raises(KMTPUInvalidArguments, match="int32"):
        knn_cuda(4, x, torch.empty((REF_K, REF_F), device="meta"),
                 torch.empty((big,), dtype=torch.int32, device="meta"))
    for rows, words in ((big, "int32"), (big - 1, "unsupported device")):
        args = (torch.empty((rows, REF_F), device="meta"),
                torch.empty((rows,), dtype=torch.bool, device="meta"),
                torch.empty((rows,), dtype=torch.int32, device="meta"),
                torch.empty((REF_K, REF_F), device="meta"))
        for fn in (K.fused_lloyd_pass, K.assign_only_pass):
            with pytest.raises(KMTPUInvalidArguments, match=words):
                fn(*args, n_clusters=REF_K, metric=D.DistanceMetric.L2)
    assert K.LAUNCHES == {name: 0 for name in K.LAUNCHES}


@pytest.mark.parametrize("call", ["fused_lloyd_pass", "assign_only_pass",
                                  "kmeans_cuda"])
def test_row_limit_is_config_max_samples(call, monkeypatch):
    """The wrappers and the public call read the row limit from
    ``config.MAX_SAMPLES`` alone: lowered, it refuses one row more and
    takes the limit itself."""
    monkeypatch.setattr(config, "MAX_SAMPLES", 99)
    rng = np.random.RandomState(0)
    c = torch.from_numpy(rng.rand(3, 4).astype(np.float32))

    def run(n):
        x = torch.from_numpy(rng.rand(n, 4).astype(np.float32))
        if call == "kmeans_cuda":
            return kmeans_cuda(x, 3, init=c, tolerance=0.0, yinyang_t=0,
                               max_iterations=1)
        return getattr(K, call)(
            x, torch.ones(n, dtype=torch.bool),
            torch.zeros(n, dtype=torch.int32), c, n_clusters=3,
            metric=D.DistanceMetric.L2)

    with pytest.raises(KMTPUInvalidArguments, match="int32"):
        run(100)
    assert run(99)[1].shape == (99,)


@pytest.fixture(scope="module")
def large_k():
    """tests/test_scale.py:104-115's fixture at KNN_ROWS rows: k=16,384
    centroids on a grid times 100, rows at a random centroid plus 0.05
    noise, each assigned its true nearest centroid."""
    k, f = 16384, 8
    rng = np.random.RandomState(7)
    cents = rng.rand(k, f).astype(np.float32) * 100.0
    which = rng.randint(0, k, size=KNN_ROWS)
    x = (cents[which] + 0.05 * rng.randn(KNN_ROWS, f)).astype(np.float32)
    d2 = ((x ** 2).sum(1)[:, None] - 2.0 * x @ cents.T
          + (cents ** 2).sum(1)[None, :])
    return x, cents, np.argmin(d2, axis=1)


def test_knn_16k_clusters_exact(large_k, monkeypatch):
    """knn_cuda against knn_tpu and sklearn, with the projection relabel
    taken (a spy counts it) and the greedy tour not."""
    from sklearn.neighbors import NearestNeighbors

    from kmcuda_tpu import config as jconfig
    from kmcuda_tpu import knn_tpu

    x, cents, a = large_k
    k, kn = cents.shape[0], 4
    assert k > config.KNN_TOUR_MAX_K and k > jconfig.KNN_TOUR_MAX_K
    taken = []

    def spy(name):
        real = getattr(TK, name)

        def counted(*args):
            taken.append(name)
            return real(*args)
        monkeypatch.setattr(TK, name, counted)

    spy("_proj_relabel")
    spy("_tour_relabel")
    got = knn_cuda(kn, torch.from_numpy(x), torch.from_numpy(cents),
                   torch.from_numpy(a.astype(np.int32))).numpy()
    assert taken == ["_proj_relabel"]
    want = np.asarray(knn_tpu(kn, x, cents, a.astype(np.uint32),
                              device=1)).astype(np.int64)
    assert got.min() >= 0 and got.max() < len(x)
    assert (got != np.arange(len(x))[:, None]).all()
    x64 = x.astype(np.float64)
    for r in np.nonzero((got != want).any(axis=1))[0]:
        np.testing.assert_allclose(
            np.sort(np.linalg.norm(x64[got[r]] - x64[r], axis=1)),
            np.sort(np.linalg.norm(x64[want[r]] - x64[r], axis=1)),
            rtol=1e-5)
    _, ref_i = NearestNeighbors(n_neighbors=kn + 1).fit(x).kneighbors(x)
    dref = np.linalg.norm(x[:, None, :] - x[ref_i[:, 1:]], axis=2)
    dgot = np.linalg.norm(x[:, None, :] - x[got], axis=2)
    np.testing.assert_allclose(np.sort(dgot, 1), np.sort(dref, 1),
                               rtol=1e-5, atol=1e-5)


@pytest.fixture
def pinned_controller(monkeypatch):
    """The wall-clock controller pinned to "never gate, never revoke", as
    tests/conftest.py pins the JAX package's: a 3-iteration budget would
    otherwise hand the run to Lloyd before any grouping."""
    monkeypatch.setattr(config, "YY_MIN_REMAINING", 0)
    monkeypatch.setattr(config, "YY_BAILOUT_MARGIN", float("inf"))


def _iteration_lines(log):
    return [l for l in log.splitlines() if l.startswith("iteration ")]


def _port_kmeans(x, c0, **kw):
    kw = {"tolerance": 0.01, "max_iterations": 3, **kw}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        c, a = kmeans_cuda(torch.from_numpy(x), c0.shape[0],
                           init=torch.from_numpy(c0), **kw)
    return c.numpy(), a.numpy(), buf.getvalue()


@pytest.fixture(scope="module")
def large_k_kmeans():
    """tests/test_scale.py:144's samples and one imported start of 2048."""
    x = np.random.RandomState(0).rand(8192, 32).astype(np.float32)
    return x, x[np.random.RandomState(2).choice(8192, 2048, replace=False)]


def test_large_k_yinyang_matches_jax(large_k_kmeans, pinned_controller):
    from kmcuda_tpu import kmeans_tpu

    x, c0 = large_k_kmeans
    c, a, log = _port_kmeans(x, c0, yinyang_t=0.1, verbosity=2)
    assert "yinyang: group capacity" in log     # 204 groups of 2048
    assert "samples passed the global filter" in log   # the loop ran
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cj, aj = kmeans_tpu(x, 2048, init=c0, tolerance=0.01, yinyang_t=0.1,
                            max_iterations=3, verbosity=1, device=1)
    assert _iteration_lines(log) == _iteration_lines(buf.getvalue())
    assert len(_iteration_lines(log)) == 3
    np.testing.assert_array_equal(a, np.asarray(aj).astype(np.int64))
    np.testing.assert_allclose(c, np.asarray(cj), rtol=1e-5, atol=1e-6)
    assert len(np.unique(a)) > 1024            # the JAX test's fill check


@pytest.mark.parametrize("iterations, tolerance", [(3, 0.01), (8, 0.0)],
                         ids=["jax_test", "sparse"])
def test_large_k_yinyang_equals_lloyd(large_k_kmeans, pinned_controller,
                                      iterations, tolerance):
    x, c0 = large_k_kmeans
    kw = dict(tolerance=tolerance, max_iterations=iterations)
    c_yy, a_yy, log_yy = _port_kmeans(x, c0, yinyang_t=0.1, verbosity=2,
                                      **kw)
    c_ll, a_ll, log_ll = _port_kmeans(x, c0, yinyang_t=0, verbosity=1, **kw)
    passed = [int(l.split()[3]) for l in log_yy.splitlines()
              if l.endswith(" samples passed the global filter")]
    if iterations > 3:                      # a sparse iteration filtered
        assert passed and min(passed) < len(x)
    assert "yinyang: group capacity" in log_yy
    assert _iteration_lines(log_yy) == _iteration_lines(log_ll)
    np.testing.assert_array_equal(a_yy, a_ll)
    np.testing.assert_array_equal(c_yy, c_ll)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    D.disable_tf32()
    return torch.device("cuda")


def overflow_samples(device, seed=3):
    """tests/test_scale.py:44-57's samples on ``device``: 40 blobs, centers
    U(0, 1) * 8, plus 0.3 N(0, 1), made in 8 slabs into one buffer."""
    g = torch.Generator(device=device).manual_seed(seed)
    centers = torch.rand(40, REF_F, generator=g, device=device) * 8.0
    x = torch.empty((REF_N, REF_F), device=device)
    slab = REF_N // 8
    for i in range(8):
        which = torch.randint(0, 40, (slab,), generator=g, device=device)
        x[i * slab:(i + 1) * slab] = centers[which] + 0.3 * torch.randn(
            slab, REF_F, generator=g, device=device)
    return x


@pytest.mark.gpu
def test_uint32_overflow_lloyd(cuda):
    """The reference's configuration: 167,772,160 x 8 @ k=50, k-means++
    seed 3, tolerance 0.142.  More than 2**32 bytes flow through the row
    cut, the kernels and the segment sum's scratch unclipped; assignments
    stay in range and centroids come back finite."""
    x = overflow_samples(cuda)
    assert x.nbytes > 2**32
    c, a = kmeans_cuda(x, REF_K, init="k-means++", seed=3, tolerance=0.142,
                       yinyang_t=0, verbosity=1, donate_samples=True)
    assert c.shape == (REF_K, REF_F) and a.shape == (REF_N,)
    assert int(a.min()) >= 0 and int(a.max()) < REF_K
    assert bool(torch.isfinite(c).all())
