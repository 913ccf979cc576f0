"""The port's multi-device path (``kmcuda_torch.parallel.devices``) on
logical CPU shards.

``Topology([cpu] * d)`` cuts the samples into d contiguous row shards on
one device, the port's counterpart of the JAX suite's 8-device CPU mesh
(tests/conftest.py).  The public calls reach it through the device mask:
``select_devices`` is replaced by one that returns d CPU devices, and a
numpy input with mask 0 then runs over all of them.

Tolerances: at d = 8 against ``kmeans_tpu(..., device=0)`` on the 8
virtual devices, from one imported start on the separated set, the rule
of tests/test_torch_kmeans.py (identical assignments and iteration
lines, centroids within rtol 1e-5 / atol 1e-6).  Across device counts the
centroid sums are added in another order, so the contract is the JAX
suite's behavioural one (tests/test_kmeans.py:277-309): iteration counts
within 1, at most 0.2% of the assignments differ, centroids of the
clusters assigned alike within rtol 1e-4 / atol 1e-5.  Bitwise: one shard
against the tensor call, reruns at one d, Yinyang against Lloyd at a
ragged d = 3 (and in bf16 storage at d = 1 and 3), the init's picks at d = 2 and 3, and the kNN neighbours at
every d (a query chunk's search does not depend on the cut).
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from kmcuda_tpu import kmeans_tpu, knn_tpu
from kmcuda_torch import config, kmeans_cuda, knn_cuda
from kmcuda_torch.models import initialization as I
from kmcuda_torch.models import lloyd as L
from kmcuda_torch.models.problem import prepare
from kmcuda_torch.ops import assign as A
from kmcuda_torch.ops.distance import DistanceMetric
from kmcuda_torch.parallel import devices
from kmcuda_torch.parallel.devices import Topology
from kmcuda_torch.utils.logging import Logger

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def pinned_controller(monkeypatch):
    """Pin the Yinyang controller to "never gate, never revoke", as
    tests/conftest.py pins the JAX package's."""
    monkeypatch.setattr(config, "YY_MIN_REMAINING", 0)
    monkeypatch.setattr(config, "YY_BAILOUT_MARGIN", float("inf"))


@pytest.fixture(scope="module")
def samples():
    """The blob mixture of tests/test_kmeans.py."""
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
def separated():
    """4096 x 16: 32 well-separated blobs (tests/test_torch_kmeans.py)."""
    rng = np.random.RandomState(1)
    centers = rng.rand(32, 16).astype(np.float32) * 20
    which = rng.randint(0, 32, size=4096)
    return (centers[which]
            + 0.1 * rng.randn(4096, 16)).astype(np.float32)


def _start(x, k, seed):
    return x[np.random.RandomState(seed).choice(len(x), k, replace=False)]


def _lines(out, prefix="iteration "):
    return [l for l in out.splitlines() if l.startswith(prefix)]


def _shards(monkeypatch, d):
    """Make the mask select d logical CPU devices."""
    monkeypatch.setattr(devices, "select_devices",
                        lambda mask, logger=None: [CPU] * d)


def _kmeans(monkeypatch, x, k, d, **kw):
    """The public call on numpy input over d logical CPU shards; returns
    ((centroids, assignments[, average]), log)."""
    _shards(monkeypatch, d)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = kmeans_cuda(x, k, **dict(dict(verbosity=1), **kw))
    return out, buf.getvalue()


def _assert_contract(one, many):
    """tests/test_kmeans.py:277-309's cross-device-count contract."""
    (c1, a1), log1 = one
    (cd, ad), logd = many
    assert abs(len(_lines(log1)) - len(_lines(logd))) <= 1
    assert np.sum(a1 != ad) <= 0.002 * len(a1)
    match = np.isclose(c1, cd, rtol=1e-4, atol=1e-5).all(axis=1)
    assert match.sum() >= len(c1) - 2, match.sum()


@pytest.mark.parametrize("yinyang_t,metric", [(0.0, "L2"), (0.1, "L2"),
                                               (0.0, "cos")])
def test_eight_shard_parity_with_the_jax_mesh(separated, capsys,
                                              monkeypatch, yinyang_t,
                                              metric):
    """Tolerance 0 runs the Yinyang case into its sparse iterations."""
    x = separated
    if metric == "cos":
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
    c0 = _start(x, 32, 3)
    kw = dict(tolerance=0.0, yinyang_t=yinyang_t, verbosity=2,
              metric=metric)
    want = kmeans_tpu(x, 32, init=c0, device=0, **kw)
    want_log = _lines(capsys.readouterr().out)
    got, log = _kmeans(monkeypatch, x, 32, 8, init=c0, **kw)
    assert _lines(log) == want_log and len(want_log) > 5
    assert ("sparse keep iteration" in log) == (yinyang_t > 0)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d", [2, 3, 8])
def test_device_count_contract(samples, monkeypatch, d):
    kw = dict(init="kmeans++", seed=3, tolerance=0.01, yinyang_t=0)
    _assert_contract(_kmeans(monkeypatch, samples, 50, 1, **kw),
                     _kmeans(monkeypatch, samples, 50, d, **kw))


@pytest.mark.parametrize("package,seed", [("jax", 3), ("torch", 1)])
def test_whole_runs_part_on_uniform_data(capsys, monkeypatch, package,
                                         seed):
    """The contract above is stated for the blob mixture, not for uniform
    data: there a row on a knife edge between two centroids flips with the
    last bit of their sums, and the runs then part by the order in which
    the shards' sums are added.  From one imported k-means++ start on
    20,000 x 32 U(0, 1) rows, k=256, the JAX package's 8-device run and
    the port's 8 shards each follow one device's iteration lines over the
    first 3 iterations, then part, and end more than 0.2% of the rows
    apart.  Each package parts on other seeds (their sum orders differ);
    the seeds here are ones where it does."""
    n, f, k = 20_000, 32, 256
    x = np.random.RandomState(seed).rand(n, f).astype(np.float32)
    p = prepare(torch.from_numpy(x), k, DistanceMetric.L2, CPU, Logger(0))
    start = I.init_centroids(p, I.InitMethod.PLUS_PLUS, 1).numpy()
    kw = dict(init=start, tolerance=0.002, yinyang_t=0, verbosity=1)
    if package == "jax":
        runs = []
        for device in (1, 0):
            _c, a = kmeans_tpu(x, k, device=device, **kw)
            runs.append((a, _lines(capsys.readouterr().out)))
    else:
        runs = [(out[1], _lines(log)) for out, log in (
            _kmeans(monkeypatch, x, k, d, **kw) for d in (1, 8))]
    (a1, lines1), (a8, lines8) = runs
    assert lines1[:3] == lines8[:3]
    assert lines1 != lines8
    assert np.sum(a1 != a8) > 0.002 * n


def test_one_shard_is_the_tensor_call(samples, monkeypatch):
    kw = dict(init="kmeans++", seed=3, tolerance=0.01, verbosity=1)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        c, a = kmeans_cuda(torch.from_numpy(samples), 50, **kw)
    (c1, a1), log = _kmeans(monkeypatch, samples, 50, 1, **kw)
    assert log == buf.getvalue()
    np.testing.assert_array_equal(c1, c.numpy())
    np.testing.assert_array_equal(a1, a.numpy().astype(np.uint32))


def test_reruns_repeat_bitwise(samples, monkeypatch):
    kw = dict(init="kmeans++", seed=5, tolerance=0.01, average_distance=True)
    (c1, a1, d1), log1 = _kmeans(monkeypatch, samples, 50, 3, **kw)
    (c2, a2, d2), log2 = _kmeans(monkeypatch, samples, 50, 3, **kw)
    assert log1 == log2 and d1 == d2
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(a1, a2)


def test_yinyang_equals_lloyd_on_ragged_shards(samples, monkeypatch):
    """d = 3 cuts 13,000 rows 4334 / 4333 / 4333; the Yinyang loop runs
    (its per-iteration lines) and gives Lloyd's results bitwise, with
    invalid rows in two shards."""
    x = samples.copy()
    x[[5, 9000]] = np.nan
    kw = dict(init="kmeans++", seed=4, tolerance=0.002, verbosity=2)
    (cy, ay), logy = _kmeans(monkeypatch, x, 50, 3, yinyang_t=0.1, **kw)
    (cl, al), logl = _kmeans(monkeypatch, x, 50, 3, yinyang_t=0, **kw)
    assert (ay[[5, 9000]] == 50).all()
    assert "passed the global filter" in logy
    assert _lines(logy, "plan: ") == [
        "plan: cpu rows [0, 4334) (1 chunks, 0.0 MB samples)",
        "plan: cpu rows [4334, 8667) (1 chunks, 0.0 MB samples)",
        "plan: cpu rows [8667, 13000) (1 chunks, 0.0 MB samples)"]
    assert _lines(logy) == _lines(logl)
    np.testing.assert_array_equal(cy, cl)
    np.testing.assert_array_equal(ay, al)


@pytest.mark.parametrize("d", [1, 3])
def test_bf16_yinyang_equals_lloyd_on_ragged_shards(samples, monkeypatch,
                                                    d):
    """The ragged case above as fp16 input (bf16 storage): each shard's
    bounds carry the bf16 panel's envelope, so Yinyang gives Lloyd's
    results bitwise at one shard and at three."""
    x = samples.copy()
    x[[5, 9000]] = np.nan
    x = x.astype(np.float16)
    kw = dict(init="kmeans++", seed=4, tolerance=0.002, verbosity=2)
    (cy, ay), logy = _kmeans(monkeypatch, x, 50, d, yinyang_t=0.1, **kw)
    (cl, al), logl = _kmeans(monkeypatch, x, 50, d, yinyang_t=0, **kw)
    assert cy.dtype == np.float16 and (ay[[5, 9000]] == 50).all()
    assert "passed the global filter" in logy
    assert len(_lines(logy, "plan: ")) == d
    assert _lines(logy) == _lines(logl)
    np.testing.assert_array_equal(cy, cl)
    np.testing.assert_array_equal(ay, al)


def test_bf16_shards_follow_one_device_over_the_first_iterations(
        samples, monkeypatch):
    """fp16 input (bf16 storage) from one imported start: the first
    assignment depends only on each row and the start, so d = 3 gives
    d = 1's bitwise, through the loop and through the public call; the
    first update's counts are equal and its centroids differ by the order
    of the fp32 sums only (rtol 1e-5).  The next iterations score against
    those centroids rounded to bf16, so a last-bit difference can move a
    panel entry by a bf16 step: they are held to the contract."""
    x16 = samples.astype(np.float16)
    c0 = _start(samples, 50, 2)
    steps = {}
    for d in (1, 3):
        p = prepare(torch.from_numpy(x16), 50, DistanceMetric.L2,
                    Topology([CPU] * d), Logger(0))
        assert p.dtype == torch.bfloat16 and len(p.shards) == d
        loop = A.lloyd_run(p.xs, p.valids, p.assign0s, torch.from_numpy(c0),
                           n_clusters=50, metric=DistanceMetric.L2)
        steps[d] = [next(loop) for _ in range(3)]
        loop.close()
    one, many = steps[1], steps[3]
    assert torch.equal(torch.cat(many[0].assign), torch.cat(one[0].assign))
    assert many[0].changed == one[0].changed
    assert torch.equal(many[0].counts, one[0].counts)
    torch.testing.assert_close(many[0].c_next, one[0].c_next, rtol=1e-5,
                               atol=1e-6)
    for s1, s3 in zip(one[1:], many[1:]):
        a1, a3 = torch.cat(s1.assign), torch.cat(s3.assign)
        assert int((a1 != a3).sum()) <= 0.002 * a1.numel()
        close = torch.isclose(s3.c_next, s1.c_next, rtol=1e-4, atol=1e-5)
        assert int(close.all(dim=1).sum()) >= 48
    kw = dict(init=c0, tolerance=0.0, yinyang_t=0, max_iterations=1)
    (c1, a1), _ = _kmeans(monkeypatch, x16, 50, 1, **kw)
    (c3, a3), _ = _kmeans(monkeypatch, x16, 50, 3, **kw)
    assert c3.dtype == np.float16
    np.testing.assert_array_equal(a3, a1)
    np.testing.assert_array_equal(c3, c1)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("method,m", [(I.InitMethod.RANDOM, 0),
                                      (I.InitMethod.PLUS_PLUS, 0),
                                      (I.InitMethod.AFKMC2, 50)])
def test_init_picks_the_rows_of_one_device(samples, d, method, m):
    x = samples.copy()
    x[[7, 4500, 12999]] = np.nan    # invalid rows in the first and last shard

    def init(topo):
        p = prepare(torch.from_numpy(x), 50, DistanceMetric.L2, topo,
                    Logger(0))
        return I.init_centroids(p, method, 11, afkmc2_m=m)

    one = init(CPU)
    many = init(Topology([CPU] * d))
    assert torch.equal(one, many)
    assert bool(torch.isfinite(one).all())


def test_average_distance_over_shards(samples):
    """The same centroids and assignments on one and on three shards."""
    def problem(where):
        return prepare(torch.from_numpy(samples), 50, DistanceMetric.L2,
                       where, Logger(0))

    p1, p3 = problem(CPU), problem(Topology([CPU] * 3))
    c, a = L.run(p1, torch.from_numpy(_start(samples, 50, 2)), p1.assign0,
                 0.01)[:2]
    d1 = L.mean_assigned_distance(p1, c, a)
    d3 = L.mean_assigned_distance(p3, c, a)
    assert d3 == pytest.approx(d1, rel=1e-6)
    d64 = np.linalg.norm(samples.astype(np.float64)
                         - c.numpy().astype(np.float64)[a.numpy()], axis=1)
    assert d3 == pytest.approx(float(d64.mean()), rel=1e-5)


@pytest.fixture(scope="module")
def knn_case(samples):
    """A clustering of the blob mixture and the JAX package's 10-NN over
    its 8 virtual devices."""
    c, a = kmeans_tpu(samples, 50, seed=777, tolerance=0.01, yinyang_t=0)
    return c, a, knn_tpu(10, samples, c, a, device=0)


def _knn(monkeypatch, d, x, c, a):
    _shards(monkeypatch, d)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        nb = knn_cuda(10, x, c, a, verbosity=1)
    return nb, _lines(buf.getvalue(), "calculated")


@pytest.mark.parametrize("d", [2, 3, 8])
def test_knn_shards(samples, knn_case, monkeypatch, d):
    c, a, want = knn_case
    one, frac1 = _knn(monkeypatch, 1, samples, c, a)
    many, frac = _knn(monkeypatch, d, samples, c, a)
    assert many.dtype == np.uint32 and frac == frac1
    np.testing.assert_array_equal(many, one)
    x64 = samples.astype(np.float64)
    for r in np.nonzero((many != want).any(axis=1))[0]:
        dg = np.linalg.norm(x64[many[r]] - x64[r], axis=1)
        dw = np.linalg.norm(x64[want[r]] - x64[r], axis=1)
        np.testing.assert_allclose(np.sort(dg), np.sort(dw), rtol=1e-6)


def test_public_calls_over_three_devices(separated, monkeypatch, capsys):
    """numpy in, numpy out over three devices: one plan line per shard,
    one memory line per distinct device; the separated set's assignments
    and neighbours are the one-device call's."""
    x = separated
    c0 = _start(x, 32, 3)
    kw = dict(init=c0, tolerance=0.01, yinyang_t=0)
    c1, a1 = kmeans_cuda(torch.from_numpy(x), 32, **kw)
    nb1 = knn_cuda(8, torch.from_numpy(x), c1, a1)
    _shards(monkeypatch, 3)
    c3, a3 = kmeans_cuda(x, 32, verbosity=2, **kw)
    out = capsys.readouterr().out.splitlines()
    assert len([l for l in out if l.startswith("plan: ")]) == 3
    assert out.count("cpu: memory stats n/a") == 1
    assert isinstance(a3, np.ndarray) and a3.dtype == np.uint32
    np.testing.assert_array_equal(a3, a1.numpy())
    np.testing.assert_allclose(c3, c1.numpy(), rtol=1e-5, atol=1e-6)
    nb3 = knn_cuda(8, x, c3, a3)
    assert nb3.dtype == np.uint32
    np.testing.assert_array_equal(nb3, nb1.numpy())


def test_fewer_rows_than_devices(monkeypatch):
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    (c8, a8), log = _kmeans(monkeypatch, x, 2, 8, init=x[[0, 4]],
                            tolerance=0.0, yinyang_t=0, verbosity=2)
    assert "5 samples for 8 devices: running on 5 shards" in log
    assert len(_lines(log, "plan: ")) == 5
    (c1, a1), _ = _kmeans(monkeypatch, x, 2, 1, init=x[[0, 4]],
                          tolerance=0.0, yinyang_t=0)
    np.testing.assert_array_equal(a8, a1)
    np.testing.assert_allclose(c8, c1, rtol=1e-6)
    nb = knn_cuda(2, x, c8, a8)
    assert nb.shape == (5, 2) and (nb[:, 0] != np.arange(5)).all()


def test_topology_cut_and_reductions():
    topo = Topology([CPU] * 3)
    assert topo.split(10) == [(0, 4), (4, 7), (7, 10)]
    assert topo.split(2) == [(0, 1), (1, 2)]
    # the reference's overflow run, 167,772,160 rows (tests/test_scale.py:
    # 27), over 1 and 4 devices: contiguous, no padding, within one row
    n = 167_772_160
    for d in (1, 4):
        ranges = Topology([CPU] * d).split(n)
        assert len(ranges) == d and ranges[0][0] == 0 and ranges[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        sizes = [stop - start for start, stop in ranges]
        assert max(sizes) - min(sizes) <= 1
    parts = topo.scatter(torch.arange(10.0), topo.split(10))
    assert [p.numel() for p in parts] == [4, 3, 3]
    assert torch.equal(topo.gather(parts), torch.arange(10.0))
    # shard order: (1 + 2^24) + 1 rounds to 2^24 in fp32; 1 + 1 first
    # would give 2^24 + 2
    vals = [torch.tensor(1.0), torch.tensor(2.0 ** 24), torch.tensor(1.0)]
    assert float(topo.reduce(vals)) == 2.0 ** 24
    assert topo.read([p.sum() for p in parts]) == [6.0, 15.0, 24.0]
    assert topo.memory_report() == ["cpu: memory stats n/a"]
