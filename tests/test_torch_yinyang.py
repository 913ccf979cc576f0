"""The port's Yinyang (kmcuda_torch.models.yinyang, ops.yinyang).

Inside the port Yinyang must equal the port's Lloyd bitwise — the same
assignments, centroids (NaN rows included) and iteration lines from the
same start — in fp32, in bf16 storage and for cosine, on the 13K blob
fixture of tests/test_yinyang.py and on the "tight" fixture of
tests/test_yy_invariants.py, whose contested clusters die.  Against the
JAX package's Yinyang from the same imported start, assignments and
iteration lines are identical and centroids agree to rtol 1e-5 /
atol 1e-6 (the Lloyd parity rule of tests/test_torch_kmeans.py).  The
bound invariants are checked on the port's loop driven with the JAX
package's grouping.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import jax

from kmcuda_tpu import kmeans_tpu
from kmcuda_tpu.models import initialization as JI
from kmcuda_tpu.models import problem as JP
from kmcuda_tpu.models import yinyang as JY
from kmcuda_tpu.ops.distance import DistanceMetric as JMetric
from kmcuda_tpu.parallel.mesh import Topology
from kmcuda_tpu.utils.logging import Logger as JLogger
from kmcuda_torch import config, kmeans_cuda
from kmcuda_torch.interop import groups_from_jax
from kmcuda_torch.models import lloyd as L
from kmcuda_torch.models import yinyang as Y
from kmcuda_torch.models.problem import prepare
from kmcuda_torch.ops import assign as A
from kmcuda_torch.ops import assign_kernels as K
from kmcuda_torch.ops import distance as TD
from kmcuda_torch.ops import yinyang as YY
from kmcuda_torch.utils.logging import Logger

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def pinned_controller(monkeypatch):
    """The wall-clock controller decides on host timings, which would make
    the path a test takes depend on the machine's load; pin it to "never
    gate, never revoke, never hand over to Lloyd", as tests/conftest.py
    pins the JAX package's.  The controller's own tests set the values
    back."""
    monkeypatch.setattr(config, "YY_MIN_REMAINING", 0)
    monkeypatch.setattr(config, "YY_BAILOUT_MARGIN", float("inf"))
    monkeypatch.setattr(config, "YY_LLOYD_HANDOVER", False)


@pytest.fixture(scope="module")
def samples():
    """The blob mixture of tests/test_yinyang.py."""
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
def tight():
    """tests/test_yy_invariants.py's fixture: 96 blobs for 256 clusters,
    so contested clusters lose all members (NaN centroids)."""
    rng = np.random.RandomState(0)
    n, k, f = 30000, 256, 32
    centers = (rng.rand(96, f) * 2).astype(np.float32)
    x = (centers[rng.randint(0, 96, n)]
         + 0.2 * rng.randn(n, f)).astype(np.float32)
    return x, k


def _run(x, k, **kw):
    """kmeans_cuda with verbosity 2; returns (centroids, assignments,
    iteration lines, whole log)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        c, a = kmeans_cuda(x, k, verbosity=2, **kw)
    log = buf.getvalue()
    return c, a, [l for l in log.splitlines() if l.startswith("iteration")], \
        log


def _assert_bitwise(yy, ll):
    assert yy[2] == ll[2] and len(yy[2]) > 0
    assert torch.equal(yy[1], ll[1])
    assert torch.equal(torch.isnan(yy[0]), torch.isnan(ll[0]))
    assert torch.equal(torch.nan_to_num(yy[0]), torch.nan_to_num(ll[0]))


def _entered(log):
    """Iterations the Yinyang loop ran (its per-iteration debug lines)."""
    return sum("passed the global filter" in l for l in log.splitlines())


@pytest.mark.parametrize("init", ["random", "kmeans++", "afkmc2 NaN rows"])
def test_yinyang_equals_lloyd_13k(samples, init):
    """"NaN rows": AFK-MC2 init, three NaN rows and one inf entry, which
    keep the invalid id 50 in both runs."""
    x = samples
    if init == "afkmc2 NaN rows":
        x = samples.copy()
        x[[42, 4242, 12999]] = np.nan
        x[777, 1] = np.inf
        init = ("afkmc2", 50)
    kw = dict(init=init, seed=3, tolerance=0.002)
    yy = _run(torch.from_numpy(x), 50, yinyang_t=0.1, **kw)
    ll = _run(torch.from_numpy(x), 50, yinyang_t=0, **kw)
    assert _entered(yy[3]) > 10 and _entered(ll[3]) == 0
    _assert_bitwise(yy, ll)
    if x is not samples:
        assert (yy[1][[42, 777, 4242, 12999]] == 50).all()


@pytest.mark.parametrize("case", ["fp32", "fp32 gathered", "fp16", "cos"])
def test_yinyang_equals_lloyd_tight(tight, case, monkeypatch):
    """"gathered": also counts the rows of every B2 launch of the Yinyang
    run; the loop's launches take only the survivors of the filters, a
    strict subset of the rows."""
    x, k = tight
    b2_rows = []
    if case == "fp32 gathered":
        b2 = K.assign_only_pass

        def counted(xs, *args, **kwargs):
            b2_rows.append(xs.shape[0])
            return b2(xs, *args, **kwargs)

        monkeypatch.setattr(K, "assign_only_pass", counted)
    if case == "cos":
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
    if case == "fp16":
        x = x.astype(np.float16)
    xt = torch.from_numpy(x)
    kw = dict(init="random", seed=5, tolerance=0.0, max_iterations=30,
              metric="cos" if case == "cos" else "L2")
    yy = _run(xt, k, yinyang_t=0.1, **kw)
    if case == "fp32 gathered":
        assert 0 < min(b2_rows) < len(x), b2_rows
    ll = _run(xt, k, yinyang_t=0, **kw)
    assert _entered(yy[3]) > 10
    _assert_bitwise(yy, ll)
    if case != "cos":
        assert bool(torch.isnan(yy[0]).any()), "no dead centroid"


def _separated():
    rng = np.random.RandomState(1)
    centers = rng.rand(32, 16).astype(np.float32) * 20
    x = (centers[rng.randint(0, 32, size=4096)]
         + 0.1 * rng.randn(4096, 16)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("case", ["blobs L2", "separated cos"])
def test_yinyang_matches_kmeans_tpu(samples, case):
    """Both packages' Yinyang from one imported start, with a budget far
    past the draft (the JAX loop is entered, see its candidate lines)."""
    if case == "blobs L2":
        x, k, metric = samples, 50, "L2"
    else:
        x, k, metric = _separated(), 32, "cos"
    c0 = x[np.random.RandomState(2).choice(len(x), k, replace=False)]
    kw = dict(tolerance=0.002, yinyang_t=0.1, metric=metric,
              max_iterations=100)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        want_c, want_a = kmeans_tpu(x, k, init=c0, device=1, verbosity=2,
                                    **kw)
    want_log = buf.getvalue()
    got = _run(torch.from_numpy(x), k, init=torch.from_numpy(c0), **kw)
    assert _entered(want_log) > 0 and _entered(got[3]) > 0
    assert got[2] == [l for l in want_log.splitlines()
                      if l.startswith("iteration")]
    np.testing.assert_array_equal(got[1].numpy(), want_a.astype(np.int32))
    np.testing.assert_allclose(got[0].numpy(), want_c, rtol=1e-5, atol=1e-6)


def test_group_cap_matches_jax():
    for k, g in ((50, 5), (256, 25), (1024, 102), (1000, 1), (7, 3),
                 (100_000, 10_000)):
        assert Y._group_cap(k, g) == JY._group_cap(k, g)


def _jax_problem(x, k):
    return JP.prepare(x, k, JMetric.L2, Topology(jax.devices()[:1]),
                      JLogger(0))


def test_balance_groups_matches_jax(tight):
    """The balancing step on the JAX group k-means' own output equals the
    JAX ``_group_centroids`` layout."""
    x, k = tight
    p = _jax_problem(x[:4000], k)
    c = JI.init_centroids(p, JI.InitMethod.RANDOM, jax.random.key(1))
    c = np.asarray(c).copy()
    c[[3, 77]] = np.nan                             # dead centroids
    key = jax.random.key(9)
    groups = 25
    kp = -(-k // 256) * 256
    g_assign, prefs = JY._group_kmeans(
        jax.numpy.asarray(c), key,
        np.int32(int(config.YINYANG_GROUP_TOLERANCE * k)), kp=kp,
        groups=groups, metric=JMetric.L2, chunk=kp)
    want = JY._group_centroids(p, jax.numpy.asarray(c), groups, key)
    cap = Y._group_cap(k, groups)
    got = Y.balance_groups(np.asarray(g_assign)[:k].astype(np.int64),
                           np.asarray(prefs)[:k], groups, cap)
    assert cap == want[4]
    for g, w in zip(got, want[:4]):
        np.testing.assert_array_equal(g, w)
    assert (got[0][[3, 77]] == groups).all()


def test_bound_invariants(tight, monkeypatch):
    """u >= d(x, own centroid); l[g] <= min over the other centroids of
    group g of d(x, c) (tests/test_yy_invariants.py:66-137), on the port's
    loop after a draft to 11% and 6 iterations, with the JAX grouping;
    the filter prunes (no full pass after the first).  The dense fraction
    is raised so the iterations go sparse (on this fixture 40-70% of the
    rows stay candidates)."""
    monkeypatch.setattr(config, "YY_DENSE_FRACTION", 0.99)
    x_np, k = tight
    n = len(x_np)
    groups = 25
    p = prepare(torch.from_numpy(x_np), k, TD.DistanceMetric.L2,
                torch.device("cpu"), Logger(0))
    c0 = torch.from_numpy(
        x_np[np.random.RandomState(5).choice(n, k, replace=False)])
    step = L.drive(L.Driver(p.logger, int(0.11 * n)),
                   A.lloyd_run(p.x, p.valid, p.assign0, c0, n_clusters=k,
                               metric=p.metric))
    jp = _jax_problem(x_np, k)
    layout = groups_from_jax(
        *JY._group_centroids(jp, jax.numpy.asarray(step.c_used.numpy()),
                             groups, jax.random.key(5)), device="cpu")
    loop = YY.yy_run(p.x, p.x_sq, p.valid, step.assign, step.c_used,
                     step.sums, step.counts, step.changed, layout,
                     n_clusters=k, metric=p.metric)
    passed = []
    for i, ys in enumerate(loop):
        passed.append(ys.passed)
        if i == 5:
            break
    loop.close()
    assert min(passed) < n, "the filter never pruned"
    u, l_arr = (t.numpy() for t in YY.current_bounds(ys.u, ys.l, ys.ga,
                                                     ys.acc))
    c_fin = ys.c_used.numpy().astype(np.float64)
    assign = ys.assign.numpy()
    alive = np.isfinite(c_fin).all(axis=1)
    assert (~alive).sum() > 0, "fixture must produce dead centroids"
    cz = np.where(alive[:, None], c_fin, 0.0)
    xs = x_np.astype(np.float64)
    d = np.sqrt(np.maximum(
        (xs ** 2).sum(1)[:, None] + (cz ** 2).sum(1)[None, :]
        - 2.0 * xs @ cz.T, 0.0))
    d[:, ~alive] = np.inf
    assert (u + 1e-4 >= d[np.arange(n), assign]).all()
    d[np.arange(n), assign] = np.inf
    gof = layout.group_of.numpy()
    for g in range(groups):
        cols = np.flatnonzero(gof == g)
        if not len(cols):
            continue
        minother = d[:, cols].min(axis=1)
        finite = np.isfinite(minother)
        assert (l_arr[finite, g] <= minother[finite] + 1e-4).all(), g


def test_yinyang_skips_work(samples):
    """Late iterations pass only a small fraction of the samples through
    the local filter (tests/test_yinyang.py:150-159).  The port starts
    from that test's own k-means++ centroids (jax.random draws, seed 3),
    so it runs the trajectory the JAX assertion is made on; the port's own
    k-means++ draws another, whose last iteration falls elsewhere in the
    schedule's refresh cycle."""
    c0 = np.array(JI.init_centroids(_jax_problem(samples, 50),
                                    JI.InitMethod.PLUS_PLUS,
                                    jax.random.key(3)))[:50]
    _c, _a, _lines, log = _run(torch.from_numpy(samples), 50,
                               init=torch.from_numpy(c0), seed=3,
                               tolerance=0.002, yinyang_t=0.1,
                               max_iterations=100)
    passed = [int(l.split()[3]) for l in log.splitlines()
              if "passed the global" in l]
    assert passed, log
    assert passed[-1] < 0.25 * 13000, passed


def test_flat_slot_ceiling_falls_back_to_lloyd(samples, capsys):
    """Past groups * cap >= 2**24 run() warns and runs Lloyd, like the JAX
    package (tests/test_yinyang.py:183-209)."""
    p = prepare(torch.from_numpy(samples), 50, TD.DistanceMetric.L2,
                torch.device("cpu"), Logger(0))
    c0 = torch.from_numpy(samples[:50].copy())
    cy, ay, _by, it_y = Y.run(p, c0, p.assign0, 0.01, 2 ** 23, seed=4)
    assert "exceed the fp32 exact-integer range" in capsys.readouterr().err
    cl, al, _bl, it_l, _ = L.run(p, c0, p.assign0, 0.01)
    assert it_y == it_l
    assert torch.equal(ay, al) and torch.equal(cy, cl)


def test_stagnation_stop_spans_draft_and_loop(tight, monkeypatch):
    """With patience 1 the stop comes inside the Yinyang loop, at the
    iteration and with the message of the Lloyd run of the same
    trajectory: the (mark, stale) counters flow through the hand-over."""
    x, k = tight
    monkeypatch.setattr(config, "STAGNATION_PATIENCE", 1)
    kw = dict(init="random", seed=5, tolerance=0.0, max_iterations=200)
    xt = torch.from_numpy(x)
    yy = _run(xt, k, yinyang_t=0.1, **kw)
    ll = _run(xt, k, yinyang_t=0, **kw)
    assert "stagnated" in yy[3] and "stagnated" in ll[3]
    assert _entered(yy[3]) > 0
    _assert_bitwise(yy, ll)
    counts = [int(l.split(": ")[1].split()[0]) for l in yy[2]]
    assert counts[-1] >= counts[-2] - (counts[-2] >> 6)


#: seed-locked iteration trajectory of the port's k-means++/Yinyang on the
#: 13K fixture (seed=3, tolerance=0.01), pinned from its first run; the
#: JAX package's golden (tests/test_yinyang.py:92) rests on jax.random
#: draws.  Draft: the first 3 iterations (to <= 11% of 13000), then 17 in
#: the Yinyang loop.
YY_GOLDEN_COUNTS = [13000, 1884, 1051, 661, 520, 381, 342, 341, 332, 304,
                    263, 229, 209, 202, 202, 183, 166, 155, 134, 125]


def test_yinyang_iteration_golden(samples):
    _c, _a, lines, log = _run(torch.from_numpy(samples), 50,
                              init="kmeans++", seed=3, tolerance=0.01,
                              yinyang_t=0.1)
    counts = [int(l.split(": ")[1].split()[0]) for l in lines]
    assert counts == YY_GOLDEN_COUNTS
    draft = next(i for i, c in enumerate(counts) if c <= 0.11 * 13000)
    assert draft == 2 and _entered(log) == len(counts) - draft - 1 == 17
