"""The port's Yinyang schedule: budget gates, the dense floor and its
refresh backoff, the wall-clock controller, bf16 lower bounds, the triage
modes (kmcuda_torch.models.yinyang.run, ops.yinyang.yy_run), and the
profiler window (kmcuda_torch.utils.profiling).

Every schedule moves wall time only, so each run here equals the port's
Lloyd bitwise (assignments, centroids NaN-aware, iteration lines), as in
tests/test_yy_invariants.py:140-376 for the JAX package.  The gate and
controller debug lines are held against kmeans_tpu's, word for word with
the numbers masked, on the 13K blob fixture from one imported start.
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch

import jax

from kmcuda_tpu import config as jax_config
from kmcuda_tpu import kmeans_tpu
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
from kmcuda_torch.ops import distance as TD
from kmcuda_torch.ops import yinyang as YY
from kmcuda_torch.utils.logging import Logger

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def pinned_controller(monkeypatch):
    """The controller pin of tests/test_torch_yinyang.py: never gate, never
    revoke, never hand over; the controller's tests set the values back
    (the handover's own: tests/test_torch_yy_handover.py)."""
    monkeypatch.setattr(config, "YY_MIN_REMAINING", 0)
    monkeypatch.setattr(config, "YY_BAILOUT_MARGIN", float("inf"))
    monkeypatch.setattr(config, "YY_LLOYD_HANDOVER", False)


@pytest.fixture(scope="module")
def tight():
    """tests/test_yy_invariants.py's fixture: 96 blobs for 256 clusters,
    so contested clusters die (NaN centroids)."""
    rng = np.random.RandomState(0)
    n, k, f = 30000, 256, 32
    centers = (rng.rand(96, f) * 2).astype(np.float32)
    x = (centers[rng.randint(0, 96, n)]
         + 0.2 * rng.randn(n, f)).astype(np.float32)
    return torch.from_numpy(x), k


@pytest.fixture(scope="module")
def blobs():
    """The 13K blob mixture of tests/test_yinyang.py and an imported start
    from which both packages give identical iteration lines."""
    rng = np.random.RandomState(0)
    arr = np.empty((13000, 2), dtype=np.float32)
    arr[:2000] = rng.rand(2000, 2) + [0, 0.5]
    arr[2000:4000] = rng.rand(2000, 2) + [0, 1.5]
    arr[4000:6000] = rng.rand(2000, 2) - [0, 0.5]
    arr[6000:8000] = rng.rand(2000, 2) + [0.5, 0]
    arr[8000:10000] = rng.rand(2000, 2) - [0.5, 0]
    arr[10000:] = rng.rand(3000, 2) * 5 - [2, 2]
    return arr, arr[np.random.RandomState(2).choice(13000, 50,
                                                    replace=False)]


TIGHT_KW = dict(init="random", seed=5, tolerance=0.0, max_iterations=40)


def _run(x, k, **kw):
    """kmeans_cuda at verbosity 2: (centroids, assignments, iteration
    lines, whole log)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        c, a = kmeans_cuda(x, k, verbosity=2, **kw)
    log = buf.getvalue()
    return c, a, [l for l in log.splitlines() if l.startswith("iteration")], \
        log


def _assert_bitwise(got, want):
    assert got[2] == want[2] and len(got[2]) > 0
    assert torch.equal(got[1], want[1])
    assert torch.equal(torch.isnan(got[0]), torch.isnan(want[0]))
    assert torch.equal(torch.nan_to_num(got[0]), torch.nan_to_num(want[0]))


def _draft_iterations(log):
    return int(re.search(r"draft phase [\d.]+ s \((\d+) iterations",
                         log).group(1))


def _variants(log):
    """{variant: iterations} of a verbosity-2 Yinyang log."""
    out = {v: 0 for v in YY.VARIANTS}
    for l in log.splitlines():
        m = re.match(r"yinyang: (.+) iteration, \d+ moved rows patched", l)
        if m:
            out[m.group(1)] += 1
    return out


@pytest.fixture(scope="module")
def tight_refs(tight):
    """The tight fixture's Lloyd run and its Yinyang run under the default
    schedule (controller pinned as above)."""
    x, k = tight
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(config, "YY_MIN_REMAINING", 0)
        mp.setattr(config, "YY_BAILOUT_MARGIN", float("inf"))
        mp.setattr(config, "YY_LLOYD_HANDOVER", False)
        yy = _run(x, k, yinyang_t=0.1, **TIGHT_KW)
    return _run(x, k, yinyang_t=0, **TIGHT_KW), yy


def test_default_schedule_equals_lloyd(tight_refs):
    """The default schedule runs a dense refresh and sparse keep
    iterations on this fixture (40-75% of the rows candidates), patches
    moved rows, and equals Lloyd; dense plain iterations are the knob
    tests' (dense fraction 0.01)."""
    lloyd, yy = tight_refs
    _assert_bitwise(yy, lloyd)
    v = _variants(yy[3])
    assert v["dense refresh"] and v["sparse keep"], v
    assert "moved rows patched" in yy[3]
    assert any(int(m) > 0 for m in re.findall(
        r"iteration, (\d+) moved rows patched", yy[3]))


@pytest.mark.parametrize("knobs", [
    dict(YY_REFRESH_BACKOFF_MAX=1, YY_TIGHTEN_MIN_PRUNE=0.0),
    dict(YY_REFRESH_BACKOFF_MAX=64, YY_TIGHTEN_MIN_PRUNE=1.0),
    dict(YY_DENSE_FRACTION=0.01),
    dict(YY_DENSE_FRACTION=0.99),
], ids=["backoff 1, always tighten", "backoff 64, tighten backs off",
        "dense fraction 0.01", "dense fraction 0.99"])
def test_scheduling_knobs_never_change_results(tight, tight_refs, knobs,
                                               monkeypatch):
    """The knob sets of tests/test_yy_invariants.py:140-145: each run
    equals the default-schedule run and the port's Lloyd bitwise."""
    x, k = tight
    lloyd, yy = tight_refs
    for name, val in knobs.items():
        monkeypatch.setattr(config, name, val)
    got = _run(x, k, yinyang_t=0.1, **TIGHT_KW)
    _assert_bitwise(got, yy)
    _assert_bitwise(got, lloyd)
    v = _variants(got[3])
    if knobs.get("YY_DENSE_FRACTION") == 0.99:
        assert v["sparse keep"] + v["sparse refresh"] > v["dense plain"], v
    if knobs.get("YY_DENSE_FRACTION") == 0.01:
        assert v["sparse keep"] + v["sparse refresh"] < v["dense plain"], v


def test_sparse_path_under_dense_sum_arm(tight, monkeypatch):
    """DELTA_DENSE_FRACTION = 0 makes every sum arm dense (B1, in the
    Lloyd run too) and dense fraction 0.99 sends the bound path sparse:
    the survivors' ids come from B1 over every row, so the run equals
    Lloyd's bitwise, with sparse iterations that patch moved rows."""
    x, k = tight
    monkeypatch.setattr(config, "DELTA_DENSE_FRACTION", 0.0)
    monkeypatch.setattr(config, "YY_DENSE_FRACTION", 0.99)
    got = _run(x, k, yinyang_t=0.1, **TIGHT_KW)
    _assert_bitwise(got, _run(x, k, yinyang_t=0, **TIGHT_KW))
    v = _variants(got[3])
    assert v["sparse keep"] > 0, v
    assert any(int(m) > 0 for m in re.findall(
        r"sparse keep iteration, (\d+) moved rows patched", got[3]))


def test_bf16_bound_storage_never_changes_results(tight, tight_refs,
                                                  monkeypatch):
    """bf16 lower bounds (forced: YY_BOUNDS_F32_MAX_BYTES = 0) round down
    (ops.yinyang.lower_cast), so the filter stays sound: bitwise Lloyd."""
    x, k = tight
    lloyd, _yy = tight_refs
    monkeypatch.setattr(config, "YY_BOUNDS_F32_MAX_BYTES", 0)
    got = _run(x, k, yinyang_t=0.1, **TIGHT_KW)
    assert "yinyang: bf16 lower-bound storage (%d MB)" % (
        x.shape[0] * 25 * 2 // 2**20) in got[3]
    _assert_bitwise(got, lloyd)


def test_lower_cast_never_raises_a_bound():
    v = torch.from_numpy(np.random.RandomState(3).randn(100_000)
                         .astype(np.float32) * 50)
    stored = YY.lower_cast(v, torch.bfloat16)
    assert stored.dtype == torch.bfloat16
    assert bool((stored.float() <= v).all())
    assert bool(((v - stored.float()).abs()
                 <= 2.0 ** -6 * v.abs() + 1e-30).all())


@pytest.mark.parametrize("mode", [1, 2])
def test_debug_modes_never_change_results(tight, tight_refs, mode,
                                          monkeypatch):
    """YY_DEBUG_MODE 1 (every valid row a candidate) and 2 (no re-test
    after the tighten) take the sparse path in every iteration, the first
    included, and refresh every bound they touch, as the JAX triage
    modes do (kmcuda_tpu/ops/yinyang.py:667-668, :703-705)."""
    x, k = tight
    lloyd, _yy = tight_refs
    monkeypatch.setattr(config, "YY_DEBUG_MODE", mode)
    got = _run(x, k, yinyang_t=0.1, **TIGHT_KW)
    _assert_bitwise(got, lloyd)
    v = _variants(got[3])
    assert v["sparse refresh"] == len(got[2]) - _draft_iterations(got[3]), v


def test_wall_controller_never_changes_results(tight, tight_refs,
                                               monkeypatch):
    """Revoke-always (margin 0) with 2-iteration probes and re-probes
    after 4, then 8 iterations (tests/test_yy_invariants.py:314-354):
    the same iterations, bitwise; the revocation and re-probe lines
    appear.  Dense fraction 0.99 makes the windows sparse-heavy."""
    x, k = tight
    lloyd, yy = tight_refs
    monkeypatch.setattr(config, "YY_DENSE_FRACTION", 0.99)
    monkeypatch.setattr(config, "YY_BAILOUT_MARGIN", 0.0)
    monkeypatch.setattr(config, "YY_PROBE_ITERS", 2)
    monkeypatch.setattr(config, "YY_REPROBE_ITERS", 4)
    monkeypatch.setattr(config, "YY_REPROBE_ITERS_MAX", 8)
    got = _run(x, k, yinyang_t=0.1, **TIGHT_KW)
    assert len(got[2]) == len(yy[2])
    _assert_bitwise(got, lloyd)
    assert "yinyang: sparse branch revoked (" in got[3]
    assert "yinyang: re-probing the sparse branch after " in got[3]
    sizes = [int(m) for m in re.findall(r"segment of (\d+) iterations",
                                        got[3])]
    assert sizes[:2] == [1, 2], sizes
    assert sum(sizes) == got[3].count("passed the global filter")


def test_floor_probe_never_changes_results(tight, monkeypatch):
    """A draft of one iteration measures no Lloyd floor: the first judged
    window runs dense to measure it, then the sparse branch is granted.
    The first iteration moves every valid row off the 'never assigned'
    id, so only a run with at most 11% valid rows drafts once: 90% of
    the tight fixture's rows are NaN here."""
    x, k = tight
    x = x.clone()
    x[3000:] = float("nan")
    monkeypatch.setattr(config, "YY_PROBE_ITERS", 2)
    monkeypatch.setattr(config, "YY_DENSE_FRACTION", 0.99)
    kw = dict(init="random", seed=5, tolerance=0.0, max_iterations=30)
    got = _run(x, k, yinyang_t=0.1, **kw)
    _assert_bitwise(got, _run(x, k, yinyang_t=0, **kw))
    assert "draft phase" in got[3] and " s (1 iterations)" in got[3]
    lines = [m.group(1) for m in re.finditer(
        r"yinyang: (.+) iteration, \d+ moved rows patched", got[3])]
    assert lines[0] == "dense refresh"
    assert not any(v.startswith("sparse") for v in lines[1:3]), lines
    assert any(v.startswith("sparse") for v in lines[3:]), lines


@pytest.mark.parametrize("gate", ["pre-draft", "post-draft"])
def test_budget_gates(tight, gate, monkeypatch):
    """A budget under YY_MIN_REMAINING runs Lloyd outright; one that
    leaves fewer after the draft finishes on the draft's Lloyd loop.  The
    gate's line is logged, nothing is grouped, and the run equals Lloyd."""
    x, k = tight
    kw = dict(init="random", seed=5, tolerance=0.0)
    if gate == "pre-draft":
        monkeypatch.setattr(config, "YY_MIN_REMAINING", 32)
        kw["max_iterations"] = 12
        line = ("yinyang: budget 12 < YY_MIN_REMAINING=32; running the "
                "Lloyd driver outright (identical results)")
    else:
        draft = int(re.search(r"draft phase [\d.]+ s \((\d+) iterations",
                              _run(x, k, yinyang_t=0.1, max_iterations=40,
                                   **kw)[3]).group(1))
        monkeypatch.setattr(config, "YY_MIN_REMAINING", 3)
        kw["max_iterations"] = draft + 2
        line = ("yinyang: 2 iterations left < YY_MIN_REMAINING=3; "
                "finishing on the Lloyd path (identical results)")
    got = _run(x, k, yinyang_t=0.1, **kw)
    assert line in got[3].splitlines()
    assert "group capacity" not in got[3]
    assert "passed the global filter" not in got[3]
    _assert_bitwise(got, _run(x, k, yinyang_t=0, **kw))
    assert len(got[2]) == kw["max_iterations"]


def test_controller_switched_off(tight, monkeypatch):
    """YY_WALL_CONTROLLER = False: no gate (a 12-iteration budget enters
    the loop), one window for the whole loop, never a revocation (margin
    0 is not read); the run equals Lloyd."""
    x, k = tight
    monkeypatch.setattr(config, "YY_WALL_CONTROLLER", False)
    monkeypatch.setattr(config, "YY_MIN_REMAINING", 32)
    monkeypatch.setattr(config, "YY_BAILOUT_MARGIN", 0.0)
    kw = dict(init="random", seed=5, tolerance=0.0, max_iterations=12)
    got = _run(x, k, yinyang_t=0.1, **kw)
    assert "YY_MIN_REMAINING" not in got[3]
    assert "passed the global filter" in got[3]
    assert got[3].count("yinyang: segment of ") == 1
    assert "revoked" not in got[3]
    _assert_bitwise(got, _run(x, k, yinyang_t=0, **kw))


def _clear_jax_loop():
    """Drop the JAX loop's builds and traces (its jitted ``yy_run`` keeps a
    trace cache of its own, keyed without the config knobs it reads)."""
    JY._build_yy_run.cache_clear()
    jax.clear_caches()


def _masked(lines):
    return [re.sub(r"\d+(\.\d+)?(e-?\d+)?", "#", l) for l in lines]


def _controller_lines(log):
    return [l for l in log.splitlines() if l.startswith((
        "yinyang: budget", "yinyang: segment of", "yinyang: sparse branch",
        "yinyang: re-probing", "yinyang: draft phase"))
        or "iterations left <" in l]


@pytest.mark.parametrize("case", ["pre-draft gate", "post-draft gate",
                                  "controller"])
def test_gate_and_controller_lines_match_kmeans_tpu(blobs, case, request,
                                                    monkeypatch):
    """Both packages from one imported start on the 13K fixture: the same
    gate line word for word; under the revoke-always controller the same
    kinds of controller lines (numbers masked), the same iteration lines
    and the same assignments."""
    x, c0 = blobs
    kw = dict(tolerance=0.002, yinyang_t=0.1)
    knobs = {}
    if case == "pre-draft gate":
        knobs["YY_MIN_REMAINING"] = 32
        kw["max_iterations"] = 15
    elif case == "post-draft gate":
        draft = int(re.search(
            r"draft phase [\d.]+ s \((\d+) iterations",
            _run(torch.from_numpy(x), 50, init=torch.from_numpy(c0),
                 max_iterations=100, **kw)[3]).group(1))
        knobs["YY_MIN_REMAINING"] = 3
        kw["max_iterations"] = draft + 2
    else:
        knobs.update(YY_MIN_REMAINING=0, YY_BAILOUT_MARGIN=0.0,
                     YY_PROBE_ITERS=2, YY_REPROBE_ITERS=4,
                     YY_REPROBE_ITERS_MAX=8, YY_DENSE_FRACTION=0.99)
        kw["max_iterations"] = 100
    for name, val in knobs.items():
        monkeypatch.setattr(config, name, val)
        monkeypatch.setattr(jax_config, name, val)
    # the JAX loop bakes its knobs in at trace time: trace it afresh, and
    # leave no trace of these knobs to later tests
    _clear_jax_loop()
    request.addfinalizer(_clear_jax_loop)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        # the JAX controller judges no window of a cold executable: warm
        # them first, so its decisions do not depend on the test order
        kmeans_tpu(x, 50, init=c0, device=1, **kw)
        buf.seek(0)
        buf.truncate()
        want_c, want_a = kmeans_tpu(x, 50, init=c0, device=1, verbosity=2,
                                    **kw)
    want = buf.getvalue()
    got = _run(torch.from_numpy(x), 50, init=torch.from_numpy(c0), **kw)
    assert got[2] == [l for l in want.splitlines()
                      if l.startswith("iteration")]
    np.testing.assert_array_equal(got[1].numpy(), want_a.astype(np.int32))
    mine, theirs = _controller_lines(got[3]), _controller_lines(want)
    if case == "controller":
        assert "yinyang: sparse branch revoked (# s/it vs Lloyd #)" \
            in _masked(mine)
        assert set(_masked(mine)) == set(_masked(theirs))
    else:
        gate = [l for l in mine if "YY_MIN_REMAINING" in l]
        assert len(gate) == 1 and gate == [
            l for l in theirs if "YY_MIN_REMAINING" in l]


def _filter_counts(log):
    """(candidates, passed) of each Yinyang loop iteration."""
    return [(int(l.split()[1]), int(l.split()[3])) for l in log.splitlines()
            if "passed the global filter" in l]


def test_schedule_counts_match_kmeans_tpu(blobs, monkeypatch):
    """Both packages' loops from one imported start and one grouping (the
    JAX package's, fed to the port), controllers off, and one dense
    threshold in rows (the JAX loop compares its candidates against its
    padded row count): the same iteration lines, the same iterations
    dense, and per iteration the same candidate and survivor counts up to
    the bounds' rounding (the packages round drift and products apart),
    at most 0.1% of the rows."""
    x, c0 = blobs
    n = len(x)
    kw = dict(tolerance=0.002, yinyang_t=0.1, seed=3, max_iterations=100)
    jp = JP.prepare(x, 50, JMetric.L2, Topology(jax.devices()[:1]),
                    JLogger(0))
    key = jax.random.fold_in(jax.random.key(3), 0x77)
    monkeypatch.setattr(Y, "_group_centroids", lambda c, groups, _m, _g:
                        groups_from_jax(*JY._group_centroids(
                            jp, jax.numpy.asarray(c.numpy()), groups, key),
                            device="cpu"))
    monkeypatch.setattr(config, "YY_WALL_CONTROLLER", False)
    monkeypatch.setattr(jax_config, "YY_WALL_CONTROLLER", False)
    monkeypatch.setattr(config, "YY_DENSE_FRACTION", float(
        np.float32(jax_config.YY_DENSE_FRACTION) * np.float32(jp.n_pad)
        / np.float32(n)))
    _clear_jax_loop()   # no trace made under another test's knobs
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        kmeans_tpu(x, 50, init=c0, device=1, verbosity=2, **kw)
    want = buf.getvalue()
    got = _run(torch.from_numpy(x), 50, init=torch.from_numpy(c0), **kw)
    assert got[2] == [l for l in want.splitlines()
                      if l.startswith("iteration")]
    mine, theirs = _filter_counts(got[3]), _filter_counts(want)
    assert len(mine) == len(theirs) > 20
    assert [p == n for _c, p in mine] == [p == n for _c, p in theirs]
    assert sum(p < n for _c, p in mine) > 10, mine
    diff = np.abs(np.array(mine) - np.array(theirs))
    assert diff.max() <= n // 1000, (mine, theirs)


def test_bound_invariants_plain_and_patch(tight, monkeypatch):
    """The bound invariants of tests/test_torch_yinyang.py's
    test_bound_invariants after dense plain iterations (l kept, u exact)
    and the moved-row patch: YY_DENSE_FRACTION = 0 makes every iteration
    dense, plain between backed-off refreshes.  Checked after the fifth
    iteration, a plain one that patched moved rows."""
    monkeypatch.setattr(config, "YY_DENSE_FRACTION", 0.0)
    x, k = tight
    x_np = x.numpy()
    n = len(x_np)
    groups = 25
    p = prepare(x, k, TD.DistanceMetric.L2, torch.device("cpu"), Logger(0))
    c0 = torch.from_numpy(
        x_np[np.random.RandomState(5).choice(n, k, replace=False)])
    step = L.drive(L.Driver(p.logger, int(0.11 * n)),
                   A.lloyd_run(p.x, p.valid, p.assign0, c0, n_clusters=k,
                               metric=p.metric))
    jp = JP.prepare(x_np, k, JMetric.L2, Topology(jax.devices()[:1]),
                    JLogger(0))
    layout = groups_from_jax(
        *JY._group_centroids(jp, jax.numpy.asarray(step.c_used.numpy()),
                             groups, jax.random.key(5)), device="cpu")
    loop = YY.yy_run(p.x, p.x_sq, p.valid, step.assign, step.c_used,
                     step.sums, step.counts, step.changed, layout,
                     n_clusters=k, metric=p.metric)
    variants = []
    for i, ys in enumerate(loop):
        variants.append((ys.variant, ys.patched))
        if i == 4:
            break
    loop.close()
    assert [v for v, _ in variants] == [
        "dense refresh", "dense plain", "dense refresh", "dense plain",
        "dense plain"], variants
    assert variants[-1][1] > 0, variants
    u, l_arr = (t.numpy() for t in YY.current_bounds(ys.u, ys.l, ys.ga,
                                                     ys.acc))
    c_fin = ys.c_used.numpy().astype(np.float64)
    assign = ys.assign.numpy()
    alive = np.isfinite(c_fin).all(axis=1)
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


def test_profile_window(blobs, tmp_path, monkeypatch, capsys):
    """KMTPU_PROFILE=<dir> brackets the compute span with a torch.profiler
    trace (tests/test_kmeans.py:387); unset, no line and no trace."""
    x = torch.from_numpy(blobs[0])
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("KMTPU_PROFILE", str(trace_dir))
    kmeans_cuda(x, 50, init="random", seed=5, tolerance=0.01, yinyang_t=0,
                verbosity=2, max_iterations=2)
    out = capsys.readouterr().out
    assert "profiler trace started (KMTPU_PROFILE=%s)" % trace_dir in out
    assert "profiler trace written to %s" % trace_dir in out
    traces = [f for _r, _d, files in os.walk(trace_dir) for f in files
              if f.endswith(".pt.trace.json")]
    assert len(traces) == 1, traces

    written = sorted(os.listdir(trace_dir))  # the trace and its counters
    monkeypatch.delenv("KMTPU_PROFILE")
    kmeans_cuda(x, 50, init="random", seed=5, tolerance=0.01, yinyang_t=0,
                verbosity=2, max_iterations=1)
    assert "profiler trace" not in capsys.readouterr().out
    assert sorted(os.listdir(trace_dir)) == written
