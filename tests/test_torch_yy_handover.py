"""The Yinyang controller's Lloyd handover (``models/yinyang.
_controlled_loop``, ``config.YY_LLOYD_HANDOVER``) and the resume state of
``ops.assign.lloyd_run`` it continues on.

On uniform 128-feature rows a fresh bound refresh leaves nearly every row
a candidate, so the iteration after the bound init hands the run to the
Lloyd loop; on the tight blob fixture the filter prunes and the arm never
engages.  Every run here equals the port's Lloyd from the same start
bitwise: assignments, centroids and iteration lines, on one shard and on
two logical CPU shards (``tests/test_torch_multidevice.py``'s device
mask).  The handover is counted by the program's ``yinyang.handed_over``
counter, read from the call's record while the profiler runs.
"""

import contextlib
import io
import re
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kmcuda_torch import config, kmeans_cuda
from kmcuda_torch.models import yinyang as Y
from kmcuda_torch.models.problem import prepare
from kmcuda_torch.ops import assign as A
from kmcuda_torch.ops import compact as C
from kmcuda_torch.ops import yinyang as YY
from kmcuda_torch.ops.distance import DistanceMetric
from kmcuda_torch.parallel import devices
from kmcuda_torch.utils import profiling as P
from kmcuda_torch.utils.logging import Logger

torch.set_num_threads(2)

CPU = torch.device("cpu")
K = 64


@pytest.fixture(autouse=True)
def pinned_controller(monkeypatch):
    """Never gate, never revoke, as tests/test_torch_yinyang.py pins the
    controller; the handover arm on."""
    monkeypatch.setattr(config, "YY_MIN_REMAINING", 0)
    monkeypatch.setattr(config, "YY_BAILOUT_MARGIN", float("inf"))
    monkeypatch.setattr(config, "YY_LLOYD_HANDOVER", True)


@pytest.fixture(scope="module")
def uniform():
    """6,000 x 128 uniform rows and a start of 64 of them."""
    x = np.random.RandomState(1).rand(6000, 128).astype(np.float32)
    return x, x[np.random.RandomState(2).choice(len(x), K, replace=False)]


@pytest.fixture(scope="module")
def tight():
    """tests/test_yy_invariants.py's fixture: 96 blobs for 256 clusters."""
    rng = np.random.RandomState(0)
    n, f = 30000, 32
    centers = (rng.rand(96, f) * 2).astype(np.float32)
    return (centers[rng.randint(0, 96, n)]
            + 0.2 * rng.randn(n, f)).astype(np.float32)


class _Clock:
    """A stand-in for the controller's ``time``: each reading of
    ``perf_counter`` is one second after the last."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        self.now += 1.0
        return self.now


def _run(monkeypatch, x, k, d=1, **kw):
    """The public call on numpy input over d logical CPU shards at
    verbosity 2, while the profiler runs: (centroids, assignments,
    iteration lines, whole log, the call's counters)."""
    monkeypatch.setattr(devices, "select_devices",
                        lambda mask, logger=None: [CPU] * d)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            profile(activities=[ProfilerActivity.CPU]):
        c, a = kmeans_cuda(x, k, verbosity=2, **kw)
    log = buf.getvalue()
    return (c, a, [l for l in log.splitlines() if l.startswith("iteration")],
            log, P.records()[-1]["counters"])


def _assert_bitwise(got, want):
    assert got[2] == want[2] and len(got[2]) > 0
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def _counted(got, name):
    return [v for c, v in got[4] if c == name]


def _variants(log):
    """{variant: iterations} of a verbosity-2 Yinyang log."""
    out = {v: 0 for v in YY.VARIANTS}
    for l in log.splitlines():
        m = re.match(r"yinyang: (.+) iteration, \d+ moved rows patched", l)
        if m:
            out[m.group(1)] += 1
    return out


def _draft(lines, n):
    """The draft's iterations: through the first count at or below 11%."""
    counts = [int(l.split()[2]) for l in lines]
    tol = int(config.YINYANG_DRAFT_REASSIGNMENTS * n)
    return next(i + 1 for i, c in enumerate(counts) if c <= tol)


@pytest.mark.parametrize("d", [1, 2])
def test_handover_engages_and_equals_lloyd(uniform, monkeypatch, d):
    """Right after the bound init the filter leaves more than
    ``YY_DENSE_FRACTION`` of the rows candidates: the run goes on as
    Lloyd, bitwise ``models.lloyd.run``'s from the same start (the call
    with ``yinyang_t`` 0), and the share of the loop's iterations counted
    handed over lies in (0, 1]."""
    x, c0 = uniform
    kw = dict(init=c0, tolerance=0.0, seed=3)
    yy = _run(monkeypatch, x, K, d, yinyang_t=0.1, **kw)
    ll = _run(monkeypatch, x, K, d, yinyang_t=0, **kw)
    _assert_bitwise(yy, ll)
    # handed over after the loop's second iteration, the first after the
    # bound init
    before = yy[3].split("yinyang: handing over to Lloyd (")[0]
    assert before.count("passed the global filter") == 2
    handed = _counted(yy, "yinyang.handed_over")
    assert handed[0] == 0 and sum(handed) > 0
    assert 0 < sum(handed) <= len(_counted(yy, "yinyang.passed"))
    assert _counted(yy, "yinyang.rows") == [len(x)]
    assert not _counted(ll, "yinyang.handed_over")


def test_tight_fixture_never_hands_over(tight, monkeypatch):
    """The filter prunes on the blobs: the arm never engages, the loop's
    iteration variants are those of a run with the arm off, and both
    equal Lloyd."""
    kw = dict(init="random", seed=5, tolerance=0.0, max_iterations=40)
    on = _run(monkeypatch, tight, 256, yinyang_t=0.1, **kw)
    monkeypatch.setattr(config, "YY_LLOYD_HANDOVER", False)
    off = _run(monkeypatch, tight, 256, yinyang_t=0.1, **kw)
    ll = _run(monkeypatch, tight, 256, yinyang_t=0, **kw)
    assert _counted(on, "yinyang.handed_over") == [0]
    assert "handing over" not in on[3]
    v = _variants(on[3])
    assert v == _variants(off[3])
    assert v["dense refresh"] and v["sparse keep"], v
    _assert_bitwise(on, ll)
    _assert_bitwise(off, ll)


@pytest.mark.parametrize("d", [1, 2])
def test_reentry_doubles_and_equals_lloyd(uniform, monkeypatch, d):
    """The controller's clock stubbed (a second a reading): every
    iteration's wall is 1 s, the refresh's surcharge 1 s less the draft's
    Lloyd floor, so the first handover comes back after 1 Lloyd
    iteration and the second after 2.  Cut 8 iterations past the draft
    (refresh, handover, Lloyd, refresh, handover, Lloyd, Lloyd, refresh),
    the run counts 2 handovers and 3 iterations handed over, and equals
    Lloyd bitwise."""
    x, c0 = uniform
    kw = dict(init=c0, tolerance=0.0, seed=3)
    full = _run(monkeypatch, x, K, d, yinyang_t=0, **kw)
    cap = _draft(full[2], len(x)) + 8
    monkeypatch.setattr(Y, "time", _Clock())
    yy = _run(monkeypatch, x, K, d, yinyang_t=0.1, max_iterations=cap, **kw)
    ll = _run(monkeypatch, x, K, d, yinyang_t=0, max_iterations=cap, **kw)
    _assert_bitwise(yy, ll)
    assert yy[2] == full[2][:cap]
    assert yy[3].count("yinyang: handing over to Lloyd (") == 2
    assert re.findall(r"back on the bound path after (\d+) Lloyd", yy[3]) \
        == ["1", "2"]
    assert sum(_counted(yy, "yinyang.handed_over")) == 3
    assert _variants(yy[3])["dense refresh"] == 3


def test_handover_spans_and_counters(uniform, monkeypatch):
    """Each iteration handed over is one ``kmt.yinyang.lloyd`` span whose
    nearest enclosing ``kmt.`` span is ``kmt.yinyang.loop`` and which holds
    the Lloyd pass's wrapper spans; it counts ``yinyang.handed_over`` 1
    and ``yinyang.passed`` the valid rows, beside one ``yinyang.passed``
    sample per bound-path iteration (its filter line)."""
    x, c0 = uniform
    monkeypatch.setattr(devices, "select_devices",
                        lambda mask, logger=None: [CPU])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        kmeans_cuda(x, K, init=c0, tolerance=0.0, seed=3, verbosity=2,
                    max_iterations=20)
    ev = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.name().startswith("kmt.")), key=lambda e: e[1])
    counters = P.records()[-1]["counters"]
    parent, inner, stack = [], set(), []
    for name, s, e in ev:
        while stack and stack[-1][2] < e:
            stack.pop()
        if name == "kmt.yinyang.lloyd":
            parent.append(stack[-1][0])
        elif stack and stack[-1][0] == "kmt.yinyang.lloyd":
            inner.add(name)
        stack.append((name, s, e))
    handed = [v for c, v in counters if c == "yinyang.handed_over"]
    passed = [v for c, v in counters if c == "yinyang.passed"]
    filtered = buf.getvalue().count("passed the global filter")
    assert handed[0] == 0 and sum(handed) == len(handed) - 1 > 0
    assert parent == ["kmt.yinyang.loop"] * sum(handed)
    assert inner and inner <= {"kmt.fused_pass", "kmt.assign_pass",
                               "kmt.moved_rows", "kmt.delta_sum"}
    assert len(passed) == filtered + sum(handed)
    assert all(counters[i + 1] == ["yinyang.passed", len(x)]
               for i, (c, v) in enumerate(counters)
               if c == "yinyang.handed_over" and v)


def test_reentry_frees_the_closed_loops_bounds(uniform, monkeypatch):
    """No bound of a closed loop is alive when the next loop allocates
    its own (``peak_gb`` must not grow by a re-entry)."""
    x, c0 = uniform
    alive, refs = [], []
    yy_run = YY.yy_run

    def tracked(*args, **kwargs):
        alive.append(sum(r() is not None for r in refs))
        for ys in yy_run(*args, **kwargs):
            for t in (ys.u, ys.l, ys.ga):   # a list of shards, or one
                refs.extend(weakref.ref(b) for b in
                            (t if isinstance(t, list) else [t]))
            yield ys

    monkeypatch.setattr(YY, "yy_run", tracked)
    monkeypatch.setattr(Y, "time", _Clock())
    _run(monkeypatch, x, K, yinyang_t=0.1, init=c0, tolerance=0.0, seed=3,
         max_iterations=20)
    assert len(alive) >= 3 and refs
    assert alive == [0] * len(alive)


@pytest.mark.parametrize("case", ["controller off", "triage mode 1",
                                  "arm off"])
def test_no_handover_without_the_arm(uniform, monkeypatch, case):
    """``YY_WALL_CONTROLLER`` off, a triage mode, or the arm's own switch
    off: the bound path runs to the end, bitwise Lloyd."""
    x, c0 = uniform
    name, value = {"controller off": ("YY_WALL_CONTROLLER", False),
                   "triage mode 1": ("YY_DEBUG_MODE", 1),
                   "arm off": ("YY_LLOYD_HANDOVER", False)}[case]
    monkeypatch.setattr(config, name, value)
    kw = dict(init=c0, tolerance=0.0, seed=3, max_iterations=20)
    yy = _run(monkeypatch, x, K, yinyang_t=0.1, **kw)
    ll = _run(monkeypatch, x, K, yinyang_t=0, **kw)
    _assert_bitwise(yy, ll)
    assert _counted(yy, "yinyang.handed_over") == [0]
    assert "handing over" not in yy[3]
    assert len(_counted(yy, "yinyang.passed")) > 10


@pytest.mark.parametrize("split", [1, 2, 6])
def test_lloyd_run_resumes_bitwise(uniform, split):
    """A Lloyd loop stopped after ``split`` iterations and resumed from its
    last step's (sums, counts, changed) and centroid update runs the same
    next iterations as one that never stopped: after 1 the next sum arm is
    dense (every row moved), after 6 the moved-row delta."""
    x, c0 = uniform
    p = prepare(torch.from_numpy(x), K, DistanceMetric.L2, CPU, Logger(0))
    kw = dict(n_clusters=K, metric=p.metric)
    whole = A.lloyd_run(p.x, p.valid, p.assign0, torch.from_numpy(c0), **kw)
    want = [next(whole) for _ in range(split + 3)]
    whole.close()
    first = A.lloyd_run(p.x, p.valid, p.assign0, torch.from_numpy(c0), **kw)
    for _ in range(split):
        last = next(first)
    first.close()
    resumed = A.lloyd_run(p.x, p.valid, last.assign, last.c_next, **kw,
                          resume=(last.sums, last.counts, last.changed))
    got = [next(resumed) for _ in range(3)]
    resumed.close()
    dense = [C.predict_dense(s.changed, len(x)) for s in want[split - 1:-1]]
    if split == 1:
        assert dense[0]
    if split == 6:
        assert not dense[0]
    for g, w in zip(got, want[split:]):
        assert g.changed == w.changed
        for name in ("c_used", "c_next", "assign", "best", "sums", "counts"):
            assert torch.equal(getattr(g, name), getattr(w, name)), name
