"""The port's tracing (kmcuda_torch.utils.profiling): ``kmt.`` spans and
counter records under a torch.profiler session, nothing without one.

On the CPU the kernel wrappers run their plain twins, many torch ops
each; on a card each is one launch, so the coverage check here counts a
wrapper's span as one host event (the harness names an idle gap by the
innermost host event covering it among the last 400, kmbench/trace.py).
"""

import contextlib
import io
import json
import os
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kmcuda_torch import config, kmeans_cuda, knn_cuda
from kmcuda_torch.utils import profiling as P

torch.set_num_threads(2)

#: the spans of one kernel wrapper: a launch on a card
WRAPPERS = {"kmt.point_min", "kmt.weighted_draw", "kmt.fused_pass",
            "kmt.assign_pass", "kmt.moved_rows", "kmt.delta_sum",
            "kmt.walk"}
#: the harness's look-back when it names an idle gap
LOOK_BACK = 400
#: each span's enclosing kmt. span, by the layer map of PERF.md
PARENTS = {
    "kmt.kmeans": {None}, "kmt.knn": {None},
    "kmt.prepare": {"kmt.kmeans", "kmt.knn"},
    "kmt.output": {"kmt.kmeans", "kmt.knn"},
    "kmt.init": {"kmt.kmeans"},
    "kmt.init.step": {"kmt.init", "kmt.yinyang.grouping"},
    "kmt.point_min": {"kmt.init", "kmt.init.step", "kmt.yinyang.grouping"},
    "kmt.weighted_draw": {"kmt.init", "kmt.init.step",
                          "kmt.yinyang.grouping"},
    "kmt.lloyd": {"kmt.kmeans", "kmt.yinyang.grouping"},
    "kmt.lloyd.iteration": {"kmt.lloyd", "kmt.yinyang.draft"},
    "kmt.fused_pass": {"kmt.lloyd.iteration", "kmt.yinyang.assign"},
    "kmt.assign_pass": {"kmt.lloyd.iteration", "kmt.yinyang.assign"},
    "kmt.moved_rows": {"kmt.lloyd.iteration"},
    "kmt.delta_sum": {"kmt.lloyd.iteration", "kmt.yinyang.assign"},
    "kmt.yinyang.draft": {"kmt.kmeans"},
    "kmt.yinyang.grouping": {"kmt.kmeans"},
    "kmt.yinyang.layout": {"kmt.yinyang.grouping"},
    "kmt.yinyang.loop": {"kmt.kmeans"},
    "kmt.yinyang.iteration": {"kmt.yinyang.loop"},
    "kmt.yinyang.filter": {"kmt.yinyang.iteration"},
    "kmt.yinyang.assign": {"kmt.yinyang.iteration"},
    "kmt.yinyang.refresh": {"kmt.yinyang.iteration"},
    "kmt.yinyang.bounds": {"kmt.yinyang.iteration", "kmt.yinyang.refresh"},
    "kmt.knn.plan": {"kmt.knn"}, "kmt.knn.batch": {"kmt.knn"},
    "kmt.knn.finalize": {"kmt.knn"}, "kmt.walk": {"kmt.knn.batch"},
}
ITERATION = re.compile(r"^iteration \d+: \d+ reassignments$")
FILTER = re.compile(r"^yinyang: (\d+) candidates, (\d+) samples passed")
EXAMINED = re.compile(r"^calculated ([0-9.]+) of all the distances$")


@pytest.fixture(autouse=True)
def pinned_controller(monkeypatch):
    """Never gate, never revoke (tests/test_torch_yinyang.py's pin)."""
    monkeypatch.setattr(config, "YY_MIN_REMAINING", 0)
    monkeypatch.setattr(config, "YY_BAILOUT_MARGIN", float("inf"))


@pytest.fixture(scope="module")
def x():
    g = torch.Generator().manual_seed(0)
    return torch.rand((4000, 8), generator=g)


def _yinyang(x, verbosity=0):
    return kmeans_cuda(x, 64, tolerance=0.002, seed=3, verbosity=verbosity)


def _lloyd(x, verbosity=0):
    return kmeans_cuda(x, 64, tolerance=0.002, yinyang_t=0, seed=3,
                       verbosity=verbosity)


def _knn(x, verbosity=0):
    c, a = kmeans_cuda(x, 64, init="random", tolerance=0.01, yinyang_t=0,
                       seed=3, max_iterations=5)
    return knn_cuda(8, x, c, a, verbosity=verbosity)


CALLS = {"yinyang": _yinyang, "lloyd": _lloyd, "knn": _knn}


def _traced(fn, *args):
    """(result, host events [(name, start, end)] by start, stdout lines,
    the call's record)."""
    out = io.StringIO()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with contextlib.redirect_stdout(out):
            res = fn(*args)
    ev = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()),
                key=lambda e: e[1])
    return res, ev, out.getvalue().splitlines(), P.records()[-1]


def _parents(ev):
    """{span: the set of its enclosing kmt. spans' names}."""
    got, stack = {}, []
    for name, s, e in ev:
        if not name.startswith("kmt."):
            continue
        while stack and stack[-1][2] < e:
            stack.pop()
        got.setdefault(name, set()).add(stack[-1][0] if stack else None)
        stack.append((name, s, e))
    return got


def _uncovered(ev, top):
    """Host events inside the ``top`` spans with no kmt. span covering
    them among the LOOK_BACK events before, a wrapper's events counted as
    its one launch."""
    kept, inside_wrapper = [], -1
    for e in ev:
        if e[1] < inside_wrapper:
            continue
        kept.append(e)
        if e[0] in WRAPPERS:
            inside_wrapper = e[2]
    bad = []
    for _n, t0, t1 in [e for e in kept if e[0] == top]:
        inside = [e for e in kept if t0 <= e[1] and e[2] <= t1]
        for i, e in enumerate(inside):
            if not any(f[0].startswith("kmt.") and f[1] <= e[1]
                       and f[2] >= e[2]
                       for f in inside[max(0, i - LOOK_BACK):i + 1]):
                bad.append(e[0])
    return bad


def test_the_gate_flips_inside_a_session():
    """The flag the spans and counters read is torch's own: off, on in a
    torch.profiler session, off after it."""
    flag = lambda: torch.autograd.profiler._is_profiler_enabled  # noqa
    assert not flag()
    with profile(activities=[ProfilerActivity.CPU]):
        assert flag()
        assert P.span("kmt.x") is not P.span("kmt.y")
    assert not flag()
    assert P.span("kmt.x") is P.span("kmt.y")


@pytest.mark.parametrize("case", ["yinyang", "knn"])
def test_no_session_enters_no_span_and_keeps_no_record(x, case,
                                                        monkeypatch):
    def boom(*_a, **_k):
        raise AssertionError("a range entered with no session")

    monkeypatch.setattr(P, "_range", boom)
    monkeypatch.setattr(P, "record_function", boom)
    before = P.records()
    CALLS[case](x)
    after = P.records()
    assert len(after) == len(before)
    assert all(a is b for a, b in zip(after, before))
    assert P._current is None


@pytest.mark.parametrize("case", ["yinyang", "lloyd", "knn"])
def test_spans_nest_and_cover_the_call(x, case):
    _res, ev, _lines, rec = _traced(CALLS[case], x)
    got = _parents(ev)
    for name, parents in got.items():
        assert name in PARENTS, name
        assert parents <= PARENTS[name], (name, parents)
    top = "kmt.knn" if case == "knn" else "kmt.kmeans"
    want = {"knn": {"kmt.prepare", "kmt.knn.plan", "kmt.knn.batch",
                    "kmt.walk", "kmt.knn.finalize", "kmt.output"},
            "lloyd": {"kmt.prepare", "kmt.init", "kmt.init.step",
                      "kmt.point_min", "kmt.weighted_draw", "kmt.lloyd",
                      "kmt.lloyd.iteration", "kmt.fused_pass",
                      "kmt.assign_pass", "kmt.moved_rows", "kmt.delta_sum",
                      "kmt.output"},
            "yinyang": {"kmt.init", "kmt.yinyang.draft",
                        "kmt.yinyang.grouping", "kmt.yinyang.layout",
                        "kmt.yinyang.loop", "kmt.yinyang.iteration",
                        "kmt.yinyang.filter", "kmt.yinyang.assign",
                        "kmt.yinyang.refresh", "kmt.yinyang.bounds"}}[case]
    assert want <= set(got) and got[top] == {None}
    assert _uncovered(ev, top) == []
    assert rec["kind"] == top[4:]
    spans = [(s, e) for n, s, e in ev if n == top]
    assert len(spans) == 1
    assert spans[0][0] <= (rec["start_ns"] + rec["end_ns"]) // 2 \
        <= spans[0][1]


def _counter(rec, name):
    return [v for c, v in rec["counters"] if c == name]


def test_lloyd_counters_agree_with_the_lines(x):
    _res, _ev, lines, rec = _traced(_lloyd, x, 1)
    its = sum(1 for line in lines if ITERATION.match(line))
    moved = _counter(rec, "lloyd.moved_rows")
    assert its == sum(_counter(rec, "lloyd.dense")) + len(moved) > 0
    assert moved and all(m >= 0 for m in moved)
    assert _counter(rec, "init.steps") == [63]


def test_yinyang_counters_agree_with_the_lines(x):
    _res, _ev, lines, rec = _traced(_yinyang, x, 2)
    seen = [tuple(map(int, m.groups())) for m in map(FILTER.match, lines)
            if m]
    cands = _counter(rec, "yinyang.candidates")
    passed = _counter(rec, "yinyang.passed")
    assert seen and seen == list(zip(cands, passed))
    assert len(_counter(rec, "yinyang.patched")) == len(seen)
    assert _counter(rec, "yinyang.rows") == [4000]


def test_knn_counters_agree_with_the_line(x):
    _res, _ev, lines, rec = _traced(_knn, x, 1)
    line = [m.group(1) for m in map(EXAMINED.match, lines) if m]
    examined, = _counter(rec, "knn.examined")
    queries, = _counter(rec, "knn.queries")
    assert queries == 4000
    assert line == ["%f" % min(examined / float(queries) ** 2, 1.0)]


def test_the_ring_keeps_the_last_records():
    call = P.public_call("kmeans")(lambda: P.count("c", 1))
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(P.RING + 5):
            call()
    recs = P.records()
    assert len(recs) == P.RING
    assert all(r["counters"] == [["c", 1]] for r in recs)


@pytest.mark.parametrize("case", ["lloyd", "knn"])
def test_profile_window_writes_spans_and_counters(x, case, tmp_path,
                                                  monkeypatch):
    """KMTPU_PROFILE's trace holds the call's kmt. spans, and its record
    is written beside it."""
    c, a = _lloyd(x) if case == "knn" else (None, None)
    monkeypatch.setenv("KMTPU_PROFILE", str(tmp_path))
    if case == "knn":
        knn_cuda(8, x, c, a)
    else:
        _lloyd(x)
    traces = sorted(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in
             json.loads(traces[0].read_text())["traceEvents"]}
    want = ({"kmt.knn.plan", "kmt.knn.batch", "kmt.walk"} if case == "knn"
            else {"kmt.init", "kmt.lloyd", "kmt.lloyd.iteration"})
    assert want <= names
    stem = traces[0].name[:-len(".pt.trace.json")]
    rec = json.loads((tmp_path / (stem + ".counters.json")).read_text())
    assert rec["kind"] == case.replace("lloyd", "kmeans")
    assert rec["start_ns"] < rec["end_ns"]
    counted = {c for c, _v in rec["counters"]}
    assert counted >= ({"knn.examined", "knn.queries"} if case == "knn"
                       else {"init.steps", "lloyd.dense"})
    assert sorted(os.listdir(tmp_path)) == sorted(
        [traces[0].name, stem + ".counters.json"])
