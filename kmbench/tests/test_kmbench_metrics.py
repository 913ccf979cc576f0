"""Every per-layer metric's reader on a synthetic trace whose answer is
known, and the trace arithmetic under them."""

import json

import pytest

from kmbench_tree import REPO, H
from kmbench import roofline as R
from kmbench import trace as T

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
MS = 1_000_000  # ns


def _run(cell_name, calls, device, spans):
    cell = H.find_cell(REPO, cell_name)
    window_s = sum(b - a for a, b in spans) / 1e9
    busy_s = T.busy_ns(device, spans) / 1e9
    return H.TraceRun(cell, calls, spans, device, [], window_s, busy_s)


def _call(lines):
    return H.Call(1, 0.0, lines, None, "")


def _lloyd_trace(cell_name, iters=3, assign_ms=2, gap_ms=1, start_ms=5):
    """Two calls of ``iters`` iterations: ``start_ms`` of init, then one
    ``assign_kernel`` of ``assign_ms`` and a gap of ``gap_ms`` an
    iteration."""
    ev, spans, calls = [], [], []
    t = 0
    for _ in range(2):
        s0 = t
        ev.append(T.Event("point_min_kernel<float>", t, t + start_ms * MS))
        t += start_ms * MS
        for _ in range(iters):
            ev.append(T.Event("void assign_kernel<float>(float const*)", t,
                              t + assign_ms * MS))
            t += (assign_ms + gap_ms) * MS
        spans.append((s0, t))
        calls.append(_call(["iteration %d: 9 reassignments" % (i + 1)
                            for i in range(iters)]))
        t += 50 * MS
    return _run(cell_name, calls, ev, spans)


@pytest.mark.parametrize("suffix, cell", [
    ("kmeans", "8m_bf16.kmeanspp_lloyd"),
    ("headline", "100k_fp32.random_lloyd15")])
def test_lloyd_readers(suffix, cell):
    run = _lloyd_trace(cell)
    read = {m: H.metric_reader(REPO / "kmbench", m + "." + suffix)(run)
            for m in ("device_idle", "assign_roofline", "mfu",
                      "lloyd_ms_per_iteration")}
    # per call 14 ms: 5 + 3 x 2 busy, 3 x 1 idle
    assert read["device_idle"] == pytest.approx(100 * 3 / 14)
    assert read["lloyd_ms_per_iteration"] == pytest.approx(3.0)
    cfg = run.cell.config
    n, f, k, dt = (cfg["samples"], cfg["features"], cfg["clusters"],
                   cfg["dtype"])
    bound = R.assign_bound(n, f, k, dt)["ms"]
    assert read["assign_roofline"] == pytest.approx(100 * bound / 2)
    peak = R.PEAK_OPS_PER_S["bf16" if dt == "bfloat16" else "fp32 product"]
    assert read["mfu"] == pytest.approx(
        100 * 2.0 * n * k * f * 6 / peak / 0.028)
    if suffix == "kmeans":
        pi = H.metric_reader(REPO / "kmbench", "prepare_init_s.kmeans")(run)
        assert pi == pytest.approx(0.005)


def test_assign_roofline_counts_launches():
    """A share per launch, whatever the iteration lines say."""
    run = _lloyd_trace("8m_bf16.kmeanspp_lloyd", iters=4)
    run = run._replace(calls=[_call(["iteration 1: 5 reassignments"])] * 2)
    bound = R.assign_bound(8_000_000, 256, 1024, "bfloat16")["ms"]
    assert T.assign_roofline(run) == pytest.approx(100 * bound / 2)


def test_default_call_readers():
    run = _lloyd_trace("100k_fp32.default_call", iters=4)
    idle = H.metric_reader(REPO / "kmbench", "device_idle.default_call")(run)
    yy = H.metric_reader(REPO / "kmbench",
                         "yinyang_ms_per_iteration.default_call")(run)
    pi = H.metric_reader(REPO / "kmbench", "prepare_init_s.default_call")(run)
    assert idle == pytest.approx(100 * 4 / 17)
    assert yy == pytest.approx(3.0) and pi == pytest.approx(0.005)


def test_knn_readers():
    ev = [T.Event("void walk_kernel<float>(x)", 0, 8 * MS),
          T.Event("Memcpy DtoH (Device -> Pageable)", 8 * MS, 9 * MS),
          T.Event("void walk_kernel<float>(x)", 20 * MS, 28 * MS)]
    spans = [(0, 10 * MS), (20 * MS, 30 * MS)]
    calls = [_call(["calculated 0.500000 of all the distances"])] * 2
    run = _run("100k_fp32.knn16", calls, ev, spans)
    rd = {m: H.metric_reader(REPO / "kmbench", m)(run)
          for m in ("device_idle.knn", "walk_roofline.knn",
                    "examined_fraction.knn")}
    assert rd["device_idle.knn"] == pytest.approx(100 * 3 / 20)
    assert rd["examined_fraction.knn"] == 0.5
    n, f = 100_000, 256
    b = R.walk_ops_bound(0.5 * n * n, f, "float32")["ms"] / 1e3
    assert rd["walk_roofline.knn"] == pytest.approx(100 * 2 * b / 0.016)


def test_readers_find_nothing_in_an_empty_trace():
    for m in SPEC["per_layer"]:
        cell = H.find_cell(REPO, m["workloads"][0])
        run = H.TraceRun(cell, [_call([])], [(0, MS)], [], [], 0.001, 0.0)
        assert H.metric_reader(REPO / "kmbench", m["name"])(run) is None, m


def test_union_gaps_and_ops():
    ev = [T.Event("a_kernel<float>", 0, 4), T.Event("b_kernel", 2, 6),
          T.Event("a_kernel<float>", 10, 12)]
    host = [T.Event(T.CALL_SPAN, 0, 20), T.Event("aten::nonzero", 6, 10),
            T.Event("cudaStreamSynchronize", 12, 20)]
    spans = [(0, 20)]
    assert T.union_ns([(0, 4), (2, 6), (10, 12)]) == 8
    assert T.busy_ns(ev, spans) == 8
    ops = dict(T.device_ops(ev, spans))
    assert ops == {"a_kernel<float>": 6e-9, "b_kernel": 4e-9}
    gaps = dict(T.idle_gaps(ev, host, spans))
    assert gaps == {"aten::nonzero": 4e-9, "cudaStreamSynchronize": 8e-9}
