"""The readers of the program's own spans and counters (``kmbench/spans.py``
and the metrics that use it) on synthetic traces whose answer is known,
and ``trace.events`` with the program's spans in the trace."""

import pytest
import torch

from kmbench_tree import REPO, H
from kmbench import roofline as R
from kmbench import trace as T
from kmcuda_torch.utils import profiling

MS = 1_000_000  # ns
SPANS = [(0, 100 * MS), (200 * MS, 300 * MS)]


def _read(name, run):
    return H.metric_reader(REPO / "kmbench", name)(run)


def _run(cell_name, device, host, spans=SPANS):
    cell = H.find_cell(REPO, cell_name)
    host = sorted(host + [T.Event(T.CALL_SPAN, a, b) for a, b in spans],
                  key=lambda e: e.start)
    window_s = sum(b - a for a, b in spans) / 1e9
    return H.TraceRun(cell, [H.Call(1, 0.0, [], None, "")] * len(spans),
                      spans, sorted(device, key=lambda e: e.start), host,
                      window_s, T.busy_ns(device, spans) / 1e9)


def _record(kind, span, counters):
    return {"kind": kind, "start_ns": span[0] + 1, "end_ns": span[1] - 1,
            "counters": [list(c) for c in counters]}


@pytest.fixture
def kept(monkeypatch):
    """Sets the records the program reports."""
    def put(recs):
        monkeypatch.setattr(profiling, "records", lambda: list(recs))
    return put


def test_kmeanspp_idle_per_step(kept):
    host, dev = [], []
    for s0, _s1 in SPANS:
        host.append(T.Event("kmt.init", s0 + 5 * MS, s0 + 45 * MS))
        dev.append(T.Event("point_min_kernel<float>", s0 + 10 * MS,
                           s0 + 20 * MS))
    kept([_record("kmeans", s, [("init.steps", 1023)]) for s in SPANS])
    run = _run("100k_fp32.default_call", dev, host)
    # 30 ms idle in each of the two inits, over 2 x 1023 steps
    assert _read("kmeanspp_idle_us_per_step.default_call", run) == \
        pytest.approx(60e3 / 2046)


@pytest.mark.parametrize("suffix, cell", [
    ("kmeans", "8m_bf16.kmeanspp_lloyd"),
    ("headline", "100k_fp32.random_lloyd15")])
def test_lloyd_idle_per_iteration(kept, suffix, cell):
    host, dev = [], []
    for s0, _s1 in SPANS:
        host.append(T.Event("kmt.lloyd", s0 + 10 * MS, s0 + 90 * MS))
        dev.append(T.Event("assign_kernel<float>", s0 + 10 * MS,
                           s0 + 70 * MS))
    kept([_record("kmeans", SPANS[0], [("lloyd.dense", 1), ("lloyd.dense", 1),
                                       ("lloyd.moved_rows", 9)]),
          _record("kmeans", SPANS[1], [("lloyd.dense", 1),
                                       ("lloyd.moved_rows", 0)])])
    run = _run(cell, dev, host)
    # 20 ms idle in each loop, over 5 iterations
    assert _read("lloyd_idle_ms_per_iteration." + suffix, run) == \
        pytest.approx(40.0 / 5)


def test_delta_roofline(kept):
    s0 = SPANS[0][0]
    host = [T.Event("kmt.delta_sum", s0 + 10 * MS, s0 + 11 * MS),
            T.Event("kmt.delta_sum", s0 + 50 * MS, s0 + 51 * MS)]
    dev = [T.Event("void seg_count_kernel(int)", s0 + 5 * MS, s0 + 6 * MS),
           T.Event("void seg_count_kernel(int)", s0 + 12 * MS, s0 + 13 * MS),
           T.Event("void seg_reduce_kernel<float>(x)", s0 + 13 * MS,
                   s0 + 15 * MS),
           T.Event("index_elementwise_kernel", s0 + 15 * MS, s0 + 16 * MS),
           T.Event("void assign_kernel<bf16>(x)", s0 + 20 * MS, s0 + 30 * MS),
           T.Event("void seg_reduce_kernel<float>(x)", s0 + 30 * MS,
                   s0 + 40 * MS),
           T.Event("void seg_reduce_kernel<float>(x)", s0 + 52 * MS,
                   s0 + 53 * MS)]
    kept([_record("kmeans", SPANS[0], [("lloyd.dense", 1),
                                       ("lloyd.moved_rows", 1000),
                                       ("lloyd.moved_rows", 0),
                                       ("lloyd.moved_rows", 3000)]),
          _record("kmeans", SPANS[1], [])])
    run = _run("8m_bf16.kmeanspp_lloyd", dev, host)
    bound = sum(R.delta_sum_bound(m, 256, 1024, "bfloat16")["ms"]
                for m in (1000, 3000))
    # the delta's seg_* kernels: 1 + 2 ms after the first span, 1 ms
    # after the second; not the one before it nor B1's after assign_kernel
    assert _read("delta_roofline.kmeans", run) == pytest.approx(
        100 * bound / 4.0)


def test_yinyang_passed_fraction(kept):
    kept([_record("kmeans", SPANS[0], [("yinyang.rows", 100),
                                       ("yinyang.passed", 100),
                                       ("yinyang.candidates", 100),
                                       ("yinyang.passed", 50),
                                       ("yinyang.passed", 30)]),
          _record("kmeans", SPANS[1], [("yinyang.rows", 100),
                                       ("yinyang.passed", 20)])])
    run = _run("100k_fp32.default_call", [], [])
    assert _read("yinyang_passed_fraction.default_call", run) == \
        pytest.approx(200 / 400)


def test_knn_plan_ms():
    host, dev = [], []
    for s0, _s1 in SPANS:
        host.append(T.Event("kmt.knn.plan", s0 + 2 * MS, s0 + 12 * MS))
        dev.append(T.Event("reduce_kernel", s0 + 11 * MS, s0 + 14 * MS))
        dev.append(T.Event("void walk_kernel<float>(x)", s0 + 15 * MS,
                           s0 + 95 * MS))
    host[1] = T.Event("kmt.knn.plan", 202 * MS, 214_500_000)
    run = _run("100k_fp32.knn16", dev, host)
    # 12 ms (the last kernel started inside ends 2 ms past the span) and
    # 12.5 ms (it ends inside); the walk starts after both
    assert _read("knn_plan_ms.knn", run) == pytest.approx(12.25)


NEW = ["kmeanspp_idle_us_per_step.default_call",
       "lloyd_idle_ms_per_iteration.headline",
       "lloyd_idle_ms_per_iteration.kmeans", "delta_roofline.kmeans",
       "yinyang_passed_fraction.default_call", "knn_plan_ms.knn"]


def _cell_of(name):
    return {"default_call": "100k_fp32.default_call",
            "headline": "100k_fp32.random_lloyd15",
            "kmeans": "8m_bf16.kmeanspp_lloyd",
            "knn": "100k_fp32.knn16"}[name.split(".")[1]]


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_spans_or_records_reads_nothing(name, kept,
                                                          monkeypatch):
    """An older program: no kmt. span in the trace, no records kept (or no
    ``records`` at all)."""
    dev = [T.Event("void assign_kernel<float>(x)", 10 * MS, 20 * MS),
           T.Event("void seg_reduce_kernel<float>(x)", 20 * MS, 30 * MS)]
    host = [T.Event("aten::add", 5 * MS, 6 * MS)]
    kept([])
    run = _run(_cell_of(name), dev, host)
    assert _read(name, run) is None
    monkeypatch.delattr(profiling, "records")
    assert _read(name, run) is None


@pytest.mark.parametrize("fault", ["count", "kind", "outside"])
def test_records_that_do_not_pair_read_nothing(fault, kept):
    from kmbench import spans as S

    recs = [_record("kmeans", s, [("init.steps", 7)]) for s in SPANS]
    if fault == "count":
        recs = recs[1:]
    elif fault == "kind":
        recs[1]["kind"] = "knn"
    else:
        recs[0] = _record("kmeans", (150 * MS, 160 * MS), [])
    kept(recs)
    host = [T.Event("kmt.init", s0 + 5 * MS, s0 + 45 * MS)
            for s0, _s1 in SPANS]
    run = _run("100k_fp32.default_call", [], host)
    assert S.records(run) is None
    assert _read("kmeanspp_idle_us_per_step.default_call", run) is None
    kept([_record("kmeans", (0, 1), [])] + [
        _record("kmeans", s, [("init.steps", 7)]) for s in SPANS])
    assert S.records(run) is not None   # the last len(spans) records pair


class _Kineto:
    """A finished profiler's Kineto event, as ``trace.events`` reads it."""

    def __init__(self, name, start, dur, cuda, annotation):
        self._n, self._s, self._d = name, start, dur
        self._cuda, self._a = cuda, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._cuda
                else torch.autograd.DeviceType.CPU)

    def device_index(self):
        return 0

    def is_user_annotation(self):
        return self._a


class _Prof:
    def __init__(self, events):
        kineto = type("K", (), {"events": lambda _self: events})()
        self.profiler = type("P", (), {"kineto_results": kineto})()


def test_events_keep_device_and_host_lists_with_program_spans():
    """A kmt. span's host range joins the host list, where it names idle
    gaps; its device copy (a range over its kernels, not work) stays out
    of the device list, so busy time and every device metric read as
    without it."""
    base = [_Kineto("void assign_kernel<float>(x)", 10, 5, True, False),
            _Kineto("Memcpy DtoH (Device -> Pageable)", 20, 2, True, False),
            _Kineto(T.CALL_SPAN, 0, 40, False, True),
            _Kineto(T.CALL_SPAN, 8, 20, True, True),
            _Kineto("aten::add", 3, 2, False, False)]
    spans = [_Kineto("kmt.lloyd", 1, 30, False, True),
             _Kineto("kmt.lloyd", 9, 15, True, True),
             _Kineto("kmt.fused_pass", 2, 3, False, True),
             _Kineto("kmt.fused_pass", 10, 5, True, True)]
    dev0, host0 = T.events(_Prof(base))
    dev1, host1 = T.events(_Prof(base + spans))
    assert dev1 == dev0 == [T.Event("void assign_kernel<float>(x)", 10, 15),
                            T.Event("Memcpy DtoH (Device -> Pageable)", 20,
                                    22)]
    assert [e for e in host1 if not e.name.startswith("kmt.")] == host0
    assert [e.name for e in host1 if e.name.startswith("kmt.")] == [
        "kmt.lloyd", "kmt.fused_pass"]
