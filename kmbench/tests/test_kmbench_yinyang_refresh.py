"""The readers of Yinyang's bound refreshes (``yinyang_refreshed_fraction``
and ``yinyang_refresh_roofline``) on synthetic traces whose answer is
known: a card that runs a refresh's operations long after the host left
its span, a launch the trace leaves out, a sync that is a copy too, and
both cells that list them."""

import importlib.util

import pytest

from kmbench_tree import REPO, H
from kmbench import trace as T
from kmcuda_torch.utils import profiling

MS = 1_000_000  # ns
SPANS = [(0, 100 * MS), (200 * MS, 300 * MS)]
CELLS = ["k40k_f480_bf16.random_yinyang", "8m_bf16.default_call"]
SUFFIX = {CELLS[0]: ".k40k", CELLS[1]: ".default_8m"}


def _module(name):
    path = REPO / "kmbench" / "metrics" / (name + ".py")
    spec = importlib.util.spec_from_file_location("t_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ROOF = _module("yinyang_refresh_roofline")


def _read(stem, cell, run):
    return H.metric_reader(REPO / "kmbench", stem + SUFFIX[cell])(run)


def _run(cell_name, device, host, spans=SPANS):
    cell = H.find_cell(REPO, cell_name)
    host = sorted(host + [T.Event(T.CALL_SPAN, a, b) for a, b in spans],
                  key=lambda e: e.start)
    window_s = sum(b - a for a, b in spans) / 1e9
    return H.TraceRun(cell, [H.Call(1, 0.0, [], None, "")] * len(spans),
                      spans, sorted(device, key=lambda e: e.start), host,
                      window_s, T.busy_ns(device, spans) / 1e9)


def _record(span, counters):
    return {"kind": "kmeans", "start_ns": span[0] + 1, "end_ns": span[1] - 1,
            "counters": [list(c) for c in counters]}


@pytest.fixture
def kept(monkeypatch):
    """Sets the records the program reports."""
    def put(recs):
        monkeypatch.setattr(profiling, "records", lambda: list(recs))
    return put


def _bound_s(cell, rows):
    c = H.find_cell(REPO, cell)
    cfg = c.config
    k = int(cfg["clusters"])
    groups = int(c.traffic["kwargs"].get("yinyang_t", 0.1) * k)
    return ROOF.refresh_bound(rows, int(cfg["samples"]), int(cfg["features"]),
                              k, groups, cfg["dtype"])["ms"] / 1e3


def _launch(t, name="cudaLaunchKernel", length=10_000):
    return T.Event(name, t, t + length)


def _lagging_call(s0, lag):
    """One call from ``s0``: work before a sync, one launch after it, a
    refresh span of three launches, one launch after the span and a sync
    that drains the card.  The card runs
    the five launches ``lag`` ns after the host makes them, past the
    span's end.  Returns (host, device, the refresh's device ns)."""
    host = [_launch(s0 + 1 * MS),
            T.Event("cudaStreamSynchronize", s0 + 2 * MS, s0 + 3 * MS),
            _launch(s0 + 4 * MS),
            T.Event(ROOF.SPAN, s0 + 5 * MS, s0 + 9 * MS),
            _launch(s0 + 6 * MS), _launch(s0 + 7 * MS, "cudaMemsetAsync"),
            _launch(s0 + 8 * MS, "cudaLaunchKernelExC"),
            _launch(s0 + 10 * MS),
            T.Event("cudaStreamSynchronize", s0 + 11 * MS,
                    s0 + 11 * MS + lag + 20 * MS)]
    t = s0 + 4 * MS + lag
    dev = [T.Event("before_sync_kernel", s0 + 1 * MS + 5_000,
                   s0 + 2 * MS + 500_000)]
    for name, length in (("pre_kernel", 2), ("gemm_kernel", 6),
                         ("Memset (Device)", 1), ("amin_kernel", 3),
                         ("post_kernel", 4)):
        dev.append(T.Event(name, t, t + length * MS))
        t += length * MS
    return host, dev, 10 * MS


@pytest.mark.parametrize("cell", CELLS)
def test_refresh_roofline_on_a_lagging_card(kept, cell):
    host, dev = [], []
    for s0, _s1 in SPANS:
        h, d, want_ns = _lagging_call(s0, lag=30 * MS)
        host += h
        dev += d
    kept([_record(s, [("yinyang.rows", 1000),
                      ("yinyang.refreshed_rows", 1000),
                      ("yinyang.passed", 1000)]) for s in SPANS])
    run = _run(cell, dev, host)
    # nothing of the card's work starts inside a span: the refresh's
    # operations run 30 ms after the host left it
    assert not any(s0 <= e.start < s1 for e in dev
                   for s0, s1 in [(s + 5 * MS, s + 9 * MS)
                                  for s, _ in SPANS])
    assert ROOF.refresh_device_ns(run) == [want_ns, want_ns]
    assert _read("yinyang_refresh_roofline", cell, run) == pytest.approx(
        100.0 * _bound_s(cell, 1000) / (want_ns / 1e9))


def test_refresh_roofline_leaves_out_a_stretch_that_does_not_count(kept):
    cell = CELLS[0]
    h0, d0, want = _lagging_call(SPANS[0][0], lag=30 * MS)
    h1, d1, _ = _lagging_call(SPANS[1][0], lag=30 * MS)
    # the second call's trace shows one launch fewer than the card ran
    h1 = [e for e in h1 if e.start != SPANS[1][0] + 4 * MS]
    kept([_record(s, [("yinyang.rows", 1000),
                      ("yinyang.refreshed_rows", r),
                      ("yinyang.passed", 1000)])
          for s, r in zip(SPANS, (1000, 300))])
    run = _run(cell, d0 + d1, h0 + h1)
    assert ROOF.refresh_device_ns(run) == [want, None]
    assert _read("yinyang_refresh_roofline", cell, run) == pytest.approx(
        100.0 * _bound_s(cell, 1000) / (want / 1e9))
    run = _run(cell, d1, h1, spans=SPANS[1:])
    kept([_record(SPANS[1], [("yinyang.rows", 1000),
                             ("yinyang.refreshed_rows", 300),
                             ("yinyang.passed", 1000)])])
    assert _read("yinyang_refresh_roofline", cell, run) is None


def test_refresh_roofline_after_a_copy_that_syncs(kept):
    """A synchronous cudaMemcpy is both a launch and a sync: as the stretch's
    end its copy is one of the stretch's operations."""
    cell = CELLS[1]
    s0 = SPANS[0][0]
    host = [T.Event("cudaStreamSynchronize", s0 + 1 * MS, s0 + 2 * MS),
            T.Event(ROOF.SPAN, s0 + 3 * MS, s0 + 5 * MS),
            _launch(s0 + 4 * MS),
            T.Event("cudaMemcpy", s0 + 6 * MS, s0 + 30 * MS)]
    dev = [T.Event("gemm_kernel", s0 + 10 * MS, s0 + 25 * MS),
           T.Event("Memcpy DtoH (Device -> Pageable)", s0 + 25 * MS,
                   s0 + 26 * MS)]
    kept([_record(SPANS[0], [("yinyang.rows", 500),
                             ("yinyang.refreshed_rows", 500),
                             ("yinyang.passed", 500)])])
    run = _run(cell, dev, host, spans=SPANS[:1])
    assert ROOF.refresh_device_ns(run) == [15 * MS]


def test_refresh_bound_counts_the_work_at_k():
    # 4M x 480 bf16, k = 40,000, 4,000 groups: bf16 bounds (4 n G bytes
    # pass 2 GB); operations 2 n k f at the fp32-product rate
    b = ROOF.refresh_bound(4_000_000, 4_000_000, 480, 40_000, 4_000,
                           "bfloat16")
    assert b["ops"] == {"fp32 product": 2.0 * 4e6 * 4e4 * 480}
    assert b["bytes"] == 4e6 * 480 * 2 + 4 * 4e4 * 480 + 4e6 * 4e3 * 2
    assert b["by"] == "operations"
    # 100K x 256 fp32, 102 groups: fp32 bounds
    small = ROOF.refresh_bound(10, 100_000, 256, 1024, 102, "float32")
    assert small["bytes"] == 10 * 256 * 4 + 4 * 1024 * 256 + 10 * 102 * 4


@pytest.mark.parametrize("cell", CELLS)
def test_refreshed_fraction(kept, cell):
    kept([_record(SPANS[0], [("yinyang.rows", 1000),
                             ("yinyang.refreshed_rows", 1000),
                             ("yinyang.passed", 1000),
                             ("yinyang.refreshed_rows", 40),
                             ("yinyang.passed", 300),
                             ("yinyang.passed", 200)]),
          _record(SPANS[1], [("yinyang.rows", 1000),
                             ("yinyang.refreshed_rows", 1000),
                             ("yinyang.passed", 1000),
                             ("yinyang.refreshed_rows", 1000),
                             ("yinyang.passed", 1000)])])
    run = _run(cell, [], [])
    # 3,040 rows refreshed of 5 iterations x 1,000 rows
    assert _read("yinyang_refreshed_fraction", cell, run) == \
        pytest.approx(3040 / 5000)


def test_refreshed_fraction_reads_nothing_without_records(kept):
    kept([])
    assert _read("yinyang_refreshed_fraction", CELLS[0],
                 _run(CELLS[0], [], [])) is None
