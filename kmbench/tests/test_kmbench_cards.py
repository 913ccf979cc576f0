"""A cell over several cards against the same cell on one: its data, its
call, its last line and its judgement, run on the CPU over logical
devices; and the trace's arithmetic and readers over several cards."""

import json
import shutil

import pytest
import torch

from kmbench_tree import REPO, H, run, small_tree
from kmbench import roofline as R
from kmbench import trace as T

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
FOUR = [w["name"] for w in SPEC["workloads"] if w["chips"] > 1]
ONE = [w["name"] for w in SPEC["workloads"] if w["chips"] == 1]
CPU = torch.device("cpu")
MS = 1_000_000  # ns


def test_host_samples_are_the_card_samples(monkeypatch):
    monkeypatch.setattr(H, "DATA_BLOCK_ROWS", 1000)
    for kind in ("uniform", "blobs"):
        cfg = {"samples": 3017, "features": 8, "dtype": "bfloat16",
               "data": kind, "blob_centers": 5, "blob_spread": 10.0}
        on_card = H.make_samples(cfg, 2 ** 31 + 5, CPU)
        host = H.make_samples(cfg, 2 ** 31 + 5, CPU, host=True)
        assert torch.equal(on_card, host)
        ptr = host.data_ptr()
        again = H.make_samples(cfg, 2 ** 31 + 6, CPU, host=True, out=host)
        assert again.data_ptr() == ptr  # the same memory, refilled
        assert not torch.equal(on_card, again)


@pytest.mark.parametrize("cell", ONE)
def test_a_one_card_cell_makes_the_call_it_made(cell):
    c = H.find_cell(REPO, cell)
    runner = H.Runner(c, None, None, [CPU])
    want = dict(tolerance=c.config["tolerance"], metric=c.config["metric"])
    want.update(c.traffic.get("kwargs", {}))
    assert c.chips == 1 and runner.kw == want


@pytest.mark.parametrize("cell", FOUR)
def test_a_four_card_cell_names_its_cards(cell):
    c = H.find_cell(REPO, cell)
    runner = H.Runner(c, None, None, [CPU] * c.chips)
    assert runner.kw["device"] == (1 << c.chips) - 1


class OneShard(H.Program):
    """The program on the samples as one shard, whatever mask it is given
    (the mask is recorded): its results do not depend on the cards, so a
    run over four logical cards and a run on one must judge alike."""

    masks = []

    def kmeans(self, x, k, device=0, **kw):
        self.masks.append(device)
        return super().kmeans(x, k, **kw)


@pytest.mark.parametrize("cell", FOUR)
def test_four_cards_judge_as_one(cell, tmp_path):
    root = small_tree(tmp_path, samples=4001, clusters=64)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    w4 = next(w for w in spec["workloads"] if w["name"] == cell)
    twin = dict(w4, name="twin.one_card", chips=1)
    spec["workloads"].append(twin)
    for m in spec["end_to_end"] + spec["per_layer"]:
        if cell in m.get("workloads", []):
            m["workloads"].append(twin["name"])
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    shutil.copy(root / "kmbench" / "limits" / (cell + ".json"),
                root / "kmbench" / "limits" / "twin.one_card.json")
    got = {}
    for name in (cell, twin["name"]):
        for trace in (0, 1):
            OneShard.masks = []
            rc, res, err = run(root, name, seed=2 ** 31 + 3, seconds=0,
                               trace=trace, program=OneShard())
            assert rc == 0 and res["correct"], err
            got[name, trace] = res, set(OneShard.masks)
    chips = w4["chips"]
    assert got[cell, 0][1] == {(1 << chips) - 1}
    assert got[twin["name"], 0][1] == {0}
    for trace in (0, 1):
        four, one = got[cell, trace][0], got[twin["name"], trace][0]
        assert four["checks"].keys() == one["checks"].keys()
        for k, c in one["checks"].items():
            if k == "init_shard_share":
                # the picks over the cards' row parts: one part reads 1
                assert c["value"] == 1.0
                assert 1.0 <= four["checks"][k]["value"] <= c["limit"]
                continue
            assert four["checks"][k]["value"] == pytest.approx(
                c["value"], rel=1e-9, abs=0), k
        d4, d1 = four["device"], one["device"]
        assert (d4["count"], d1["count"]) == (chips, 1)
        assert d4["memory_peak_bytes"] == d1["memory_peak_bytes"]
        assert d4["memory_peak_bytes_per_card"] == [0] * chips
        assert "memory_peak_bytes_per_card" not in d1
        if trace:
            assert d4["busy_s"] == d1["busy_s"]
            assert d4["window_s"] > 0 and d1["window_s"] > 0
        else:
            assert four["metrics"].keys() == one["metrics"].keys()


def _on(events, card):
    return [e._replace(device=card) for e in events]


EV = [T.Event("a_kernel<float>", 0, 4), T.Event("b_kernel", 2, 6),
      T.Event("a_kernel<float>", 10, 12)]
HOST = [T.Event(T.CALL_SPAN, 0, 20), T.Event("aten::nonzero", 6, 10),
        T.Event("cudaStreamSynchronize", 12, 20)]


def test_busy_is_each_cards_own_and_the_mean():
    spans = [(0, 20)]
    four = [e for d in range(4) for e in _on(EV, d)]
    assert T.busy_ns(EV, spans) == 8
    assert T.busy_ns(four, spans, 4) == 8
    assert T.busy_ns(EV, spans, 4) == 2      # three cards ran nothing
    assert T.busy_ns(EV + _on([T.Event("c", 0, 20)], 1), spans, 2) == 14
    assert T.busy_ns_per_card(four, spans) == {0: 8, 1: 8, 2: 8, 3: 8}
    assert dict(T.device_ops(four, spans, cards=4)) == {
        "a_kernel<float> (4 cards)": 24e-9, "b_kernel (4 cards)": 16e-9}
    assert dict(T.device_ops(EV, spans)) == {"a_kernel<float>": 6e-9,
                                             "b_kernel": 4e-9}
    one = dict(T.idle_gaps(EV, HOST, spans))
    assert one == {"aten::nonzero": 4e-9, "cudaStreamSynchronize": 8e-9}
    assert dict(T.idle_gaps(four, HOST, spans, cards=4)) == one
    # a card idle throughout adds its whole span to the mean
    half = dict(T.idle_gaps(EV, HOST, spans, cards=2))
    assert sum(half.values()) == pytest.approx((12 + 20) / 2 * 1e-9)


def _call(lines):
    return H.Call(1, 0.0, lines, None, "")


def _trace(cell, dev, host, spans, calls):
    c = H.find_cell(REPO, cell)
    host = sorted(host + [T.Event(T.CALL_SPAN, a, b) for a, b in spans],
                  key=lambda e: e.start)
    dev = sorted(dev, key=lambda e: e.start)
    window_s = sum(b - a for a, b in spans) / 1e9
    return H.TraceRun(c, calls, spans, dev, host, window_s,
                      T.busy_ns(dev, spans, c.chips) / 1e9)


@pytest.mark.parametrize("cell", FOUR)
def test_readers_over_four_cards(cell, monkeypatch):
    """The same work on each of four cards reads as it does on one card;
    the loop's start is the first ``assign_kernel`` on any card."""
    from kmcuda_torch.utils import profiling
    spans = [(0, 100 * MS), (200 * MS, 300 * MS)]
    host, dev = [], []
    for s0, _s1 in spans:
        host += [T.Event("kmt.prepare", s0, s0 + 8 * MS),
                 T.Event("kmt.init", s0 + 10 * MS, s0 + 50 * MS)]
        dev += [T.Event("point_min_kernel<bf16>", s0 + 20 * MS,
                        s0 + 30 * MS),
                T.Event("void assign_kernel<bf16>(x)", s0 + 60 * MS,
                        s0 + 70 * MS)]
        host.append(T.Event("kmt.lloyd", s0 + 55 * MS, s0 + 100 * MS))
    recs = [{"kind": "kmeans", "start_ns": a + 1, "end_ns": b - 1,
             "counters": [["init.steps", 1023], ["lloyd.dense", 4]]}
            for a, b in spans]
    monkeypatch.setattr(profiling, "records", lambda: list(recs))
    calls = [_call(["iteration %d: 5 reassignments" % i
                    for i in (1, 2, 3, 4)])] * 2
    one = _trace("8m_bf16.kmeanspp_lloyd", dev, host, spans, calls)
    four = _trace(cell, [e for d in range(4) for e in _on(dev, d)], host,
                  spans, calls)
    rd = {m: H.metric_reader(REPO / "kmbench", m) for m in (
        "device_idle", "kmeanspp_idle_us_per_step", "lloyd_ms_per_iteration",
        "copy_in_roofline", "prepare_init_s", "lloyd_idle_ms_per_iteration",
        "assign_roofline", "mfu")}
    for stem in ("device_idle", "kmeanspp_idle_us_per_step",
                 "lloyd_ms_per_iteration", "prepare_init_s",
                 "lloyd_idle_ms_per_iteration"):
        assert rd[stem](four) == pytest.approx(rd[stem](one)), stem
    assert rd["prepare_init_s"](four) == pytest.approx(0.060)
    # 45 ms of kmt.lloyd a call, 10 of them busy, over 4 iterations
    assert rd["lloyd_idle_ms_per_iteration"](four) == pytest.approx(35 / 4)
    # each card's launches score its own shard; the peak is four cards'
    cfg = four.cell.config
    n, f, k, dt = (cfg["samples"], cfg["features"], cfg["clusters"],
                   cfg["dtype"])
    chips = four.cell.chips
    shard = R.assign_bound(n // chips, f, k, dt)["ms"] / 1e3
    assert rd["assign_roofline"](four) == pytest.approx(
        100 * 2 * shard / 0.020)
    assert rd["mfu"](four) == pytest.approx(
        100 * 2.0 * n * k * f * 8 / (R.PEAK_OPS_PER_S["bf16"] * chips) / 0.2)
    assert rd["device_idle"](four) == pytest.approx(80.0)
    assert rd["kmeanspp_idle_us_per_step"](four) == pytest.approx(
        2 * 30e3 / 2046)
    assert rd["lloyd_ms_per_iteration"](four) == pytest.approx(40 / 4)
    # the loop starts at the first assign_kernel on any card
    early = four._replace(device_events=sorted(
        four.device_events + [T.Event("assign_kernel<bf16>", 56 * MS,
                                      57 * MS, 3)], key=lambda e: e.start))
    assert rd["lloyd_ms_per_iteration"](early) == pytest.approx(
        (44 + 40) / 8)
    cfg = four.cell.config
    nbytes = cfg["samples"] * cfg["features"] * 2
    link = nbytes / (four.cell.chips * 64e9)
    assert rd["copy_in_roofline"](four) == pytest.approx(100 * link / 0.008)
