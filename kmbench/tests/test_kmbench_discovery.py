"""The harness finds a configuration, a traffic mix, limits and a per-layer
metric by their names alone, and BENCHMARK.json keeps to its format."""

import json
import re

import pytest

from kmbench_tree import REPO, H, run, small_tree

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())


def test_dropped_files_are_found_with_no_edit(tmp_path):
    root = small_tree(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    bench = root / "kmbench"
    (bench / "configs" / "dropped_cfg.json").write_text(json.dumps({
        "samples": 1500, "features": 8, "clusters": 12, "metric": "L2",
        "tolerance": 0.01, "dtype": "float32", "data": "uniform"}))
    (bench / "traffic" / "dropped_mix.json").write_text(json.dumps({
        "call": "kmeans", "kwargs": {"init": "random", "yinyang_t": 0,
                                     "max_iterations": 5},
        "traced_calls": 2, "judged_calls": 1}))
    (bench / "limits" / "dropped.cell.json").write_text(json.dumps({
        "failed_calls": 0, "bad_ids": 0, "trajectory_differs": 0,
        "init_off_rows": 0, "stop_early": 0, "churn_differs": 0,
        "assign_gap": 1e-3, "mean_gap": 1e-3}))
    (bench / "metrics" / "dropped_calls.kmeans.py").write_text(
        "def read(run):\n    return float(len(run.calls))\n")
    spec["configs"].append({"name": "dropped_cfg", "source": "x",
                            "file": "kmbench/configs/dropped_cfg.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "dropped.cell", "config": "dropped_cfg",
                              "traffic": "dropped_mix", "chips": 1,
                              "why": "x"})
    spec["per_layer"].append({"name": "dropped_calls.kmeans", "unit": "1",
                              "better": "lower", "source": "program_counter",
                              "layer": "x", "moves": "kmeans_s"})
    for m in spec["end_to_end"]:
        if m["name"] == "kmeans_s":
            m["workloads"].append("dropped.cell")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = H.find_cell(root, "dropped.cell")
    assert cell.config["clusters"] == 12
    assert cell.traffic["kwargs"]["max_iterations"] == 5
    assert "dropped_calls.kmeans" in [m["name"] for m in cell.per_layer]
    rc, res, err = run(root, "dropped.cell", trace=1)
    assert rc == 0, err
    assert res["correct"], err
    assert res["metrics"]["dropped_calls.kmeans"]["value"] == 2.0
    rc, res, err = run(root, "dropped.cell", trace=0, seconds=0.2)
    assert rc == 0 and res["correct"], err
    assert set(res["metrics"]) == {"kmeans_s", "peak_gb", "setup_s"}


def test_unknown_workload_fails(tmp_path):
    root = small_tree(tmp_path)
    rc, res, err = run(root, "no.such_cell")
    assert rc != 0 and res is None and "no workload" in err


def test_spec_names_and_units():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in SPEC["configs"]]
             + [w["name"] for w in SPEC["workloads"]]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
             + [w["traffic"] for w in SPEC["workloads"]])
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_spec_entries_and_files():
    cfg_keys = {"name", "source", "file", "reduced", "why"}
    for c in SPEC["configs"]:
        assert set(c) == cfg_keys
        assert (REPO / c["file"]).exists()
        assert c["file"].startswith(SPEC["paths"][0] + "/")
        assert 1 <= len(c["source"]) <= 200
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        bench = REPO / SPEC["paths"][0]
        assert (bench / "traffic" / (w["traffic"] + ".json")).exists()
        assert (bench / "limits" / (w["name"] + ".json")).exists()
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


def test_every_cell_reports_what_its_layers_move():
    cells = [w["name"] for w in SPEC["workloads"]]
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert H.metric_reader(REPO / "kmbench", m["name"])
        for w in m["workloads"]:
            assert w in cells
            mv = e2e[m["moves"]]
            assert "workloads" not in mv or w in mv["workloads"]
    for w in cells:
        cell = H.find_cell(REPO, w)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer, w


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_has_its_files(cell):
    c = H.find_cell(REPO, cell)
    assert c.limits and all(isinstance(v, (int, float))
                            for v in c.limits.values())
    assert c.traffic["call"] in ("kmeans", "knn")
