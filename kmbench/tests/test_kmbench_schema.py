"""The last line of a run keeps to its format: its keys, their types,
``checks`` last, and the checks again as the last lines of stderr."""

import json
import math

import pytest

from kmbench_tree import REPO, run, small_tree

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return small_tree(tmp_path_factory.mktemp("tree"))


def _number(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool) \
        and math.isfinite(v)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_last_line(tree, cell, trace):
    rc, res, err = run(tree, cell, seed=2 ** 31 + 11, seconds=0.3,
                       trace=trace)
    assert rc == 0, err
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert ("breakdown" in keys) == bool(trace)
    assert res["correct"] is True, err
    assert res["attempted"] >= 1 and res["failed"] == 0
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    chips = next(w["chips"] for w in SPEC["workloads"] if w["name"] == cell)
    assert dev["count"] == chips
    assert ("memory_peak_bytes_per_card" in dev) == (chips > 1)
    if trace:
        assert _number(dev["busy_s"]) and _number(dev["window_s"])
        for key in ("device_ops", "idle_gaps"):
            lst = res["breakdown"][key]
            assert len(lst) <= 10
            assert all(isinstance(n, str) and _number(s) for n, s in lst)
    want = {m["name"]: m["unit"] for m in SPEC["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}
    if not trace:
        assert {k: v["unit"] for k, v in res["metrics"].items()} == want
    for m in res["metrics"].values():
        assert _number(m["value"])
    for c in res["checks"].values():
        assert _number(c["value"]) and _number(c["limit"])
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert [line.split(":")[1].split()[-1] for line in tail] == \
        list(res["checks"])


def test_a_run_without_a_card_prints_nothing(tmp_path):
    import subprocess
    import sys
    proc = subprocess.run(
        [sys.executable, str(REPO / "kmbench" / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA card" in proc.stderr
