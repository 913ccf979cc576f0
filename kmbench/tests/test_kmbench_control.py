"""``correct`` comes out false for the control and for each fault a cell
can have, true for the program, through the whole of a run: these tests
skip the harness's look for a card and run each cell on the CPU at a
size a test run holds, with the cells' own limits.

The faults are ``kmbench.faults``'s, planted where the result is
produced, under the harness."""

import json

import pytest
import torch

from kmbench_tree import REPO, H, run, small_tree
from kmbench.faults import FAULTS, INSIDE, Broken

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
KMEANS = [w["name"] for w in SPEC["workloads"]
          if json.loads((REPO / "kmbench" / "traffic" /
                         (w["traffic"] + ".json")).read_text())["call"]
          == "kmeans"]
KNN = [w["name"] for w in SPEC["workloads"] if w["name"] not in KMEANS]
SIZE = dict(samples=4000, clusters=64)
#: cells that judge the weighting of their k-means++ starts
WEIGHED = [w["name"] for w in SPEC["workloads"]
           if "judged_starts" in json.loads(
               (REPO / "kmbench" / "traffic" / (w["traffic"] + ".json"))
               .read_text())]
#: cells over several cards, whose cards exchange their work
FOUR = [w["name"] for w in SPEC["workloads"] if w["chips"] > 1]


def _dtype(cell):
    return H.find_cell(REPO, cell).config["dtype"]


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def tree(request, tmp_path_factory):
    return request.param, small_tree(
        tmp_path_factory.mktemp("tree_" + request.param), **SIZE)


def _cells(dtype, cells):
    return [c for c in cells if _dtype(c) == dtype]


def test_the_program_is_correct(tree):
    dtype, root = tree
    for cell in _cells(dtype, KMEANS + KNN):
        rc, res, err = run(root, cell, seconds=0.2)
        assert rc == 0 and res["correct"], (cell, err)


def test_the_control_is_not(tree):
    dtype, root = tree
    for cell in _cells(dtype, KMEANS + KNN):
        rc, res, err = run(root, cell, seconds=0,
                           program=H.ReferenceProgram(H.LOWER[dtype]))
        assert rc == 0 and res["correct"] is False, (cell, err)


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_is_not(tree, fault):
    dtype, root = tree
    cells = _cells(dtype, WEIGHED if fault == "uniform" else
                   FOUR if fault in INSIDE else
                   KMEANS + (KNN if fault == "moved" else []))
    for cell in cells:
        rc, res, err = run(root, cell, seconds=0, program=Broken(fault))
        assert rc == 0 and res["correct"] is False, (cell, fault, err)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_the_control_fails_at_the_cells_size(cell):
    """On the card, at the cell's own size: the control reads above a limit
    on three seeds (``control.py`` gives the readings themselves)."""
    c = H.find_cell(REPO, cell)
    if torch.cuda.device_count() < c.chips:
        pytest.skip("needs %d CUDA cards" % c.chips)
    devs = [torch.device("cuda", i) for i in range(c.chips)]
    prog = H.control_program(c, devs)
    for seed in (11, 2 ** 31 + 7, 4000000007):
        res = H.run_cell(c, seed, 0, False, prog, devs, 0.0, warm=False)
        assert res["correct"] is False, res["checks"]


#: cells over several cards, whose control is the program's call with its
#: last assignment in the lower precision
STEP = FOUR


@pytest.mark.parametrize("cell", FOUR)
def test_a_fault_across_cards_reads_past_its_limit(cell, tmp_path):
    """The faults of the cards' exchange, on the CPU over logical cards:
    the sums of one shard left out move entries of the means past their
    rounding; draws from the leader's shard alone put every pick there."""
    root = small_tree(tmp_path, **SIZE)
    got = {}
    for fault in (None, "exchange", "lead_draw"):
        rc, res, err = run(root, cell, seconds=0,
                           program=Broken(fault) if fault else None)
        assert rc == 0, err
        got[fault] = {k: c["value"] for k, c in res["checks"].items()}
        limits = {k: c["limit"] for k, c in res["checks"].items()}
    assert got[None]["mean_off_rounding"] == 0
    assert 1 <= got[None]["init_shard_share"] < limits["init_shard_share"]
    assert got["exchange"]["mean_off_rounding"] > \
        100 * max(1, limits["mean_off_rounding"])
    assert got["lead_draw"]["init_shard_share"] == 4.0


@pytest.mark.parametrize("cell", STEP)
def test_the_step_control_is_not(cell, tmp_path):
    root = small_tree(tmp_path, **SIZE)
    c = H.find_cell(root, cell)
    rc, res, err = run(root, cell, seconds=0, program=H.control_program(
        c, [torch.device("cpu")] * c.chips))
    assert rc == 0 and res["correct"] is False, err
    assert res["checks"]["assign_gap"]["value"] > \
        res["checks"]["assign_gap"]["limit"], err


def test_control_readings_share_the_program_calls(tmp_path, capsys):
    """``control.py`` on one seed's data: the program, the control and the
    faults read as whole runs do, and a call the program made is not made
    again."""
    from kmbench import control
    from kmbench_tree import cpu_cards
    cell = (STEP or KMEANS)[0]
    root = small_tree(tmp_path, **SIZE)
    made = []

    class Counted(H.Program):
        def __init__(self):
            super().__init__()
            fn = self.kmeans_fn
            self.kmeans_fn = lambda *a, **kw: made.append(kw) or fn(*a, **kw)

    planted = []

    class Inside(Broken):
        def __init__(self, fault, devices=()):
            super().__init__(fault, devices)
            if fault in INSIDE:
                fn = self.kmeans_fn
                self.kmeans_fn = lambda *a, **kw: (planted.append(kw)
                                                   or fn(*a, **kw))

    with cpu_cards(), pytest.MonkeyPatch.context() as mp:
        mp.setattr("kmbench.faults.Broken", Inside)
        rc = control.main(["--workload", cell, "--program-seeds", "5",
                           "--control-seeds", "5,6", "--fault",
                           "unchanged,moved=5,exchange=6"], root=root,
                          device=torch.device("cpu"), program=Counted())
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    got = {(r["side"], r["seed"]): r for r in lines if "side" in r}
    assert got["program", 5]["correct"] is True
    assert all(r["correct"] is False for s, r in got.items()
               if s[0] != "program"), got
    assert {s for s in got if s[0].startswith("fault")} == {
        ("fault unchanged", 5), ("fault unchanged", 6), ("fault moved", 5),
        ("fault exchange", 6)}
    # the window's call and the judgement's two, each made once; the
    # fault planted inside the program makes its own
    assert len(made) == 3, made
    assert len(planted) == 3, planted
    assert lines[-1]["summary"]["assign_gap"]["control_min"] > \
        lines[-1]["summary"]["assign_gap"]["program_max"]
