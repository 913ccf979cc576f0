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
from kmbench.faults import Broken

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


@pytest.mark.parametrize("fault", ["unchanged", "half", "moved", "early",
                                   "uniform"])
def test_a_fault_is_not(tree, fault):
    dtype, root = tree
    cells = _cells(dtype, WEIGHED if fault == "uniform" else
                   KMEANS + (KNN if fault == "moved" else []))
    for cell in cells:
        rc, res, err = run(root, cell, seconds=0, program=Broken(fault))
        assert rc == 0 and res["correct"] is False, (cell, fault, err)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_the_control_fails_at_the_cells_size(cell):
    """On the card, at the cell's own size: the control reads above a limit
    on three seeds (``control.py`` gives the readings themselves)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = H.find_cell(REPO, cell)
    prog = H.ReferenceProgram(H.LOWER[c.config["dtype"]])
    dev = torch.device("cuda", 0)
    for seed in (11, 2 ** 31 + 7, 4000000007):
        res = H.run_cell(c, seed, 0, False, prog, dev, 0.0, warm=False)
        assert res["correct"] is False, res["checks"]
