"""Nothing the harness, the traffic, the metrics or the references import
has the top-level name jax, jaxlib, flax or kmcuda_tpu (the part before
the first dot, compared whole: kmcuda_torch is not kmcuda_tpu), and the
references import nothing of kmcuda_torch."""

import ast
import subprocess
import sys

import pytest

from kmbench_tree import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "kmcuda_tpu"}
SOURCES = sorted(p for p in (REPO / "kmbench").rglob("*.py"))
REFERENCE = sorted((REPO / "kmbench" / "reference").glob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_in_the_sources(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    for m in _imports(path):
        assert m.split(".")[0] in {"torch", "contextlib", "concurrent",
                                   "kmbench"}, m
        if m.split(".")[0] == "kmbench":
            assert m.startswith("kmbench.reference"), m


def _loaded(code):
    proc = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"
    )], capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return set(eval(proc.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    tops = _loaded(
        "import kmbench.harness as H, kmbench.trace, kmbench.roofline\n"
        "import kmbench.reference.kmeans, kmbench.reference.knn\n"
        "import pathlib\n"
        "for m in H.find_cell(pathlib.Path('.'), '100k_fp32.knn16')"
        ".per_layer + H.find_cell(pathlib.Path('.'), "
        "'8m_bf16.kmeanspp_lloyd').per_layer:\n"
        "    H.metric_reader(pathlib.Path('kmbench'), m['name'])\n"
        "H.Program()")
    assert "kmcuda_torch" in tops
    assert not tops & FORBIDDEN


def test_the_reference_loads_no_program():
    tops = _loaded("import kmbench.reference.kmeans, kmbench.reference.knn")
    assert "kmcuda_torch" not in tops and not tops & FORBIDDEN
