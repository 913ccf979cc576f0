"""The port's benchmark (bench_torch.py) held against the JAX package's
(bench.py), on the CPU at bench.py's smoke sizes.

- Each in-process stage of bench.py, run under JAX with ``bench.SMOKE``
  set, and the port's stage on CPU tensors emit the same metrics in the
  same order, with the same units, and a null ``vs_baseline`` on the same
  metrics (for the 8M loop rate bench.py's own rule decides: null exactly
  when the timed rate is not positive).  Both kNN stages find tie-aware
  recall 1.0; the port's examined fraction lies in (0, 1] and its 8M run
  counts at least one iteration.
- The whole matrix as a program (``KMTPU_BENCH_SMOKE=1 KMTPU_BENCH_CPU=1
  python bench_torch.py``): exit 0, bench.py's final-line keys and
  headline, and every metric bench.py's dict literals name, read from
  its source with ``ast``; no stage failed.  Without a CUDA device and
  without ``KMTPU_BENCH_CPU`` the program raises before any stage; a stage
  that raises makes it exit non-zero.
- The recall adjudication against an independent fp64 brute force in
  numpy; the rate estimators and ``vs_baseline`` roundings on hand cases;
  the fixtures (seeded, shaped, unit rows); bench.py's sizes.
- ``import bench_torch`` loads neither JAX, the JAX package nor bench.py.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
import bench_torch as B

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH_TREE = ast.parse((ROOT / "bench.py").read_text())
FINAL_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}


def bench_py_metrics() -> set:
    """The "metric" of every dict literal in bench.py that also has a
    "value" key: its 18 emitted metrics and its headline (the error
    records carry no value)."""
    names = set()
    for node in ast.walk(BENCH_TREE):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
            if "metric" in keys and "value" in keys:
                names.add(node.values[keys.index("metric")].value)
    return names


def bench_py_sizes() -> set:
    """bench.py's ``full if not SMOKE else smoke`` pairs."""
    pairs = set()
    for node in ast.walk(BENCH_TREE):
        if (isinstance(node, ast.IfExp) and isinstance(node.test, ast.UnaryOp)
                and isinstance(node.test.op, ast.Not)
                and getattr(node.test.operand, "id", None) == "SMOKE"):
            pairs.add((ast.literal_eval(node.body),
                       ast.literal_eval(node.orelse)))
    return pairs


def shape(extra) -> list:
    """(metric, unit, vs_baseline is None) in emission order."""
    out = []
    for name, rec in extra.items():
        none = rec["vs_baseline"] is None
        if name == "kmeans_8mx256_loop_s_per_iteration":
            # bench.py:438-439: null exactly when the timed rate is not
            # positive, which host noise may decide at smoke sizes
            assert none == (rec["value"] <= 0)
            none = "by its rate"
        out.append((name, rec["unit"], none))
    return out


@pytest.mark.parametrize("name", ["bench_100k", "bench_yy_deep_tail",
                                  "bench_spherical", "bench_knn",
                                  "bench_8m_bf16"])
def test_stage_parity_with_bench_py(name, monkeypatch):
    import jax
    import jax.numpy as jnp

    from kmcuda_tpu import kmeans_tpu, knn_tpu

    monkeypatch.setattr(bench, "SMOKE", True)
    ref, got = {}, {}
    calls = (kmeans_tpu, knn_tpu) if name == "bench_knn" else (kmeans_tpu,)
    getattr(bench, name)(jax, jnp, *calls, ref)
    getattr(B, name)(got, device="cpu", smoke=True)
    assert shape(got) == shape(ref)
    assert list(got) == [m for m in B.METRICS if m in got]
    if name == "bench_knn":
        for extra in (ref, got):
            assert extra["knn16_1mx256_tie_aware_recall_at_16"]["value"] \
                == 1.0
        assert 0 < got["knn16_1mx256_examined_fraction"]["value"] <= 1
    if name == "bench_8m_bf16":
        assert got["kmeans_8mx256_iterations"]["value"] >= 1
    for rec in got.values():
        if rec["unit"] == "s":
            assert rec["value"] > 0 or rec["vs_baseline"] is None


def test_whole_matrix_as_a_program():
    env = dict(os.environ, KMTPU_BENCH_SMOKE="1", KMTPU_BENCH_CPU="1",
               OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    final = json.loads(lines[-1])
    assert set(final) == FINAL_KEYS
    assert final["metric"] == B.HEADLINE
    assert "failed" not in final["extra"]
    assert set(final["extra"]) | {final["metric"]} == bench_py_metrics()
    assert tuple(final["extra"]) == B.METRICS
    emitted = [json.loads(l)["metric"] for l in lines[:-1]
               if l.startswith("{")]
    assert tuple(emitted) == B.METRICS
    assert final["extra"]["knn16_1mx256_tie_aware_recall_at_16"]["value"] \
        == 1.0


def test_main_raises_without_cuda_before_any_stage(monkeypatch):
    monkeypatch.delenv("KMTPU_BENCH_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(B, "first_contact", lambda device: ran.append(0))
    monkeypatch.setattr(B, "STAGES", tuple(
        (name, lambda *a, **kw: ran.append(name)) for name, _ in B.STAGES))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        B.main()
    assert ran == []


def test_a_failed_stage_exits_non_zero(monkeypatch, capsys):
    monkeypatch.setenv("KMTPU_BENCH_CPU", "1")

    def broken(extra, device, smoke):
        raise ValueError("stage broke")

    def headline(extra, device, smoke):
        return 1.0

    monkeypatch.setattr(B, "STAGES", ((B.HEADLINE, headline),
                                      ("knn16_1mx256_k1024_wall", broken)))
    assert B.main() == 1
    out = capsys.readouterr().out.strip().splitlines()
    assert {"metric": "knn16_1mx256_k1024_wall",
            "error": "stage broke"} in [json.loads(l) for l in out
                                        if l.startswith("{\"metric\"")]
    final = json.loads(out[-1])
    assert final["extra"]["failed"] == ["knn16_1mx256_k1024_wall"]
    assert final["value"] == 1.0 and final["vs_baseline"] == 9.2


# ---------------------------------------------------------------------------
# The recall adjudication against an independent fp64 brute force

N, F, KN = 2000, 16, 8


def exact_neighbours(xs):
    """Every row's KN nearest other rows in fp64, lowest id first on ties."""
    d = np.sqrt(((xs[:, None, :].astype(np.float64)
                  - xs[None, :, :]) ** 2).sum(-1))
    np.fill_diagonal(d, np.inf)
    return np.argsort(d, axis=1, kind="stable")[:, :KN], d


def test_recall_of_the_exact_answer():
    xs = np.random.RandomState(0).randn(N, F).astype(np.float32)
    nb, _d = exact_neighbours(xs)
    assert B.check_recall(torch.from_numpy(xs), torch.from_numpy(nb), KN) \
        == (1.0, 1.0)


def test_recall_of_a_duplicate_and_of_a_far_row():
    xs = np.random.RandomState(0).randn(N, F).astype(np.float32)
    q = 5
    nb, d = exact_neighbours(xs)
    r = nb[q, -1]                      # q's KN-th neighbour
    far = int(np.argmax(np.where(np.isfinite(d[q]), d[q], -1.0)))
    xs[far] = xs[r]                    # a planted duplicate of it
    x = torch.from_numpy(xs)
    qi = torch.tensor([q])
    nb, _d = exact_neighbours(xs)
    assert r in nb[q] or far in nb[q]
    answers = []
    for keep, drop in ((r, far), (far, r)):
        ans = nb.copy()
        ans[q] = [keep if j in (r, far) else j for j in nb[q]]
        answers.append(B.recall_of(x, torch.from_numpy(ans), KN, qi))
    # the brute force holds one of the tied pair: the answer with the
    # other is a strict miss but a tie-aware hit
    assert sorted(strict for strict, _tie in answers) == [(KN - 1) / KN, 1.0]
    assert [tie for _strict, tie in answers] == [1.0, 1.0]

    # q's last neighbour replaced by the farthest row left unchanged: over
    # every query, that one slot fails
    ans = nb.copy()
    ans[q, -1] = int(np.argmax(np.where(np.isin(np.arange(N), [q, r, far]),
                                        -np.inf, d[q])))
    strict, tie = B.recall_of(x, torch.from_numpy(ans), KN,
                              torch.arange(N))
    assert strict < 1.0
    assert tie == pytest.approx(1.0 - 1.0 / (KN * N), rel=1e-12, abs=0)


# ---------------------------------------------------------------------------
# Rates and roundings (bench.py:115-124, :173, :423-439) on hand cases


def test_per_iteration_rates():
    # the difference between the 45- and 35-iteration restarts
    assert B.per_iteration_rates(((10.0, 45), (8.0, 35)),
                                 ((5.0, 45), (4.5, 35))) == (0.2, 0.05)
    # converged before the long budget: each long wall over its iterations
    assert B.per_iteration_rates(((9.0, 30), (8.0, 30)),
                                 ((6.0, 40), (4.5, 35))) == (0.3, 0.15)
    # a difference that is not positive (noise): the same fallback
    assert B.per_iteration_rates(((9.0, 45), (9.5, 35)),
                                 ((4.5, 45), (4.0, 35))) == (0.2, 0.1)


def test_loop_rate():
    assert B.loop_rate(12.0, 9.25, 56) == pytest.approx(2.75 / 55)
    assert B.loop_rate(6.0, 6.5, 10) == 0.0
    assert B.loop_rate(5.0, 1.0, 1) == 4.0


def test_records_round_as_bench_py():
    assert B.headline_records(0.05, 0.06) == [
        {"metric": "kmeans_yinyang_100kx256_k1024_15iter_wall",
         "value": 0.05, "unit": "s", "vs_baseline": 184.0},
        {"metric": "yinyang_over_lloyd_100kx256", "value": 1.2,
         "unit": "ratio", "vs_baseline": None}]
    assert [(r["value"], r["vs_baseline"])
            for r in B.eight_m_records(12.0, 56, 9.3)] == [
        (12.0, 220.0), (56, 0.602), (0.2143, 132.47), (9.3, None),
        (0.0491, 578.26)]
    assert [(r["value"], r["vs_baseline"])
            for r in B.eight_m_records(6.0, 1, 6.5)] == [
        (6.0, 440.0), (1, 0.011), (6.0, 4.73), (6.5, None), (0.0, None)]
    assert [r["value"] for r in B.deep_tail_records(
        ((10.0, 45), (8.0, 35)), ((5.0, 45), (4.5, 35)))] == [
        2.0, 4.0, 0.2, 0.05]


# ---------------------------------------------------------------------------
# Fixtures, sizes, imports


FIXTURES = {
    "uniform_rows": ((8_192, 32), torch.float32),
    "deep_tail_blobs": ((16_384, 32), torch.float32),
    "unit_rows": ((16_384, 32), torch.float32),
    "knn_blobs": ((16_384, 32), torch.float32),
    "uniform_bf16_rows": ((32_768, 32), torch.bfloat16),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_is_seeded_and_shaped(name):
    def make():
        out = getattr(B, name)("cpu", smoke=True)
        return out[0] if isinstance(out, tuple) else out

    first, again = make(), make()
    assert torch.equal(first, again)
    assert (tuple(first.shape), first.dtype) == FIXTURES[name]
    if name == "unit_rows":
        torch.testing.assert_close(first.double().norm(dim=1),
                                   torch.ones(first.shape[0],
                                              dtype=torch.float64),
                                   rtol=0, atol=1e-6)
    if name == "knn_blobs":
        assert B.knn_blobs("cpu", smoke=True)[1].shape == (64, 32)


def test_sizes_and_constants_are_bench_py():
    assert set(B.SIZES.values()) == bench_py_sizes()
    assert (B.BASE_LLOYD_100K, B.BASE_8M_LLOYD, B.BASE_8M_YY) == (
        bench.BASE_LLOYD_100K, bench.BASE_8M_LLOYD, bench.BASE_8M_YY)
    assert set(B.METRICS) | {B.HEADLINE} == bench_py_metrics()
    assert len(B.METRICS) == 18


def test_import_loads_no_jax():
    code = ("import sys, bench_torch\n"
            "print([m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'kmcuda_tpu', 'bench')])")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
