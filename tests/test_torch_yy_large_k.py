"""Yinyang at many groups: kmcuda's 40,000-cluster deployment (4M x 480
bf16 into k = 40,000, ``yinyang_t`` 0.1, so G = 4,000) cut to the CPU,
n = 12,000, f = 48, k = 2,400, G = 240, bf16 rows of overlapping blobs
made from a seed by the benchmark's own generator
(``kmbench.harness.make_samples``).  k sets G and is kept; n is cut to
five rows a cluster, because every iteration of the plain twins scores
all n x k pairs on the CPU.

From the port's random start (the first run's, ``init="random"``),
Yinyang gives Lloyd's iteration lines, assignments and centroids
bitwise, with its lower bounds stored in fp32 and, forced below the size
that switches them (``YY_BOUNDS_F32_MAX_BYTES``), in bf16; the loop runs
its sparse branch, and its refreshes run over many row chunks
(``ops.yinyang.BOUND_CHUNK_ELEMENTS`` cut here).  From the same start
the JAX package's Yinyang, at the same 240 groups on the same bf16 rows
with fp32 bounds, gives the same iteration lines and assignments.  The
results stand beside the benchmark's plain reference
(``kmbench/reference/kmeans.py``, fp64): the first step's assignment and
means, and the last assignment.  A refresh of the bounds is one span
``kmt.yinyang.refresh`` with its rows counted as
``yinyang.refreshed_rows``, n on the bound init.
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kmbench.harness import make_samples
from kmbench.reference import kmeans as RK
from kmcuda_tpu import kmeans_tpu
from kmcuda_torch import config, kmeans_cuda
from kmcuda_torch.models.yinyang import _group_cap
from kmcuda_torch.ops import yinyang as YY
from kmcuda_torch.ops.distance import DistanceMetric
from kmcuda_torch.utils import profiling as P

torch.set_num_threads(2)

N, F, K = 12_000, 48, 2_400
GROUPS = int(0.1 * K)
CONFIG = {"samples": N, "features": F, "dtype": "bfloat16",
          "data": "blobs", "blob_centers": K, "blob_spread": 2.0}
#: tolerance 0.001: kmcuda's default 0.01 stops this cut after five
#: iterations, before the filter leaves few enough candidates for the
#: gathered branch (at five rows a cluster they fall more slowly than at
#: the deployment's hundred)
KW = dict(init="random", tolerance=0.001, seed=11)
#: the runs from the random start stop here, past the draft and two
#: gathered iterations (unbounded they stop after nine)
MAX_ITERATIONS = 8
#: a chunk of this many elements cuts a full refresh into 91-row chunks
CHUNK_ELEMENTS = 1 << 18


@contextlib.contextmanager
def _settings(**values):
    """Module settings for a module-scoped run (monkeypatch is per test)."""
    where = {"BOUND_CHUNK_ELEMENTS": YY}
    old = {k: getattr(where.get(k, config), k) for k in values}
    for k, v in values.items():
        setattr(where.get(k, config), k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(where.get(k, config), k, v)


#: never gate, never revoke, never hand over (as tests/test_torch_yinyang.py
#: pins the controller), and refreshes in many row chunks
PINNED = dict(YY_MIN_REMAINING=0, YY_BAILOUT_MARGIN=float("inf"),
              YY_LLOYD_HANDOVER=False, BOUND_CHUNK_ELEMENTS=CHUNK_ELEMENTS)


@pytest.fixture(scope="module")
def x():
    return make_samples(CONFIG, 5, torch.device("cpu"))


def _run(x, **kw):
    """kmeans_cuda at verbosity 2: (centroids, assignments, iteration
    lines, whole log)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        c, a = kmeans_cuda(x, K, verbosity=2, **dict(KW, **kw))
    log = buf.getvalue()
    return c, a, [l for l in log.splitlines() if l.startswith("iteration")], \
        log


def _entered(log):
    """Iterations the Yinyang loop ran (its per-iteration debug lines)."""
    return log.count("passed the global filter")


@pytest.fixture(scope="module")
def first(x):
    """The first step from the random start: {1: the run stopped after one
    iteration (the start and the assignment against it), 2: after two
    (the first assignment's means)}."""
    with _settings(**PINNED):
        return {m: _run(x, yinyang_t=0.1, max_iterations=m) for m in (1, 2)}


@pytest.fixture(scope="module")
def start(first):
    """The random start, imported by the longer runs."""
    return first[1][0].float()


@pytest.fixture(scope="module")
def lloyd(x, start):
    with _settings(**PINNED):
        return _run(x, init=start, yinyang_t=0,
                    max_iterations=MAX_ITERATIONS)


@pytest.fixture(scope="module")
def yinyang(x, start):
    """{bound storage: the Yinyang run}: fp32 bounds with the default
    schedule, under a profiler session (its host events and its record
    kept with it); bf16 bounds, forced, with every iteration after the
    bound init on the gathered branch (``YY_DENSE_FRACTION`` 1)."""
    kw = dict(init=start, yinyang_t=0.1, max_iterations=MAX_ITERATIONS)
    with _settings(**PINNED), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        run = _run(x, **kw)
    ev = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()),
                key=lambda e: e[1])
    runs = {"fp32": run + (ev, P.records()[-1])}
    with _settings(YY_BOUNDS_F32_MAX_BYTES=0, YY_DENSE_FRACTION=1.0,
                   **PINNED):
        runs["bf16"] = _run(x, **kw)
    return runs


def _nearest_gap_limit(x, c):
    """The widest assign_gap B2's bf16 panel can leave: B2 ranks by scores
    against bf16(c), each within e |x| |c| of the exact one
    (``ops.yinyang.panel_envelope``), and rescores its top 2 exactly, so a
    row's pick lies at most twice that above its nearest; as a share of
    the mean nearest distance, as ``assign_gap`` takes it."""
    e = YY.panel_envelope(torch.bfloat16, DistanceMetric.L2, F)
    xf, cf = x.double(), c.double()
    _a, best = RK.assign(x, c.float())
    widest = 2 * e * xf.norm(dim=1).max() * cf.norm(dim=1).nan_to_num().max()
    return float(widest / best.mean())


@pytest.mark.parametrize("store", ["fp32", "bf16"])
def test_yinyang_is_lloyd(lloyd, yinyang, store):
    c, a, lines, log = yinyang[store][:4]
    assert "yinyang: %d groups" % GROUPS in log
    assert ("bf16 lower-bound storage" in log) == (store == "bf16")
    # the loop ran its gathered branch, and more than the bound init
    assert "sparse keep iteration" in log or "sparse refresh" in log
    assert lines == lloyd[2] and len(lines) == MAX_ITERATIONS
    assert _entered(log) > 0 and _entered(lloyd[3]) == 0
    assert torch.equal(a, lloyd[1])
    assert torch.equal(c.view(torch.int16), lloyd[0].view(torch.int16))


def test_yinyang_matches_kmeans_tpu(x, start, yinyang):
    """The JAX package's Yinyang from the same start on the same bf16 rows
    (fp32 bounds, 240 groups, its own grouping): the port's iteration
    lines and assignments; centroids, rounded to bf16 on both sides,
    within a bf16 step (2^-7 relative) of each other, NaN where the
    port's are."""
    x16 = x.view(torch.int16).numpy().view(jnp.bfloat16)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        want_c, want_a = kmeans_tpu(x16, K, init=start.numpy(), device=1,
                                    verbosity=2, tolerance=KW["tolerance"],
                                    yinyang_t=0.1,
                                    max_iterations=MAX_ITERATIONS)
    want_log = buf.getvalue()
    c, a, lines, log = yinyang["fp32"][:4]
    assert "yinyang: %d groups" % GROUPS in want_log
    assert _entered(want_log) > 0
    assert lines == [l for l in want_log.splitlines()
                     if l.startswith("iteration")]
    np.testing.assert_array_equal(a.numpy(), np.asarray(want_a, np.int32))
    np.testing.assert_allclose(c.float().numpy(),
                               np.asarray(want_c, np.float32),
                               rtol=2.0 ** -7, atol=0)


@pytest.mark.parametrize("store", ["fp32", "bf16"])
def test_last_assignment_against_the_reference(x, yinyang, store):
    c, a = yinyang[store][:2]
    gap, bad = RK.assign_gap(x, c, a)
    assert bad == 0
    assert gap <= _nearest_gap_limit(x, c)


def test_first_step_against_the_reference(x, first):
    """One iteration: the start and the assignment against it; two: the
    centroids are the first assignment's means, in bf16 (half a bf16
    step of an entry, 2^-9 of the largest at most, plus the fp32 sums'
    rounding, far below 2^-8)."""
    c1, a1, lines1, _ = first[1]
    c2, _a2, lines2, _ = first[2]
    assert len(lines1) == 1 and lines2[:1] == lines1
    gap, bad = RK.assign_gap(x, c1, a1)
    assert bad == 0 and gap <= _nearest_gap_limit(x, c1)
    assert RK.start_rows(x, c1)[1] == 0
    assert RK.mean_gap(x, c2, a1) <= 2.0 ** -8


def test_refresh_span_and_counter(yinyang):
    ev, rec = yinyang["fp32"][4:]
    rows = [v for name, v in rec["counters"]
            if name == "yinyang.refreshed_rows"]
    assert rows[0] == N
    assert all(0 <= v <= N for v in rows)
    refresh = [(s, e) for name, s, e in ev if name == "kmt.yinyang.refresh"]
    first_it = next((s, e) for name, s, e in ev
                    if name == "kmt.yinyang.iteration")
    assert len(refresh) == len(rows)
    assert first_it[0] <= refresh[0][0] and refresh[0][1] <= first_it[1]
    # the bound init's row chunks lie inside its refresh
    chunks = [(s, e) for name, s, e in ev if name == "kmt.yinyang.bounds"
              and refresh[0][0] <= s and e <= refresh[0][1]]
    step = CHUNK_ELEMENTS // (GROUPS * _group_cap(K, GROUPS))
    assert len(chunks) == -(-N // step)
