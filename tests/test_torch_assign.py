"""The port's Lloyd pass entries (kmcuda_torch.ops.assign_kernels) against
the JAX package, on the CPU, where the wrappers run their plain twins.

Two references: the XLA scan ``_assign_update_pass(..., axis_name=None)``
(the path with the exact top-2 rescore, which the port follows) and the
Pallas kernels in interpret mode (no rescore, so only on tie-free
fixtures, as tests/test_pallas.py does).  Tolerances: assignments and
reassignment counts must be equal; best scores are fp32 products summed
in another order (rtol 1e-5, atol 1e-5); centroids from the segment sums
agree to rtol 1e-5 / atol 1e-6, the bound tests/test_pallas.py uses.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmcuda_tpu.ops import assign as JA
from kmcuda_tpu.ops import assign_pallas as JP
from kmcuda_tpu.ops import distance as JD
from kmcuda_torch.ops import assign as TA
from kmcuda_torch.ops import assign_kernels as K
from kmcuda_torch.ops import distance as TD
from kmcuda_torch.utils.errors import KMTPUInvalidArguments

torch.set_num_threads(2)

METRICS = pytest.mark.parametrize(
    "mname,tmetric,jmetric",
    [("L2", TD.DistanceMetric.L2, JD.DistanceMetric.L2),
     ("cos", TD.DistanceMetric.COSINE, JD.DistanceMetric.COSINE)],
    ids=["L2", "cos"])


def _inputs(metric_name, seed=0, n=4096, f=16, k=50, invalid=False,
            dead=False):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, f).astype(np.float32)
    if metric_name == "cos":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    valid = np.ones(n, bool)
    if invalid:
        valid[100:110] = False       # 'NaN rows', pre-zeroed by prepare()
        x[100:110] = 0
    c = x[:k].copy()
    if dead:
        c[3] = np.nan                # a dead centroid never wins
    prev = np.full(n, k, np.uint32)
    return x, valid, c, prev


def _port(x, valid, c, prev, dtype=torch.float32):
    """numpy inputs -> the wrappers' (x, valid, prev_assign, centroids)."""
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(valid),
            torch.from_numpy(prev.astype(np.int32)), torch.from_numpy(c))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@METRICS
def test_fused_reference_matches_xla_pass(mname, tmetric, jmetric, dtype):
    x, valid, c, prev = _inputs(mname)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    xj = jnp.asarray(x, jdt)
    nc, a2, b2, ch2 = JA._assign_update_pass(
        xj, (xj.astype(jnp.float32) ** 2).sum(1), jnp.asarray(valid),
        jnp.asarray(prev), jnp.asarray(c), n_clusters=50, metric=jmetric,
        chunk=1024, axis_name=None)
    aid, best, sums, counts, changed = K.fused_lloyd_pass(
        *_port(x, valid, c, prev, tdt), n_clusters=50, metric=tmetric)
    np.testing.assert_array_equal(aid.numpy(), np.asarray(a2))
    np.testing.assert_allclose(best.numpy(), np.asarray(b2), rtol=1e-5,
                               atol=1e-5)
    assert int(changed) == int(ch2)
    cent = TD.normalize_centroids(sums, counts.float(), tmetric)
    np.testing.assert_allclose(cent.numpy(), np.asarray(nc), rtol=1e-5,
                               atol=1e-6, equal_nan=True)


@METRICS
def test_fused_reference_matches_pallas_interpret(mname, tmetric, jmetric):
    x, valid, c, prev = _inputs(mname)
    xj = jnp.asarray(x)
    aid_j, best_j, sums_j, counts_j, ch_j = JP.fused_lloyd_pass(
        xj, jnp.asarray(valid), jnp.asarray(prev), jnp.asarray(c),
        n_clusters=50, metric=jmetric, tile=1024, interpret=True)
    aid, best, sums, counts, changed = K.fused_lloyd_pass(
        *_port(x, valid, c, prev), n_clusters=50, metric=tmetric)
    np.testing.assert_array_equal(aid.numpy(), np.asarray(aid_j))
    np.testing.assert_allclose(best.numpy(), np.asarray(best_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j))
    assert int(changed) == int(ch_j)
    np.testing.assert_allclose(sums.numpy(), np.asarray(sums_j), rtol=1e-5,
                               atol=1e-5)


@METRICS
def test_assign_only_reference_matches_jax(mname, tmetric, jmetric):
    x, valid, c, _ = _inputs(mname, seed=7)
    rng = np.random.RandomState(8)
    prev = rng.randint(0, 51, size=x.shape[0]).astype(np.uint32)
    a_x, b_x = JA.assign_pass(jnp.asarray(x), jnp.asarray(valid),
                              jnp.asarray(c), n_clusters=50, metric=jmetric,
                              chunk=1024)
    a_p, b_p, ch_p = JP.assign_only_pass(
        jnp.asarray(x), jnp.asarray(valid), jnp.asarray(prev),
        jnp.asarray(c), n_clusters=50, metric=jmetric, tile=1024,
        interpret=True)
    aid, best, changed = K.assign_only_pass(
        *_port(x, valid, c, prev), n_clusters=50, metric=tmetric)
    np.testing.assert_array_equal(aid.numpy(), np.asarray(a_x))
    np.testing.assert_array_equal(aid.numpy(), np.asarray(a_p))
    np.testing.assert_allclose(best.numpy(), np.asarray(b_x), rtol=1e-5,
                               atol=1e-5)
    assert int(changed) == int(np.sum(np.asarray(a_x) != prev))
    assert int(changed) == int(ch_p)


def test_nan_rows_and_dead_centroid():
    x, valid, c, prev = _inputs("L2", seed=1, n=2048, f=8, k=20,
                                invalid=True, dead=True)
    _nc, a2, *_ = JA._assign_update_pass(
        jnp.asarray(x), jnp.asarray((x * x).sum(1)), jnp.asarray(valid),
        jnp.asarray(prev), jnp.asarray(c), n_clusters=20,
        metric=JD.DistanceMetric.L2, chunk=1024, axis_name=None)
    aid, best, sums, counts, changed = K.fused_lloyd_pass(
        *_port(x, valid, c, prev), n_clusters=20, metric=TD.DistanceMetric.L2)
    aid = aid.numpy()
    np.testing.assert_array_equal(aid, np.asarray(a2))
    assert (aid[100:110] == 20).all()
    assert not (aid == 3).any()
    assert int(counts.sum()) == 2048 - 10
    assert counts[3] == 0 and (sums[3] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_fused_and_assign_only_bitwise_equal(dtype):
    """B1 and B2 must give bitwise equal assignments, best scores and
    counts: the Lloyd loop's arm choice then changes only the sums."""
    x, valid, c, _ = _inputs("L2", seed=9, invalid=True, dead=True)
    prev = np.random.RandomState(10).randint(0, 51, size=x.shape[0])
    xt, vt, pt, ct = _port(x, valid, c, prev.astype(np.uint32), dtype)
    a1, b1, _s, _c, ch1 = K.fused_lloyd_pass(xt, vt, pt, ct, n_clusters=50,
                                             metric=TD.DistanceMetric.L2)
    a2, b2, ch2 = K.assign_only_pass(xt, vt, pt, ct, n_clusters=50,
                                     metric=TD.DistanceMetric.L2)
    assert torch.equal(a1, a2) and torch.equal(b1, b2)
    assert int(ch1) == int(ch2)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x, valid, prev, c = _port(*_inputs("L2", n=256, k=8))
    m = TD.DistanceMetric.L2
    bad = [
        dict(x=x.half()),                      # storage is fp32 or bf16
        dict(x=x.t().contiguous().t()),        # non-contiguous
        dict(prev_assign=prev.long()),         # assignments are int32
        dict(valid=valid.int()),               # valid is bool
        dict(centroids=c[:, :5]),              # wrong width
        dict(centroids=c.double()),            # centroids are fp32
    ]
    for over in bad:
        args = dict(x=x, valid=valid, prev_assign=prev, centroids=c)
        args.update(over)
        for fn in (K.fused_lloyd_pass, K.assign_only_pass):
            with pytest.raises(KMTPUInvalidArguments):
                fn(args["x"], args["valid"], args["prev_assign"],
                   args["centroids"], n_clusters=8, metric=m)


@pytest.mark.parametrize("n,f,k,itemsize", [
    (100_000, 256, 1024, 4), (1_000_000, 256, 1024, 2),
    (8_000_000, 256, 1024, 2), (100_003, 250, 1000, 2), (3, 64, 2, 4),
    (1000, 1, 5000, 4), (50_000, 65_536, 65_536, 4),
    (2**31 - 1, 256, 1024, 2), (2**31 - 1, 3, 2**20, 4)])
def test_segment_plan_covers_rows_and_bounds_scratch(n, f, k, itemsize):
    """The segment sum's cut: placement blocks and reduction chunks cover
    [0, n) exactly, the blocks hold at least 1024 rows, and at least k
    where n passes SEGMENT_TABLE, so the (k, blocks) table stays within
    max(n, SEGMENT_TABLE) + k entries and the integer scratch is the
    table, its total, its scan's tile sums and 2 n; the partials within
    2 * SEGMENT_MAX_CHUNKS * f floats; the block shape divides 256
    threads and the grid fits CUDA's limits; and the cut depends on the
    shape alone."""
    p = K.segment_plan(n, f, k, itemsize)
    assert p == K.segment_plan(n, f, k, itemsize)
    blocks, chunks = -(-n // p.rows), -(-n // p.chunk)
    assert p.rows >= 1024 and p.rows % 256 == 0
    assert p.rows >= k or n < K.SEGMENT_TABLE
    assert (blocks - 1) * p.rows < n <= blocks * p.rows
    assert (chunks - 1) * p.chunk < n <= chunks * p.chunk
    assert p.chunk >= K.SEGMENT_MIN_CHUNK
    assert chunks <= K.SEGMENT_MAX_CHUNKS
    table = blocks * k
    assert table <= max(n, K.SEGMENT_TABLE) + k
    assert p.int_scratch == (table + 1 + -(-table // K.SEGMENT_SCAN_TILE)
                             + 2 * n)
    assert p.int_scratch <= 3 * n + 2 * k + 1 + (
        K.SEGMENT_TABLE + -(-(K.SEGMENT_TABLE + 2 * n + 2 * k)
                            // K.SEGMENT_SCAN_TILE))
    assert p.float_scratch == 2 * chunks * f
    assert p.float_scratch <= 2 * K.SEGMENT_MAX_CHUNKS * f
    assert K.SEGMENT_THREADS % p.tx == 0 and p.tx >= 32
    slab = p.tx * (16 // itemsize)
    assert -(-f // slab) < 2**16 and chunks < 2**31
    assert blocks < 2**31 and k < 2**31


def test_near_ties_sees_score_and_rescore_ties():
    """A row is a near-tie when any comparison of the assignment is within
    rounding.  Row 0: c0 = (1+e, 0) and c1 = (1-e, 0) round to the same
    bf16 panel row, so their scores differ by 4e (|c|^2 comes from the
    fp32 centroids) while both exact squared distances to x = (1, 0) are
    e^2: a rescore tie that the score gap does not show.  Row 1: a clear
    winner.  Row 2: an exact score tie (c3 duplicates c2)."""
    e = 2.0 ** -10
    c = torch.tensor([[1 + e, 0], [1 - e, 0], [5, 5], [5, 5]])
    x = torch.tensor([[1, 0], [-2, -2], [5, 4]]).to(torch.bfloat16)
    m = TD.DistanceMetric.L2
    panel, c_sq = TA.pad_clusters(c, torch.bfloat16)
    s = TD.scores(x[:1], panel.T, c_sq, m)[0]
    assert float(s[0] - s[1]) > 1e-3          # the scores are not tied
    np.testing.assert_array_equal(K.near_ties(x, c, m).numpy(),
                                  [True, False, True])


def test_lloyd_run_dense_then_sparse_matches_fresh_sums():
    """The host loop replaces the sums on dense iterations and adds the
    compacted delta on sparse ones; the running sums must stay within fp32
    accumulation noise of a fresh segment sum of the same assignment."""
    x, valid, c, _ = _inputs("L2", seed=11, n=6000, f=8, k=30)
    xt, vt, ct = torch.from_numpy(x), torch.from_numpy(valid), \
        torch.from_numpy(c)
    assign = torch.full((6000,), 30, dtype=torch.int32)
    arms = []
    steps = TA.lloyd_run(xt, vt, assign, ct, n_clusters=30,
                         metric=TD.DistanceMetric.L2)
    for i, step in enumerate(steps):
        arms.append(step.changed)
        if i == 7:
            break
    steps.close()
    sums, counts = K.segment_sum_reference(xt, step.assign, 30)
    assert torch.equal(counts, step.counts)
    fresh = TD.normalize_centroids(sums, counts.float(),
                                   TD.DistanceMetric.L2)
    np.testing.assert_allclose(step.c_next.numpy(), fresh.numpy(),
                               rtol=1e-5, atol=1e-6)
    assert arms[0] == 6000                 # dense: everything moves first
    assert any(a < 0.35 * 6000 for a in arms[1:-1])   # sparse arm ran
