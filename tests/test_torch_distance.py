"""The port's metric math (kmcuda_torch.ops.distance) against the JAX
package's (kmcuda_tpu.ops.distance) on the same seeded inputs.

Tolerances: scores are fp32 products whose summation order differs
between XLA's and torch's CPU matmuls, so they agree to rtol 1e-5 /
atol 1e-5 (a few ulps of |c|^2 at these scales); everything computed
from the same scores (argmin, rescored choice, best) must be equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmcuda_tpu.ops import assign as JA
from kmcuda_tpu.ops import distance as JD
from kmcuda_torch import config
from kmcuda_torch.ops import assign as TA
from kmcuda_torch.ops import distance as TD

torch.set_num_threads(2)

METRICS = pytest.mark.parametrize(
    "mname,tmetric,jmetric",
    [("L2", TD.DistanceMetric.L2, JD.DistanceMetric.L2),
     ("cos", TD.DistanceMetric.COSINE, JD.DistanceMetric.COSINE)],
    ids=["L2", "cos"])
DTYPES = pytest.mark.parametrize(
    "dname,tdtype,jdtype",
    [("fp32", torch.float32, jnp.float32),
     ("bf16", torch.bfloat16, jnp.bfloat16)],
    ids=["fp32", "bf16"])


def _fixture(metric_name, seed=0, n=256, f=16, k=50):
    """Samples and centroids with a duplicated centroid (exact tie -> the
    lowest id wins), a NaN centroid (never wins) and an overflow-scale
    centroid (|c|^2 overflows fp32, so its score is clamped)."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, f).astype(np.float32)
    if metric_name == "cos":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    c = x[rng.choice(n, k, replace=False)].copy()
    c[7] = c[3]
    c[11] = np.nan
    c[13] = 3e38
    return x, c


def _jax_panel(c, jdtype):
    c_t, c_sq, pen, ids = JA.pad_clusters(jnp.asarray(c), jdtype)
    return c_t, c_sq, pen, ids


def _t(a, dtype=None):
    """JAX array -> torch tensor on the CPU (bf16 through fp32, exact)."""
    arr = np.asarray(jnp.asarray(a).astype(jnp.float32)
                     if a.dtype == jnp.bfloat16 else a)
    t = torch.from_numpy(np.array(arr))
    return t if dtype is None else t.to(dtype)


@DTYPES
@METRICS
def test_scores_match_jax(mname, tmetric, jmetric, dname, tdtype, jdtype):
    x, c = _fixture(mname)
    k = c.shape[0]
    xj = jnp.asarray(x, jdtype)
    c_t, c_sq, pen, ids = _jax_panel(c, jdtype)
    # the port has no pad columns: compare the k real ones
    want = np.asarray(JD.scores(xj, c_t, c_sq, pen, jmetric))[:, :k]
    got = TD.scores(_t(xj, tdtype), _t(c_t, tdtype)[:, :k], _t(c_sq)[:k],
                    tmetric).numpy()
    pad = want >= config.PAD_PENALTY
    np.testing.assert_array_equal(got >= config.PAD_PENALTY, pad)
    assert pad[:, 11].all() and pad[:, 13].all()   # NaN and overflow clamp
    np.testing.assert_array_equal(got[pad], want[pad])
    np.testing.assert_allclose(got[~pad], want[~pad], rtol=1e-5, atol=1e-5)


def test_argmin_lowest_index_ties():
    rng = np.random.RandomState(1)
    s = rng.randint(0, 4, size=(300, 40)).astype(np.float32)  # many ties
    ids = np.arange(40, dtype=np.int32)
    jb, ja = JD.argmin_lowest_index(jnp.asarray(s), jnp.asarray(ids), 40)
    tb, ta = TD.argmin_lowest_index(torch.from_numpy(s), 40)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja).astype(np.int32))


@DTYPES
@METRICS
def test_argmin_rescored_matches_jax(mname, tmetric, jmetric, dname, tdtype,
                                     jdtype):
    """Both sides rescore the SAME score matrix (JAX's), so the chosen ids
    and best scores must be equal; d2 is an fp32 sum of f squares in
    another order (rtol 1e-6)."""
    x, c = _fixture(mname, seed=2)
    xj = jnp.asarray(x, jdtype)
    c_t, c_sq, pen, ids = _jax_panel(c, jdtype)
    s = JD.scores(xj, c_t, c_sq, pen, jmetric)
    k = c.shape[0]
    c_ext = JA._rescore_table(jnp.asarray(c), c.shape[1])
    jb, ja, jd2 = JD.argmin_rescored(s, ids, k, xj, c_ext)
    t_ext = TA.rescore_table(torch.from_numpy(c))
    np.testing.assert_array_equal(t_ext.numpy(), np.asarray(c_ext))
    # the port has no pad columns: score the k real ones
    tb, ta, td2 = TD.argmin_rescored(_t(s)[:, :k], k, _t(xj, tdtype), t_ext)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja).astype(np.int32))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(td2.numpy(), np.asarray(jd2), rtol=1e-6)
    assert not (ta.numpy() == 7).any()    # c[7] duplicates c[3]: id 3 wins
    assert not np.isin(ta.numpy(), [11, 13]).any()


@METRICS
def test_normalize_centroids_empty_cluster(mname, tmetric, jmetric):
    rng = np.random.RandomState(3)
    sums = (rng.rand(20, 8) * 50).astype(np.float32)
    counts = rng.randint(1, 100, size=20).astype(np.float32)
    counts[[4, 9]] = 0                     # empty clusters -> NaN rows
    want = np.asarray(JD.normalize_centroids(jnp.asarray(sums),
                                             jnp.asarray(counts), jmetric))
    got = TD.normalize_centroids(torch.from_numpy(sums),
                                 torch.from_numpy(counts), tmetric).numpy()
    assert np.isnan(got[[4, 9]]).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)


@METRICS
def test_finalize_distance_and_norms(mname, tmetric, jmetric):
    rng = np.random.RandomState(4)
    x = rng.rand(64, 8).astype(np.float32)
    score = (rng.rand(64, 5).astype(np.float32) - 1.0)
    x_sq = np.array(JD.row_sq_norms(jnp.asarray(x)))
    np.testing.assert_allclose(TD.row_sq_norms(torch.from_numpy(x)).numpy(),
                               x_sq, rtol=1e-6)
    want = np.asarray(JD.finalize_distance(jnp.asarray(score),
                                           jnp.asarray(x_sq)[:, None],
                                           jmetric))
    got = TD.finalize_distance(torch.from_numpy(score),
                               torch.from_numpy(x_sq)[:, None],
                               tmetric).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_bf16_panel_rounds_centroids_but_not_norms():
    """For bf16 storage the score panel is the bf16-rounded centroids,
    while |c|^2 comes from the unrounded fp32 ones."""
    rng = np.random.RandomState(5)
    c = rng.rand(30, 12).astype(np.float32)
    j_ct, j_csq, _, _ = JA.pad_clusters(jnp.asarray(c), jnp.bfloat16)
    panel, c_sq = TA.pad_clusters(torch.from_numpy(c), torch.bfloat16)
    assert panel.dtype == torch.bfloat16 and panel.shape == (30, 12)
    np.testing.assert_array_equal(
        panel.float().numpy(),
        np.asarray(j_ct.astype(jnp.float32)).T[:30])
    np.testing.assert_allclose(c_sq.numpy(), np.asarray(j_csq)[:30],
                               rtol=1e-6)
