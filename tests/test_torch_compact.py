"""The port's compaction and incremental-update primitives
(kmcuda_torch.ops.compact) against the JAX package's
(kmcuda_tpu.ops.compact) on the same seeded inputs.

Tolerances: permutations, counts and the dense/compacted decision must be
equal; delta sums are fp32 one-hot-difference products accumulated in
another order (rtol 1e-5, atol 1e-5).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmcuda_tpu.ops import compact as JC
from kmcuda_torch.ops import compact as TC

torch.set_num_threads(2)


@pytest.mark.parametrize("p_true", [0.0, 0.03, 0.5, 1.0])
def test_stable_partition_matches_jax(p_true):
    rng = np.random.RandomState(int(p_true * 100))
    mask = rng.rand(5000) < p_true
    j_order, j_n = JC.stable_partition(jnp.asarray(mask))
    t_order, t_n = TC.stable_partition(torch.from_numpy(mask))
    np.testing.assert_array_equal(t_order.numpy(), np.asarray(j_order))
    assert int(t_n) == int(j_n) == int(mask.sum())


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_delta_compacted_matches_jax(dtype):
    rng = np.random.RandomState(11)
    n, f, k = 3000, 8, 40
    x = rng.rand(n, f).astype(np.float32)
    aold = rng.randint(0, k + 1, size=n).astype(np.uint32)   # k = invalid
    anew = aold.copy()
    moved = rng.rand(n) < 0.2
    anew[moved] = rng.randint(0, k + 1, size=int(moved.sum()))
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    xj = jnp.asarray(x, jdt)
    order, n_changed = JC.stable_partition(jnp.asarray(anew != aold))
    j_sums, j_counts = JC.delta_compacted(
        xj, jnp.asarray(anew), jnp.asarray(aold), order, n_changed,
        n_clusters=k, chunk=256)
    xt = torch.from_numpy(x).to(tdt)
    an, ao = (torch.from_numpy(a.astype(np.int32)) for a in (anew, aold))
    t_order, t_n = TC.stable_partition(an != ao)
    t_sums, t_counts = TC.delta_compacted(xt, an, ao, t_order, int(t_n),
                                          n_clusters=k, chunk=256)
    assert int(t_n) == int(n_changed)
    np.testing.assert_array_equal(t_counts.numpy(), np.asarray(j_counts))
    np.testing.assert_allclose(t_sums.numpy(), np.asarray(j_sums),
                               rtol=1e-5, atol=1e-5)


def test_delta_compacted_nothing_moved():
    x = torch.rand(100, 4)
    a = torch.randint(0, 5, (100,), dtype=torch.int32)
    order, n = TC.stable_partition(a != a)
    sums, counts = TC.delta_compacted(x, a, a, order, int(n), n_clusters=5)
    assert int(n) == 0 and not sums.any() and not counts.any()


def test_chunk_delta_matches_jax():
    rng = np.random.RandomState(12)
    x = rng.rand(64, 6).astype(np.float32)
    anew = rng.randint(0, 11, size=64).astype(np.uint32)
    aold = rng.randint(0, 11, size=64).astype(np.uint32)
    j_sums, j_counts = JC.chunk_delta(
        jnp.asarray(x), jnp.asarray(anew), jnp.asarray(aold),
        jnp.zeros((10, 6), jnp.float32), jnp.zeros((10,), jnp.int32))
    t_sums, t_counts = TC.chunk_delta(
        torch.from_numpy(x), torch.from_numpy(anew.astype(np.int32)),
        torch.from_numpy(aold.astype(np.int32)), torch.zeros((10, 6)),
        torch.zeros((10,), dtype=torch.int32))
    np.testing.assert_array_equal(t_counts.numpy(), np.asarray(j_counts))
    np.testing.assert_allclose(t_sums.numpy(), np.asarray(j_sums),
                               rtol=1e-5, atol=1e-6)


def test_predict_dense_matches_jax():
    """The arm choice is compared in fp32 on both sides, including at the
    boundary and for the fresh-start sentinel (int32 max)."""
    cases = [(0, 100), (35, 100), (36, 100), (34999, 100000),
             (35000, 100000), (35001, 100000), (2**31 - 1, 13000),
             (2**31 - 1, 2**32 - 1), (1_500_000_000, 4_000_000_000)]
    for prev, n in cases:
        want = bool(JC.predict_dense(jnp.int32(prev), n))
        assert TC.predict_dense(prev, n) == want, (prev, n)
