"""The 3xTF32 score path of the fp32 assignment kernel, on the CPU.

``kmt_assign`` takes fp32 products as error-compensated TF32 on the
tensor cores: each operand v splits into hi = tf32(v) and lo = tf32(v -
hi), and the product accumulates x_lo.c_hi + x_hi.c_lo + x_hi.c_hi.  The
wrapper splits the panel with ``assign_kernels.tf32_split``; the kernel
splits x tiles the same way with ``cvt.rna.tf32.f32``.  The kernel itself
runs only on the card (tests/test_torch_kernels.py, chip_smoke.py); here
the split is checked bit by bit, and a plain emulation of the kernel's
accumulation (``emulated_3xtf32_products``: per 32-feature stage, fresh
accumulators that add each k-step of 8 products with truncation to fp32,
the large product apart from the cross terms, then stage sums rounded to
nearest) must keep its products within 8 fp32 ulps of sum_j |x_j c_j|
from fp64, and give the plain twin's and the JAX package's XLA
assignments, off near-ties (``assign_kernels.near_ties``: consecutive
top-3 scores within 1e-5 * max(1, |s1|), or the rescore's two exact
squared distances within 1e-5 * max(1, d2)), with best scores to rtol
1e-5 (atol 1e-6 of the mean |x|^2 for scores near 0).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from kmcuda_tpu.ops import assign as JA
from kmcuda_tpu.ops import distance as JD
from kmcuda_torch.ops import assign_kernels as K
from kmcuda_torch.ops import distance as D
from kmcuda_torch.ops.assign import pad_clusters, rescore_table

torch.set_num_threads(2)

LOW13 = 0x1FFF

# finite fp32 values whose TF32 rounding cannot overflow to inf (from
# (2 - 2**-11) * 2**127 on, halfway past the largest TF32 value, the
# kernel's cvt.rna rounds to inf, as products of such data overflow in any
# fp32 arithmetic) and whose residual v - hi stays a normal number (below
# 2**-100 it may be subnormal, where TF32 keeps fewer bits than 2**-11
# relative)
BIG = float(np.nextafter(np.float32((2 - 2.0 ** -11) * 2.0 ** 127),
                         np.float32(0)))
finite32 = st.floats(min_value=-BIG, max_value=BIG, width=32,
                     allow_nan=False, allow_infinity=False,
                     allow_subnormal=False).filter(
                         lambda v: v == 0 or abs(v) >= 2.0 ** -100)


def _bits(t):
    return t.view(torch.int32)


@settings(max_examples=300, deadline=None)
@given(st.lists(finite32, min_size=1, max_size=64))
def test_tf32_split_properties(values):
    """hi and lo are TF32 values (low 13 mantissa bits zero); the residual
    v - hi is exact in fp32, so hi + (v - hi) == v; lo is that residual
    rounded to TF32, so v - hi - lo is within 2**-11 of lo's size; and
    |lo| <= 2**-11 |v|."""
    v = torch.tensor(values, dtype=torch.float32)
    hi, lo = K.tf32_split(v)
    assert bool(((_bits(hi) & LOW13) == 0).all())
    assert bool(((_bits(lo) & LOW13) == 0).all())
    r = v - hi
    assert torch.equal(hi + r, v)
    v64, hi64, lo64 = v.double(), hi.double(), lo.double()
    assert torch.equal(r.double(), v64 - hi64)            # exact residual
    assert bool(((r.double() - lo64).abs()
                 <= 2.0 ** -11 * r.double().abs()).all())
    assert bool((lo64.abs() <= 2.0 ** -11 * v64.abs()).all())


def test_tf32_round_is_nearest_ties_away():
    """tf32_round against an fp64 reference: the significand rounded to 11
    bits, halves away from zero (normal numbers), and exact ties."""
    rng = np.random.RandomState(0)
    v = (rng.randn(20000) * np.exp(rng.randn(20000) * 20)).astype(np.float32)
    v = v[(np.abs(v) >= np.float32(2.0 ** -126)) & (np.abs(v) <= BIG)]
    m, e = np.frexp(np.abs(v).astype(np.float64))
    want = np.sign(v) * np.floor(m * 2.0 ** 11 + 0.5) * 2.0 ** (e - 11)
    got = K.tf32_round(torch.from_numpy(v)).double().numpy()
    np.testing.assert_array_equal(got, want)
    # 1 + 2**-11 is halfway between 1 and 1 + 2**-10: away from zero
    half = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12,
                         float("inf"), float("nan")])
    out = K.tf32_round(half)
    assert out[:4].tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0,
                                float("inf")]
    assert bool(torch.isnan(out[4]))


def _trunc32(v):
    """fp64 to fp32, rounded toward zero, as the tensor cores' fp32
    accumulator adds."""
    f = v.float()
    over = f.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def emulated_3xtf32_products(x, panel, stage=32, kstep=8):
    """x . panel^T (fp32) as the kernel forms it.  Per stage of 32 features
    (one 128-byte chunk) two accumulators start afresh; each k-step of 8
    features adds its products (summed exactly, in fp64) to them with
    truncation to fp32: x_lo.c_hi, then x_hi.c_lo into the cross-term
    accumulator, x_hi.c_hi into the other.  The stage's two sums are added,
    and the stages summed in order, rounded to nearest in fp32."""
    xh, xl = K.tf32_split(x)
    ph, pl = K.tf32_split(panel)
    f = x.shape[1]
    total = None
    for s0 in range(0, f, stage):
        acc = lo = None
        for k0 in range(s0, min(s0 + stage, f), kstep):
            cols = slice(k0, min(k0 + kstep, f))

            def mm(a, b):
                return a[:, cols].double() @ b[:, cols].double().T

            lo = _trunc32(mm(xl, ph) + (0.0 if lo is None else lo.double()))
            lo = _trunc32(lo.double() + mm(xh, pl))
            acc = _trunc32(mm(xh, ph)
                           + (0.0 if acc is None else acc.double()))
        total = acc + lo if total is None else total + (acc + lo)
    return total


def emulated_3xtf32_assign(x, valid, centroids, k, metric):
    """The kernel's score path in plain torch: the products of
    :func:`emulated_3xtf32_products`, scores clamped as
    ``distance.scores``, then the exact top-2 rescore.  Returns (assign,
    best)."""
    panel, c_sq = pad_clusters(centroids, torch.float32)
    prod = emulated_3xtf32_products(x, panel)
    s = -prod if metric == D.DistanceMetric.COSINE else c_sq[None] - 2 * prod
    s = torch.where(torch.isfinite(s), s, torch.full_like(s, 1e30))
    best, aid, _d2 = D.argmin_rescored(s, k, x, rescore_table(centroids))
    aid = torch.where(valid, aid, torch.tensor(k, dtype=torch.int32))
    return aid, best


def blob_fixture():
    """The 13K blob mixture of tests/test_kmeans.py."""
    rng = np.random.RandomState(0)
    xs = np.empty((13000, 2), dtype=np.float32)
    xs[:2000] = rng.rand(2000, 2) + [0, 0.5]
    xs[2000:4000] = rng.rand(2000, 2) + [0, 1.5]
    xs[4000:6000] = rng.rand(2000, 2) - [0, 0.5]
    xs[6000:8000] = rng.rand(2000, 2) + [0.5, 0]
    xs[8000:10000] = rng.rand(2000, 2) - [0.5, 0]
    xs[10000:] = rng.rand(3000, 2) * 5 - [2, 2]
    return xs


def ragged_like(metric_name, n=2003, f=250, k=100, seed=3):
    """Odd n, f not a multiple of the kernel's chunks, k not a multiple of
    its tile; ten invalid (zeroed) rows and a NaN centroid, as the smoke's
    ragged case."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, f).astype(np.float32)
    if metric_name == "cos":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    c = (x[rng.choice(n, k, replace=False)]
         + 0.01 * rng.rand(k, f)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[5:15] = False
    x[5:15] = 0
    c[7] = np.nan
    return x, valid, c


def _check(x, valid, c, metric_name, chunk):
    """``chunk`` divides n: the JAX pass scans whole chunks."""
    k = c.shape[0]
    tm = D.DistanceMetric.COSINE if metric_name == "cos" \
        else D.DistanceMetric.L2
    jm = JD.DistanceMetric.COSINE if metric_name == "cos" \
        else JD.DistanceMetric.L2
    xt, vt, ct = torch.from_numpy(x), torch.from_numpy(valid), \
        torch.from_numpy(c)
    prev = torch.full((x.shape[0],), k, dtype=torch.int32)
    aid_e, best_e = emulated_3xtf32_assign(xt, vt, ct, k, tm)
    aid_p, best_p, _ch = K.assign_only_pass_reference(
        xt, vt, prev, ct, n_clusters=k, metric=tm)
    aid_j, _best_j = JA.assign_pass(jnp.asarray(x), jnp.asarray(valid),
                                    jnp.asarray(c), n_clusters=k, metric=jm,
                                    chunk=chunk)
    aid_j = torch.from_numpy(np.asarray(aid_j).astype(np.int32))
    # the emulated products lie within 8 fp32 ulps (2**-20) of sum_j |x_j
    # c_j| from fp64 (finite centroids, nonzero rows); one truncating
    # accumulator for all three products over all stages errs by 2.8e-6 on
    # the ragged case, past what the card's 1e-5 scores allow
    panel = pad_clusters(ct, torch.float32)[0]
    exact = xt.double() @ panel.double().T
    size = xt.double().abs() @ panel.double().abs().T
    fin = torch.isfinite(exact) & (size > 0)
    prod = emulated_3xtf32_products(xt, panel).double()
    assert float(((prod - exact).abs() / size)[fin].max()) <= 2.0 ** -20
    ties = K.near_ties(xt, ct, tm)
    for other in (aid_p, aid_j):
        assert not bool(((aid_e != other) & ~ties).any())
    # best scores: rtol 1e-5, or 1e-6 of the mean |x|^2 where the score is
    # near 0 (c_sq - 2 prod cancels terms of that size)
    same = aid_e == aid_p
    scale = float(D.row_sq_norms(xt).mean())
    torch.testing.assert_close(best_e[same], best_p[same], rtol=1e-5,
                               atol=1e-6 * scale)
    return int(ties.sum())


def test_emulated_3xtf32_matches_plain_on_blobs():
    xs = blob_fixture()
    rng = np.random.RandomState(2)
    c = xs[rng.choice(13000, 50, replace=False)]
    valid = np.ones(13000, bool)
    _check(xs, valid, c, "L2", 1000)


@pytest.mark.parametrize("metric_name", ["L2", "cos"])
def test_emulated_3xtf32_matches_plain_ragged(metric_name):
    x, valid, c = ragged_like(metric_name)
    _check(x, valid, c, metric_name, x.shape[0])
