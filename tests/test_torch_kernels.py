"""The CUDA kernels against their plain-torch twins, on the card.

Every test here needs a CUDA device and skips without one.  On the card:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

(``--noconftest``: the suite's conftest sets up JAX, which the card's
machine does not need.)  Tolerances, as in chip_smoke.py: assignments are
equal except at near-ties (``K.near_ties``: consecutive plain top-3 scores
within 1e-5 * max(1, |s1|), or the rescore's two exact squared distances
within 1e-5 * max(1, d2)); best scores agree to rtol 1e-5; sums to
rtol 1e-5 and atol 1e-5 * mean |x| (fp32 sums in another order), always
against the plain segment sum of the kernel's own assignment, and also
against the plain twin's wherever no assignment differs; counts and the
reassignment count are equal wherever the assignments are.  The whole
call on the card against the same call on the CPU is checked by
chip_smoke.py.
"""

import pytest
import torch

from kmcuda_torch.ops import assign_kernels as K
from kmcuda_torch.ops import distance as D

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    D.disable_tf32()
    return torch.device("cuda")


def _problem(dev, n, f, k, dtype, metric, ragged, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.rand(n, f, generator=g)
    if metric == D.DistanceMetric.COSINE:
        x = x / x.norm(dim=1, keepdim=True)
    c = x[torch.randperm(n, generator=g)[:k]] \
        + 0.01 * torch.rand(k, f, generator=g)
    valid = torch.ones(n, dtype=torch.bool)
    if ragged:
        x[5:15] = 0                      # NaN rows, as prepare() leaves them
        valid[5:15] = False
        c[7] = float("nan")              # an empty cluster's centroid
    prev = torch.randint(0, k + 1, (n,), generator=g, dtype=torch.int32)
    return (x.to(dev, dtype), valid.to(dev), prev.to(dev), c.to(dev))


CASES = [(20011, 70, 300, True), (1000, 3, 5, False), (4096, 256, 1024, True)]


@pytest.mark.parametrize("metric", [D.DistanceMetric.L2,
                                    D.DistanceMetric.COSINE],
                         ids=["L2", "cos"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,f,k,ragged", CASES)
def test_kernels_match_plain(cuda, n, f, k, ragged, dtype, metric):
    x, valid, prev, c = _problem(cuda, n, f, k, dtype, metric, ragged)
    aid_r, best_r, sums_r, counts_r, ch_r = K.fused_lloyd_pass_reference(
        x, valid, prev, c, n_clusters=k, metric=metric)
    aid, best, sums, counts, ch = K.fused_lloyd_pass(
        x, valid, prev, c, n_clusters=k, metric=metric)
    torch.cuda.synchronize()
    differ = aid != aid_r
    assert not (differ & ~K.near_ties(x, c, metric)).any()
    same = ~differ
    torch.testing.assert_close(best[same], best_r[same], rtol=1e-5, atol=0)
    atol = 1e-5 * float(x.float().abs().mean())
    sums_own, counts_own = K.segment_sum_reference(x, aid, k)
    assert torch.equal(counts, counts_own)
    torch.testing.assert_close(sums, sums_own, rtol=1e-5, atol=atol)
    if not differ.any():
        assert torch.equal(counts, counts_r) and int(ch) == int(ch_r)
        torch.testing.assert_close(sums, sums_r, rtol=1e-5, atol=atol)
    if ragged:
        assert (aid[5:15] == k).all() and not (aid == 7).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_fused_equals_assign_only_and_sums_repeat(cuda, dtype):
    x, valid, prev, c = _problem(cuda, 30000, 64, 500, dtype,
                                 D.DistanceMetric.L2, True, seed=1)
    a1, b1, s1, n1, ch1 = K.fused_lloyd_pass(x, valid, prev, c,
                                             n_clusters=500,
                                             metric=D.DistanceMetric.L2)
    a2, b2, ch2 = K.assign_only_pass(x, valid, prev, c, n_clusters=500,
                                     metric=D.DistanceMetric.L2)
    a3, b3, s3, n3, ch3 = K.fused_lloyd_pass(x, valid, prev, c,
                                             n_clusters=500,
                                             metric=D.DistanceMetric.L2)
    assert torch.equal(a1, a2) and torch.equal(b1, b2)
    assert int(ch1) == int(ch2)
    assert torch.equal(s1, s3) and torch.equal(n1, n3)   # bitwise repeat

