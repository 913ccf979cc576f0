"""The CUDA kernels against their plain-torch twins, on the card.

Every test here needs a CUDA device and skips without one.  On the card:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

(``--noconftest``: the suite's conftest sets up JAX, which the card's
machine does not need.)  Tolerances, as in chip_smoke.py: assignments are
equal except at near-ties (``K.near_ties``: consecutive plain top-3 scores
within 1e-5 * max(1, |s1|), or the rescore's two exact squared distances
within 1e-5 * max(1, d2)); best scores agree to rtol 1e-5 (here plus 1e-6
of |x|^2 + |c|^2, the size of the terms that cancel in them, for the f = 3
case: ``_assert_best_close``); sums to rtol 1e-5 and atol 1e-5 * mean |x|
(fp32 sums in another order), always against the plain segment sum of the
kernel's own assignment, and also against the plain twin's wherever no
assignment differs; counts and the reassignment count are equal wherever
the assignments are.  The whole
call on the card against the same call on the CPU is checked by
chip_smoke.py.
"""

import pytest
import torch

from kmcuda_torch.ops import _build
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


def _assert_best_close(best, best_r, x, c, aid):
    """Best scores within rtol 1e-5 of the twin's plus 1e-6 of |x|^2 +
    |c|^2 of the row and its centroid: the size of the terms that cancel in
    |c|^2 - 2 x.c (L2), and a bound on |x.c| (cosine).  The fp32 kernel's
    3xTF32 products round otherwise than the twin's FMA chain; where a
    score cancels to near 0 (the f = 3 case), an ulp of those terms is
    past 1e-5 of the score, for the twin against fp64 as much as for the
    kernel.  Prints the measured differences beside the tolerance."""
    a = aid.long()
    own = a < c.shape[0]                 # invalid rows have id k, x = 0
    size = D.row_sq_norms(x.float())
    size[own] += D.row_sq_norms(c.float())[a[own]]
    gap = (best - best_r).abs()
    past = gap > 1e-5 * best_r.abs()
    worst = float((gap[past] / size[past]).max()) if past.any() else 0.0
    print("best scores: max |d| %.3g; %d rows past rtol 1e-5, largest "
          "|d| / (|x|^2 + |c|^2) there %.3g (tolerance 1e-6)"
          % (float(gap.max()) if gap.numel() else 0.0, int(past.sum()),
             worst))
    assert bool((gap <= 1e-5 * best_r.abs() + 1e-6 * size).all()), worst


# (n, f, k, ragged): the kernel tiles 128 rows by 128 centroid columns and
# walks features in 128-byte chunks, so besides the main-path shape these
# cover k < 128 (k = 5, 2), k not a multiple of 128 (300, 1000), f whose
# bf16 rows are not 16-byte aligned (70, 3, 251: the plain-load path), and
# n < 128 (3)
CASES = [(20011, 70, 300, True), (1000, 3, 5, False), (4096, 256, 1024, True),
         (4099, 251, 1000, True), (3, 64, 2, False)]


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
    _assert_best_close(best[same], best_r[same], x[same], c, aid[same])
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



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_assign_only_rows_are_independent(cuda, dtype):
    """B2 on a gathered, sorted subset of the rows gives them bitwise what
    B2 over all rows gives them: the Yinyang loop's local filter rests on
    it."""
    x, valid, prev, c = _problem(cuda, 20011, 70, 300, dtype,
                                 D.DistanceMetric.L2, True, seed=2)
    kw = dict(n_clusters=300, metric=D.DistanceMetric.L2)
    a, b, _ch = K.assign_only_pass(x, valid, prev, c, **kw)
    g = torch.Generator(device="cpu").manual_seed(3)
    rows = torch.sort(torch.randperm(20011, generator=g)[:2000]).values
    rows = rows.to(cuda)
    a2, b2, ch2 = K.assign_only_pass(x[rows], valid[rows], prev[rows], c,
                                     **kw)
    assert torch.equal(a2, a[rows]) and torch.equal(b2, b[rows])
    assert int(ch2) == int((a[rows] != prev[rows]).sum())


def _card_problem(n, f, k, metric, ragged, seed=0):
    """``_problem`` made on the card (the 1M-row cases), bf16 x; ``ragged``
    zeroes and invalidates 1000 rows and sets centroid 7 to NaN."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(n, f, generator=g, device="cuda")
    if metric == D.DistanceMetric.COSINE:
        x = x / x.norm(dim=1, keepdim=True)
    c = x[torch.randperm(n, generator=g, device="cuda")[:k]] \
        + 0.01 * torch.rand(k, f, generator=g, device="cuda")
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    if ragged:
        rows = torch.randperm(n, generator=g, device="cuda")[:1000]
        x[rows] = 0
        valid[rows] = False
        c[7] = float("nan")
    prev = torch.randint(0, k + 1, (n,), generator=g, device="cuda",
                         dtype=torch.int32)
    return x.to(torch.bfloat16).contiguous(), valid, prev, c


def _routed(x, valid, prev, c, k, metric, route):
    """``kmt_assign`` forced onto ``route``, synchronized."""
    out = K._launch_assign(_build.library(), x, valid, prev, c, k, metric,
                           torch.cuda.current_stream().cuda_stream,
                           route=route)
    torch.cuda.synchronize()
    return out


def _assert_bitwise(got, want):
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    assert int(got[2]) == int(want[2])


# (n, f, k, metric, ragged): the persistent route against the streamed one
# at the main-path size, 1M x 256 x 1024 bf16, one change at a time: a
# ragged last row tile, k past a centroid tile's edge, one 64-feature chunk,
# a chunk zero-filled past f, cosine, invalid rows with a NaN centroid
ROUTE_CASES = [
    (1_000_037, 256, 1024, "L2", False),
    (1_000_000, 256, 1000, "L2", False),
    (1_000_000, 64, 1024, "L2", False),
    (1_000_000, 200, 1024, "L2", False),
    (1_000_000, 256, 1024, "cos", False),
    (1_000_000, 256, 1024, "L2", True),
]


@pytest.mark.parametrize("n,f,k,metric,ragged", ROUTE_CASES)
def test_persistent_route_is_bitwise_the_streamed(cuda, n, f, k, metric,
                                                  ragged):
    """``aid``, ``best`` and ``changed`` of the persistent kernel are the
    streamed kernel's, bit for bit."""
    metric = D.DistanceMetric.COSINE if metric == "cos" \
        else D.DistanceMetric.L2
    assert K.assign_route(torch.bfloat16, f, True) == K.ROUTE_PERSISTENT
    x, valid, prev, c = _card_problem(n, f, k, metric, ragged)
    want = _routed(x, valid, prev, c, k, metric, K.ROUTE_STREAMED)
    got = _routed(x, valid, prev, c, k, metric, K.ROUTE_PERSISTENT)
    _assert_bitwise(got, want)
    if ragged:
        assert bool((got[0][~valid] == k).all())


def test_persistent_route_rows_are_independent(cuda):
    """The persistent kernel on a gathered, sorted 10% of the rows gives
    them bitwise what it gives them over all 1M rows (and what the
    streamed kernel gives them)."""
    n, f, k = 1_000_000, 256, 1024
    metric = D.DistanceMetric.L2
    x, valid, prev, c = _card_problem(n, f, k, metric, True, seed=1)
    full = _routed(x, valid, prev, c, k, metric, K.ROUTE_PERSISTENT)
    _assert_bitwise(full, _routed(x, valid, prev, c, k, metric,
                                  K.ROUTE_STREAMED))
    g = torch.Generator(device="cuda").manual_seed(3)
    rows = torch.sort(torch.randperm(n, generator=g, device="cuda")
                      [:n // 10]).values
    sub = _routed(x[rows], valid[rows], prev[rows], c, k, metric,
                  K.ROUTE_PERSISTENT)
    assert torch.equal(sub[0], full[0][rows])
    assert torch.equal(sub[1].view(torch.int32),
                       full[1][rows].view(torch.int32))
    assert int(sub[2]) == int((full[0][rows] != prev[rows]).sum())


def _segment_sum(x, aid, k):
    """``kmt_segment_sum`` alone (B1's second half), synchronized."""
    lib = _build.library()
    out = K.launch_segment_sum(lib, x, aid, k,
                               torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    return out


# (n, f, k, dtype, ids): a skewed assignment (90% of the rows in one
# cluster, which spreads over many reduction chunks), k > n with empty
# clusters, every row invalid (id k), odd f in bf16 (rows not 16-byte
# aligned: the scalar loads), and a k past the shared-memory counters
SEGMENT_CASES = [
    (100_000, 256, 1024, torch.float32, "skewed"),
    (30_011, 251, 700, torch.bfloat16, "skewed"),
    (500, 64, 3000, torch.float32, "uniform"),
    (4099, 32, 50, torch.float32, "invalid"),
    (20_011, 251, 1000, torch.bfloat16, "uniform"),
    (40_000, 8, 20_000, torch.float32, "uniform"),
]


@pytest.mark.parametrize("n,f,k,dtype,ids", SEGMENT_CASES)
def test_segment_sum_matches_plain(cuda, n, f, k, dtype, ids):
    """B1' against ``segment_sum_reference``: counts equal; sums within
    rtol 1e-5 and atol 1e-5 * mean |x| of the same sums in fp64 (the twin's
    ``index_add_`` adds in the order of its atomics: on a 90,000-row
    cluster its own fp32 rounding passes 1e-5 of fp64); an empty cluster a
    zero row; two launches bitwise equal."""
    g = torch.Generator(device="cpu").manual_seed(n)
    x = torch.rand(n, f, generator=g)
    if ids == "skewed":
        aid = torch.where(torch.rand(n, generator=g) < 0.9,
                          torch.tensor(k // 3),
                          torch.randint(0, k + 1, (n,), generator=g))
    elif ids == "invalid":
        aid = torch.full((n,), k)
    else:
        aid = torch.randint(0, k + 1, (n,), generator=g)
    x, aid = x.to(cuda, dtype), aid.to(cuda, torch.int32)
    sums, counts = _segment_sum(x, aid, k)
    sums_r, counts_r = K.segment_sum_reference(x, aid, k)
    assert torch.equal(counts, counts_r)
    keep = aid < k
    sums64 = torch.zeros((k, f), dtype=torch.float64, device=cuda)
    sums64.index_add_(0, aid[keep].long(), x[keep].double())
    atol = 1e-5 * float(x.float().abs().mean())
    torch.testing.assert_close(sums.double(), sums64, rtol=1e-5, atol=atol)
    assert bool((sums[counts == 0] == 0).all())
    sums2, counts2 = _segment_sum(x, aid, k)
    assert torch.equal(sums, sums2) and torch.equal(counts, counts2)



def test_segment_sum_refuses_short_scratch(cuda):
    """``kmt_segment_sum`` counts the scratch its cut needs itself and
    refuses shorter scratch (cudaErrorInvalidValue) before it launches."""
    n, f, k = 5000, 64, 100
    x = torch.rand(n, f, device=cuda)
    aid = torch.randint(0, k, (n,), device=cuda, dtype=torch.int32)
    plan = K.segment_plan(n, f, k, 4)
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    sums = torch.empty((k, f), device=cuda)
    counts = torch.empty((k,), dtype=torch.int32, device=cuda)
    for ni, nf in ((plan.int_scratch - 1, plan.float_scratch),
                   (plan.int_scratch, plan.float_scratch - 1)):
        iscratch = torch.empty((ni,), dtype=torch.int32, device=cuda)
        fscratch = torch.empty((nf,), device=cuda)
        code = lib.kmt_segment_sum(
            x.data_ptr(), aid.data_ptr(), iscratch.data_ptr(),
            fscratch.data_ptr(), sums.data_ptr(), counts.data_ptr(), n, f, k,
            plan.rows, plan.chunk, plan.tx, ni, nf, 0, stream)
        assert code == 1   # cudaErrorInvalidValue
