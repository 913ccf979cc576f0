"""The k-means++ step's weighted draw (``ops.init_kernels.weighted_draw``,
``kmt_weighted_draw`` on the card) and its plain twin
(``weighted_draw_reference``).

The twin runs the kernel's tree in plain torch: quads of 4 rows, lines of
32 quads, chunks of 4096 rows, groups of chunk partials, 32 supergroups
of 32 groups; every node the left-to-right fp32 sum of its children, the
pick a descent that holds t below each node's total.  Here it is held
against a literal numpy walk of that tree (bitwise), against the draw
contract the torch draw the port ran before (``chip_profile.py``
``torch_weighted_draw``) meets
(chi-square frequencies, the top of the range, no zero-weight row, the
valid rows when no weight is positive) and against an fp64 inverse CDF
(equal picks except where the uniform lies within ``draw_margin`` of a
boundary).  The ``gpu`` tests hold the kernel against the twin bitwise
on the card, with a second stream busy, and k-means++ on the card bitwise
across calls; they skip here.  Run them on the card with

    python -m pytest --noconftest -q -m gpu tests/test_torch_draw.py
"""

import numpy as np
import pytest
import torch
from scipy.stats import chisquare

import chip_profile
from kmcuda_torch import KMTPUInvalidArguments
from kmcuda_torch.models import initialization as I
from kmcuda_torch.models.problem import prepare
from kmcuda_torch.ops import assign_kernels as K
from kmcuda_torch.ops import distance as TD
from kmcuda_torch.ops import init_kernels as IK
from kmcuda_torch.utils.logging import Logger

torch.set_num_threads(2)


def _torch_draw(w, valid, u):
    """The torch draw the port ran before the kernel: over the weights, or
    over the valid rows when no weight is positive."""
    return chip_profile.torch_weighted_draw(
        torch.where(w.sum() > 0, w, valid.float()), u)


DRAWS = {"torch": _torch_draw, "twin": IK.weighted_draw_reference}


def _all_valid(n):
    return torch.ones(n, dtype=torch.bool)


def _weights(n, seed, zero_share=0.3, invalid_share=0.1):
    """(w, valid): U(0, 1) weights, a share of them 0, a share of the rows
    invalid (weight 0)."""
    rng = np.random.RandomState(seed)
    w = rng.rand(n).astype(np.float32)
    w[rng.rand(n) < zero_share] = 0
    valid = rng.rand(n) >= invalid_share
    w[~valid] = 0
    return torch.from_numpy(w), torch.from_numpy(valid)


@pytest.mark.parametrize("draw", sorted(DRAWS))
@pytest.mark.parametrize("n", [7, 16])
def test_weighted_draw_frequencies(draw, n):
    """Draw counts follow the weights (chi-square, p > 1e-3) and a row of
    weight 0 is never drawn (tests/test_torch_init.py's case, both
    draws)."""
    weights = torch.tensor([0.0, 1.0, 2.5, 0.0, 3.0, 0.5, 1.0, 2.0, 0.0,
                            4.0, 1.5, 0.0, 0.25, 3.0, 2.0, 0.0][:n])
    us = torch.rand(6000, generator=torch.Generator().manual_seed(n))
    counts = np.bincount([int(DRAWS[draw](weights, _all_valid(n),
                                          us[i:i + 1]))
                          for i in range(us.numel())], minlength=n)
    w = weights.numpy().astype(np.float64)
    assert (counts[w == 0] == 0).all()
    pos = w > 0
    expected = w[pos] / w.sum() * counts.sum()
    assert chisquare(counts[pos], expected).pvalue > 1e-3


@pytest.mark.parametrize("draw", sorted(DRAWS))
def test_weighted_draw_at_the_top_of_the_range(draw):
    """u just below 1 (u * total rounds up to the total) still draws the
    last row of positive weight, not a trailing zero-weight row."""
    weights = torch.tensor([1.0, 3.0, 0.1, 0.0, 0.0, 0.0, 0.0, 0.0])
    top = torch.tensor([1.0 - 2.0 ** -24])
    assert int(DRAWS[draw](weights, _all_valid(8), top)) == 2
    assert int(DRAWS[draw](weights[:7], _all_valid(7), top)) == 2


# a literal walk of the kernel's tree, in numpy fp32, one value at a time

def _running(values):
    c, out = np.float32(0), []
    for v in values:
        c = np.float32(c + np.float32(v))
        out.append(c)
    return out


def _pick(values, t):
    run = _running(values)
    lim = np.nextafter(run[-1], np.float32(0))
    t = t if t < lim else lim
    for i, c in enumerate(run):
        if c > t:
            return i, np.float32(t - (run[i - 1] if i else np.float32(0)))
    return len(run) - 1, np.float32(t - (run[-2] if len(run) > 1
                                         else np.float32(0)))


def _literal_draw(w, valid, u):
    n = len(w)
    C = IK.DRAW_CHUNK
    P = -(-n // C)
    R = -(-P // IK.DRAW_GROUPS)

    def leaf(i, use_valid):
        if i >= n:
            return np.float32(0)
        return np.float32(valid[i]) if use_valid else w[i]

    def chunk(j, use_valid):
        quads = [[_running([leaf(j * C + 128 * l + 4 * q + r, use_valid)
                            for r in range(4)])[-1] for q in range(32)]
                 for l in range(32)]
        return quads, [_running(qs)[-1] for qs in quads]

    def partial(j, use_valid):
        if j >= P:
            return np.float32(0)
        if use_valid:
            return np.float32(sum(bool(valid[i]) for i in
                                  range(j * C, min(n, (j + 1) * C))))
        return _running(chunk(j, False)[1])[-1]

    for use_valid in (False, True):
        parts = [partial(j, use_valid) for j in range(P)]
        groups = [_running([parts[g * R + i] if g * R + i < P
                            else np.float32(0) for i in range(R)])[-1]
                  for g in range(IK.DRAW_GROUPS)]
        supers = [_running(groups[32 * s:32 * s + 32])[-1]
                  for s in range(32)]
        total = _running(supers)[-1]
        if total > 0:
            break
    t = np.float32(np.float32(u) * total)
    s, t = _pick(supers, t)
    g, t = _pick(groups[32 * s:32 * s + 32], t)
    g += 32 * s
    i, t = _pick([parts[g * R + i] if g * R + i < P else np.float32(0)
                  for i in range(R)], t)
    j = g * R + i
    quads, lines = chunk(j, use_valid)
    l, t = _pick(lines, t)
    q, t = _pick(quads[l], t)
    first = j * C + 128 * l + 4 * q
    r, t = _pick([leaf(first + e, use_valid) for e in range(4)], t)
    return min(first + r, n - 1)


@pytest.mark.parametrize("n", [1, 5, 4096, 4101, 12_289])
def test_twin_is_the_literal_tree(n):
    """The twin's index is bitwise a walk of the tree one value at a time
    (a one-row chunk, a whole chunk, a ragged second chunk, a prime n over
    four chunks), over weights with zeros and invalid rows, at random
    uniforms and at the ends of [0, 1)."""
    w, valid = _weights(n, seed=n)
    us = np.concatenate([np.random.RandomState(n + 1).rand(12),
                         [0.0, 1.0 - 2.0 ** -24]]).astype(np.float32)
    for u in us:
        got = int(IK.weighted_draw_reference(w, valid,
                                             torch.tensor([u])))
        assert got == _literal_draw(w.numpy(), valid.numpy(), u)


@pytest.mark.parametrize("n", [3, 4095, 4096, 4097, 8191, 100_003, 300_000])
def test_twin_is_the_fp64_inverse_cdf_off_the_boundaries(n):
    """Ragged and prime n, n below and above a chunk: the twin draws the
    row of the fp64 inverse CDF, except where u lies within draw_margin of
    the boundary between that row and the twin's, two rows of positive
    weight with none between; it never draws a row of weight 0."""
    w, valid = _weights(n, seed=3 * n)
    w[n // 2], valid[n // 2] = 0.5, True   # some weight is positive
    cum = np.cumsum(w.double().numpy())
    share = cum / cum[-1]
    margin = IK.draw_margin(n)
    us = torch.rand(300, generator=torch.Generator().manual_seed(n))
    for u in us:
        got = int(IK.weighted_draw_reference(w, valid, u.reshape(1)))
        assert w[got] > 0
        want = int(np.searchsorted(share, float(u), side="right"))
        if got != want:
            lo, hi = min(got, want), max(got, want)
            assert abs(share[lo] - float(u)) <= margin
            assert not bool((w[lo + 1:hi] > 0).any())


@pytest.mark.parametrize("n", [1, 3, 4097, 9001])
def test_all_zero_weights_draw_only_valid_rows(n):
    """Every valid row already chosen: the draw runs over the valid rows,
    uniformly (each valid row drawn, no invalid one) and bitwise the
    literal tree."""
    valid = torch.from_numpy(np.random.RandomState(n).rand(n) < 0.5)
    valid[n // 2] = True
    w = torch.zeros(n)
    us = torch.rand(400, generator=torch.Generator().manual_seed(n))
    picks = [int(IK.weighted_draw_reference(w, valid, u.reshape(1)))
             for u in us]
    assert all(bool(valid[i]) for i in picks)
    if int(valid.sum()) <= 4:
        assert set(picks) == set(torch.nonzero(valid)[:, 0].tolist())
    for u in us[:5]:
        assert (int(IK.weighted_draw_reference(w, valid, u.reshape(1)))
                == _literal_draw(w.numpy(), valid.numpy(), float(u)))


def test_wrapper_runs_the_twin_and_copies_the_row_on_the_cpu():
    """On a CPU tensor ``weighted_draw`` is the twin, counts no launch,
    and copies the drawn row as fp32 (from fp32 and bf16 storage)."""
    n, f = 5000, 7
    w, valid = _weights(n, seed=11)
    u = torch.tensor([0.375])
    want = IK.weighted_draw_reference(w, valid, u)
    launches = IK.LAUNCHES["weighted_draw"]
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(n, f).to(dtype)
        out = torch.full((f,), float("nan"))
        got = IK.weighted_draw(w, valid, u, row_source=x, out_row=out)
        assert torch.equal(got, want) and got.dtype == torch.int64
        assert torch.equal(out, x[int(want)].float())
    assert torch.equal(IK.weighted_draw(w, valid, u), want)
    assert IK.LAUNCHES["weighted_draw"] == launches


def _bad_draw_args():
    n = 10
    w, valid, u = torch.rand(n), torch.ones(n, dtype=torch.bool), \
        torch.rand(1)
    x, out = torch.rand(n, 3), torch.empty(3)
    return {
        "w not 1-D": (torch.rand(n, 1), valid, u, {}),
        "w float64": (w.double(), valid, u, {}),
        "w empty": (torch.rand(0), torch.ones(0, dtype=torch.bool), u, {}),
        "valid not bool": (w, valid.int(), u, {}),
        "valid short": (w, valid[:-1], u, {}),
        "u two values": (w, valid, torch.rand(2), {}),
        "u float64": (w, valid, u.double(), {}),
        "w not contiguous": (torch.rand(2 * n)[::2], valid, u, {}),
        "row without out": (w, valid, u, {"row_source": x}),
        "out without row": (w, valid, u, {"out_row": out}),
        "row fp16": (w, valid, u, {"row_source": x.half(), "out_row": out}),
        "row short": (w, valid, u, {"row_source": x[:-1], "out_row": out}),
        "out wrong width": (w, valid, u, {"row_source": x,
                                          "out_row": torch.empty(4)}),
        "out bf16": (w, valid, u, {"row_source": x,
                                   "out_row": out.bfloat16()}),
        "meta device": (w.to("meta"), valid.to("meta"), u.to("meta"), {}),
        "devices differ": (w, valid.to("meta"), u, {}),
    }


@pytest.mark.parametrize("case", sorted(_bad_draw_args()))
def test_wrapper_checks_its_arguments(case):
    w, valid, u, kw = _bad_draw_args()[case]
    with pytest.raises(KMTPUInvalidArguments):
        IK.weighted_draw(w, valid, u, **kw)


def test_wrapper_refuses_what_is_not_a_tensor():
    with pytest.raises(TypeError):
        IK.weighted_draw(np.ones(3, np.float32),
                         torch.ones(3, dtype=torch.bool), torch.rand(1))


def test_draw_margin_grows_with_the_groups():
    """draw_margin: (R + 140) 2**-24 of the total, R the chunk partials a
    group holds (1 up to 4096 * 1024 rows)."""
    assert IK.draw_margin(1) == 141 * 2.0**-24
    assert IK.draw_margin(4096 * 1024) == 141 * 2.0**-24
    assert IK.draw_margin(4096 * 1024 + 1) == 142 * 2.0**-24
    assert IK.draw_margin(40_000_000) == 150 * 2.0**-24


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_case(n, f, seed, cuda, dtype=torch.float32):
    w, valid = _weights(n, seed)
    x = torch.randn(n, f, generator=torch.Generator().manual_seed(seed))
    return w.to(cuda), valid.to(cuda), x.to(cuda, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 7, 4095, 4096, 4097, 100_003, 1_000_000])
def test_kernel_is_the_twin_bitwise(cuda, n):
    """The kernel's index is the twin's over 200 uniforms and the ends of
    [0, 1), its row the drawn row as fp32 (fp32 and bf16 storage), a
    launch counted per call; all-zero weights draw the twin's valid row."""
    w, valid, x = _card_case(n, 5, n, cuda)
    us = torch.cat([torch.rand(200, generator=torch.Generator()
                               .manual_seed(n)),
                    torch.tensor([0.0, 1.0 - 2.0**-24])]).to(cuda)
    launches = IK.LAUNCHES["weighted_draw"]
    for i in range(us.numel()):
        u = us[i:i + 1]
        xs = x if i % 2 else x.bfloat16()
        out = torch.empty(5, device=cuda)
        got = IK.weighted_draw(w, valid, u, row_source=xs, out_row=out)
        want = IK.weighted_draw_reference(w, valid, u)
        assert torch.equal(got, want)
        assert torch.equal(out, xs[got[0]].float())
        if bool(w.sum() > 0):
            assert float(w[got[0]]) > 0
    assert IK.LAUNCHES["weighted_draw"] == launches + us.numel()
    zero = torch.zeros_like(w)
    for i in range(8):
        got = IK.weighted_draw(zero, valid, us[i:i + 1])
        assert torch.equal(got, IK.weighted_draw_reference(
            zero, valid, us[i:i + 1]))


@pytest.mark.gpu
def test_kernel_repeats_with_a_second_stream_busy(cuda):
    """The index does not depend on what else the card runs: the same 64
    draws at 2,000,003 weights, idle and while a second stream runs the
    assignment kernel, are bitwise equal."""
    n, f, k = 2_000_003, 64, 256
    w, valid, _ = _card_case(n, 1, 5, cuda)
    us = torch.rand(64, generator=torch.Generator().manual_seed(5)).to(cuda)
    idle = torch.cat([IK.weighted_draw(w, valid, us[i:i + 1])
                      for i in range(64)])
    x = torch.rand(n, f, device=cuda)
    c = torch.rand(k, f, device=cuda)
    prev = torch.zeros(n, dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(20):
            K.assign_only_pass(x, valid, prev, c, n_clusters=k,
                               metric=TD.DistanceMetric.L2)
    busy = torch.cat([IK.weighted_draw(w, valid, us[i:i + 1])
                      for i in range(64)])
    torch.cuda.synchronize()
    assert torch.equal(idle, busy)


@pytest.mark.gpu
def test_kmeanspp_on_card_repeats_bitwise(cuda):
    """k-means++ on the card (point_min and the draw, three launches a
    step) at 300,000 x 64 bf16, k=200: two calls, bitwise equal; every
    centroid a row of x."""
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.rand(300_000, 64, generator=g, device=cuda)
    p = prepare(x.half(), 200, TD.DistanceMetric.L2, cuda, Logger(0))
    before = dict(IK.LAUNCHES)
    a = I.init_centroids(p, I.InitMethod.PLUS_PLUS, 9)
    b = I.init_centroids(p, I.InitMethod.PLUS_PLUS, 9)
    assert torch.equal(a, b)
    assert IK.LAUNCHES["weighted_draw"] - before["weighted_draw"] == 400
    assert IK.LAUNCHES["point_min"] - before["point_min"] == 398
    rows = p.x.float()
    hit = torch.cat([(rows == a[i]).all(dim=1).any().reshape(1)
                     for i in range(200)])
    assert bool(hit.all())
