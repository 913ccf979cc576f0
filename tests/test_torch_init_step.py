"""The init step (``kmcuda_torch.ops.init_kernels.point_min``) and the
row-blocked prepare passes (``ops.distance.row_sq_norms``,
``finite_rows``).

On the CPU ``point_min`` runs its plain twin, which must be bitwise the
composition the init loops ran before it (``point_distances``, then
``torch.where`` or ``torch.minimum``), and within rtol 1e-5 of the JAX
package's ``point_distances`` and its minimum (fp32 products summed in
another order).  The blocked passes must give every row bitwise the bits
of the whole-tensor pass, at a block size forced small so that the blocks
cut a ragged edge.  The kernel itself runs only on a card: the last test
holds it against its twin there (``gpu`` marker; it skips here):

    python -m pytest --noconftest -q -m gpu tests/test_torch_init_step.py
"""

import numpy as np
import pytest
import torch

from kmcuda_torch.models import initialization as I
from kmcuda_torch.models.problem import prepare
from kmcuda_torch.ops import distance as TD
from kmcuda_torch.ops import init_kernels as IK
from kmcuda_torch.utils.errors import KMTPUInvalidArguments
from kmcuda_torch.utils.logging import Logger

torch.set_num_threads(2)

L2, COS = TD.DistanceMetric.L2, TD.DistanceMetric.COSINE


def _rows(n, f, metric, seed=1, invalid=0.05):
    """U(0, 1) rows (unit rows for cosine) with a share of zero rows
    marked invalid, as ``prepare`` leaves NaN rows; and two points near
    valid rows (unit for cosine), fp32 numpy."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, f).astype(np.float32)
    if metric == COS:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    valid = rng.rand(n) >= invalid
    x[~valid] = 0.0
    cs = x[rng.choice(np.nonzero(valid)[0], 2)] + 0.01 * rng.rand(2, f)
    if metric == COS:
        cs /= np.linalg.norm(cs, axis=1, keepdims=True)
    return x, valid, cs.astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", [L2, COS])
def test_reference_is_the_old_composition(metric, dtype):
    """The twin's first and later steps are bitwise what the loops ran:
    ``where(valid, point_distances(...), 0)`` and ``minimum(m,
    point_distances(...))``."""
    x, valid, cs = _rows(3000, 24, metric)
    xt = torch.from_numpy(x).to(dtype)
    x_sq = TD.row_sq_norms(xt)
    vt = torch.from_numpy(valid)
    c0, c1 = torch.from_numpy(cs)
    m = torch.empty(3000)
    got0 = IK.point_min_reference(xt, x_sq, vt, c0, m, metric, first=True)
    want0 = torch.where(vt, TD.point_distances(xt, x_sq, c0, metric), 0.0)
    assert got0 is m and torch.equal(got0, want0)
    got1 = IK.point_min_reference(xt, x_sq, vt, c1, m.clone(), metric,
                                  first=False)
    want1 = torch.minimum(want0, TD.point_distances(xt, x_sq, c1, metric))
    assert torch.equal(got1, want1)


def _assert_close_to(got, want, x, c, metric, rtol):
    """Distances within ``rtol`` of the terms that cancel in them: L2 in
    the d^2 domain against rtol (|x|^2 + |c|^2), cosine in the cos domain
    against rtol |x| |c|.  The points lie near sample rows, as a drawn
    centroid does, so d^2 = |x|^2 - 2 x.c + |c|^2 cancels there and an
    rtol on d itself would measure the cancellation, not the pass."""
    x = x.astype(np.float64)
    c = c.astype(np.float64)
    got = got.astype(np.float64)
    want = want.astype(np.float64)
    if metric == L2:
        tol = rtol * ((x * x).sum(axis=1) + (c * c).sum())
        gap = np.abs(got ** 2 - want ** 2)
    else:
        tol = rtol * np.linalg.norm(x, axis=1) * np.linalg.norm(c)
        gap = np.abs(np.cos(got) - np.cos(want))
    assert (gap <= tol).all(), float((gap / tol).max())


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["L2", "cos"])
def test_point_min_matches_jax(metric, dname):
    """Two steps through the wrapper (on the CPU: the twin) against the
    JAX package's ``point_distances`` with its own squared norms, then
    ``where`` and ``minimum``: within rtol 1e-5 of the cancelling terms
    (``_assert_close_to``), invalid rows 0.  JAX is imported here, so the
    card's tests run without it."""
    import jax.numpy as jnp
    from kmcuda_tpu.ops import distance as JD

    tm = TD.metrics[metric]
    tdtype = getattr(torch, dname)
    x, valid, cs = _rows(4000, 40, tm, seed=2)
    xj = jnp.asarray(x, getattr(jnp, dname))
    xj_sq = JD.row_sq_norms(xj)
    d = [np.asarray(JD.point_distances(xj, xj_sq, jnp.asarray(c),
                                       JD.metrics[metric])) for c in cs]
    xt = torch.from_numpy(x).to(tdtype)
    x_sq = TD.row_sq_norms(xt)
    vt = torch.from_numpy(valid)
    xs = xt.float().numpy()
    IK.reset_launch_counts()
    m = IK.point_min(xt, x_sq, vt, torch.from_numpy(cs[0]),
                     torch.empty(4000), tm, first=True)
    _assert_close_to(m.numpy()[valid], d[0][valid], xs[valid], cs[0], tm,
                     1e-5)
    assert bool((m[~vt] == 0).all())
    first = m.clone()
    IK.point_min(xt, x_sq, vt, torch.from_numpy(cs[1]), m, tm, first=False)
    # the minimum took the new distance exactly where it is below the old
    took = m.numpy() < first.numpy()
    assert np.array_equal(m.numpy()[~took], first.numpy()[~took])
    _assert_close_to(m.numpy()[took], d[1][took], xs[took], cs[1], tm, 1e-5)
    assert bool((m[~vt] == 0).all())
    assert IK.LAUNCHES["point_min"] == 0      # the CPU runs no kernel


def test_wrapper_checks_its_arguments():
    x, valid, cs = _rows(50, 8, L2)
    xt = torch.from_numpy(x)
    args = dict(x_sq=TD.row_sq_norms(xt), valid=torch.from_numpy(valid),
                c=torch.from_numpy(cs[0]), m=torch.empty(50))
    bad = [dict(x=xt.double()), dict(x=xt.T), dict(c=args["c"][:4]),
           dict(m=torch.empty(50, dtype=torch.float64)),
           dict(valid=args["valid"].float()), dict(x_sq=args["x_sq"][:49])]
    for change in bad:
        kw = {"x": xt, **args, **change}
        with pytest.raises(KMTPUInvalidArguments):
            IK.point_min(kw["x"], kw["x_sq"], kw["valid"], kw["c"], kw["m"],
                         L2, first=True)
    meta = {name: t.to("meta") for name, t in {"x": xt, **args}.items()}
    with pytest.raises(KMTPUInvalidArguments, match="unsupported device"):
        IK.point_min(meta["x"], meta["x_sq"], meta["valid"], meta["c"],
                     meta["m"], L2, first=True)


@pytest.mark.parametrize("method,calls", [(I.InitMethod.PLUS_PLUS, 19),
                                          (I.InitMethod.AFKMC2, 1)])
def test_init_loops_step_through_point_min(monkeypatch, method, calls):
    """k-means++ takes one step per centroid but the last (k - 1), the
    first of them a first step; AFK-MC2 one, for its first centroid's
    distances."""
    seen = []
    real = IK.point_min

    def counted(*args, **kwargs):
        seen.append(kwargs["first"])
        return real(*args, **kwargs)

    monkeypatch.setattr(IK, "point_min", counted)
    x, _valid, _cs = _rows(500, 6, L2, invalid=0.0)
    p = prepare(torch.from_numpy(x), 20, L2, torch.device("cpu"), Logger(0))
    I.init_centroids(p, method, 3, afkmc2_m=10)
    assert seen == [True] + [False] * (calls - 1)


@pytest.mark.parametrize("f", [3, 17, 64])
def test_row_blocks_cover_the_rows(monkeypatch, f):
    """Blocks of a multiple of 64 rows, contiguous and covering [0, n);
    every block but the last holds the block's rows, the last from one to
    two blocks' worth, so no block is shorter than a block."""
    monkeypatch.setattr(TD, "ROW_BLOCK_BYTES", 4 * f * 128)
    for n in (1, 63, 64, 127, 128, 129, 300, 1000):
        blocks = TD.row_blocks(n, f)
        assert blocks[0][0] == 0 and blocks[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
        sizes = [e - s for s, e in blocks]
        assert all(s == 128 for s in sizes[:-1])
        assert sizes[-1] >= min(n, 128) and sizes[-1] < 256


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("f", [3, 17, 64])
def test_blocked_passes_are_the_whole_passes(monkeypatch, dtype, f):
    """x_sq and the finite test over blocks of 64 rows (the last one
    ragged) are bitwise the whole-tensor passes, with NaN and inf
    entries."""
    monkeypatch.setattr(TD, "ROW_BLOCK_BYTES", 4 * f * 64)
    rng = np.random.RandomState(f)
    x = (rng.randn(64 * 7 + 37, f) * 3).astype(np.float32)
    x[5, 0], x[77, f - 1], x[-1, f // 2] = np.nan, np.inf, -np.inf
    xt = torch.from_numpy(x).to(dtype)
    assert len(TD.row_blocks(*xt.shape)) == 7
    xf = xt.float()
    want = torch.sum(xf * xf, dim=-1)
    got = TD.row_sq_norms(xt)
    assert got.dtype == torch.float32
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert torch.equal(TD.finite_rows(xt), torch.isfinite(xt).all(dim=1))


@pytest.mark.parametrize("kind", ["fp32 tensor", "fp16 numpy", "bf16 tensor"])
def test_prepare_matches_the_whole_passes(monkeypatch, kind):
    """prepare's x_sq, valid and zeroed rows at a block size forced small
    equal the whole-tensor passes over the cleaned storage rows; the
    caller's tensor is not written."""
    monkeypatch.setattr(TD, "ROW_BLOCK_BYTES", 4 * 16 * 64)
    rng = np.random.RandomState(9)
    x = rng.rand(64 * 9 + 5, 16).astype(np.float32)
    x[rng.rand(x.shape[0]) < 0.1, 3] = np.nan
    if kind == "fp32 tensor":
        src = torch.from_numpy(x)
    elif kind == "fp16 numpy":
        src = x.astype(np.float16)
    else:
        src = torch.from_numpy(x).to(torch.bfloat16)
    before = src.clone() if isinstance(src, torch.Tensor) else src.copy()
    p = prepare(src, 8, L2, torch.device("cpu"), Logger(0))
    stored = torch.as_tensor(before).to(p.dtype)
    valid = torch.isfinite(stored).all(dim=1)
    clean = stored.masked_fill(~valid[:, None], 0)
    xf = clean.float()
    assert torch.equal(p.valid, valid) and int((~valid).sum()) > 0
    assert torch.equal(p.x, clean)
    assert torch.equal(p.x_sq, torch.sum(xf * xf, dim=-1))
    if isinstance(src, torch.Tensor):
        assert torch.equal(src.isnan(), before.isnan())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("f", [3, 8, 256, 257])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", [L2, COS])
def test_kernel_matches_twin_on_card(cuda, metric, dtype, f):
    """``kmt_point_min`` against its twin at the smoke's odd shapes: first
    steps within 1e-6 (x_sq + |c|^2) in the d^2 domain (L2) or 1e-6 |x| |c|
    in the cos domain (cosine), invalid rows 0, a launch counted; a later
    step bitwise the minimum of its input and the kernel's distances."""
    for n in (1, 33, 10_007):
        x, valid, cs = _rows(n, f, metric, seed=n)
        xt = torch.from_numpy(x).to(cuda, dtype)
        x_sq = TD.row_sq_norms(xt)
        vt = torch.from_numpy(valid).to(cuda)
        c0, c1 = torch.from_numpy(cs).to(cuda)
        before = IK.LAUNCHES["point_min"]
        got = IK.point_min(xt, x_sq, vt, c0, torch.empty_like(x_sq), metric,
                           first=True)
        assert IK.LAUNCHES["point_min"] == before + 1
        ref = IK.point_min_reference(xt, x_sq, vt, c0, torch.empty_like(x_sq),
                                     metric, first=True)
        if metric == L2:
            tol = 1e-6 * (x_sq + (c0 * c0).sum())
            gap = (got.double() ** 2 - ref.double() ** 2).abs()
        else:
            tol = 1e-6 * xt.float().norm(dim=1) * c0.norm()
            gap = (torch.cos(got.double()) - torch.cos(ref.double())).abs()
        assert bool((gap <= tol).all())
        assert bool((got[~vt] == 0).all())
        d1 = IK.point_min(xt, x_sq, vt, c1, torch.empty_like(x_sq), metric,
                          first=True)
        later = IK.point_min(xt, x_sq, vt, c1, ref.clone(), metric,
                             first=False)
        assert torch.equal(later, torch.minimum(ref, d1))
