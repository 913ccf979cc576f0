"""Exact bf16 cosine kNN through the public ``knn_cuda``.

bf16 rows of unit vectors are not of unit norm (|q| |m| = 1 +- ~2^-8), so
for near neighbours, where 1 - cos is far below that, an angle taken from
the dot product is mostly rounding.  The rescore returns the angle of the
chord of the stored rows, 2 asin(|q - m| / 2); the walk and pass 1 must
rank by that same measure, or the walk's kk-wide buffer holds the wrong
members and the rescore can only re-sort them.

The data: the layout of tests/test_torch_knn_kernels.py at a CPU size,
4,000 x 70 unit rows around 24 blob directions, fp16 input (bf16
storage), one NaN row, and the three rows the cosine check probes set to
exact unit vectors.  Every valid row's neighbours must equal an fp64
brute force of that measure over the stored rows, tie-aware as
``knn_kernels.exact_hits`` (each sorted slot within rtol 1e-6 of the
exact one).  Pass 1's tile bounds lie below the fp64 measure of every
(query, member) pair they cover.  The same rows in fp32 still give
``knn_tpu``'s neighbours, up to fp64 ties.
"""

import numpy as np
import pytest
import torch

from kmcuda_tpu import knn_tpu
from kmcuda_torch import knn_cuda
from kmcuda_torch.models import knn as TK
from kmcuda_torch.models.problem import prepare
from kmcuda_torch.ops import knn_prune as KP
from kmcuda_torch.ops.distance import DistanceMetric
from kmcuda_torch.utils.logging import Logger

torch.set_num_threads(2)

N, F, KC = 4000, 70, 24
NAN_ROW = 1234


@pytest.fixture(scope="module")
def unit_rows():
    """(fp32 rows, fp16 rows, unit centers, assignments)."""
    g = torch.Generator().manual_seed(3)
    centers = torch.rand(KC, F, generator=g, dtype=torch.float64) * 8.0
    which = torch.randint(0, KC, (N,), generator=g)
    x = centers[which] + 0.3 * torch.randn(N, F, generator=g,
                                           dtype=torch.float64)
    x = x / x.norm(dim=1, keepdim=True)
    x[[0, N // 2, N - 1]] = torch.eye(F, dtype=torch.float64)[:3]
    x[NAN_ROW] = float("nan")
    cents = (centers / centers.norm(dim=1, keepdim=True)).float()
    return (x.float(), x.to(torch.float16), cents, which.to(torch.int32))


def _chord_angles(xs):
    """(n, n) fp64 2 asin(|q - m| / 2) of the rows, +inf on the diagonal
    and for NaN rows."""
    x = xs.double()
    sq = (x * x).sum(dim=1)
    d2 = (sq[:, None] + sq[None, :] - 2.0 * x @ x.T).clamp(min=0.0)
    # the Gram form cancels for near neighbours: redo the near pairs by
    # subtract and square
    near = d2 < 1e-2
    qi, mi = torch.nonzero(near, as_tuple=True)
    d2[qi, mi] = ((x[qi] - x[mi]) ** 2).sum(dim=1)
    d = 2.0 * torch.asin(torch.clamp(torch.sqrt(d2) * 0.5, max=1.0))
    bad = torch.isnan(d)
    d[bad] = float("inf")
    d.fill_diagonal_(float("inf"))
    return d


def _assert_exact(nb, stored, kn):
    d = _chord_angles(stored)
    valid = torch.isfinite(stored).all(dim=1)
    assert (nb[~valid] == -1).all()
    nbv = nb[valid].long()
    assert (nbv >= 0).all() and valid[nbv].all()
    assert all(len(set(r)) == kn for r in nbv.tolist())
    dv = d[valid]
    true_prof = torch.topk(dv, kn, dim=1, largest=False).values
    got_prof = torch.sort(torch.gather(dv, 1, nbv), dim=1).values
    bad = (got_prof > true_prof * (1.0 + 1e-6)).any(dim=1)
    assert int(bad.sum()) == 0, (
        "%d of %d rows not exact; %d of %d neighbours found"
        % (int(bad.sum()), int(valid.sum()),
           int((got_prof <= true_prof * (1.0 + 1e-6)).sum()),
           int(valid.sum()) * kn))


@pytest.mark.parametrize("kn", [10, 100])
def test_bf16_cosine_neighbours_are_exact(unit_rows, kn):
    _x32, x16, cents, which = unit_rows
    nb = knn_cuda(kn, torch.from_numpy(x16.numpy()), cents, which,
                  metric="cos")
    assert nb.shape == (N, kn) and nb.dtype == torch.int32
    _assert_exact(nb, x16.to(torch.bfloat16), kn)


def test_bf16_cosine_tile_bounds_hold(unit_rows):
    """Pass 1 (``knn_prune.tours``) takes its bound in the chord and turns
    it into the angle: every chunk's bound of a tile is at most the fp64
    measure of each valid query of the chunk to each member of the
    tile."""
    _x32, x16, cents, which = unit_rows
    p = prepare(x16, KC, DistanceMetric.COSINE, torch.device("cpu"),
                Logger(0))
    plan = TK.plan_pruned(p, cents, which)
    nchunks = plan.m_total // plan.q_chunk
    args, kw = TK.batch_walk_inputs(plan, 0, nchunks, k_neighbors=10,
                                    n_clusters=KC,
                                    metric=DistanceMetric.COSINE)
    assert kw["eps_env"] == KP.EPS_ENV
    tile_order, sorted_min = args[6], args[7]
    real = plan.m_spos >= 0
    d = _chord_angles(torch.where(real[:, None], plan.xm.float(),
                                  float("nan")))
    d[~real] = float("inf")
    # the least measure of each chunk's valid queries to each tile
    per_tile = d.view(plan.m_total, plan.n_tiles, plan.tile_m).amin(dim=2)
    per_chunk = per_tile.view(nchunks, plan.q_chunk, plan.n_tiles).amin(
        dim=1)
    nt = plan.n_tiles
    order = tile_order[:, :nt].long()
    bound = sorted_min[:, :nt].double()
    least = torch.gather(per_chunk, 1, order)
    assert bool((bound <= least).all())
    assert bool((bound < KP.STOP_BOUND).any())


def test_bf16_cosine_brute_force_is_exact(unit_rows):
    """Under 2 * 128 rows the call searches by brute force; it ranks by
    the same measure."""
    _x32, x16, cents, which = unit_rows
    # 202 rows; the probed rows 0, 101 and 201 are the exact unit ones
    rows = torch.cat([torch.arange(101), torch.tensor([N // 2]),
                      torch.arange(101, 200), torch.tensor([N - 1])])
    sub = x16[rows]
    nb = knn_cuda(10, sub, cents, which[rows], metric="cos")
    _assert_exact(nb, sub.to(torch.bfloat16), 10)


def test_fp32_cosine_matches_knn_tpu(unit_rows):
    x32, _x16, cents, which = unit_rows
    got = knn_cuda(10, x32, cents, which, metric="cos").numpy()
    want = np.asarray(knn_tpu(10, x32.numpy(), cents.numpy(),
                              which.numpy().astype(np.uint32), metric="cos",
                              device=1)).astype(np.int64)
    want[want == 0xFFFFFFFF] = -1
    assert (got[NAN_ROW] == -1).all() and (want[NAN_ROW] == -1).all()
    d = _chord_angles(x32)
    rows = np.nonzero((got != want).any(axis=1))[0]
    for r in rows:
        prof = [np.sort(d[r, torch.from_numpy(ids)].numpy())
                for ids in (got[r].astype(np.int64), want[r])]
        np.testing.assert_allclose(prof[0], prof[1], rtol=1e-6, atol=0)
    assert len(rows) <= 0.01 * N
