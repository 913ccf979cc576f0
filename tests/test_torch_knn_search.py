"""The port's kNN layout, pass 1 and walk on CPU tensors against the JAX
package (``kmcuda_tpu.models.knn`` / ``ops.knn_prune`` / ``ops.knn_pallas``),
on the same inputs, made with numpy from a seed.

- ``packed_layout`` and ``select_k``: equal exactly.
- ``plan_pruned`` at n = 16,384, where JAX's one-device padding leaves
  n_pad == n: the shape fields, incidence tables, tile counts, sort order,
  sorted positions, cluster ids and packed members exactly; radii and
  rank-space centroids to rtol 1e-6 (fp32 sums in another order).  The
  fixture has no near-tie in the relabeling tour, whose k sequential
  argmins would otherwise follow rounding.
- ``search`` on the JAX plan (``interop.plan_from_jax``) against JAX's
  plain XLA walk (``use_pallas=False``): neighbours equal except where the
  fp64 distances tie (rtol 1e-6), distances rtol 1e-6, the examined count
  rel 1e-6 (JAX sums it in fp32).
- ``walk_reference`` against the Pallas walk in interpret mode, on the
  port's walk inputs: candidate lists equal except where their fp64
  distance profiles agree to rtol 1e-5 (near-ties at the kk boundary),
  examined equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmcuda_tpu import config as jconfig
from kmcuda_tpu import kmeans_tpu
from kmcuda_tpu.models import knn as JK
from kmcuda_tpu.models.problem import prepare as jprepare
from kmcuda_tpu.ops import distance as JD
from kmcuda_tpu.ops import knn_pallas as JKNP
from kmcuda_tpu.ops import knn_prune as JKP
from kmcuda_tpu.parallel.mesh import Topology
from kmcuda_tpu.utils.logging import Logger as JLogger
from kmcuda_torch import config
from kmcuda_torch.interop import plan_from_jax
from kmcuda_torch.models import knn as TK
from kmcuda_torch.models.problem import prepare
from kmcuda_torch.ops import distance as D
from kmcuda_torch.ops import knn_kernels as KK
from kmcuda_torch.ops import knn_prune as KP
from kmcuda_torch.utils.logging import Logger

torch.set_num_threads(2)

METRICS = {"L2": (JD.DistanceMetric.L2, D.DistanceMetric.L2),
           "cos": (JD.DistanceMetric.COSINE, D.DistanceMetric.COSINE)}


def _blobs(n, f, kc, seed, spread=0.3, metric="L2"):
    rng = np.random.RandomState(seed)
    centers = rng.rand(kc, f).astype(np.float32) * 8.0
    x = centers[rng.randint(0, kc, n)] + spread * rng.randn(n, f).astype(
        np.float32)
    if metric == "cos":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def _jax_plan(x, kc, metric="L2"):
    """JAX problem, clustering and layout plan on one device."""
    topo = Topology((jax.devices()[0],))
    p = jprepare(x, kc, METRICS[metric][0], topo, JLogger(0))
    assert p.n_pad == len(x)
    c, a = kmeans_tpu(x, kc, seed=7, tolerance=0.01, yinyang_t=0,
                      metric=metric, device=1)
    plan = JK.plan_pruned(p, jnp.asarray(c, jnp.float32),
                          jnp.asarray(a.astype(np.uint32)))
    return p, c, a, plan


@pytest.fixture(scope="module")
def plan16k():
    x = _blobs(16384, 32, 16, 3)
    return (x,) + _jax_plan(x, 16)


@pytest.mark.parametrize("n,k,tile_m", [(5000, 37, 128), (3000, 9, 256)])
def test_packed_layout_matches_jax(n, k, tile_m):
    rng = np.random.RandomState(n)
    a = np.sort(rng.randint(0, k + 1, n)).astype(np.uint32)  # k = invalid
    a[a == 3] = 4                                            # empty cluster
    n_tiles = -(-(n + tile_m) // tile_m)
    want = JKP.packed_layout(jnp.asarray(a), k=k, tile_m=tile_m,
                             n_tiles=n_tiles)
    got = KP.packed_layout(torch.from_numpy(a.astype(np.int64)), k=k,
                           tile_m=tile_m, n_tiles=n_tiles)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_select_k_lexicographic_on_ties():
    """Duplicate distances: the lowest id wins, whatever the column."""
    rng = np.random.RandomState(2)
    d = rng.randint(0, 4, (64, 300)).astype(np.float32)
    d[:, 7] = np.inf
    idx = np.stack([rng.permutation(300) for _ in range(64)]).astype(np.int32)
    wd, wi = JKP.select_k(jnp.asarray(d), jnp.asarray(idx), 40)
    gd, gi = KP.select_k(torch.from_numpy(d), torch.from_numpy(idx), 40)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def _port_plan(x, c, a, kc, metric="L2"):
    p = prepare(torch.from_numpy(x), kc, METRICS[metric][1],
                torch.device("cpu"), Logger(0))
    return TK.plan_pruned(p, torch.tensor(c).float(),
                          torch.from_numpy(a.astype(np.int64)))


def _assert_plans_equal(got, want):
    for name in ("tile_m", "q_chunk", "n_tiles", "m_total", "group"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("inc_c", "inc_t", "tile_nvalid", "sorder", "m_spos",
                 "q_assign", "xm"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(),
            np.asarray(getattr(want, name)).astype(
                getattr(got, name).numpy().dtype), err_msg=name)
    for name in ("r_ext", "c_rank"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, err_msg=name)


def test_plan_pruned_matches_jax(plan16k):
    x, _p, c, a, want = plan16k
    got = _port_plan(x, c, a, 16)
    assert got.group > 1
    _assert_plans_equal(got, want)


def test_projection_relabel_matches_jax(plan16k, monkeypatch):
    """Past KNN_TOUR_MAX_K clusters both packages sort by a projection."""
    x, p, c, a, _plan = plan16k
    monkeypatch.setattr(jconfig, "KNN_TOUR_MAX_K", 8)
    monkeypatch.setattr(config, "KNN_TOUR_MAX_K", 8)
    want = JK.plan_pruned(p, jnp.asarray(c, jnp.float32),
                          jnp.asarray(a.astype(np.uint32)))
    _assert_plans_equal(_port_plan(x, c, a, 16), want)


def _fp64_ties(xc, q_rows, got, want, rtol):
    """For each row where the id lists differ, their fp64 distance
    profiles (to the query rows ``q_rows``) agree to rtol."""
    bad = np.nonzero((got != want).any(axis=1))[0]
    for r in bad:
        dg = np.linalg.norm(xc[got[r]].astype(np.float64) - q_rows[r], axis=1)
        dw = np.linalg.norm(xc[want[r]].astype(np.float64) - q_rows[r],
                            axis=1)
        np.testing.assert_allclose(np.sort(dg), np.sort(dw), rtol=rtol)
    return len(bad)


SEARCH_CASES = {
    "fp32-L2-nan": ("L2", False, True),
    "cos": ("cos", False, False),
    "bf16-L2": ("L2", True, False),
}


@pytest.mark.parametrize("case", list(SEARCH_CASES))
def test_search_matches_jax_xla_walk(case):
    metric, bf16, nan = SEARCH_CASES[case]
    x = _blobs(8192, 16, 16, 5, metric=metric)
    if nan:
        x[5] = np.nan
        x[999, 3] = np.inf
    xin = x.astype(np.float16) if bf16 else x
    p, _c, _a, jplan = _jax_plan(xin, 16, metric)
    assert jplan.group > 1
    kn = 9
    nchunks = jplan.m_total // jplan.q_chunk
    jm, tm = METRICS[metric]
    sq = JD.row_sq_norms(jplan.xm)
    orig_pos = jnp.where(jplan.m_spos >= 0,
                         jplan.sorder[jnp.maximum(jplan.m_spos, 0)], -1)
    fx = jax.jit(functools.partial(
        JKP.search, k_neighbors=kn, n_clusters=16, metric=jm,
        chunk=jplan.q_chunk, tile_m=jplan.tile_m, group=jplan.group,
        n_batch_chunks=nchunks, use_pallas=False, axis_name=None))
    wn, wd, wc = jax.device_get(fx(
        jplan.xm, sq, jplan.q_assign, jplan.xm, sq, jplan.m_spos, orig_pos,
        jplan.c_rank, jplan.r_ext, jplan.inc_c, jplan.inc_t,
        jplan.tile_nvalid, jplan.xm, jnp.int32(0)))

    plan = plan_from_jax(jplan, device="cpu")
    gn, gd, gc = TK.search_batch(plan, 0, nchunks, k_neighbors=kn,
                                 n_clusters=16, metric=tm)
    gn, gd = gn.numpy(), gd.numpy()
    assert int(gc.sum()) == pytest.approx(float(wc), rel=1e-6)
    xc = np.asarray(p.x.astype(jnp.float32))
    q_rows = np.asarray(plan.xm.float())
    valid = plan.m_spos.numpy() >= 0
    np.testing.assert_array_equal(gn[~valid], -1)
    _fp64_ties(xc, q_rows[valid], gn[valid], np.asarray(wn)[valid], 1e-6)
    same = gn == np.asarray(wn)
    np.testing.assert_allclose(gd[same], np.asarray(wd)[same], rtol=1e-6)


def test_walk_reference_matches_pallas_interpret():
    x = _blobs(4096, 32, 16, 9)
    _p, c, a, _plan = _jax_plan(x, 16)
    plan = _port_plan(x, c, a, 16)
    assert plan.group > 1
    nchunks = plan.m_total // plan.q_chunk
    args, kw = TK.batch_walk_inputs(plan, 0, nchunks, k_neighbors=7,
                                    n_clusters=16, metric=D.DistanceMetric.L2)
    bi, ex, _steps = KK.walk_reference(*args, **kw)
    (xq, xq_sq, q_pos, q_valid, n_qvalid, n_steps, tile_order, sorted_min,
     tile_nvalid, xm, xm_sq, m_spos) = [jnp.asarray(t.numpy()) for t in args]
    kk = kw["kk"]
    wbi, wex = JKNP.walk(
        xq, xq_sq, q_pos, q_valid, n_qvalid, n_steps, tile_order, sorted_min,
        tile_nvalid, xm, xm_sq, m_spos, k_neighbors=7, kk=kk,
        chunk=plan.q_chunk, tile_m=plan.tile_m, group=plan.group,
        metric=JD.DistanceMetric.L2, eps_env=0.0, interpret=True)
    assert int(ex.sum()) == int(float(wex))
    xmn = plan.xm.numpy()
    valid = plan.m_spos.numpy() >= 0
    got = bi.numpy()[valid]
    want = np.asarray(wbi)[:, :kk][valid]
    _fp64_ties(xmn, xmn[valid].astype(np.float64), got, want, 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_walk_tie_accepts_only_edge_differences(dtype):
    """``knn_kernels.walk_tie``: a cosine candidate buffer is the exact
    walk's top kk when it differs from it only in a member whose dot
    equals the kk-th's to within the products' rounding; one that lacks a
    member far inside the top kk, holds one far outside it, the query
    itself, a padding row, a duplicate or an empty slot is not."""
    rng = np.random.RandomState(4)
    q = rng.randn(16)
    q /= np.linalg.norm(q)
    u = rng.randn(16)
    u -= (u @ q) * q
    u /= np.linalg.norm(u)
    # member 0 is the query, 1 a padding row at 0.05; then members at
    # angles 0.1, 0.2, 0.3, 0.5 from q and one more at 0.5 (a tie with the
    # fifth), and one at 0.9
    angles = [0.0, 0.05, 0.1, 0.2, 0.3, 0.5, 0.5 + 1e-9, 0.9]
    xm = torch.tensor(np.array([np.cos(a) * q + np.sin(a) * u
                                for a in angles]), dtype=dtype)
    m_spos = torch.tensor([0, -1, 2, 3, 4, 5, 6, 7], dtype=torch.int32)
    qt = xm[0].float()

    def tie(*v):
        return KK.walk_tie(qt, 0, torch.tensor(v, dtype=torch.int32), xm,
                           m_spos)

    assert tie(2, 3, 4, 5) and tie(2, 3, 4, 6) and tie(5, 3, 4, 2)
    assert not tie(2, 3, 5, 6)      # lacks the member at 0.3
    assert not tie(2, 3, 4, 7)      # holds the member at 0.9
    assert not tie(0, 2, 3, 4)      # the query itself
    assert not tie(1, 2, 3, 4)      # padding
    assert not tie(2, 3, 4, 4)
    assert not tie(2, 3, 4, -1)


def test_exact_hits_counts_true_neighbours_up_to_ties():
    """``knn_kernels.exact_hits``: a returned slot counts when its fp64
    distance reaches the exact profile's slot; the query itself, padding
    (m_spos < 0) and NaN members are never exact neighbours; either of two
    tied members counts."""
    q = torch.zeros(2)
    # member 0 is the query, 1 padding, 2 NaN; 3..6 at 1, 2, 2, 3
    xm = torch.tensor([[0.0, 0.0], [0.5, 0.0], [float("nan"), 0.0],
                       [1.0, 0.0], [0.0, 2.0], [-2.0, 0.0], [3.0, 0.0]])
    m_spos = torch.tensor([0, -1, 2, 3, 4, 5, 6], dtype=torch.int32)
    sides = torch.tensor([[3, 4], [5, 3], [3, 6], [6, -1], [0, 1]],
                         dtype=torch.int32)
    assert KK.exact_hits(q, 0, sides, xm, m_spos) == [2, 2, 1, 0, 0]
