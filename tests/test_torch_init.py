"""The port's k-means++ and AFK-MC2 init (kmcuda_torch.models
.initialization) and ``ops.distance.point_distances``.

``jax.random`` draws cannot be reproduced, so init is held by what its
draws must satisfy — the weighted draw's category frequencies (chi-square),
the Metropolis-Hastings chain against a literal sequential scan, only
valid rows drawn, the AFK-MC2 chain-length rules — by sklearn's one-step
check after a Lloyd run from it (as tests/test_kmeans.py), and by a
port-side golden.  ``point_distances`` is held against the JAX package's
to rtol 1e-5 (fp32 products summed in another order).
"""

import contextlib
import io

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from scipy.stats import chisquare
from sklearn.cluster import KMeans

import jax.numpy as jnp

from kmcuda_tpu.models import initialization as JI
from kmcuda_tpu.ops import distance as JD
from kmcuda_torch import KMTPUInvalidArguments, config, kmeans_cuda
from kmcuda_torch.models import initialization as I
from kmcuda_torch.models.problem import prepare
from kmcuda_torch.ops import distance as TD
from kmcuda_torch.utils.logging import Logger

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def samples():
    """The blob mixture of tests/test_kmeans.py."""
    rng = np.random.RandomState(0)
    arr = np.empty((13000, 2), dtype=np.float32)
    arr[:2000] = rng.rand(2000, 2) + [0, 0.5]
    arr[2000:4000] = rng.rand(2000, 2) + [0, 1.5]
    arr[4000:6000] = rng.rand(2000, 2) - [0, 0.5]
    arr[6000:8000] = rng.rand(2000, 2) + [0.5, 0]
    arr[8000:10000] = rng.rand(2000, 2) - [0.5, 0]
    arr[10000:] = rng.rand(3000, 2) * 5 - [2, 2]
    return arr


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["L2", "cos"])
def test_point_distances_match_jax(metric, dtype):
    rng = np.random.RandomState(1)
    x = rng.rand(500, 24).astype(np.float32)
    c = rng.rand(24).astype(np.float32) + 0.5
    if metric == "cos":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        c /= np.linalg.norm(c)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray(JD.point_distances(
        xj, JD.row_sq_norms(xj), jnp.asarray(c), JD.metrics[metric]))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = TD.point_distances(xt, TD.row_sq_norms(xt), torch.from_numpy(c),
                             TD.metrics[metric])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_draw_block_size_matches_jax():
    for n in (1, 2, 7, 8, 13000, 100_000, 1 << 20, 4096 * 3):
        assert I._draw_block_size(n) == JI._draw_block_size(n)


@pytest.mark.parametrize("n", [7, 16])     # one level; two blocks of 8
def test_weighted_draw_frequencies(n):
    """Draw counts follow the weights (chi-square, p > 1e-3) and a row of
    weight 0 is never drawn."""
    weights = torch.tensor([0.0, 1.0, 2.5, 0.0, 3.0, 0.5, 1.0, 2.0, 0.0,
                            4.0, 1.5, 0.0, 0.25, 3.0, 2.0, 0.0][:n])
    assert I._draw_block_size(n) == (1 if n == 7 else 8)
    us = torch.rand(6000, generator=torch.Generator().manual_seed(n))
    counts = np.bincount([int(I._weighted_draw(weights, us[i:i + 1]))
                          for i in range(us.numel())], minlength=n)
    w = weights.numpy().astype(np.float64)
    assert (counts[w == 0] == 0).all()
    pos = w > 0
    expected = w[pos] / w.sum() * counts.sum()
    assert chisquare(counts[pos], expected).pvalue > 1e-3


def test_weighted_draw_at_the_top_of_the_range():
    """u just below 1 (u * total rounds up to the total) still draws the
    last row of positive weight, not a trailing zero-weight row."""
    weights = torch.tensor([1.0, 3.0, 0.1, 0.0, 0.0, 0.0, 0.0, 0.0])
    top = torch.tensor([1.0 - 2.0 ** -24])
    assert int(I._weighted_draw(weights, top)) == 2
    assert int(I._weighted_draw(weights[:7], top)) == 2


def _scan(prob, u):
    """The literal sequential AFK-MC2 chain (the JAX package's lax.scan)."""
    held, cur = 0, np.float32(0.0)
    for j in range(len(prob)):
        if cur == 0 or np.float32(prob[j]) / cur > u[j]:
            held, cur = j, np.float32(prob[j])
    return held


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 40).flatmap(lambda m: st.tuples(
    st.lists(st.one_of(st.sampled_from([0.0, 0.5, 1.0, 2.0]),
                       st.floats(0.0, 10.0, width=32)),
             min_size=m, max_size=m),
    st.lists(st.one_of(st.sampled_from([0.0, 0.5, 1.0]),
                       st.floats(0.0, 1.0, width=32, exclude_max=True)),
             min_size=m, max_size=m))))
def test_mh_chain_matches_literal_scan(data):
    prob, u = (np.asarray(v, dtype=np.float32) for v in data)
    with np.errstate(all="ignore"):
        want = _scan(prob, u)
    got = I.mh_chain(torch.from_numpy(prob), torch.from_numpy(u))
    assert got.shape == (1,) and int(got) == want


def _problem(x, k, metric=TD.DistanceMetric.L2, verbosity=0):
    return prepare(torch.from_numpy(x), k, metric, torch.device("cpu"),
                   Logger(verbosity))


@pytest.mark.parametrize("method", [I.InitMethod.PLUS_PLUS,
                                    I.InitMethod.AFKMC2])
def test_init_draws_only_valid_rows(method):
    """A third of the rows (the last one among them) are NaN; prepare
    zeroes them, and every valid row is >= 1, so a drawn invalid row would
    show as a zero centroid."""
    rng = np.random.RandomState(3)
    x = (1.0 + rng.rand(3000, 4)).astype(np.float32)
    x[rng.rand(3000) < 0.33] = np.nan
    x[-1] = np.nan
    for seed in range(3):
        cent = I.init_centroids(_problem(x, 60), method, seed, afkmc2_m=20)
        assert cent.shape == (60, 4) and bool((cent >= 1.0).all())
        assert len(torch.unique(cent, dim=0)) == 60


def test_afkmc2_chain_length_rules(capsys):
    x = np.random.RandomState(4).rand(101, 3).astype(np.float32)
    x[:11] = np.nan                                 # n = 101, 90 valid
    p = _problem(x, 5, verbosity=1)
    assert I.afkmc2_chain_length(p, 0) == 45        # min(200, 90 // 2)
    assert I.afkmc2_chain_length(p, 50) == 50       # = n // 2
    with pytest.raises(KMTPUInvalidArguments, match="m > 50"):
        I.afkmc2_chain_length(p, 51)
    big = _problem(np.random.RandomState(5).rand(1000, 3).astype(np.float32),
                   5)
    assert I.afkmc2_chain_length(big, 0) == config.AFKMC2_DEFAULT_M
    I.init_centroids(p, I.InitMethod.AFKMC2, 1)
    assert "performing afkmc2 (m = 45)..." in capsys.readouterr().out
    with pytest.raises(KMTPUInvalidArguments, match="m > 50"):
        kmeans_cuda(torch.from_numpy(x), 5, init=("afkmc2", 51),
                    yinyang_t=0)


@pytest.mark.parametrize("method,label", [(I.InitMethod.PLUS_PLUS,
                                           "kmeans++"),
                                          (I.InitMethod.AFKMC2, "afkmc2")])
def test_progress_lines_do_not_change_results(samples, monkeypatch, method,
                                              label):
    def init():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cent = I.init_centroids(_problem(samples, 50, verbosity=1),
                                    method, 7, afkmc2_m=30)
        return cent, [l for l in buf.getvalue().splitlines()
                      if l.startswith(label + ":")]

    ref, ref_lines = init()
    assert ref_lines == []                  # k <= INIT_SEGMENT_CENTROIDS
    monkeypatch.setattr(config, "INIT_SEGMENT_CENTROIDS", 16)
    got, lines = init()
    assert torch.equal(got, ref)
    assert lines == ["%s: %d / 50 centroids" % (label, d)
                     for d in (17, 33, 49, 50)]


def _validate(samples, centroids, assignments, tolerance):
    """One sklearn Lloyd step from the centroids moves < tolerance of the
    samples (tests/test_kmeans.py:validate)."""
    nxt = KMeans(n_clusters=len(centroids), init=centroids, n_init=1,
                 max_iter=1).fit_predict(samples)
    assert np.sum(assignments != nxt) / len(samples) < tolerance


#: seed-locked iteration count of the port's k-means++ (seed=3,
#: tolerance=0.05) on the blob mixture; the JAX package's golden (4)
#: rests on jax.random draws and cannot carry over
GOLDEN_PLUSPLUS = 5


def test_kmeanspp_lloyd_golden(samples, capsys):
    c, a = kmeans_cuda(torch.from_numpy(samples), 50, init="kmeans++",
                       seed=3, tolerance=0.05, yinyang_t=0, verbosity=1)
    out = capsys.readouterr().out
    assert "performing kmeans++..." in out
    assert sum(l.startswith("iteration") for l in out.splitlines()) \
        == GOLDEN_PLUSPLUS
    assert not torch.isnan(c).any()
    _validate(samples, c.numpy(), a.numpy(), 0.05)


def test_afkmc2_lloyd(samples):
    c, a = kmeans_cuda(torch.from_numpy(samples), 50, init=("afkmc2", 200),
                       seed=3, tolerance=0.05, yinyang_t=0)
    assert not torch.isnan(c).any()
    _validate(samples, c.numpy(), a.numpy(), 0.05)


def test_kmeanspp_cosine_and_bf16_run():
    """k-means++ and AFK-MC2 on unit rows (cosine) and fp16 input (bf16
    storage) give k distinct valid rows."""
    rng = np.random.RandomState(6)
    x = rng.rand(2000, 8).astype(np.float32) + 0.1
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    for metric, data in ((TD.DistanceMetric.COSINE, x),
                         (TD.DistanceMetric.L2, x.astype(np.float16))):
        p = _problem(data, 40, metric)
        for method in (I.InitMethod.PLUS_PLUS, I.InitMethod.AFKMC2):
            cent = I.init_centroids(p, method, 2)
            rows = p.x.float()
            hit = (cent[:, None, :] == rows[None, :, :]).all(-1).any(1)
            assert bool(hit.all()) and len(torch.unique(cent, dim=0)) == 40
