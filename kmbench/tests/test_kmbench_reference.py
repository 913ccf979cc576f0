"""The plain references against brute NumPy at tiny sizes, and the
judgement's numbers on answers known right and known wrong."""

import numpy as np
import pytest
import torch

from kmbench_tree import REPO  # noqa: F401  (puts the repo on the path)
from kmbench.reference import kmeans as RK
from kmbench.reference import knn as RN


def _data(n=500, f=12, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).rand(n, f)).float()


def _np_d2(x, c):
    x, c = np.asarray(x, np.float64), np.asarray(c, np.float64)
    return ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)


@pytest.mark.parametrize("seed", [0, 1])
def test_assign_is_numpy_argmin(seed):
    x, c = _data(seed=seed), _data(20, seed=seed + 10)
    a, d = RK.assign(x, c, "fp64")
    ref = _np_d2(x, c)
    np.testing.assert_array_equal(a.numpy(), ref.argmin(1))
    np.testing.assert_allclose(d.numpy(), ref.min(1), rtol=1e-10, atol=1e-12)


def test_assign_blocks_and_invalid_rows(monkeypatch):
    x, c = _data(), _data(20, seed=5)
    x[7, 3] = float("nan")
    monkeypatch.setattr(RK, "BLOCK_ENTRIES", 20 * 33)
    a, _ = RK.assign(x, c, "fp64")
    ref = _np_d2(np.nan_to_num(x.numpy()), c).argmin(1)
    assert int(a[7]) == 20
    keep = np.arange(500) != 7
    np.testing.assert_array_equal(a.numpy()[keep], ref[keep])


def test_means_are_numpy_means():
    x = _data()
    a = torch.from_numpy(np.random.RandomState(3).randint(0, 9, 500))
    a[0] = 10  # out of range: takes no part
    mean, counts = RK.means(x, a, 10)
    for j in range(9):
        rows = x.numpy()[1:][a.numpy()[1:] == j].astype(np.float64)
        np.testing.assert_allclose(mean[j].numpy(), rows.mean(0), rtol=1e-12)
        assert int(counts[j]) == len(rows)
    assert bool(torch.isnan(mean[9]).all()) and int(counts[9]) == 0


def test_tf32_rounding_keeps_ten_bits():
    v = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -12), 0.0])
    r = RK.rounded(v, "tf32")
    assert r.tolist() == [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -1.0, 0.0]
    x = _data(2000, 64)
    rel = ((RK.rounded(x, "tf32") - x).abs() / x.abs().clamp(min=1e-30)).max()
    assert 0 < float(rel) <= 2 ** -11


def test_fp8_and_bf16_round_coarser():
    x = _data(2000, 64)
    errs = [float((RK.rounded(x, p) - x).abs().max())
            for p in ("fp32", "tf32", "bf16", "fp8")]
    assert errs[0] == 0 and errs[1] < errs[2] < errs[3]


def test_kmeans_reaches_a_lloyd_fixed_point():
    x = _data(800, 8)
    c, a, lines = RK.kmeans(x, 10, tolerance=0.0, init="k-means++", seed=4)
    assert lines[-1].startswith("iteration")
    gap, bad = RK.assign_gap(x, c, a)
    assert gap < 1e-12 and bad == 0
    # at tolerance 0 the last iteration moved no row: c is a's means
    assert RK.mean_gap(x, c, a) < 1e-6
    c1, a1, _ = RK.kmeans(x, 10, tolerance=0.0, init="k-means++", seed=4,
                          max_iterations=1)
    assert RK.init_off_rows(x, c1) == 0


def test_kmeanspp_and_random_pick_distinct_rows():
    x = _data(300, 6)
    for init in ("k-means++", "random"):
        c, _a, _ = RK.kmeans(x, 25, tolerance=0.5, init=init, seed=2,
                             max_iterations=1)
        assert RK.init_off_rows(x, c) == 0
    assert RK.init_off_rows(x, x[[1, 1, 2]]) == 1
    assert RK.init_off_rows(x, x[[1, 2]] + 1e-3) == 2


def test_start_rows_finds_the_picks_in_order():
    x = _data(300, 6)
    rows, off = RK.start_rows(x, x[[5, 9, 2]])
    assert rows.tolist() == [5, 9, 2] and off == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_weight_shortfall_tells_kmcuda_starts_from_uniform(seed):
    """Pooled over 64 starts at a size where the weights vary: kmcuda's
    distance-weighted picks read near 0, uniform picks near 1."""
    x = _data(2000, 2, seed=seed)
    gen = torch.Generator().manual_seed(seed)
    plus = torch.stack([RK.kmeanspp(x, 24, gen, "fp32") for _ in range(64)])
    uni = torch.stack([torch.randperm(2000, generator=gen)[:24]
                       for _ in range(64)])
    assert abs(RK.weight_shortfall(x, plus)) < 0.3
    assert abs(RK.weight_shortfall(x, uni) - 1) < 0.3


def test_kmeanspp_weighs_by_distance_not_its_square():
    """kmcuda draws in proportion to the distance: with one pick made, the
    next lands on a row in proportion to its distance to it."""
    x = torch.tensor([[0.0], [1.0], [3.0]])
    hits = torch.zeros(3)
    for s in range(4000):
        gen = torch.Generator().manual_seed(s)
        picks = RK.kmeanspp(x, 2, gen, "fp64")
        if int(picks[0]) == 0:
            hits[int(picks[1])] += 1
    share = float(hits[2] / hits.sum())
    assert abs(share - 0.75) < 0.05  # 3 / (1 + 3); squared: 9 / 10


@pytest.mark.parametrize("counts,tol,cap,want", [
    ([900, 400, 90], 100, None, 0),      # at the tolerance
    ([900, 400, 190], 100, None, 90),    # stopped above it
    ([900, 400, 190], 100, 3, 0),        # at the cap
    ([900] + [890] * 50, 100, None, 0),  # stagnation: 50 without a new best
    ([900] + [890] * 49, 100, None, 790),
])
def test_stop_early(counts, tol, cap, want):
    assert RK.stop_early(counts, tol, cap) == want


def test_judgement_sees_a_moved_row_and_a_moved_centroid():
    x = _data(800, 8)
    c, a, _ = RK.kmeans(x, 10, tolerance=0.0, seed=4)
    wrong = a.clone()
    d = _np_d2(x[:1], c)[0]
    wrong[0] = int(np.argsort(d)[1])
    gap, bad = RK.assign_gap(x, c, wrong)
    assert gap > 1e-3 and bad == 0
    assert RK.assign_gap(x, c, torch.full_like(a, 11))[1] == 800
    moved = c.clone()
    moved[3, 0] += 1e-3
    assert RK.mean_gap(x, moved, a) > 1e-4
    emptied = a.clone()
    emptied[emptied == 2] = 3
    assert RK.mean_gap(x, c, emptied) == float("inf")


def test_knn_is_numpy_brute_force(monkeypatch):
    x = _data(400, 10)
    monkeypatch.setattr(RN, "BLOCK_ENTRIES", 400 * 37)
    nb = RN.knn(5, x)
    d = _np_d2(x, x)
    np.fill_diagonal(d, np.inf)
    np.testing.assert_array_equal(nb.numpy(), np.argsort(d, 1)[:, :5])
    assert RN.knn_gap(x, nb) == (0.0, 0)


def test_knn_judgement_sees_wrong_lists():
    x = _data(400, 10)
    nb = RN.knn(5, x)
    far = nb.clone()
    far[3, 0] = int(RN.knn(399, x)[3, -1])
    gap, bad = RN.knn_gap(x, far)
    assert gap > 0.1 and bad == 0
    dup = nb.clone()
    dup[5, 1] = dup[5, 0]
    assert RN.knn_gap(x, dup)[1] >= 1
    me = nb.clone()
    me[6, 0] = 6
    assert RN.knn_gap(x, me)[1] >= 1
    x2 = x.clone()
    x2[9, 0] = float("inf")
    nb2 = RN.knn(5, x2)
    assert (nb2[9] == -1).all() and RN.knn_gap(x2, nb2) == (0.0, 0)


@pytest.mark.parametrize("kind", ["uniform", "blobs"])
def test_data_repeats_from_the_seed(kind):
    from kmbench.harness import make_samples
    cfg = {"samples": 3000, "features": 8, "dtype": "float32", "data": kind,
           "blob_centers": 5, "blob_spread": 10.0}
    a = make_samples(cfg, 2 ** 31 + 5, torch.device("cpu"))
    b = make_samples(cfg, 2 ** 31 + 5, torch.device("cpu"))
    c = make_samples(cfg, 2 ** 31 + 6, torch.device("cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    if kind == "uniform":
        assert 0 <= float(a.min()) and float(a.max()) < 1


def _judged(x, c, a, starts):
    """Every number the judgement reads off ``x`` (a tensor or parts)."""
    mean, counts = RK.means(x, a, c.shape[0])
    return dict(gap=RK.assign_gap(x, c, a), mean_gap=RK.mean_gap(x, c, a),
                off=RK.mean_off_rounding(x, c.to(torch.bfloat16), a),
                means=mean, counts=counts, start=RK.start_rows(x, c),
                shortfall=RK.weight_shortfall(x, starts))


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_parts_give_the_whole_numbers(shards, monkeypatch):
    """Each reference of the judgement over row parts, one a device (here
    logical CPU devices, ragged, blocks smaller than a part), equals the
    whole tensor's up to fp64 rounding."""
    monkeypatch.setattr(RK, "BLOCK_ENTRIES", 20 * 37)
    x = _data(1003, 8, seed=3)
    x[5, 2] = float("nan")
    x[700, 0] = float("inf")
    c, a, _ = RK.kmeans(x, 20, tolerance=0.0, seed=2, max_iterations=4)
    a = a.clone()
    a[11] = (a[11] + 1) % 20        # a row off its nearest centroid
    a[12] = 25                      # an id out of range
    starts = torch.stack([RK.kmeanspp(x, 20, torch.Generator().manual_seed(
        s)) for s in (1, 2)])
    ps = RK.shard(x, [torch.device("cpu")] * shards)
    assert [s for s, _ in ps] == [i * (1003 // shards) + min(i, 1003 % shards)
                                  for i in range(shards)]
    torch.testing.assert_close(torch.cat([p for _, p in ps]), x, rtol=0,
                               atol=0, equal_nan=True)
    whole, cut = _judged(x, c, a, starts), _judged(ps, c, a, starts)
    assert cut["gap"][1] == whole["gap"][1] == 1
    assert cut["gap"][0] == pytest.approx(whole["gap"][0], rel=1e-12)
    assert whole["gap"][0] > 1e-3
    assert torch.equal(cut["counts"], whole["counts"])
    torch.testing.assert_close(cut["means"], whole["means"], rtol=1e-12,
                               atol=0, equal_nan=True)
    assert cut["mean_gap"] == pytest.approx(whole["mean_gap"], rel=1e-9)
    assert cut["off"] == whole["off"]
    assert torch.equal(cut["start"][0], whole["start"][0])
    assert cut["start"][1] == whole["start"][1]
    assert cut["shortfall"] == pytest.approx(whole["shortfall"], rel=1e-9)
    picks = starts[0]
    assert torch.equal(RK.rows_at(ps, picks), x[picks])


def test_mean_off_rounding_counts_entries_past_their_rounding():
    """The fp64 means rounded to bf16 read 0, whatever the cluster size;
    entries moved by two steps, or the means of three parts of four,
    read those entries."""
    x = _data(4000, 16, seed=5)
    a = torch.from_numpy(np.random.RandomState(6).randint(0, 8, 4000))
    mean, _ = RK.means(x, a, 8)
    c = mean.to(torch.bfloat16)
    assert RK.mean_off_rounding(x, c, a) == 0
    assert RK.mean_off_rounding(x, mean.float(), a) == 0
    stepped = c.float().clone()
    _, e = torch.frexp(mean[2, :3])
    stepped[2, :3] = (mean[2, :3] + torch.ldexp(torch.ones(
        3, dtype=torch.float64), e - 7)).float()   # two bf16 steps up
    assert RK.mean_off_rounding(x, stepped.to(torch.bfloat16), a) == 3
    three = a.clone()
    three[3000:] = -1                             # the last part left out
    part, _ = RK.means(x, three, 8)
    assert RK.mean_off_rounding(x, part.to(torch.bfloat16), a) > 8
    emptied = a.clone()
    emptied[emptied == 2] = 3
    assert RK.mean_off_rounding(x, c, emptied) == float("inf")


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_shard_share_of_picks(shards):
    x = _data(1000, 4)
    ps = RK.shard(x, [torch.device("cpu")] * shards)
    even = torch.arange(0, 1000, 10)
    assert RK.shard_share(ps, even) == pytest.approx(1.0)
    assert RK.shard_share(ps, torch.arange(0, 1000 // shards)) == shards
    assert RK.shard_share(x, torch.arange(10)) == 1.0
