"""The sparse iteration's moved-row delta (``ops.assign_kernels.delta_sum``,
``kmt_delta_sum`` on the card) and the moved-row list that feeds it
(``ops.compact.moved_rows``).

On the CPU the wrapper runs its plain twin, ``compact.delta_compacted``
over the list, held here against the JAX package's ``delta_compacted``
(rtol 1e-5 / atol 1e-5 as tests/test_torch_compact.py: fp32 one-hot
products accumulated in another order; counts equal).  The list is the
rows ``stable_partition`` compacts to the front, in its order, so on the
CPU every delta, and every whole Lloyd and Yinyang run, is bitwise what the
sort-and-partition arm gave.  The ``gpu`` test holds the kernel on the card
against the twin (counts bitwise) and against fp64 sums: within 1e-5 of
the magnitude of the sums being differenced (the fp64 sum of |x_r| over
both sides of a cluster; the difference itself can cancel), and bitwise
on repeat.  Run it on the card with

    python -m pytest --noconftest -q -m gpu tests/test_torch_delta_sum.py
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from kmcuda_torch import KMTPUInvalidArguments, kmeans_cuda
from kmcuda_torch.ops import assign_kernels as K
from kmcuda_torch.ops import compact as TC

torch.set_num_threads(2)


def _moves(n, f, k, p_moved, seed, dtype=torch.float32, skew=False):
    """x (n, f) U(0, 1) in ``dtype``, an old assignment in [0, k] (k: an
    invalid row) and a new one where a share ``p_moved`` of the rows drew
    a new id (with ``skew`` True, half of them cluster 0; with "all", all
    of them)."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, f).astype(np.float32)
    old = rng.randint(0, k + 1, size=n).astype(np.int32)
    new = old.copy()
    moved = np.flatnonzero(rng.rand(n) < p_moved)
    new[moved] = rng.randint(0, k + 1, size=moved.size)
    if skew == "all":
        new[moved] = 0
    elif skew:
        new[moved[::2]] = 0
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(new),
            torch.from_numpy(old))


def _fp64_delta(x, rows, new, old, k):
    """(sums, magnitude, counts) in fp64 / int64 with numpy: the delta, and
    the sum of |x_r| over both sides of each cluster."""
    xs = x[rows.long()].double().numpy()
    a_new, a_old = new[rows.long()].numpy(), old[rows.long()].numpy()
    sums = np.zeros((k + 1, x.shape[1]))
    mag = np.zeros((k + 1, x.shape[1]))
    counts = np.zeros(k + 1, dtype=np.int64)
    np.add.at(sums, a_new, xs)
    np.add.at(sums, a_old, -xs)
    np.add.at(mag, a_new, np.abs(xs))
    np.add.at(mag, a_old, np.abs(xs))
    np.add.at(counts, a_new, 1)
    np.add.at(counts, a_old, -1)
    return sums[:k], mag[:k], counts[:k]


# ---------------------------------------------------------------------------
# the wrapper's checks


def _good(n=50, f=4, k=6):
    x, new, old = _moves(n, f, k, 0.3, 0)
    return x, TC.moved_rows(new, old), new, old, k


def _bad(case):
    x, rows, new, old, k = _good()
    if case == "x float16":
        x = x.half()
    elif case == "x float64":
        x = x.double()
    elif case == "x 1-d":
        x = x[:, 0].contiguous()
    elif case == "rows int64":
        rows = rows.long()
    elif case == "rows 2-d":
        rows = rows[:, None]
    elif case == "assign_new int64":
        new = new.long()
    elif case == "assign_old short":
        old = old[:-1]
    elif case == "x not contiguous":
        x = torch.cat([x, x], dim=1)[:, ::2]
    elif case == "rows on another device":
        rows = rows.to("meta")
    elif case == "every tensor on the meta device":
        x, rows, new, old = (t.to("meta") for t in (x, rows, new, old))
    elif case == "rows not ascending":
        rows = rows.flip(0).contiguous()
    elif case == "rows repeated":
        rows = torch.cat([rows[:1], rows])
    elif case == "row below 0":
        rows = torch.cat([torch.tensor([-1], dtype=torch.int32), rows])
    elif case == "row past n":
        rows = torch.cat([rows, torch.tensor([x.shape[0]],
                                             dtype=torch.int32)])
    elif case == "new id past k":
        new = new.clone()
        new[rows[0].long()] = k + 1
    elif case == "old id below 0":
        old = old.clone()
        old[rows[-1].long()] = -1
    elif case == "x not a tensor":
        x = x.numpy()
    return x, rows, new, old, k


BAD_CASES = ["x float16", "x float64", "x 1-d", "rows int64", "rows 2-d",
             "assign_new int64", "assign_old short", "x not contiguous",
             "rows on another device", "every tensor on the meta device",
             "rows not ascending", "rows repeated", "row below 0",
             "row past n", "new id past k", "old id below 0"]


@pytest.mark.parametrize("case", BAD_CASES)
def test_wrapper_refuses(case):
    x, rows, new, old, k = _bad(case)
    with pytest.raises(KMTPUInvalidArguments):
        K.delta_sum(x, rows, new, old, n_clusters=k)


def test_wrapper_refuses_what_is_not_a_tensor():
    x, rows, new, old, k = _bad("x not a tensor")
    with pytest.raises(TypeError):
        K.delta_sum(x, rows, new, old, n_clusters=k)


def test_wrapper_takes_a_listed_row_that_did_not_move():
    """A listed row whose two ids are equal adds and takes the same row:
    its cluster's count does not change (the checks take it)."""
    x, rows, new, old, k = _good()
    keep = int(torch.nonzero(new == old)[0])
    rows = torch.sort(torch.cat([rows, torch.tensor([keep],
                                                    dtype=torch.int32)]))[0]
    _s, counts = K.delta_sum(x, rows, new, old, n_clusters=k)
    want = _fp64_delta(x, rows, new, old, k)[2]
    np.testing.assert_array_equal(counts.numpy(), want)


# ---------------------------------------------------------------------------
# the list against the partition, and the CPU delta bitwise as before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p_moved", [0.0, 0.004, 0.3, 1.0])
def test_moved_rows_are_the_partitions_first_rows(p_moved, dtype):
    x, new, old = _moves(4099, 9, 33, p_moved, 3, dtype)
    order, n_true = TC.stable_partition(new != old)
    ch = int(n_true)
    rows = TC.moved_rows(new, old)
    assert rows.dtype == torch.int32
    np.testing.assert_array_equal(rows.numpy(), order[:ch].numpy())
    got = K.delta_sum(x, rows, new, old, n_clusters=33)
    want = TC.delta_compacted(x, new, old, order, ch, n_clusters=33)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# the twin against the JAX package


TWIN_CASES = {
    # name: (n, f, k, moved share, dtype, skew)
    "ragged fp32": (3001, 7, 37, 0.2, torch.float32, False),
    "ragged bf16": (2999, 13, 41, 0.3, torch.bfloat16, False),
    "past one chunk": (6000, 5, 17, 0.5, torch.float32, False),
    "empty list": (500, 6, 9, 0.0, torch.float32, False),
    "skewed to one cluster": (3000, 8, 25, 0.4, torch.float32, True),
    "every row to one cluster": (1500, 4, 12, 1.0, torch.float32, "all"),
}


@pytest.mark.parametrize("case", sorted(TWIN_CASES))
def test_twin_matches_jax(case):
    import jax.numpy as jnp
    from kmcuda_tpu.ops import compact as JC

    n, f, k, p_moved, dtype, skew = TWIN_CASES[case]
    x, new, old = _moves(n, f, k, p_moved, 5, dtype, skew)
    rows = TC.moved_rows(new, old)
    got_s, got_c = K.delta_sum(x, rows, new, old, n_clusters=k)
    xj = jnp.asarray(x.float().numpy(),
                     jnp.bfloat16 if dtype == torch.bfloat16
                     else jnp.float32)
    mask = (new != old).numpy()
    order, n_changed = JC.stable_partition(jnp.asarray(mask))
    want_s, want_c = JC.delta_compacted(
        xj, jnp.asarray(new.numpy().astype(np.uint32)),
        jnp.asarray(old.numpy().astype(np.uint32)), order, n_changed,
        n_clusters=k, chunk=min(2048, n))   # its slices need chunk <= n
    assert rows.numel() == int(n_changed)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=1e-5, atol=1e-5)
    sums64, _mag, counts64 = _fp64_delta(x.float(), rows, new, old, k)
    np.testing.assert_array_equal(got_c.numpy(), counts64)
    np.testing.assert_allclose(got_s.numpy(), sums64, rtol=1e-5, atol=1e-5)
    if skew == "all":   # every listed row went to cluster 0
        assert int(got_c[0]) == rows.numel() > 0
        assert int(got_c[1:].clamp(min=0).sum()) == 0
    if p_moved == 0.0:
        assert rows.numel() == 0 and not got_s.any() and not got_c.any()


# ---------------------------------------------------------------------------
# the cut


@pytest.mark.parametrize("m,f,k,itemsize", [
    (1, 256, 1024, 2), (79_484, 256, 1024, 2), (204_209, 256, 1024, 2),
    (630_524, 256, 1024, 2), (100_000, 256, 16_384, 2), (5_000, 7, 37, 4)])
def test_segment_plan_is_a_pure_function_of_the_shape(m, f, k, itemsize):
    """The delta's cut is the segment sum's over its 2 m signed entries,
    each side cut alone into placement blocks: the same shape gives the
    same cut (so the same summation order), within the limits
    ``csrc/segment.cu`` takes; the count table stays within
    max(2 m, SEGMENT_TABLE) + 2 k entries whatever k, so its passes are
    sized by the list, not by k; and the scratch is the table, its total,
    its scan's tile sums and the 2 m entries' permutation and ids."""
    plan = K.segment_plan(m, f, k, itemsize, sides=2)
    assert plan == K.segment_plan(m, f, k, itemsize, sides=2)
    assert plan.rows >= 1024 and plan.rows % 256 == 0
    assert plan.chunk >= K.SEGMENT_MIN_CHUNK
    chunks = -(-2 * m // plan.chunk)
    assert chunks <= K.SEGMENT_MAX_CHUNKS
    assert K.SEGMENT_THREADS % plan.tx == 0
    table = 2 * -(-m // plan.rows) * k
    assert table <= max(2 * m, K.SEGMENT_TABLE) + 2 * k
    assert plan.int_scratch == (table + 1 + -(-table // K.SEGMENT_SCAN_TILE)
                                + 4 * m)
    assert plan.float_scratch == 2 * chunks * f


# ---------------------------------------------------------------------------
# whole runs on the parity fixtures, bitwise the sort-and-partition arm


def _blobs():
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


def _separated():
    """4096 x 16: 32 well-separated blobs (tests/test_torch_kmeans.py)."""
    rng = np.random.RandomState(1)
    centers = rng.rand(32, 16).astype(np.float32) * 20
    which = rng.randint(0, 32, size=4096)
    return (centers[which] + 0.1 * rng.randn(4096, 16)).astype(np.float32)


def _partition_arm(calls):
    """The sparse arm as it was: sort n keys, walk the partition's first
    ``changed`` rows."""
    def delta(x, rows, assign_new, assign_old, *, n_clusters):
        order, n_true = TC.stable_partition(assign_new != assign_old)
        calls.append(int(n_true))
        assert int(n_true) == rows.numel()
        return TC.delta_compacted(x, assign_new, assign_old, order,
                                  int(n_true), n_clusters=n_clusters)
    return delta


RUNS = {
    "Lloyd 13K blobs": (_blobs, 50, dict(yinyang_t=0, tolerance=0.0,
                                         max_iterations=40)),
    "Yinyang 13K blobs": (_blobs, 50, dict(yinyang_t=0.1, tolerance=0.0,
                                           max_iterations=40)),
    "Lloyd separated fp16": (_separated, 32, dict(
        yinyang_t=0, tolerance=0.0, max_iterations=20, fp16=True)),
    "Yinyang separated cos": (_separated, 32, dict(
        yinyang_t=0.1, tolerance=0.0, max_iterations=20, metric="cos")),
}


@pytest.mark.parametrize("case", sorted(RUNS))
def test_whole_runs_are_bitwise_the_partition_arm(case, monkeypatch):
    make, k, kw = RUNS[case]
    kw = dict(kw)
    x = make()
    if kw.pop("fp16", False):
        x = x.astype(np.float16)
    if kw.get("metric") == "cos":
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
    start = torch.from_numpy(
        x[np.random.RandomState(2).choice(len(x), k, replace=False)]
        .astype(np.float32))
    monkeypatch.setattr("kmcuda_torch.config.YY_MIN_REMAINING", 0)
    monkeypatch.setattr("kmcuda_torch.config.YY_BAILOUT_MARGIN",
                        float("inf"))

    def run():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            c, a = kmeans_cuda(torch.from_numpy(x), k, init=start, seed=3,
                               verbosity=1, **kw)
        return c, a, [l for l in buf.getvalue().splitlines()
                      if l.startswith("iteration")]

    listed = []
    real = K.delta_sum
    monkeypatch.setattr(K, "delta_sum", lambda x_, rows, *a, **kw_: (
        listed.append(rows.numel()) or real(x_, rows, *a, **kw_)))
    got = run()
    calls = []
    monkeypatch.setattr(K, "delta_sum", _partition_arm(calls))
    want = run()
    assert listed and listed == calls, (listed, calls)
    assert got[2] == want[2] and len(got[2]) > 1
    assert torch.equal(got[1], want[1])
    assert torch.equal(torch.nan_to_num(got[0], nan=7.0),
                       torch.nan_to_num(want[0], nan=7.0))


# ---------------------------------------------------------------------------
# on the card


CARD_CASES = {
    # name: (n, f, k, moved share, dtype, skew)
    "100K fp32": (100_000, 256, 1024, 0.08, torch.float32, False),
    "ragged bf16": (100_003, 250, 1000, 0.05, torch.bfloat16, False),
    "skewed bf16": (200_000, 256, 1024, 0.1, torch.bfloat16, True),
    "k=16384 bf16": (300_000, 256, 16_384, 0.2, torch.bfloat16, False),
    "odd f bf16": (50_000, 251, 300, 0.3, torch.bfloat16, False),
    "one row": (1000, 64, 10, 0.0005, torch.float32, False),
    "k=16384 skewed bf16": (200_000, 256, 16_384, 0.2, torch.bfloat16,
                            True),
    "k past SMEM_K fp32": (100_000, 64, 12_289, 0.1, torch.float32, False),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernel_against_twin_and_fp64(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    n, f, k, p_moved, dtype, skew = CARD_CASES[case]
    x, new, old = _moves(n, f, k, p_moved, 9, dtype, skew)
    rows = TC.moved_rows(new, old)
    xc, rc, nc, oc = (t.cuda() for t in (x, rows, new, old))
    launches = K.LAUNCHES["delta_sum"]
    got = K.delta_sum(xc, rc, nc, oc, n_clusters=k)
    again = K.delta_sum(xc, rc, nc, oc, n_clusters=k)
    twin = TC.delta_compacted(xc, nc, oc, rc, rows.numel(), n_clusters=k)
    torch.cuda.synchronize()
    assert K.LAUNCHES["delta_sum"] == launches + 2
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert torch.equal(got[1], twin[1])
    sums64, mag, counts64 = _fp64_delta(x.float(), rows, new, old, k)
    np.testing.assert_array_equal(got[1].cpu().numpy(), counts64)
    sums = got[0].cpu().double().numpy()
    assert (np.abs(sums - sums64) <= 1e-5 * mag).all()
    assert (np.abs(sums - twin[0].cpu().double().numpy())
            <= 2e-5 * mag).all()


@pytest.mark.gpu
@pytest.mark.parametrize("k", [10, 16_384])
def test_kernel_one_moved_row(k):
    """m = 1: the one row's delta is +x_r on its new cluster and -x_r on
    its old, bitwise (one add each, from 0), every other row 0; counts +1
    and -1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n, f = 5000, 33
    x, new, old = _moves(n, f, k, 0.0, 4)
    r = 1234
    old[r], new[r] = 3, 7
    rows = torch.tensor([r], dtype=torch.int32)
    xc, rc, nc, oc = (t.cuda() for t in (x, rows, new, old))
    d_sums, d_counts = K.delta_sum(xc, rc, nc, oc, n_clusters=k)
    want = torch.zeros(k, f)
    want[7] += x[r]
    want[3] -= x[r]
    counts = torch.zeros(k, dtype=torch.int32)
    counts[7], counts[3] = 1, -1
    assert torch.equal(d_sums.cpu(), want)
    assert torch.equal(d_counts.cpu(), counts)
