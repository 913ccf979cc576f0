"""The port's public ``kmeans_cuda`` on CPU tensors against the JAX
package's ``kmeans_tpu(..., device=1)``, both started from the same
imported centroids (handed across with ``interop.state_from_jax``): the
two random-init streams (``jax.random`` vs ``torch.Generator``) cannot
match, so parity runs import their start.

On the CPU the JAX package runs its incremental XLA loop, whose dense arm
accumulates deltas where the port's replaces the sums, so the two agree
to fp32 rounding, not bitwise: a trajectory that passes a sample sitting
within an ulp of a decision boundary may flip it on one side only.  The
fixtures and starts below (the blob mixture of tests/test_kmeans.py and a
separated-blob set) have no such sample, so assignments and iteration
logs must be identical; fp32 centroids agree to
rtol 1e-5 / atol 1e-6 (tests/test_pallas.py's bound), and bf16 storage
(fp16 input) to 1e-3 relative on the separated set.
"""

import numpy as np
import pytest
import torch
from sklearn.cluster import KMeans

from kmcuda_tpu import kmeans_tpu
from kmcuda_torch import (KMTPUInvalidArguments, KMTPUNoSuchDevice,
                          kmeans_cuda, knn_cuda)
from kmcuda_torch.interop import state_from_jax
from kmcuda_torch.utils import validation as V

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


@pytest.fixture(scope="module")
def separated():
    """4096 x 16: 32 well-separated blobs, so no sample sits near a
    decision boundary."""
    rng = np.random.RandomState(1)
    centers = rng.rand(32, 16).astype(np.float32) * 20
    which = rng.randint(0, 32, size=4096)
    return (centers[which]
            + 0.1 * rng.randn(4096, 16)).astype(np.float32)


def _start(x, k, seed):
    return x[np.random.RandomState(seed).choice(len(x), k, replace=False)]


def _iteration_lines(out):
    return [l for l in out.splitlines() if l.startswith("iteration")]


def _both(capsys, x, k, c0, **kw):
    """Run both packages from centroids c0; returns ((c, a, ...) JAX,
    (c, a, ...) port, JAX log lines, port log lines)."""
    kw = dict(dict(tolerance=0.01, yinyang_t=0, verbosity=1), **kw)
    want = kmeans_tpu(x, k, init=c0, device=1, **kw)
    want_log = _iteration_lines(capsys.readouterr().out)
    got = kmeans_cuda(torch.from_numpy(x), k,
                      init=state_from_jax(c0, device="cpu")[0], **kw)
    got_log = _iteration_lines(capsys.readouterr().out)
    return want, got, want_log, got_log


def _assert_fp32_parity(want, got, want_log, got_log):
    assert got_log == want_log and len(got_log) > 0
    np.testing.assert_array_equal(got[1].numpy(), want[1].astype(np.int32))
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-5,
                               atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("tolerance", [0.05, 0.0])
def test_blob_parity_fp32(samples, capsys, tolerance):
    c0 = _start(samples, 50, 2)
    _assert_fp32_parity(*_both(capsys, samples, 50, c0, tolerance=tolerance,
                               max_iterations=120))


@pytest.mark.parametrize("metric", ["L2", "cos"])
def test_separated_parity_fp32(separated, capsys, metric):
    x = separated
    if metric == "cos":
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
    c0 = _start(x, 32, 3)
    _assert_fp32_parity(*_both(capsys, x, 32, c0, metric=metric))


def test_nan_rows_parity(samples, capsys):
    x = samples.copy()
    x[42] = np.nan
    x[4242, 0] = np.nan
    c0 = _start(samples, 50, 4)
    want, got, wl, gl = _both(capsys, x, 50, c0)
    _assert_fp32_parity(want, got, wl, gl)
    assert got[1][42] == 50 and got[1][4242] == 50
    assert not torch.isnan(got[0]).any()


def test_average_distance_parity(samples, capsys):
    c0 = _start(samples, 50, 2)
    want, got, wl, gl = _both(capsys, samples, 50, c0,
                              average_distance=True)
    _assert_fp32_parity(want, got, wl, gl)
    d = np.linalg.norm(samples - got[0].numpy()[got[1].numpy()], axis=1)
    assert got[2] == pytest.approx(want[2], abs=1e-5)
    assert got[2] == pytest.approx(float(d.mean()), abs=1e-5)


def test_fp16_parity(separated, capsys):
    """fp16 input -> bf16 storage on both sides."""
    x = separated.astype(np.float16)
    c0 = _start(separated, 32, 6)
    want, got, wl, gl = _both(capsys, x, 32, c0)
    assert got[0].dtype == torch.float16 and want[0].dtype == np.float16
    assert gl == wl
    np.testing.assert_array_equal(got[1].numpy(), want[1].astype(np.int32))
    np.testing.assert_allclose(got[0].float().numpy(),
                               want[0].astype(np.float32), rtol=1e-3)


def test_n_equals_clusters_parity(capsys):
    x = (np.random.RandomState(1).rand(8, 3) * 10).astype(np.float32)
    want, got, wl, gl = _both(capsys, x, 8, x.copy(), tolerance=0.0,
                              max_iterations=50)
    _assert_fp32_parity(want, got, wl, gl)
    assert len(np.unique(got[1].numpy())) == 8


class TestValidation:
    """tests/test_kmeans.py:TestValidation on the port."""

    def test_bad_clusters_type(self, samples):
        with pytest.raises(TypeError):
            kmeans_cuda(torch.from_numpy(samples), "bullshit", init="random",
                        yinyang_t=0)

    def test_bad_init(self, samples):
        with pytest.raises(ValueError):
            kmeans_cuda(torch.from_numpy(samples), 50, init="bullshit",
                        yinyang_t=0)

    def test_bad_tolerance(self, samples):
        with pytest.raises(ValueError):
            kmeans_cuda(torch.from_numpy(samples), 50, init="random",
                        tolerance=100, yinyang_t=0)

    def test_bad_yinyang(self, samples):
        with pytest.raises(ValueError):
            kmeans_cuda(torch.from_numpy(samples), 50, init="random",
                        yinyang_t=10)

    def test_bad_device_mask(self, samples):
        with pytest.raises(ValueError):
            kmeans_cuda(torch.from_numpy(samples), 50, init="random",
                        yinyang_t=0, device=0xFFFF)

    def test_too_many_clusters(self, samples):
        with pytest.raises(ValueError):
            kmeans_cuda(torch.from_numpy(samples[:10]), 50, init="random",
                        yinyang_t=0)


#: seed-locked iteration count of the port's own random init (seed=3,
#: tolerance=0.05) on the blob mixture; the JAX package's golden (7) rests
#: on jax.random draws and cannot carry over
GOLDEN_RANDOM = 8


def test_verbosity2_plan_and_memory(samples, capsys):
    """The counterpart of tests/test_kmeans.py's verbosity test on a CPU
    tensor: the split plan and the memory line at verbosity 2, the
    allocation map at verbosity 3; verbosity 1 prints none of them."""
    kmeans_cuda(torch.from_numpy(samples), 50, init="random", seed=5,
                tolerance=0.01, yinyang_t=0, verbosity=3, max_iterations=2)
    out = capsys.readouterr().out.splitlines()
    plan = [l for l in out if l.startswith("plan: ")]
    assert len(plan) == 1
    assert plan[0].startswith("plan: cpu rows [0, 13000) ")
    assert "cpu: memory stats n/a" in out
    allocs = [l for l in out if l.startswith("alloc ")]
    assert [a.split()[1] for a in allocs] == ["x", "x_sq", "valid",
                                              "assign0"]
    assert "(13000, 2)" in allocs[0] and "float32" in allocs[0]
    knn_cuda(3, torch.from_numpy(samples[:2000]), torch.zeros(1, 2),
             torch.zeros(2000, dtype=torch.int32), verbosity=2)
    out = capsys.readouterr().out.splitlines()
    assert "cpu: memory stats n/a" in out
    assert any(l.startswith("plan: ") for l in out)
    assert not any(l.startswith("alloc ") for l in out)
    kmeans_cuda(torch.from_numpy(samples), 50, init="random", seed=5,
                tolerance=0.01, yinyang_t=0, verbosity=1, max_iterations=2)
    out = capsys.readouterr().out.splitlines()
    assert out and not any(l.startswith(("plan: ", "alloc ", "cpu: "))
                           for l in out)


def test_random_init_golden(samples, capsys):
    c, a = kmeans_cuda(torch.from_numpy(samples), 50, init="random", seed=3,
                       tolerance=0.05, yinyang_t=0, verbosity=1)
    assert len(_iteration_lines(capsys.readouterr().out)) == GOLDEN_RANDOM
    c, a = c.numpy(), a.numpy()
    assert not np.isnan(c).any()
    # one sklearn Lloyd step from these centroids moves < 5% of samples
    nxt = KMeans(n_clusters=50, init=c, n_init=1,
                 max_iter=1).fit_predict(samples)
    assert np.sum(a != nxt) / len(samples) < 0.05
    again = kmeans_cuda(torch.from_numpy(samples), 50, init="random", seed=3,
                        tolerance=0.05, yinyang_t=0)
    np.testing.assert_array_equal(again[1].numpy(), a)


def test_tensor_io_and_dtypes(separated):
    x16 = torch.from_numpy(separated).half()
    c, a = kmeans_cuda(x16, 32, init="random", seed=1, yinyang_t=0)
    assert isinstance(c, torch.Tensor) and c.dtype == torch.float16
    assert a.dtype == torch.int32 and a.shape == (4096,)
    c, a = kmeans_cuda(torch.from_numpy(separated).double(), 32,
                       init="random", seed=1, yinyang_t=0)
    assert c.dtype == torch.float32 and int(a.max()) < 32


def test_numpy_input_needs_a_cuda_device(samples, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(KMTPUNoSuchDevice):
        kmeans_cuda(samples, 50, init="random", yinyang_t=0)


def test_not_ported_yet_raises(samples, monkeypatch):
    """Every init runs; a mask selecting several devices raises (§A7)."""
    x = torch.from_numpy(samples)
    for init in ("kmeans++", ("afkmc2", 10)):
        c, a = kmeans_cuda(x, 50, init=init, seed=1, tolerance=0.05,
                           yinyang_t=0)
        assert not torch.isnan(c).any() and int(a.max()) < 50
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="§A7"):
        kmeans_cuda(x, 50, init="random", yinyang_t=0, device=3)


def test_device_mask_rules(samples, monkeypatch):
    from kmcuda_torch.parallel.devices import device_for

    x = torch.from_numpy(samples)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert device_for(x, 0) == torch.device("cpu")    # a tensor's own
    assert device_for(samples, 2) == torch.device("cuda", 1)
    for mask in (0, 3):
        with pytest.raises(NotImplementedError, match="§A7"):
            device_for(samples, mask)
    with pytest.raises(KMTPUNoSuchDevice):
        device_for(x, 4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert device_for(samples, 0) == torch.device("cuda", 0)


def test_yinyang_request_runs_lloyd(samples, capsys):
    """At tolerance >= YINYANG_MIN_TOLERANCE (0.11) a yinyang_t > 0 call
    runs Lloyd, as the reference does."""
    x = torch.from_numpy(samples)
    c1, a1 = kmeans_cuda(x, 50, init="random", seed=4, tolerance=0.11,
                         yinyang_t=0.1, verbosity=2)
    out = capsys.readouterr().out
    assert "iteration 1:" in out and "yinyang" not in out
    c0, a0 = kmeans_cuda(x, 50, init="random", seed=4, tolerance=0.11,
                         yinyang_t=0)
    assert torch.equal(a0, a1) and torch.equal(c0, c1)
    kmeans_cuda(x, 50, init="random", seed=4, tolerance=0.1, yinyang_t=0.1,
                verbosity=2)
    assert "yinyang: 5 groups" in capsys.readouterr().out


def test_cluster_id_limit():
    class Shape:
        shape = (2**31, 1)
    with pytest.raises(KMTPUInvalidArguments):
        V.check_kmeans_args(Shape(), 2**31 - 1, 0.01, 0.0, None, 0)
    assert V.check_kmeans_args(Shape(), 2**31 - 2, 0.01, 0.0, None, 0)[2] \
        == 2**31 - 2


def test_state_from_jax_keeps_the_invalid_marker():
    c, a = state_from_jax(np.ones((3, 2), np.float16),
                          np.array([0, 3, 2], np.uint32), device="cpu")
    assert c.dtype == torch.float32 and a.dtype == torch.int32
    assert a.tolist() == [0, 3, 2]


def test_donation_zeroes_invalid_rows_in_place(samples):
    x = torch.from_numpy(samples.copy())
    x[7] = float("nan")
    kmeans_cuda(x, 50, init="random", seed=1, yinyang_t=0)
    assert torch.isnan(x[7]).all()             # the caller's data is kept
    kmeans_cuda(x, 50, init="random", seed=1, yinyang_t=0,
                donate_samples=True)
    assert (x[7] == 0).all()                   # ... unless donated
