"""The port's C ABI bridge (kmcuda_torch.capi) and its native shim
(native_torch/), against the JAX package's (kmcuda_tpu.capi, native/).

- Pointer parity: the same host buffers, by pointer, go to both ``capi``
  modules from one imported start (init code 3, the start written into
  the centroids buffer).  The JAX side runs on one CPU device, the port's
  under ``KMTPU_PLATFORM=cpu``.  Assignments and iteration lines must be
  identical, centroids within rtol 1e-5 / atol 1e-6 and the average
  distance within rtol 1e-5 (tests/test_torch_kmeans.py's rule);
  ``knn_from_pointers`` on the JAX outputs gives neighbours equal off fp64
  ties (tests/test_torch_knn.py's rule).
- The handle registry: tests/test_capi.py:39 and :100 on the port.
- The C shim: tests/test_capi.py:17 on ``native_torch`` (built with cmake
  and ninja; skipped only where either is missing), plus the shim loaded
  into a running interpreter with ctypes.
- No fallback: without ``KMTPU_PLATFORM=cpu`` and with no CUDA device the
  pointer path returns ``kmtpuNoSuchDevice`` and writes nothing.
"""

import ast
import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from kmcuda_tpu import capi as jcapi
from kmcuda_torch import capi, config, kmeans_torch, knn_torch
from kmcuda_torch.utils.errors import KMTPUResult

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUCCESS = int(KMTPUResult.SUCCESS)
INVALID = int(KMTPUResult.INVALID_ARGUMENTS)


@pytest.fixture(autouse=True)
def pinned_controller(monkeypatch):
    """Pin the port's Yinyang controller as tests/conftest.py pins the JAX
    one ("never gate, never revoke"), so the path does not depend on the
    machine's load."""
    monkeypatch.setattr(config, "YY_MIN_REMAINING", 0)
    monkeypatch.setattr(config, "YY_BAILOUT_MARGIN", float("inf"))


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("KMTPU_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def blobs():
    """The 13K blob mixture of tests/test_torch_kmeans.py."""
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
    """tests/test_torch_kmeans.py's 32 well-separated blobs, 4096 x 16,
    normalized for the cosine metric."""
    rng = np.random.RandomState(1)
    centers = rng.rand(32, 16).astype(np.float32) * 20
    which = rng.randint(0, 32, size=4096)
    x = (centers[which] + 0.1 * rng.randn(4096, 16)).astype(np.float32)
    return np.ascontiguousarray(x / np.linalg.norm(x, axis=1, keepdims=True))


def _ptr(arr) -> int:
    return arr.ctypes.data_as(ctypes.c_void_p).value


def _iteration_lines(out):
    return [l for l in out.splitlines() if l.startswith("iteration")]


def _kmeans(mod, x, c0, metric, yinyang_t, device, capsys):
    """kmeans_from_pointers from the imported start c0 at verbosity 2;
    returns (code, centroids, assignments, average distance, log)."""
    n, f = x.shape
    k = len(c0)
    cent = np.ascontiguousarray(c0.copy())
    assign = np.zeros(n, np.uint32)
    code, avg = mod.kmeans_from_pointers(
        3, 0, 0.01, yinyang_t, metric, n, f, k, 5, device, 0, 2, _ptr(x),
        _ptr(cent), _ptr(assign), 1)
    return code, cent, assign, avg, capsys.readouterr().out


def _knn(mod, kn, x, cent, assign, metric, device):
    n, f = x.shape
    nbr = np.zeros((n, kn), np.uint32)
    code = mod.knn_from_pointers(kn, metric, n, f, len(cent), device, 0, 0,
                                 _ptr(x), _ptr(cent), _ptr(assign),
                                 _ptr(nbr))
    return code, nbr


def _mean_distance64(x, cent, assign, metric):
    """The mean distance of every sample to its assigned centroid in
    fp64 (Euclidean, or the angle for cosine)."""
    x64, c64 = x.astype(np.float64), cent.astype(np.float64)[assign]
    if metric == 0:
        return float(np.linalg.norm(x64 - c64, axis=1).mean())
    return float(np.arccos(np.clip((x64 * c64).sum(1), -1, 1)).mean())


def _assert_equal_off_ties(x, got, want):
    """Neighbour lists equal (sentinels included), except rows whose fp64
    distance profiles agree to rtol 1e-6 (ties)."""
    np.testing.assert_array_equal(got == 0xFFFFFFFF, want == 0xFFFFFFFF)
    x64 = x.astype(np.float64)
    for r in np.nonzero((got != want).any(axis=1))[0]:
        dg = np.linalg.norm(x64[got[r]] - x64[r], axis=1)
        dw = np.linalg.norm(x64[want[r]] - x64[r], axis=1)
        np.testing.assert_allclose(np.sort(dg), np.sort(dw), rtol=1e-6)


@pytest.mark.parametrize("case", ["blobs L2", "blobs L2 Yinyang",
                                  "separated cos"])
def test_pointer_parity_with_kmcuda_tpu(case, blobs, separated, capsys,
                                        monkeypatch):
    if case == "separated cos":
        x, k, metric, yinyang_t = separated, 32, 1, 0.0
    else:
        x, k, metric = blobs, 50, 0
        yinyang_t = 0.1 if "Yinyang" in case else 0.0
    c0 = x[np.random.RandomState(2).choice(len(x), k, replace=False)]
    want = _kmeans(jcapi, x, c0, metric, yinyang_t, 1, capsys)
    monkeypatch.setenv("KMTPU_PLATFORM", "cpu")
    got = _kmeans(capi, x, c0, metric, yinyang_t, 0, capsys)
    assert want[0] == got[0] == SUCCESS
    lines = _iteration_lines(got[4])
    assert lines == _iteration_lines(want[4]) and len(lines) > 1
    # the Yinyang case runs the Yinyang loop (its per-iteration lines)
    assert ("passed the global filter" in got[4]) == (yinyang_t > 0)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)
    # each average distance is its own outputs' fp64 mean distance to
    # rtol 1e-5; across the packages they agree to rtol 1e-5 for L2.  For
    # cosine the arccos turns the centroids' allowed 1e-6 into 1e-5
    # relative on this fixture (0.1268704 against 0.1268691).
    for _code, cent, assign, avg, _log in (want, got):
        assert avg == pytest.approx(_mean_distance64(x, cent, assign, metric),
                                    rel=1e-5)
    if metric == 0:
        assert got[3] == pytest.approx(want[3], rel=1e-5)

    _cent, assign = want[1], want[2]
    kn = 10
    code_w, nb_w = _knn(jcapi, kn, x, _cent, assign, metric, 1)
    code_g, nb_g = _knn(capi, kn, x, _cent, assign, metric, 0)
    assert code_w == code_g == SUCCESS
    _assert_equal_off_ties(x, nb_g, nb_w)
    assert not (nb_g == np.arange(len(x))[:, None]).any()


def test_nan_rows_sentinel_through_pointers(blobs, on_cpu):
    """A non-finite row gets the invalid id k and the neighbour sentinel:
    the port's int32 -1 lands in the uint32 buffer as 0xFFFFFFFF, what
    the JAX package writes."""
    x = blobs.copy()
    x[[42, 4242]] = np.nan
    c0 = blobs[np.random.RandomState(4).choice(13000, 50, replace=False)]
    cent = np.ascontiguousarray(c0.copy())
    assign = np.zeros(13000, np.uint32)
    code, _avg = capi.kmeans_from_pointers(
        3, 0, 0.01, 0.0, 0, 13000, 2, 50, 5, 0, 0, 0, _ptr(x), _ptr(cent),
        _ptr(assign), 0)
    assert code == SUCCESS
    assert (assign[[42, 4242]] == 50).all() and np.isfinite(cent).all()
    code, nbr = _knn(capi, 5, x, cent, assign, 0, 0)
    assert code == SUCCESS
    assert (nbr[[42, 4242]] == 0xFFFFFFFF).all()
    assert (np.delete(nbr, [42, 4242], axis=0) < 13000).all()
    code, want = _knn(jcapi, 5, x, cent, assign, 0, 1)
    assert code == SUCCESS
    _assert_equal_off_ties(x, nbr, want)


def _grouped(n=4096, f=8):
    """tests/test_capi.py:39's four well-separated float32 groups."""
    rng = np.random.RandomState(11)
    return np.ascontiguousarray(
        rng.rand(n, f).astype(np.float32)
        + np.repeat(np.arange(4, dtype=np.float32) * 8.0,
                    n // 4)[:, None].astype(np.float32))


def test_device_handle_registry(on_cpu):
    """tests/test_capi.py:39 on the port: upload -> kmeans -> knn on
    handles, fetch, shape, release, stale-handle and short-buffer
    rejection; the pipeline bitwise equal to the direct calls."""
    n, f, k, kn = 4096, 8, 16, 5
    x = _grouped(n, f)
    code, hs = capi.upload_from_pointer(_ptr(x), n, f, 0)
    assert code == SUCCESS and hs > 0
    code, hc, ha, avg = capi.kmeans_from_handles(
        1, 0, 0.01, 0.0, 0, k, 77, 0, 0, hs, 0, 1)  # ++ init, L2, avg
    assert code == SUCCESS and hc > 0 and ha > 0 and avg > 0.0
    assert capi.handle_shape(ha) == (SUCCESS, n, 1, 4)
    assert capi.handle_shape(hc) == (SUCCESS, k, f, 4)
    code, hn = capi.knn_from_handles(kn, 0, 0, 0, hs, hc, ha)
    assert code == SUCCESS and hn > 0
    assert capi.handle_shape(hn) == (SUCCESS, n, kn, 4)

    nbr = np.zeros((n, kn), np.uint32)
    # a short buffer is rejected without writing
    nbr[...] = 7
    assert capi.fetch_to_pointer(hn, _ptr(nbr), nbr.nbytes - 1) == INVALID
    assert (nbr == 7).all()
    assert capi.fetch_to_pointer(hn, _ptr(nbr), nbr.nbytes) == SUCCESS
    assign = np.zeros(n, np.uint32)
    assert capi.fetch_to_pointer(ha, _ptr(assign), assign.nbytes) == SUCCESS
    cent = np.zeros((k, f), np.float32)
    assert capi.fetch_to_pointer(hc, _ptr(cent), cent.nbytes) == SUCCESS

    c_ref, a_ref, avg_ref = kmeans_torch(
        torch.from_numpy(x), k, init="k-means++", seed=77, tolerance=0.01,
        yinyang_t=0, average_distance=True)
    nbr_ref = knn_torch(kn, torch.from_numpy(x), c_ref, a_ref)
    np.testing.assert_array_equal(cent, c_ref.numpy())
    np.testing.assert_array_equal(assign, a_ref.numpy().view(np.uint32))
    np.testing.assert_array_equal(nbr, nbr_ref.numpy().view(np.uint32))
    assert avg == avg_ref

    for h in (hs, hc, ha, hn):
        assert capi.release_handle(h) == SUCCESS
    assert capi.release_handle(hn) == INVALID
    assert capi.handle_shape(hn) == (INVALID, 0, 0, 0)
    assert capi.fetch_to_pointer(hn, _ptr(nbr), nbr.nbytes) == INVALID
    code, _hn2 = capi.knn_from_handles(kn, 0, 0, 0, hs, hc, ha)
    assert code == INVALID


def test_kmeans_from_handles_imports_its_start(on_cpu, blobs):
    """Import init takes the import handle's tensor as ``init=``: the
    same result as the pointer path from the same start; a stale import
    handle is rejected."""
    c0 = np.ascontiguousarray(
        blobs[np.random.RandomState(2).choice(13000, 50, replace=False)])
    _code, hs = capi.upload_from_pointer(_ptr(blobs), 13000, 2, 0)
    _code, hi = capi.upload_from_pointer(_ptr(c0), 50, 2, 0)
    code, hc, ha, _avg = capi.kmeans_from_handles(
        3, 0, 0.01, 0.0, 0, 50, 5, 0, 0, hs, hi, 0)
    assert code == SUCCESS
    cent = c0.copy()
    assign = np.zeros(13000, np.uint32)
    code, _avg = capi.kmeans_from_pointers(
        3, 0, 0.01, 0.0, 0, 13000, 2, 50, 5, 0, 0, 0, _ptr(blobs),
        _ptr(cent), _ptr(assign), 0)
    assert code == SUCCESS
    np.testing.assert_array_equal(capi._handles[hc].numpy(), cent)
    np.testing.assert_array_equal(
        capi._handles[ha].numpy().view(np.uint32), assign)
    for h in (hi, hc, ha):
        assert capi.release_handle(h) == SUCCESS
    code, *_ = capi.kmeans_from_handles(3, 0, 0.01, 0.0, 0, 50, 5, 0, 0, hs,
                                        hi, 0)
    assert code == INVALID
    assert capi.release_handle(hs) == SUCCESS


def test_multi_bit_mask_reaches_the_sharded_path(separated, on_cpu,
                                                 monkeypatch, capsys):
    """A mask that selects several devices scatters the samples over them,
    through the pointer and the handle paths: three logical CPU devices
    here, one plan line each.  The separated set has no knife-edge
    sample, so the assignments and neighbours are the mask-0 call's."""
    from kmcuda_torch.parallel import devices

    x = separated
    n, f = x.shape
    c0 = x[np.random.RandomState(3).choice(n, 32, replace=False)]
    one = _kmeans(capi, x, c0, 1, 0.0, 0, capsys)
    monkeypatch.setattr(devices, "select_devices",
                        lambda mask, logger=None: [torch.device("cpu")] * 3)
    three = _kmeans(capi, x, c0, 1, 0.0, 7, capsys)
    assert one[0] == three[0] == SUCCESS
    plans = [[l for l in r[4].splitlines() if l.startswith("plan: ")]
             for r in (one, three)]
    assert [len(p) for p in plans] == [1, 3]
    assert plans[1][1].startswith("plan: cpu rows [1366, 2731) ")
    np.testing.assert_array_equal(three[2], one[2])
    np.testing.assert_allclose(three[1], one[1], rtol=1e-5, atol=1e-6)
    code, nb1 = _knn(capi, 8, x, one[1], one[2], 1, 0)
    code3, nb3 = _knn(capi, 8, x, one[1], one[2], 1, 7)
    assert code == code3 == SUCCESS
    np.testing.assert_array_equal(nb3, nb1)

    _code, hs = capi.upload_from_pointer(_ptr(x), n, f, 0)
    _code, hi = capi.upload_from_pointer(_ptr(np.ascontiguousarray(c0)), 32,
                                         f, 0)
    code, hc, ha, _avg = capi.kmeans_from_handles(
        3, 0, 0.01, 0.0, 1, 32, 5, 7, 2, hs, hi, 0)
    assert code == SUCCESS
    assert capi._handles[ha].device == torch.device("cpu")
    assert len([l for l in capsys.readouterr().out.splitlines()
                if l.startswith("plan: ")]) == 3
    code, hn = capi.knn_from_handles(8, 1, 7, 0, hs, hc, ha)
    assert code == SUCCESS
    np.testing.assert_array_equal(
        capi._handles[ha].numpy().view(np.uint32), one[2])
    np.testing.assert_array_equal(capi._handles[hn].numpy().view(np.uint32),
                                  nb1)
    for h in (hs, hi, hc, ha, hn):
        assert capi.release_handle(h) == SUCCESS


def test_mask_zero_cuts_handles_as_it_cuts_pointers(blobs, monkeypatch,
                                                    capsys):
    """native/test_kmtpu.c requires the handle pipeline bitwise the
    pointer path, both with mask 0.  On a host with three devices (three
    logical CPU devices here, ``KMTPU_PLATFORM`` unset) mask 0 must cut a
    handle over all three as it cuts the host buffer, not keep it on its
    own device."""
    from kmcuda_torch.parallel import devices

    monkeypatch.delenv("KMTPU_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(devices, "select_devices",
                        lambda mask, logger=None: [torch.device("cpu")] * (
                            3 if mask == 0 else bin(mask).count("1")))
    x = blobs
    n, f = x.shape
    cent = np.zeros((50, f), np.float32)
    assign = np.zeros(n, np.uint32)
    code, avg = capi.kmeans_from_pointers(1, 0, 0.01, 0.0, 0, n, f, 50, 77,
                                          0, 0, 0, _ptr(x), _ptr(cent),
                                          _ptr(assign), 1)
    assert code == SUCCESS
    hs = capi._register(torch.from_numpy(x.copy()))
    code, hc, ha, avg2 = capi.kmeans_from_handles(1, 0, 0.01, 0.0, 0, 50, 77,
                                                  0, 2, hs, 0, 1)
    assert code == SUCCESS
    assert len([l for l in capsys.readouterr().out.splitlines()
                if l.startswith("plan: ")]) == 3
    assert avg2 == avg
    np.testing.assert_array_equal(capi._handles[hc].numpy(), cent)
    np.testing.assert_array_equal(
        capi._handles[ha].numpy().view(np.uint32), assign)
    for h in (hs, hc, ha):
        assert capi.release_handle(h) == SUCCESS


def test_upload_owns_its_copy(on_cpu):
    """tests/test_capi.py:100 on the port: the handle never sees the
    caller's later writes, checked on a 64-byte-aligned buffer (the
    alignment at which a zero-copy wrap would be tempting)."""
    n, f = 256, 32
    nbytes = n * f * 4
    raw = np.zeros(nbytes + 64, np.uint8)
    off = (-_ptr(raw)) % 64
    buf = raw[off:off + nbytes].view(np.float32).reshape(n, f)
    assert _ptr(buf) % 64 == 0
    buf[...] = np.random.RandomState(3).rand(n, f).astype(np.float32)
    snapshot = buf.copy()
    code, h = capi.upload_from_pointer(_ptr(buf), n, f, 0)
    assert code == SUCCESS and h > 0
    buf[...] = -1.0
    got = np.zeros_like(snapshot)
    assert capi.fetch_to_pointer(h, _ptr(got), got.nbytes) == SUCCESS
    np.testing.assert_array_equal(got, snapshot)
    assert capi.release_handle(h) == SUCCESS


def test_fp16x2_pointers(on_cpu):
    """fp16x2: features_size counts pairs of halves; fp16 centroids come
    back in fp16, from bf16 storage, as the JAX package's do."""
    x = _grouped(4096, 8).astype(np.float16)
    cent = np.ascontiguousarray(x[::512][:8].copy())
    assign = np.zeros(4096, np.uint32)
    code, _avg = capi.kmeans_from_pointers(
        3, 0, 0.01, 0.0, 0, 4096, 4, 8, 5, 0, 1, 0, _ptr(x), _ptr(cent),
        _ptr(assign), 0)
    assert code == SUCCESS
    want_c, want_a = kmeans_torch(torch.from_numpy(x), 8,
                                  init=torch.from_numpy(x[::512][:8].copy()),
                                  tolerance=0.01, yinyang_t=0)
    assert want_c.dtype == torch.float16
    np.testing.assert_array_equal(cent, want_c.numpy())
    np.testing.assert_array_equal(assign, want_a.numpy().view(np.uint32))


def _filled(n=4096, f=8, k=16):
    x = _grouped(n, f)
    cent = np.full((k, f), 3.0, np.float32)
    assign = np.full(n, 9, np.uint32)
    return x, cent, assign


def test_no_cuda_device_no_fallback(monkeypatch):
    """With KMTPU_PLATFORM unset and no CUDA device every call returns
    kmtpuNoSuchDevice and writes nothing: no path runs on the CPU
    quietly."""
    monkeypatch.delenv("KMTPU_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, cent, assign = _filled()
    for init in (0, 1, 3):
        code, avg = capi.kmeans_from_pointers(
            init, 0, 0.01, 0.0, 0, 4096, 8, 16, 5, 0, 0, 0, _ptr(x),
            _ptr(cent), _ptr(assign), 1)
        assert (code, avg) == (int(KMTPUResult.NO_SUCH_DEVICE), 0.0)
        assert (cent == 3.0).all() and (assign == 9).all()
    nbr = np.full((4096, 5), 7, np.uint32)
    code = capi.knn_from_pointers(5, 0, 4096, 8, 16, 0, 0, 0, _ptr(x),
                                  _ptr(cent), _ptr(np.zeros(4096, np.uint32)),
                                  _ptr(nbr))
    assert code == int(KMTPUResult.NO_SUCH_DEVICE) and (nbr == 7).all()
    assert capi.upload_from_pointer(_ptr(x), 4096, 8, 0) == \
        (int(KMTPUResult.NO_SUCH_DEVICE), 0)


def test_platform_and_error_codes(monkeypatch, capsys):
    """KMTPU_PLATFORM=tpu names no platform of the port: invalid
    arguments, with a message on stderr.  A CUDA out-of-memory error (a
    RuntimeError) maps to kmtpuMemoryAllocationFailure, a bad argument to
    kmtpuInvalidArguments, anything else to kmtpuRuntimeError."""
    x, cent, assign = _filled()
    args = (1, 0, 0.01, 0.0, 0, 4096, 8, 16, 5, 0, 0, 0, _ptr(x),
            _ptr(cent), _ptr(assign), 0)
    monkeypatch.setenv("KMTPU_PLATFORM", "tpu")
    assert capi.kmeans_from_pointers(*args) == (INVALID, 0.0)
    assert "KMTPU_PLATFORM='tpu'" in capsys.readouterr().err
    assert capi.upload_from_pointer(_ptr(x), 4096, 8, 0) == (INVALID, 0)

    monkeypatch.setenv("KMTPU_PLATFORM", "cpu")
    for exc, code in ((torch.cuda.OutOfMemoryError("CUDA out of memory"),
                       KMTPUResult.MEMORY_ALLOCATION_FAILURE),
                      (MemoryError(), KMTPUResult.MEMORY_ALLOCATION_FAILURE),
                      (TypeError("bad"), KMTPUResult.INVALID_ARGUMENTS),
                      (RuntimeError("other"), KMTPUResult.RUNTIME_ERROR)):
        def boom(*_a, _exc=exc, **_kw):
            raise _exc

        monkeypatch.setattr(capi, "kmeans_torch", boom)
        assert capi.kmeans_from_pointers(*args) == (int(code), 0.0)
        assert (cent == 3.0).all() and (assign == 9).all()
    # an unknown init code and a tolerance out of range
    monkeypatch.setattr(capi, "kmeans_torch", kmeans_torch)
    assert capi.kmeans_from_pointers(7, *args[1:])[0] == INVALID
    assert capi.kmeans_from_pointers(args[0], 0, 100.0,
                                     *args[3:])[0] == INVALID


def test_capi_imports_no_jax():
    """kmcuda_torch/capi.py imports only torch, numpy and kmcuda_torch,
    by its source and in a fresh interpreter."""
    path = os.path.join(REPO, "kmcuda_torch", "capi.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    top = {n.split(".")[0] for n in names}
    assert top <= {"ctypes", "itertools", "os", "sys", "traceback", "numpy",
                   "torch", "kmcuda_torch"}, top
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, kmcuda_torch.capi; print(sorted(m for m in sys.modules"
         " if m.split('.')[0] in ('jax', 'jaxlib', 'kmcuda_tpu')))"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    """native_torch built with cmake and ninja; (build dir, library)."""
    if shutil.which("cmake") is None or shutil.which("ninja") is None:
        pytest.skip("cmake/ninja not available")
    build = str(tmp_path_factory.mktemp("kmtpu_torch_native"))
    subprocess.run(
        ["cmake", "-S", os.path.join(REPO, "native_torch"), "-B", build,
         "-G", "Ninja"], check=True, capture_output=True)
    subprocess.run(["cmake", "--build", build], check=True,
                   capture_output=True)
    return build, os.path.join(build, "libkmtpu_torch.so")


def _smoke(build, platform):
    env = dict(os.environ)
    env.pop("KMTPU_PLATFORM", None)
    if platform:
        env["KMTPU_PLATFORM"] = platform
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([os.path.join(build, "kmtpu_torch_smoke")],
                          env=env, timeout=600, capture_output=True,
                          text=True)


def test_c_abi_smoke(shim):
    """tests/test_capi.py:17 on native_torch: the unchanged
    native/test_kmtpu.c against libkmtpu_torch.so on the CPU."""
    out = _smoke(shim[0], "cpu")
    assert out.returncode == 0, (out.stdout, out.stderr)
    assert "KMTPU_SMOKE_OK" in out.stdout
    assert "KMTPU_DEVICE_PIPELINE_OK" in out.stdout
    assert "calculated " in out.stdout


def test_c_abi_without_cuda_or_platform(shim):
    """The compiled path has no fallback either: with no CUDA device and
    no KMTPU_PLATFORM the first call fails with kmtpuNoSuchDevice (2); an
    unknown platform gives kmtpuInvalidArguments (1) and a message."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    out = _smoke(shim[0], None)
    assert out.returncode == 1 and "kmeans_cuda failed: 2" in out.stderr
    out = _smoke(shim[0], "tpu")
    assert out.returncode == 1 and "kmeans_cuda failed: 1" in out.stderr
    assert "KMTPU_PLATFORM='tpu'" in out.stderr


def test_shim_in_a_running_interpreter(shim, on_cpu, capfd):
    """libkmtpu_torch.so loaded into this process with ctypes uses the
    interpreter that is already running: raw CUDA pointers
    (device_ptrs >= 0) are refused before Python is reached; host
    pointers give what kmcuda_torch.capi gives."""
    lib = ctypes.CDLL(shim[1])
    lib.kmeans_cuda.restype = ctypes.c_int
    lib.kmeans_cuda.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_uint32, ctypes.c_uint16, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    x = _grouped()
    avg = ctypes.c_float(-1.0)
    outs = []
    for device_ptrs in (0, -1):
        cent = np.zeros((16, 8), np.float32)
        assign = np.zeros(4096, np.uint32)
        code = lib.kmeans_cuda(1, None, 0.01, 0.0, 0, 4096, 8, 16, 77, 0,
                               device_ptrs, 0, 0, _ptr(x), _ptr(cent),
                               _ptr(assign), ctypes.addressof(avg))
        outs.append((code, cent, assign))
    assert outs[0][0] == INVALID and not outs[0][2].any()
    assert "device_ptrs >= 0 is not supported" in capfd.readouterr().err
    assert outs[1][0] == SUCCESS
    cent = np.zeros((16, 8), np.float32)
    assign = np.zeros(4096, np.uint32)
    code, want_avg = capi.kmeans_from_pointers(
        1, 0, 0.01, 0.0, 0, 4096, 8, 16, 77, 0, 0, 0, _ptr(x), _ptr(cent),
        _ptr(assign), 1)
    assert code == SUCCESS
    np.testing.assert_array_equal(outs[1][1], cent)
    np.testing.assert_array_equal(outs[1][2], assign)
    assert avg.value == np.float32(want_avg)
