"""Pointer and handle bridge for the C ABI (``native_torch/kmtpu_torch.cc``).

The native shim embeds CPython and calls these functions with raw host
addresses and opaque handles; they wrap the memory zero-copy with numpy,
run the public API (:func:`kmcuda_torch.kmeans_torch`,
:func:`kmcuda_torch.knn_torch`) and copy the results back into the
caller's buffers.  The functions, their argument order and their return
tuples are those of ``kmcuda_tpu.capi``, so the two shims share
``native/include/kmtpu.h``.

``KMTPU_PLATFORM`` picks where a call runs:

- unset or ``cuda``: host buffers go in as numpy arrays, which the public
  API runs on the CUDA devices the ``device`` mask selects (0 = all, the
  rows split over them); with no CUDA device the call returns
  ``kmtpuNoSuchDevice``.  There is no CPU fallback.
- ``cpu``: the caller asked for the CPU.  Host buffers are wrapped as CPU
  tensors (``torch.from_numpy``), and handles hold CPU tensors.
- anything else: ``kmtpuInvalidArguments``, with a message on stderr.

Results: assignments and neighbours of a tensor call are ``int32`` (the
neighbour sentinel -1); they are written into the caller's ``uint32``
buffers by bit pattern, so the sentinel arrives as 0xFFFFFFFF, as the
numpy route gives it.  fp16 centroids come back in fp16.

Errors are mapped to :class:`KMTPUResult` codes here, so the C side only
moves an int; ``torch.cuda.OutOfMemoryError`` (a ``RuntimeError``) maps to
``kmtpuMemoryAllocationFailure``.  ``KMTPU_CAPI_DEBUG=1`` prints the
traceback of a failed call.
"""

import ctypes
import itertools
import os
import sys

import numpy as np
import torch

from kmcuda_torch.api import kmeans_torch, knn_torch
from kmcuda_torch.models.initialization import InitMethod
from kmcuda_torch.utils.errors import (KMTPUError, KMTPUInvalidArguments,
                                       KMTPUNoSuchDevice, KMTPUResult)

PLATFORMS = ("cuda", "cpu")


def _on_cpu() -> bool:
    """Whether ``KMTPU_PLATFORM`` asks for the CPU; raises on a value that
    names no platform of this package."""
    plat = os.environ.get("KMTPU_PLATFORM") or "cuda"
    if plat not in PLATFORMS:
        msg = ("KMTPU_PLATFORM=%r: this library runs on 'cuda' (the default) "
               "or 'cpu'" % plat)
        print("kmtpu: %s" % msg, file=sys.stderr, flush=True)
        raise KMTPUInvalidArguments(msg)
    return plat == "cpu"


def _as_array(ptr: int, shape, dtype):
    size = int(np.prod(shape)) * np.dtype(dtype).itemsize
    buf = (ctypes.c_char * size).from_address(ptr)
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


def _result_of(exc: Exception) -> int:
    if isinstance(exc, KMTPUError):
        return int(exc.result)
    if isinstance(exc, (ValueError, TypeError)):
        return int(KMTPUResult.INVALID_ARGUMENTS)
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return int(KMTPUResult.MEMORY_ALLOCATION_FAILURE)
    return int(KMTPUResult.RUNTIME_ERROR)


def _failure(exc: Exception) -> int:
    """The code of a failed call, with its traceback under
    ``KMTPU_CAPI_DEBUG``."""
    if int(os.environ.get("KMTPU_CAPI_DEBUG", "0")):
        import traceback

        traceback.print_exception(exc)
    return _result_of(exc)


def _host(result) -> np.ndarray:
    """A result as numpy; int32 ids as uint32 by bit pattern."""
    if isinstance(result, torch.Tensor):
        result = result.cpu().numpy()
        if result.dtype == np.int32:
            return result.view(np.uint32)
    return result


def _init_arg(init, afkmc2_m, imported):
    """The ``init=`` of the public call for a KMTPUInitMethod code;
    ``imported()`` gives the imported centroids."""
    method = InitMethod(init)
    if method == InitMethod.IMPORT:
        return imported()
    if method == InitMethod.AFKMC2:
        return ("afkmc2", int(afkmc2_m))
    if method == InitMethod.PLUS_PLUS:
        return "k-means++"
    return "random"


def kmeans_from_pointers(init, afkmc2_m, tolerance, yinyang_t, metric,
                         samples_size, features_size, clusters_size, seed,
                         device, fp16x2, verbosity, samples_ptr,
                         centroids_ptr, assignments_ptr, want_average):
    """Returns (KMTPUResult int, average_distance float).  The caller's
    buffers are written only on success."""
    try:
        wrap = torch.from_numpy if _on_cpu() else (lambda a: a)
        dtype = np.float16 if fp16x2 else np.float32
        # fp16x2 packs two halves per lane: features_size is half the real
        # feature count (kmcuda.h:107-109)
        f_real = features_size * 2 if fp16x2 else features_size
        samples = _as_array(samples_ptr, (samples_size, f_real), dtype)
        out_c = _as_array(centroids_ptr, (clusters_size, f_real), dtype)
        out_a = _as_array(assignments_ptr, (samples_size,), np.uint32)
        # import reads the initial centroids from the output buffer, like
        # the reference (kmcuda.cc:224-244)
        init_arg = _init_arg(init, afkmc2_m, lambda: wrap(out_c.copy()))
        res = kmeans_torch(
            wrap(samples), int(clusters_size), tolerance=float(tolerance),
            init=init_arg, yinyang_t=float(yinyang_t), metric=int(metric),
            average_distance=bool(want_average), seed=int(seed),
            device=int(device), verbosity=int(verbosity))
        centroids, assignments = _host(res[0]), _host(res[1])
        out_c[...] = centroids.astype(dtype, copy=False)
        out_a[...] = assignments
        avg = float(res[2]) if want_average else 0.0
        return int(KMTPUResult.SUCCESS), avg
    except Exception as exc:  # noqa: BLE001 — everything maps to a code
        return _failure(exc), 0.0


def knn_from_pointers(k, metric, samples_size, features_size, clusters_size,
                      device, fp16x2, verbosity, samples_ptr, centroids_ptr,
                      assignments_ptr, neighbors_ptr):
    """Returns KMTPUResult int.  ``neighbors`` is written only on
    success."""
    try:
        wrap = torch.from_numpy if _on_cpu() else (lambda a: a)
        dtype = np.float16 if fp16x2 else np.float32
        f_real = features_size * 2 if fp16x2 else features_size
        samples = _as_array(samples_ptr, (samples_size, f_real), dtype)
        centroids = _as_array(centroids_ptr, (clusters_size, f_real), dtype)
        assignments = _as_array(assignments_ptr, (samples_size,), np.uint32)
        out_n = _as_array(neighbors_ptr, (samples_size, k), np.uint32)

        nbr = knn_torch(int(k), wrap(samples),
                        wrap(centroids.astype(np.float32)),
                        wrap(assignments), metric=int(metric),
                        device=int(device), verbosity=int(verbosity))
        out_n[...] = _host(nbr)
        return int(KMTPUResult.SUCCESS)
    except Exception as exc:  # noqa: BLE001
        return _failure(exc)


# ---------------------------------------------------------------------------
# Device-handle protocol, as in kmcuda_tpu.capi: device residency crosses
# the C ABI as opaque int64 handles into this process-wide registry of
# tensors.  A C caller uploads samples once, runs kmeans_device ->
# knn_device on the handles, and fetches only the final result: nothing
# round-trips through host memory between stages.  Raw CUDA pointers
# (device_ptrs >= 0) are refused by the shim; handles are the
# device-resident path.

_handles: dict = {}
_ids = itertools.count(1)  # 0 is the invalid handle


def _register(tensor: torch.Tensor) -> int:
    h = next(_ids)
    _handles[h] = tensor
    return h


def _cuda_device() -> torch.device:
    """Where an upload lives: the current CUDA device (device 0, the first
    device mask 0 selects, unless the caller set another).  A call on
    handles with a mask that selects several devices (mask 0 on a host
    with several) scatters the rows over them and returns its handles on
    this device."""
    if not torch.cuda.is_available():
        raise KMTPUNoSuchDevice("no CUDA device exists; set "
                                "KMTPU_PLATFORM=cpu to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def upload_from_pointer(ptr, rows, cols, fp16x2):
    """Copy a host float matrix to the device.  Returns (code, handle).

    The handle never aliases the caller's memory: the caller may free or
    reuse its buffer as soon as this returns (the reference's
    explicit-copy semantics, kmcuda.cc:146-168)."""
    try:
        on_cpu = _on_cpu()
        dtype = np.float16 if fp16x2 else np.float32
        f_real = int(cols) * 2 if fp16x2 else int(cols)
        host = torch.from_numpy(_as_array(ptr, (int(rows), f_real), dtype))
        owned = host.clone() if on_cpu else host.to(_cuda_device())
        return int(KMTPUResult.SUCCESS), _register(owned)
    except Exception as exc:  # noqa: BLE001
        return _failure(exc), 0


def handle_shape(handle):
    """Returns (code, rows, cols, itemsize) of a device handle."""
    t = _handles.get(int(handle))
    if t is None:
        return int(KMTPUResult.INVALID_ARGUMENTS), 0, 0, 0
    rows = int(t.shape[0]) if t.dim() >= 1 else 1
    cols = int(t.shape[1]) if t.dim() >= 2 else 1
    return int(KMTPUResult.SUCCESS), rows, cols, int(t.element_size())


def fetch_to_pointer(handle, ptr, dst_size):
    """Device -> host copy of a handle's tensor, straight into the
    caller's buffer (the one D2H copy of a pipeline).  A buffer shorter
    than the tensor is rejected without writing.  Returns code."""
    try:
        t = _handles.get(int(handle))
        if t is None:
            return int(KMTPUResult.INVALID_ARGUMENTS)
        nbytes = t.numel() * t.element_size()
        if nbytes > int(dst_size):
            return int(KMTPUResult.INVALID_ARGUMENTS)
        dst = torch.from_numpy(_as_array(int(ptr), (nbytes,), np.uint8))
        dst.copy_(t.contiguous().view(torch.uint8).reshape(-1))
        return int(KMTPUResult.SUCCESS)
    except Exception as exc:  # noqa: BLE001
        return _failure(exc)


def release_handle(handle):
    """Drop a handle; the tensor frees when nothing else holds it.
    Returns code (INVALID_ARGUMENTS for an unknown or released handle)."""
    return (int(KMTPUResult.SUCCESS)
            if _handles.pop(int(handle), None) is not None
            else int(KMTPUResult.INVALID_ARGUMENTS))


def _handle_mask(device: int, on_cpu: bool) -> int:
    """The mask a call on handles runs with.  Mask 0 names every CUDA
    device explicitly, so a handle (a tensor, which mask 0 would keep on
    its own device) is cut over the devices the pointer path cuts host
    buffers over, and both paths give one result."""
    if device == 0 and not on_cpu:
        return (1 << torch.cuda.device_count()) - 1
    return device


def kmeans_from_handles(init, afkmc2_m, tolerance, yinyang_t, metric,
                        clusters_size, seed, device, verbosity,
                        samples_handle, import_handle, want_average):
    """Device-resident k-means.  Returns (code, centroids_handle,
    assignments_handle, average_distance)."""
    try:
        mask = _handle_mask(int(device), _on_cpu())
        samples = _handles.get(int(samples_handle))
        imported = _handles.get(int(import_handle))
        if samples is None:
            return int(KMTPUResult.INVALID_ARGUMENTS), 0, 0, 0.0
        init_arg = _init_arg(init, afkmc2_m, lambda: imported)
        if init_arg is None:
            return int(KMTPUResult.INVALID_ARGUMENTS), 0, 0, 0.0
        res = kmeans_torch(
            samples, int(clusters_size), tolerance=float(tolerance),
            init=init_arg, yinyang_t=float(yinyang_t), metric=int(metric),
            average_distance=bool(want_average), seed=int(seed),
            device=mask, verbosity=int(verbosity))
        avg = float(res[2]) if want_average else 0.0
        return (int(KMTPUResult.SUCCESS), _register(res[0]),
                _register(res[1]), avg)
    except Exception as exc:  # noqa: BLE001
        return _failure(exc), 0, 0, 0.0


def knn_from_handles(k, metric, device, verbosity, samples_handle,
                     centroids_handle, assignments_handle):
    """Device-resident k-nn.  Returns (code, neighbors_handle)."""
    try:
        mask = _handle_mask(int(device), _on_cpu())
        samples = _handles.get(int(samples_handle))
        centroids = _handles.get(int(centroids_handle))
        assignments = _handles.get(int(assignments_handle))
        if samples is None or centroids is None or assignments is None:
            return int(KMTPUResult.INVALID_ARGUMENTS), 0
        nbr = knn_torch(int(k), samples, centroids, assignments,
                        metric=int(metric), device=mask,
                        verbosity=int(verbosity))
        return int(KMTPUResult.SUCCESS), _register(nbr)
    except Exception as exc:  # noqa: BLE001
        return _failure(exc), 0
