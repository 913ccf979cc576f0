"""Build and load the CUDA kernel library.

The sources under ``kmcuda_torch/csrc/`` are compiled with ``nvcc``, one
process per source, all started together, and linked into a shared
library with a plain C interface, loaded with ``ctypes``, at first use,
into ``build/kmcuda_torch/`` at the root of the checkout.  The library's
name carries a hash of the sources and flags, so an edit rebuilds.  A
failed build raises with the compiler's output; there is no fallback.
The compilers' output of a build that succeeds (``ptxas -v``: registers,
shared memory and spills of every kernel) is kept beside the library, in
:func:`build_log_path`.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

from kmcuda_torch.utils.errors import KMTPURuntimeError

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parents[1] / "build" / "kmcuda_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int64
#: C entry -> argtypes (pointers and the stream as void*, sizes as int64)
_SIGNATURES = {
    "kmt_assign": [_P] * 10 + [_I] * 6 + [_P],
    "kmt_segment_sum": [_P] * 6 + [_I] * 9 + [_P],
    "kmt_delta_sum": [_P] * 8 + [_I] * 10 + [_P],
    "kmt_knn_walk": [_P] * 17 + [_I] * 12 + [_P],
    "kmt_point_min": [_P] * 5 + [_I] * 5 + [_P],
    "kmt_weighted_draw": [_P] * 7 + [_I] * 4 + [_P],
}

_lock = threading.Lock()
_lib = None


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise KMTPURuntimeError("nvcc not found (looked on PATH and in %s)"
                                % path)
    return path


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / ("libkmcuda_torch_%s.so" % digest.hexdigest()[:16])


def build_log_path() -> pathlib.Path:
    return library_path().with_suffix(".log")


def build() -> pathlib.Path:
    """Compile the library unless a build of these sources exists; returns
    its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = "%s.%d" % (out.stem, os.getpid())
    cus = [src for src in sources() if src.suffix == ".cu"]
    objs = [str(BUILD_DIR / ("%s.%s.o" % (tag, src.stem))) for src in cus]
    cmds = [[nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj, str(src)]
            for obj, src in zip(objs, cus)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise KMTPURuntimeError("nvcc failed (%d): %s\n%s" % (
                proc.returncode, " ".join(cmd), log))
    tmp = out.with_suffix(".%d.tmp" % os.getpid())
    link = [nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *objs]
    proc = subprocess.run(link, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KMTPURuntimeError("nvcc failed (%d): %s\n%s%s" % (
            proc.returncode, " ".join(link), proc.stdout, proc.stderr))
    log = out.with_suffix(".%d.logtmp" % os.getpid())
    log.write_text("".join("$ %s\n%s" % (" ".join(cmd), text)
                           for cmd, text in zip(cmds, logs)))
    os.replace(log, build_log_path())
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.kmt_error_string.argtypes = [ctypes.c_int]
            lib.kmt_error_string.restype = ctypes.c_char_p
            lib.kmt_knn_walk_smem_buffer_bytes.argtypes = [_I]
            lib.kmt_knn_walk_smem_buffer_bytes.restype = _I
            _lib = lib
    return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise :class:`KMTPURuntimeError` for a non-zero CUDA error code."""
    if code != 0:
        raise KMTPURuntimeError("%s: CUDA error %d (%s)" % (
            what, code, lib.kmt_error_string(code).decode()))
