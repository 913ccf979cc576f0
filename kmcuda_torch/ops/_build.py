"""Build and load the CUDA kernel library.

The sources under ``kmcuda_torch/csrc/`` are compiled with ``nvcc`` into a
shared library with a plain C interface and loaded with ``ctypes``, at
first use, into ``build/kmcuda_torch/`` at the root of the checkout.  The
library's name carries a hash of the sources and flags, so an edit
rebuilds.  A failed build raises with the compiler's output; there is no
fallback.
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
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int64
#: C entry -> argtypes (pointers and the stream as void*, sizes as int64)
_SIGNATURES = {
    "kmt_assign": [_P] * 9 + [_I] * 5 + [_P],
    "kmt_segment_sum": [_P] * 5 + [_I] * 5 + [_P],
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


def build() -> pathlib.Path:
    """Compile the library unless a build of these sources exists; returns
    its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(".%d.tmp" % os.getpid())
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sources() if s.suffix == ".cu"]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KMTPURuntimeError("nvcc failed (%d): %s\n%s%s" % (
            proc.returncode, " ".join(cmd), proc.stdout, proc.stderr))
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
            _lib = lib
    return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise :class:`KMTPURuntimeError` for a non-zero CUDA error code."""
    if code != 0:
        raise KMTPURuntimeError("%s: CUDA error %d (%s)" % (
            what, code, lib.kmt_error_string(code).decode()))
