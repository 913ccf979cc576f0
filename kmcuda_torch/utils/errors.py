"""Error taxonomy mirroring the reference's KMCUDAResult.

The same classes and codes as ``kmcuda_tpu.utils.errors``: a
:class:`KMTPUResult` enum value-compatible with the C result enum, and
exception classes that inherit from *both* :class:`KMTPUError` and the
stdlib exception the reference binding raised, so ``except ValueError:``
call sites keep working:

- ``KMTPUInvalidArguments``        -> ``ValueError``
- ``KMTPUNoSuchDevice``            -> ``ValueError``
- ``KMTPUMemoryAllocationFailure`` -> ``MemoryError``
- ``KMTPUMemoryCopyError``         -> ``RuntimeError``
- ``KMTPURuntimeError``            -> ``AssertionError`` (also what a failed
  kernel launch raises)
"""

import enum


class KMTPUResult(enum.IntEnum):
    """Status codes, value-compatible with KMCUDAResult."""

    SUCCESS = 0
    INVALID_ARGUMENTS = 1
    NO_SUCH_DEVICE = 2
    MEMORY_ALLOCATION_FAILURE = 3
    RUNTIME_ERROR = 4
    MEMORY_COPY_ERROR = 5


class KMTPUError(Exception):
    """Base class for all libKMTPU errors."""

    result = KMTPUResult.RUNTIME_ERROR


class KMTPUInvalidArguments(KMTPUError, ValueError):
    result = KMTPUResult.INVALID_ARGUMENTS


class KMTPUNoSuchDevice(KMTPUError, ValueError):
    result = KMTPUResult.NO_SUCH_DEVICE


class KMTPUMemoryAllocationFailure(KMTPUError, MemoryError):
    result = KMTPUResult.MEMORY_ALLOCATION_FAILURE


class KMTPURuntimeError(KMTPUError, AssertionError):
    result = KMTPUResult.RUNTIME_ERROR


class KMTPUMemoryCopyError(KMTPUError, RuntimeError):
    result = KMTPUResult.MEMORY_COPY_ERROR


#: result code -> exception class, the ``statuses`` map the reference
#: exports for wrapper authors.
statuses = {
    KMTPUResult.INVALID_ARGUMENTS: KMTPUInvalidArguments,
    KMTPUResult.NO_SUCH_DEVICE: KMTPUNoSuchDevice,
    KMTPUResult.MEMORY_ALLOCATION_FAILURE: KMTPUMemoryAllocationFailure,
    KMTPUResult.RUNTIME_ERROR: KMTPURuntimeError,
    KMTPUResult.MEMORY_COPY_ERROR: KMTPUMemoryCopyError,
}

