"""The port's tracing: spans and counters for ``torch.profiler``, and the
opt-in profiler window around the compute sections (the port of
``kmcuda_tpu.utils.profiling``).

Spans and counters are on while a ``torch.profiler`` session is, and only
then (``torch.autograd.profiler._is_profiler_enabled``); nothing turns
them on but the session, ``KMTPU_PROFILE``'s included.

- :func:`span` is a range of torch's record-function machinery, a host
  event of the trace on the device trace's clock: torch's fast range
  (``_RecordFunctionFast``: about 1.5 us to enter and leave under a
  session, where ``record_function`` takes about 12), so that the spans
  of a k-means++ step cost little of the step they time.  It has no
  device copy.  With no session a span is one flag read and a shared
  no-op context.  :func:`spanned` puts a whole function in one.  Every
  ``kmt.`` name is listed in ``PERF.md`` with what reads it.
- :func:`count` adds an integer sample to the record of the public call
  in flight (:func:`public_call`).  A record holds the call's kind, its
  ``time.time_ns()`` at entry and exit and its samples in order;
  :func:`records` returns the last :data:`RING` of them.

Set ``KMTPU_PROFILE=<dir>`` and the span the reference brackets with
``cudaProfilerStart/Stop`` (init, iterations and average distance of a
k-means call; the search of a kNN call) runs under ``torch.profiler``:
CPU activity, and CUDA activity on a CUDA device.  The window writes a
Chrome trace (``*.pt.trace.json``, readable in Perfetto or
``chrome://tracing``) into the directory, and the call's record beside it
(``*.counters.json``).  Unset, the window is a no-op.
"""

import collections
import contextlib
import functools
import json
import os
import time

import torch
import torch.autograd.profiler as _profiler
from torch.profiler import record_function

#: the range a span opens (``record_function`` where torch lacks the fast
#: one)
_range = getattr(torch._C._profiler, "_RecordFunctionFast", record_function)

_ENV = "KMTPU_PROFILE"
#: torch.profiler runs one trace per process at a time
_active = False
#: the records kept: those of the last RING public calls traced
RING = 64
_records = collections.deque(maxlen=RING)
#: the record of the public call in flight under a session, else None
_current = None
_NULL = contextlib.nullcontext()


def span(name: str):
    """A range named ``name`` while a session is on, else a shared no-op
    context.  Never open one across a ``yield``: it would
    time the generator's consumer."""
    if _profiler._is_profiler_enabled:
        return _range(name)
    return _NULL


def spanned(name: str):
    """Decorator: each call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _range(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, value: int) -> None:
    """One sample of counter ``name`` in the record of the public call in
    flight; nothing when no record is open (no session)."""
    if _current is not None:
        _current["counters"].append([name, int(value)])


def records() -> list:
    """The records of the last :data:`RING` public calls made under a
    session, oldest first: dicts of ``kind`` ("kmeans" or "knn"),
    ``start_ns`` and ``end_ns`` (``time.time_ns()``) and ``counters``, the
    [name, value] samples in order."""
    return list(_records)


def _open(kind: str) -> dict:
    global _current
    _current = {"kind": kind, "start_ns": time.time_ns(), "end_ns": None,
                "counters": []}
    return _current


def _close(rec: dict) -> None:
    global _current
    rec["end_ns"] = time.time_ns()
    _records.append(rec)
    _current = None


def public_call(kind: str):
    """Decorator of a public call: under a session, the call inside span
    ``kmt.<kind>`` with a record of its own."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            rec = _open(kind)
            try:
                with _range("kmt." + kind):
                    return fn(*args, **kwargs)
            finally:
                _close(rec)
        return inner
    return wrap


@contextlib.contextmanager
def profile_window(logger, device, kind: str):
    """Bracket a compute span on ``device`` of a public call of ``kind``
    with a profiler trace when KMTPU_PROFILE names a directory.  A call
    inside an open window is a no-op, as the JAX package's."""
    global _active
    log_dir = os.environ.get(_ENV, "").strip()
    if not log_dir or _active:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    _active = True
    logger.debug("profiler trace started (%s=%s)" % (_ENV, log_dir))
    try:
        with prof:
            # the session opens inside the call: the window's record is
            # the call's
            rec = _open(kind)
            try:
                yield
            finally:
                _close(rec)
    finally:
        _active = False
        stem = os.path.join(log_dir, "kmcuda_torch.%d.%d"
                            % (os.getpid(), time.time_ns()))
        prof.export_chrome_trace(stem + ".pt.trace.json")
        with open(stem + ".counters.json", "w") as fh:
            json.dump(rec, fh)
        logger.info("profiler trace written to %s" % log_dir)
