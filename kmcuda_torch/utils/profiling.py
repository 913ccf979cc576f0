"""Opt-in profiler window around the compute sections, the port of
``kmcuda_tpu.utils.profiling``.

Set ``KMTPU_PROFILE=<dir>`` and the span the reference brackets with
``cudaProfilerStart/Stop`` (init, iterations and average distance of a
k-means call; the search of a kNN call) runs under ``torch.profiler``:
CPU activity, and CUDA activity on a CUDA device.  The window writes a
Chrome trace (``*.pt.trace.json``, readable in Perfetto or
``chrome://tracing``) into the directory.  Unset, the window is a no-op.
"""

import contextlib
import os
import time

_ENV = "KMTPU_PROFILE"
#: torch.profiler runs one trace per process at a time
_active = False


@contextlib.contextmanager
def profile_window(logger, device):
    """Bracket a compute span on ``device`` with a profiler trace when
    KMTPU_PROFILE names a directory.  A call inside an open window is a
    no-op, as the JAX package's."""
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
            yield
    finally:
        _active = False
        prof.export_chrome_trace(os.path.join(
            log_dir, "kmcuda_torch.%d.%d.pt.trace.json"
            % (os.getpid(), time.time_ns())))
        logger.info("profiler trace written to %s" % log_dir)
