"""The capacity run: a user's 40,000,000 x 256 bf16 corpus (20.48 GB of
samples) through ``kmeans_cuda`` on one card.

:func:`samples` and :func:`call` are the data and the call that
``chip_smoke.py:capacity_run`` drives and checks (peak memory, launches,
the argmin on a row sample).  Run alone, the call prints its wall and
peak memory, or the CUDA out-of-memory error of a checkout whose
``prepare`` cannot take it::

    python3 capacity.py

It needs nothing of the port but ``kmcuda_torch.kmeans_cuda``, so a copy
of this file in an older checkout shows that checkout's limit.
"""

import subprocess
import sys
import time

import torch

from kmcuda_torch import kmeans_cuda

N, F, K = 40_000_000, 256, 1024
SEED = 17


def samples(seed: int = SEED) -> torch.Tensor:
    """U(0, 1) drawn on card 0 straight into bf16 storage (``uniform_``
    holds no fp32 copy; a whole fp32 draw would take 41 GB beside them)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.empty((N, F), dtype=torch.bfloat16,
                       device="cuda").uniform_(generator=g)


def call(x: torch.Tensor, verbosity: int = 0):
    """k-means++ seed 17, tolerance 0.01, 5 iterations at most, Lloyd."""
    return kmeans_cuda(x, K, init="k-means++", seed=SEED, tolerance=0.01,
                       max_iterations=5, yinyang_t=0, verbosity=verbosity)


def main() -> int:
    if not torch.cuda.is_available():
        print("capacity: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    x = samples()
    label = "[%s] capacity %dx%d bf16 k=%d (%.2f GB of samples)" % (
        card, N, F, K, x.nbytes / 1e9)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    try:
        call(x)
        torch.cuda.synchronize()
        print("%s: wall %.4f s, peak memory %.2f GB"
              % (label, time.perf_counter() - t,
                 torch.cuda.max_memory_allocated() / 1e9), flush=True)
    except torch.cuda.OutOfMemoryError as e:
        print("%s: CUDA out of memory after %.4f s, peak memory %.2f GB: %s"
              % (label, time.perf_counter() - t,
                 torch.cuda.max_memory_allocated() / 1e9,
                 str(e).splitlines()[0]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
