"""Run one cell of the benchmark of kmcuda_torch on a CUDA card.

    python3 kmbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cells are the ``workloads`` of
``BENCHMARK.json``.  Prints the result as one JSON object on the last line
of standard output; exits non-zero, with no result, where it finds no
card.
"""

import time

_T0 = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the program's kernel caches, at fixed paths inside the checkout (the
# kernel library itself is built into build/kmcuda_torch/ there)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "kmbench" /
                                         "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "kmbench" / "triton")
# the configurations' deployment: one process a card with one host thread
# for the program's CPU-side torch ops (OpenMP, MKL), as torchrun sets it
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"
# the checkout's packages, and not this directory's modules, on the path
sys.path[0] = str(ROOT)

from kmbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], ROOT, _T0))
