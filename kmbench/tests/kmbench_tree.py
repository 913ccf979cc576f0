"""Helpers of the benchmark's CPU tests: a copy of the benchmark's tree with
its configurations cut to a size the CPU runs in seconds, and a run of a
cell in it on the CPU, its result read back."""

import contextlib
import io
import json
import pathlib
import shutil
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from kmbench import harness as H  # noqa: E402


#: features of a configuration at a test's size, by its dtype: bf16 wants
#: the full width, where the rounding of the centroids it returns stays
#: small against the distances its limits were read at; fp32 few, where
#: k-means++'s weights vary enough for 64 starts to show them
FEATURES = {"float32": 8, "bfloat16": 256}


def small_tree(tmp: pathlib.Path, samples=4000, features=None, clusters=64,
               dtype=None) -> pathlib.Path:
    """``tmp`` holding BENCHMARK.json and the benchmark's data files, its
    configurations cut to ``samples`` x ``features`` (by default
    :data:`FEATURES` of the dtype), ``clusters``."""
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for sub in ("traffic", "limits", "metrics", "configs"):
        shutil.copytree(REPO / "kmbench" / sub, tmp / "kmbench" / sub)
    for c in spec["configs"]:
        path = tmp / c["file"]
        cfg = json.loads(path.read_text())
        if dtype:
            cfg["dtype"] = dtype
        cfg.update(samples=samples, clusters=clusters,
                   features=features or FEATURES[cfg["dtype"]])
        path.write_text(json.dumps(cfg))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


@contextlib.contextmanager
def cpu_cards():
    """The program's device mask read as that many logical CPU devices (a
    cell over several cards runs on the CPU as row shards there)."""
    import torch
    from kmcuda_torch.parallel import devices as D

    real = D.select_devices
    D.select_devices = lambda mask, logger=None: (
        [torch.device("cpu")] * bin(int(mask)).count("1"))
    try:
        yield
    finally:
        D.select_devices = real


def run(root, workload, seed=7, seconds=0.5, trace=0, program=None):
    """(exit code, last line as a dict or None, stderr) of one CPU run; a
    cell over several cards runs on as many logical CPU devices."""
    import torch

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err), \
            cpu_cards():
        rc = H.main(["--workload", workload, "--seed", str(seed),
                     "--seconds", str(seconds), "--trace", str(trace)],
                    pathlib.Path(root), time.perf_counter(),
                    program=program or H.Program(),
                    device=torch.device("cpu"))
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
