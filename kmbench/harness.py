"""The harness behind ``run.py``: one run of one cell.

It reads ``BENCHMARK.json`` and finds by the names there the cell's
configuration (the ``file`` the configuration names), its traffic mix
(``traffic/<mix>.json``), its limits (``limits/<workload>.json``) and the
readers of its per-layer metrics (``metrics/<metric>.py``, or
``metrics/<stem>.py`` for ``<stem>.<cell>``), all under the
benchmark's directory.  A new cell, mix or metric is a new file and a new
entry; nothing here names one.

A run: set-up (import, CUDA context, the kernel library, data made on the
card from the seed, one warm call of the cell's call), then the window
(``--trace 0``: the cell's calls back to back until their walls add up to
``--seconds``, the one in flight finishing; ``--trace 1``: the mix's
``traced_calls`` calls under ``torch.profiler``), then the judgement of a
sample of the window's results against the plain references, then the
last line.  Every call draws its own seed from the run's seed.

A cell's ``chips`` cards are cards 0 to chips - 1.  On one card the data
lives on it and the call names no device.  Over several, the data is a
tensor in the host's pinned memory, which the call cuts into one row
shard a card (``device`` = the mask of the cell's cards), as kmcuda takes
a corpus larger than a card; the peak is the fullest card's, the busy
time each card's, averaged over them, and the references judge row parts
on the cards.
"""

import contextlib
import gc
import importlib.util
import io
import json
import math
import pathlib
import random
import re
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "kmcuda_tpu")
#: the lower precision of a configuration's stated one (the control)
LOWER = {"float32": "tf32", "bfloat16": "fp8"}
#: the numbers that judge a k-means call's centroids against the means
MEAN_NUMBERS = ("mean_gap", "mean_off_rounding")
ITERATION = re.compile(r"^iteration (\d+): (\d+) reassignments$")
EXAMINED = re.compile(r"^calculated ([0-9.]+) of all the distances$")
#: rows of data drawn in one call of the generator
DATA_BLOCK_ROWS = 1 << 20


class BenchError(Exception):
    """A run that cannot go on: no card, a file missing, a bad name."""


# --- finding things by name ------------------------------------------------

def load_json(path: pathlib.Path):
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise BenchError("missing %s" % path)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list   # the BENCHMARK.json entries this cell reports
    per_layer: list
    bench_dir: pathlib.Path


def find_cell(root: pathlib.Path, name: str) -> Cell:
    spec = load_json(root / "BENCHMARK.json")
    bench_dir = root / spec["paths"][0]
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise BenchError("no workload %r in BENCHMARK.json (have %s)"
                         % (name, ", ".join(sorted(cells))))
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg = configs[w["config"]]
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return Cell(name, int(w["chips"]), load_json(root / cfg["file"]),
                load_json(bench_dir / "traffic" / (w["traffic"] + ".json")),
                load_json(bench_dir / "limits" / (name + ".json")),
                e2e, layer, bench_dir)


def metric_reader(bench_dir: pathlib.Path, name: str):
    """The ``read(run)`` function of ``metrics/<name>.py`` or, where there
    is no such file, of ``metrics/<stem>.py``, ``stem`` being the part of
    the name before its first dot: one reader serves every
    ``<stem>.<cell>`` entry."""
    path = bench_dir / "metrics" / (name + ".py")
    if not path.exists():
        path = bench_dir / "metrics" / (name.split(".")[0] + ".py")
    if not path.exists():
        raise BenchError("missing %s" % path)
    spec = importlib.util.spec_from_file_location(
        "kmbench_metric_" + re.sub(r"\W", "_", path.stem), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# --- the system under test -------------------------------------------------

def _captured(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue().splitlines()


class Program:
    """kmcuda_torch's two public calls, at verbosity 1, their log lines
    captured: the iteration lines and the kNN's examined fraction are the
    program's counters."""

    def __init__(self):
        import kmcuda_torch
        self.kmeans_fn = kmcuda_torch.kmeans_cuda
        self.knn_fn = kmcuda_torch.knn_cuda

    def kmeans(self, x, k, **kw):
        (c, a), lines = _captured(self.kmeans_fn, x, k, verbosity=1, **kw)
        return c, a, lines

    def knn(self, kk, x, c, a, **kw):
        nbr, lines = _captured(self.knn_fn, kk, x, c, a, verbosity=1, **kw)
        return nbr, lines


class StepControl(Program):
    """The control of a cell over several cards, where the whole reference
    k-means in the lower precision is not run: the program's call, with
    the assignment it returns computed again by the reference in
    ``precision`` against the centroids it returns, on ``devices``: the
    assignment as a lower-precision assignment pass would make it.  Only
    ``assign_gap`` reads that pass; the numbers that set the foreign
    assignment beside the program's centroids and iteration lines (the
    means, the churn, the stop) read the swap itself, not a precision."""

    def __init__(self, precision: str, devices):
        super().__init__()
        self.precision, self.devices = precision, list(devices)

    def kmeans(self, x, k, **kw):
        import torch
        from kmbench.reference import kmeans as RK
        c, a, lines = super().kmeans(x, k, **kw)
        ps = samples_on(x, self.devices)
        got = RK.map_parts(lambda s, xs: RK.assign(
            xs, c.to(xs.device), self.precision)[0].to(a.device, a.dtype),
            RK.parts(ps))
        del ps
        return c, torch.cat(got), lines


def control_program(cell, devices, precision=None):
    """The control of ``cell`` in ``precision`` (by default the one below
    the configuration's): the plain references put in the program's place
    on one device; over several cards :class:`StepControl`."""
    prec = precision or LOWER[cell.config["dtype"]]
    if len(devices) > 1:
        return StepControl(prec, devices)
    return ReferenceProgram(prec)


def samples_on(x, devices):
    """The samples as the references take them: ``x`` itself on one
    device; over several, its rows cut into one part a device, copied
    there."""
    if len(devices) == 1:
        return x
    from kmbench.reference import kmeans as RK
    return RK.shard(x, devices)


class ReferenceProgram:
    """The plain references put in the program's place, computed in
    ``precision``: with a precision below the configuration's, the control
    that the judgement has to fail."""

    def __init__(self, precision: str):
        self.precision = precision

    def kmeans(self, x, k, metric="L2", **kw):
        from kmbench.reference import kmeans as RK
        if metric != "L2":
            raise BenchError("the reference k-means is L2 only")
        return RK.kmeans(x, k, precision=self.precision, **kw)

    def knn(self, kk, x, c, a, metric="L2", **kw):
        from kmbench.reference import knn as RN
        return (RN.knn(kk, x, self.precision),
                ["calculated 1.000000 of all the distances"])


def iterations(lines) -> int:
    """The last iteration number the lines report (0 if none)."""
    t = 0
    for line in lines:
        m = ITERATION.match(line)
        if m:
            t = int(m.group(1))
    return t


def reassignments(lines) -> list:
    """The reassignment counts of the iteration lines, in order."""
    return [int(m.group(2)) for m in map(ITERATION.match, lines) if m]


def examined_fraction(lines):
    for line in lines:
        m = EXAMINED.match(line)
        if m:
            return float(m.group(1))
    return None


# --- data ------------------------------------------------------------------

def make_samples(config: dict, seed: int, device, host: bool = False,
                 out=None):
    """The configuration's samples, drawn on ``device`` from ``seed`` by a
    generator there, in fp32 a block of rows a call, then stored in the
    configuration's dtype: on ``device``, or with ``host`` each block
    copied into one host tensor, the same values: ``out`` (a tensor of the
    samples' shape and dtype, filled again), or a new one, page-locked
    where ``device`` is a card (:func:`page_locked`).  ``data`` (the
    generators of the program's ``bench_torch.py``, copied):

    - ``uniform``: U(0, 1) on every feature;
    - ``blobs``: ``blob_centers`` centers U(0, 1) * ``blob_spread``, each
      row a center picked uniformly plus 0.5 N(0, 1) noise.
    """
    import torch

    n, f = int(config["samples"]), int(config["features"])
    dtype = getattr(torch, config["dtype"])
    kind = config["data"]
    if kind not in ("uniform", "blobs"):
        raise BenchError("unknown data %r" % kind)
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    if kind == "blobs":
        centers = torch.rand((int(config["blob_centers"]), f), generator=g,
                             device=device) * float(config["blob_spread"])
    if host:
        x = out if out is not None else (
            page_locked((n, f), dtype) if device.type == "cuda"
            else torch.empty((n, f), dtype=dtype))
    else:
        x = torch.empty((n, f), dtype=dtype, device=device)
    for s in range(0, n, DATA_BLOCK_ROWS):
        rows = min(DATA_BLOCK_ROWS, n - s)
        if kind == "uniform":
            block = torch.rand((rows, f), generator=g, device=device)
        else:
            which = torch.randint(0, centers.shape[0], (rows,), generator=g,
                                  device=device)
            block = centers[which] + 0.5 * torch.randn(
                (rows, f), generator=g, device=device)
        if host:
            x[s:s + rows].copy_(block.to(dtype))
        else:
            x[s:s + rows] = block
    return x


def cell_samples(cell: Cell, seed: int, devices, out=None):
    """The cell's samples of ``seed``: on its one device, or, over several
    cards, in host memory (``out`` filled again where given)."""
    return make_samples(cell.config, seed, devices[0],
                        host=len(devices) > 1, out=out)


#: cudaHostRegisterPortable: page-locked for every card's context
REGISTER_PORTABLE = 1
#: threads that first touch a host tensor's pages
TOUCH_THREADS = 8


def page_locked(shape, dtype):
    """A host tensor page-locked for the rest of the process by one
    ``cudaHostRegister`` at its own size (torch's pinned allocator rounds
    a request up to a power of two: 102.4 GB to 137 GB; two registrations
    side by side fail the copies that cross them).  Its pages are touched
    first, by :data:`TOUCH_THREADS` threads: locking pages that are there
    runs ≈3× faster than locking and zeroing new ones."""
    import torch

    t = time.perf_counter()
    x = torch.empty(shape, dtype=dtype)
    flat = x.view(-1).view(torch.uint8)
    step = -(-flat.numel() // TOUCH_THREADS)
    with ThreadPoolExecutor(TOUCH_THREADS) as ex:
        list(ex.map(lambda s: flat[s:s + step].zero_(),
                    range(0, flat.numel(), step)))
    t1 = time.perf_counter()
    size = flat.numel()
    rc = torch.cuda.cudart().cudaHostRegister(x.data_ptr(), size,
                                              REGISTER_PORTABLE)
    rc = int(getattr(rc, "value", rc))
    if rc:
        raise BenchError("cudaHostRegister of %.1f GB failed: %r"
                         % (size / 1e9, rc))
    log("host samples: %.1f GB, pages touched in %.2f s, locked in %.2f s"
        % (size / 1e9, t1 - t, time.perf_counter() - t1))
    return x


def call_seeds(seed: int):
    """The seeds of a run's calls, in order: a function of the run's."""
    rng = random.Random(seed)
    while True:
        yield rng.randrange(1 << 31)


# --- one call --------------------------------------------------------------

class Call(NamedTuple):
    seed: int
    wall: float          # s, host clock, to the device's end
    lines: list
    out: tuple           # host copies, or None when not kept
    error: str


class Runner:
    """Makes the cell's call on its data with the program given."""

    def __init__(self, cell: Cell, program, x, devices):
        self.cell, self.program, self.x = cell, program, x
        self.devices = list(devices)
        cfg, tr = cell.config, cell.traffic
        self.k = int(cfg["clusters"])
        self.kind = tr["call"]
        self.kw = dict(tolerance=cfg["tolerance"], metric=cfg["metric"])
        self.kw.update(tr.get("kwargs", {}))
        if len(self.devices) > 1:
            if self.kind != "kmeans":
                raise BenchError("a %s cell over several cards has no "
                                 "judgement yet" % self.kind)
            self.kw["device"] = (1 << len(self.devices)) - 1
        self.knn_start = None

    def sync(self):
        import torch
        for d in dict.fromkeys(self.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def prepare(self, seed: int):
        """Set-up that the mix asks for before its calls: for a kNN mix,
        the k-means that gives its centroids and assignments."""
        if self.kind == "knn":
            kw = dict(tolerance=self.cell.config["tolerance"],
                      metric=self.cell.config["metric"])
            kw.update(self.cell.traffic["setup_kmeans"])
            c, a, lines = self.program.kmeans(self.x, self.k, seed=seed, **kw)
            self.knn_start = (c, a)
            self.sync()
            return lines
        return []

    def call(self, seed: int, **override):
        """One call; returns (outputs on the device, log lines)."""
        if self.kind == "kmeans":
            kw = dict(self.kw, **override)
            c, a, lines = self.program.kmeans(self.x, self.k, seed=seed, **kw)
            return (c, a), lines
        if self.kind == "knn":
            c, a = self.knn_start
            nbr, lines = self.program.knn(int(self.cell.traffic["neighbors"]),
                                          self.x, c, a,
                                          metric=self.cell.config["metric"])
            return (nbr,), lines
        raise BenchError("unknown call %r" % self.kind)

    def timed(self, seed: int, span=None) -> tuple:
        """(Call without outputs, outputs on the device or None)."""
        t0 = time.perf_counter()
        try:
            with span() if span else contextlib.nullcontext():
                out, lines = self.call(seed)
                self.sync()
        except Exception:  # a call that raises is counted as failed
            return Call(seed, time.perf_counter() - t0, [], None,
                        traceback.format_exc()), None
        return Call(seed, time.perf_counter() - t0, lines, None, ""), out


def window(runner: Runner, seeds, seconds: float, judged: int, rng,
           span=None, count=None) -> list:
    """Calls back to back until their walls add up to ``seconds`` (or
    ``count`` calls), stopping at a failed one.  Keeps host copies of the
    outputs of a seeded reservoir sample of ``judged`` calls and of the
    first call with the most iterations."""
    calls, slots, longest = [], [], None
    total = 0.0
    while (len(calls) < count if count is not None
           else total < seconds or not calls):
        c, out = runner.timed(next(seeds), span)
        total += c.wall
        i = len(calls)
        drop = []
        keep = False
        if i < judged:
            slots.append(i)
            keep = True
        else:
            j = rng.randrange(i + 1)
            if j < judged:
                drop.append(slots[j])
                slots[j] = i
                keep = True
        if not c.error and (longest is None or iterations(c.lines)
                            > iterations(calls[longest].lines)):
            drop.append(longest)
            longest, keep = i, True
        if keep and out is not None:
            c = c._replace(out=tuple(t.cpu() for t in out))
        del out
        calls.append(c)
        for j in drop:
            if j is not None and j != longest and j not in slots:
                calls[j] = calls[j]._replace(out=None)
        if c.error:
            break
    return calls


# --- the judgement ---------------------------------------------------------

def judge(runner: Runner, calls: list, more_seeds=()) -> dict:
    """The numbers compared, each against its limit: a sample of the
    window's results, and for its longest k-means call the same call
    stopped one iteration early and after one iteration (a call of these
    that raises is a failed call, and the numbers it gives read +inf).
    A mix with ``judged_starts`` has that many calls stopped after one
    iteration, for their k-means++ starts (the window's calls' seeds, then
    ``more_seeds``), and judges the weighting of their picks together; the
    rows of the first alone (the longest call's) are judged one by one.

    The means are judged by the numbers of them that the cell's limits
    name (:data:`MEAN_NUMBERS`; ``mean_gap`` where they name none), and
    ``init_shard_share`` (the first start's picks over the cards' row
    parts) where they name it."""
    import torch
    from kmbench.reference import kmeans as RK
    from kmbench.reference import knn as RN

    x = runner.x
    jdev = runner.devices[0]
    nums = {"failed_calls": sum(1 for c in calls if c.error)}
    kept = [c for c in calls if c.out is not None and not c.error]
    if not kept:
        nums["judged_calls"] = 0
        return nums
    nums["judged_calls"] = len(kept)
    if runner.kind == "knn":
        gap, bad = 0.0, 0
        for c in kept:
            g, b = RN.knn_gap(x, c.out[0].to(x.device))
            gap, bad = max(gap, g), bad + b
        nums["knn_gap"], nums["bad_ids"] = gap, bad
        return nums
    ref = samples_on(x, runner.devices)
    gap, bad = 0.0, 0
    for c in kept:
        g, b = RK.assign_gap(ref, c.out[0], c.out[1])
        gap, bad = max(gap, g), bad + b
    longest = max(kept, key=lambda c: iterations(c.lines))
    t = iterations(longest.lines)
    inf = float("inf")
    limits = runner.cell.limits
    mean_names = [m for m in MEAN_NUMBERS if m in limits] or ["mean_gap"]
    nums.update({m: inf for m in mean_names})
    nums.update(trajectory_differs=1, init_off_rows=inf, stop_early=inf,
                churn_differs=inf)
    k, n = runner.k, x.shape[0]
    a_prev = torch.full((n,), k, dtype=torch.int64, device=jdev)
    if t >= 2:
        try:
            (cp, ap), lines = runner.call(longest.seed, max_iterations=t - 1)
        except Exception:  # counted, and its numbers stay at +inf
            log("the call stopped one iteration early failed:\n"
                + traceback.format_exc())
            nums["failed_calls"] += 1
            return dict(nums, assign_gap=inf, bad_ids=bad)
        g, b = RK.assign_gap(ref, cp, ap)
        gap, bad = max(gap, g), bad + b
        got = RK.mean_numbers(ref, longest.out[0], ap)
        nums.update({m: got[m] for m in mean_names})
        mine = [l for l in lines if ITERATION.match(l)]
        full = [l for l in longest.lines if ITERATION.match(l)][:t - 1]
        nums["trajectory_differs"] = (sum(a != b for a, b in zip(mine, full))
                                      + abs(len(mine) - len(full)))
        a_prev = ap.to(jdev).long()
        del cp
    # the stop rule, on the last step's churn counted here
    counts = reassignments(longest.lines)
    churn = int((longest.out[1].to(jdev).long() != a_prev).sum())
    del a_prev
    nums["churn_differs"] = abs(churn - counts[-1]) if counts else inf
    nums["stop_early"] = RK.stop_early(
        counts[:-1] + [churn], int(float(runner.kw["tolerance"]) * n),
        runner.kw.get("max_iterations"))
    weigh = "judged_starts" in runner.cell.traffic
    n_starts = max(1, int(runner.cell.traffic.get("judged_starts", 1)))
    starts = ([longest.seed] + [c.seed for c in calls if not c.error
                                and c.seed != longest.seed])[:n_starts]
    more = iter(more_seeds)
    while len(starts) < n_starts:
        starts.append(next(more))
    off, rows = 0, []
    for i, seed in enumerate(starts):
        try:
            (c0, a0), _ = runner.call(seed, max_iterations=1)
        except Exception:  # counted, and its numbers stay at +inf
            log("the call stopped after one iteration failed:\n"
                + traceback.format_exc())
            nums["failed_calls"] += 1
            return dict(nums, assign_gap=inf, bad_ids=bad)
        r, o = RK.start_rows(ref, c0)
        if i == 0:
            g, b = RK.assign_gap(ref, c0, a0)
            gap, bad = max(gap, g), bad + b
            nums["init_off_rows"] = o
            if "init_shard_share" in limits:
                nums["init_shard_share"] = RK.shard_share(ref, r)
        else:
            off += o > 0
        rows.append(r)
        del c0, a0
    nums["assign_gap"], nums["bad_ids"] = gap, bad
    if weigh:
        # the further starts' rows picked twice are the program's known
        # fault (a chosen row keeps a rounding's distance to itself): a
        # count on the log, not a number compared
        log("k-means++ starts with a row off or picked twice: %d of the "
            "%d further starts" % (off, len(starts) - 1))
        nums["init_weight_shortfall"] = RK.weight_shortfall(
            ref, torch.stack(rows))
    return nums


def compare(nums: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number the limits do not name, or a limit with no number,
    fails."""
    checks, ok = {}, True
    for name in sorted(set(nums) | set(limits)):
        if name == "judged_calls":
            continue
        v, lim = nums.get(name), limits.get(name)
        good = (v is not None and lim is not None and not math.isnan(v)
                and v <= lim)
        ok = ok and good
        checks[name] = {"value": v, "limit": lim}
    if not nums.get("judged_calls"):
        ok = False
    return ok, checks


# --- the run ---------------------------------------------------------------

def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def log(msg: str) -> None:
    print("kmbench: " + msg, file=sys.stderr, flush=True)


def parse(argv):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, program,
             device, t0: float, warm: bool = True, x=None) -> dict:
    """One run; returns the result's fields (``correct`` ... ``checks``).
    ``device``: the cell's one device, or a list of its cards (the first
    makes the data).  ``x``: the samples of ``seed``, made already
    (:func:`cell_samples`), else made here."""
    import torch

    devices = list(device) if isinstance(device, (list, tuple)) else [device]
    device = devices[0]
    cards = [d for d in dict.fromkeys(devices) if d.type == "cuda"]
    rng = random.Random(seed ^ 0x5EED)
    if x is None:
        x = cell_samples(cell, seed, devices)
    log("samples made by %.2f s of set-up" % (time.perf_counter() - t0))
    runner = Runner(cell, program, x, devices)
    seeds = call_seeds(seed)
    prep_lines = runner.prepare(next(seeds))
    if prep_lines:
        log("set-up k-means: %d iterations" % iterations(prep_lines))
    if warm:
        w, _ = runner.timed(next(seeds))
        if w.error:
            log("warm call failed:\n" + w.error)
    cuda = device.type == "cuda"
    for d in cards:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    setup_s = time.perf_counter() - t0
    log("set-up %.2f s" % setup_s)
    judged = int(cell.traffic.get("judged_calls", 1))
    result = {}
    if not trace:
        calls = window(runner, seeds, seconds, judged, rng)
    else:
        from torch.profiler import ProfilerActivity, profile, record_function
        from kmbench import trace as TR
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            calls = window(runner, seeds, 0, judged, rng,
                           span=lambda: record_function(TR.CALL_SPAN),
                           count=int(cell.traffic["traced_calls"]))
        dev_ev, host_ev = TR.events(prof)
        del prof
    peaks = [torch.cuda.max_memory_allocated(d) if d.type == "cuda" else 0
             for d in devices]
    peak = max(peaks)
    ok_calls = [c for c in calls if not c.error]
    walls = sorted(c.wall for c in ok_calls)
    its = [iterations(c.lines) for c in ok_calls]
    log("%d calls, %d failed; walls %.4f-%.4f s; iterations a call %s"
        % (len(calls), len(calls) - len(ok_calls), walls[0] if walls else 0,
           walls[-1] if walls else 0,
           "%d-%d (mean %.2f)" % (min(its), max(its), sum(its) / len(its))
           if its and max(its) else "none reported"))
    for c in calls:
        if c.error:
            log("call failed:\n" + c.error)
    metrics = {}
    if not trace and walls:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": end_to_end(m["name"], walls, peak,
                                                      setup_s),
                                  "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else device.type,
        "count": len(devices), "memory_peak_bytes": int(peak)}
    if len(devices) > 1:
        device_info["memory_peak_bytes_per_card"] = [int(p) for p in peaks]
    if trace:
        spans = [(e.start, e.end) for e in host_ev if e.name == TR.CALL_SPAN]
        window_s = sum(b - a for a, b in spans) / 1e9
        busy_s = TR.busy_ns(dev_ev, spans, len(devices)) / 1e9
        device_info["busy_s"], device_info["window_s"] = busy_s, window_s
        if len(devices) > 1:
            per = TR.busy_ns_per_card(dev_ev, spans)
            device_info["busy_s_per_card"] = [
                per.get(d.index, 0) / 1e9 for d in cards]
            for d, ev in TR.by_card(dev_ev).items():
                log("card %d: busy %.4f of %.4f s; %s" % (
                    d, per[d] / 1e9, window_s, ", ".join(
                        "%s %.4f s" % (nm, t)
                        for nm, t in TR.device_ops(ev, spans, top=6))))
        run = TraceRun(cell, [c for c in calls], spans, dev_ev, host_ev,
                       window_s, busy_s)
        for m in cell.per_layer:
            v = metric_reader(cell.bench_dir, m["name"])(run)
            if v is None:
                log("per-layer metric %s: nothing to read" % m["name"])
            else:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["breakdown"] = {
            "device_ops": TR.device_ops(dev_ev, spans, cards=len(devices)),
            "idle_gaps": TR.idle_gaps(dev_ev, host_ev, spans,
                                      cards=len(devices))}
        del dev_ev, host_ev
    # the program's state goes before the references run
    gc.collect()
    for d in cards:
        torch.cuda.synchronize(d)
        with torch.cuda.device(d):
            torch.cuda.empty_cache()
    tj = time.perf_counter()
    nums = judge(runner, calls, seeds)
    log("judged %d calls in %.2f s" % (nums.get("judged_calls", 0),
                                      time.perf_counter() - tj))
    correct, checks = compare(nums, cell.limits)
    return dict(correct=correct, attempted=len(calls),
                failed=len(calls) - len(ok_calls), metrics=metrics,
                device=device_info, **result, checks=checks)


def end_to_end(name: str, walls: list, peak: int, setup_s: float) -> float:
    """An end-to-end metric by its name: ``setup_s``; ``peak_gb``, the
    window's peak of allocated card memory in GB; ``<what>_p95_s``, the
    95th percentile (nearest rank) of the calls' walls; any other
    ``<what>_s``, the mean wall of a call over all the window's calls."""
    if name == "setup_s":
        return setup_s
    if name == "peak_gb":
        return peak / 1e9
    if name.endswith("_p95_s"):
        return walls[math.ceil(0.95 * len(walls)) - 1]
    if name.endswith("_s"):
        return sum(walls) / len(walls)
    raise BenchError("no rule for the end-to-end metric %r" % name)


class TraceRun(NamedTuple):
    """What a per-layer metric reader gets: the cell, the traced calls
    (each with its log lines) and their spans (ns, in call order), the
    device and host events, and the traced window's seconds and its
    device-busy seconds."""
    cell: Cell
    calls: list
    spans: list
    device_events: list
    host_events: list
    window_s: float
    busy_s: float


def main(argv, root: pathlib.Path, t0: float, program=None,
         device=None) -> int:
    """Runs one cell; prints the result as the last line of stdout.
    ``program`` and ``device`` default to kmcuda_torch on the cell's cards
    (cuda:0 ...), and a run with no card, or fewer than the cell asks
    for, fails.  A ``device`` given stands for each of the cell's cards
    (a test's logical devices)."""
    args = parse(argv)
    try:
        cell = find_cell(root, args.workload)
        import torch
        if device is None:
            if not torch.cuda.is_available():
                raise BenchError("no CUDA card: torch.cuda.is_available() "
                                 "is false")
            if torch.cuda.device_count() < cell.chips:
                raise BenchError("the cell asks for %d cards, %d present"
                                 % (cell.chips, torch.cuda.device_count()))
            devices = [torch.device("cuda", i) for i in range(cell.chips)]
        else:
            devices = [device] * cell.chips
        device = devices[0]
        if program is None:
            program = Program()
            import kmcuda_torch
            where = pathlib.Path(kmcuda_torch.__file__).resolve()
            if root.resolve() not in where.parents:
                raise BenchError("kmcuda_torch comes from %s, outside the "
                                 "checkout %s" % (where, root))
        res = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       program, devices, t0)
    except BenchError as e:
        log("error: %s" % e)
        return 2
    found = forbidden_modules()
    if found:
        log("error: modules loaded that the run may not load: %s"
            % ", ".join(found))
        return 3
    if device.type == "cuda":
        log("card: %s (power limit as read); bounds assume %s W" % (
            power_limit() or "not read", _roofline().POWER_LIMIT_W))
    import torch
    log("host threads for torch's CPU ops: %d" % torch.get_num_threads())
    for c in res["checks"].values():
        c["value"] = _finite(c["value"])
    for name, c in res["checks"].items():
        log("check %s: %r (limit %r)" % (name, c["value"], c["limit"]))
    print(json.dumps(res, allow_nan=False), flush=True)
    return 0


def _finite(v):
    """A number JSON can carry: a non-finite one as its name."""
    return v if v is None or math.isfinite(v) else repr(float(v))


def _roofline():
    from kmbench import roofline
    return roofline
