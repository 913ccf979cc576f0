#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's k-means and kNN paths once on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``kmcuda_torch/csrc`` (nvcc, one
process per source, at first use), prints ptxas's registers, shared
memory and spills of the assignment kernel, requires ``HGMMA`` (wgmma) in
the SASS of both its instantiations, and holds each kernel against its
plain-torch twin on the card; B2 must also give a gathered subset of the
rows bitwise the results it gives them in a launch over all rows (the
Yinyang loop rests on it), and its best scores are measured against fp64
in ulps.  Each kernel is timed in turns with its twin and, where one
exists, a library yardstick (plain, kernel, kernel, plain, library),
beside its bound from ``roofline.py`` (beside this script).

Lloyd: the public ``kmeans_cuda`` at the reference benchmark's headline
configuration (100,000 x 256 fp32, k=1024, random init, seed 1, tolerance
0.002, 15 iterations), a 5-iteration restart from its centroids (so the
low-churn arm runs) and a 1,000,000 x 256 bf16 run.

The default call, ``kmeans_cuda(x, 1024)`` (k-means++ and Yinyang), on the
headline data (seed 1, tolerance 0.002, at most 60 iterations) against
the same call with ``yinyang_t=0``: identical assignments, centroids and
iteration lines, and B2 launched by the Yinyang loop (both walls are
timed from one imported k-means++ start); the same at
1,000,000 x 256 bf16 (random init, tolerance 0, 30 iterations); AFK-MC2
at the JAX bench's spherical configuration (1,000,000 x 256 unit rows,
cosine, k=1024, m=100); and Yinyang on a CUDA and a CPU tensor of the 13K
blob fixture from one start.

kNN: the JAX bench's configuration (1,000,000 x 256 fp32 blobs, k=1024,
16 neighbours) through the public ``knn_cuda``, clustered from the blob
centers and, as the JAX bench seeds it, by AFK-MC2 (m=200); recall
against a brute force on the card; and the same call on a CUDA and a CPU
tensor of the 13K blob fixture.

Prints the card's name and power limit beside every time, a JSON line of
the kernels, and as its last line a JSON object with ``"ok": true``.  Any
failure raises, so the exit code is non-zero; so it is without a CUDA
device, or outside a checkout of the repository.

Tolerances (kernel vs plain twin on the same tensors):
- B2 on a gathered subset of the rows: assignments and best scores
  bitwise equal to B2's over all rows.
- Yinyang against Lloyd: bitwise equal (centroids NaN-aware); card
  against CPU: identical assignments and iteration lines, centroids
  within rtol 1e-5 / atol 1e-6.
- B1/B2: assignments equal except at near-ties
  (``ops.assign_kernels.near_ties``: consecutive plain top-3 scores within
  1e-5 * max(1, |s1|), or the rescore's two exact squared distances within
  1e-5 * max(1, d2)); best scores rtol 1e-5; sums rtol 1e-5 and atol
  1e-5 * mean |x| (fp32 sums in another order), always against the plain
  segment sum of the kernel's own assignment; counts and reassignment
  counts equal to the plain count of the kernel's assignment, and to the
  plain twin's where the assignments are equal.
- B3 (``ops.knn_kernels.compare_walks``, after the shared exact rescore):
  per-chunk examined counts equal unless the step where the walks part has
  its bound within 1e-5 relative of tau; neighbour ids equal except where
  their fp64 distance profiles agree to rtol 1e-6 (ties) or, for bf16
  cosine alone (ROADMAP §C6), where the two candidate buffers part only at
  their kk-th walk distance, within a change of the dot products by
  2^-20 sum_j |q_j m_j| (``walk_tie``), and on those rows the kernel finds
  at least as many exact fp64 neighbours as the twin (``exact_hits``);
  distances rtol 1e-6 where the ids are equal.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from kmcuda_torch import kmeans_cuda, knn_cuda
from kmcuda_torch.models import initialization as I
from kmcuda_torch.models import knn as TK
from kmcuda_torch.models import yinyang as Y
from kmcuda_torch.models.problem import prepare
from kmcuda_torch.ops import _build
from kmcuda_torch.ops import assign_kernels as K
from kmcuda_torch.ops import distance as D
from kmcuda_torch.ops import knn_kernels as KK
from kmcuda_torch.ops.assign import pad_clusters
from kmcuda_torch.utils.logging import Logger
import roofline as R

HEADLINE = dict(n=100_000, f=256, k=1024)
BF16_RUN = dict(n=1_000_000, f=256, k=1024)
RAGGED = dict(n=100_003, f=250, k=1000)
KNN_BENCH = dict(n=1_000_000, f=256, k=1024, kn=16)
KNN_RAGGED = dict(n=100_003, f=250, k=1000, kn=10)
KNN_WIDE = dict(n=16_384, f=2_560, k=16, kn=200)
SPHERICAL = dict(n=1_000_000, f=256, k=1024, m=100)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of card 0."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


def make_inputs(n, f, k, dtype, metric, ragged, seed):
    """Samples, valid mask, random previous assignment and centroids (near
    sample rows) on the card; ``ragged`` adds 10 invalid rows and a NaN
    centroid."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    x = torch.rand(n, f, generator=g, device=dev)
    if metric == D.DistanceMetric.COSINE:
        x = x / x.norm(dim=1, keepdim=True)
    c = x[torch.randperm(n, generator=g, device=dev)[:k]] \
        + 0.01 * torch.rand(k, f, generator=g, device=dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    if ragged:
        rows = torch.randperm(n, generator=g, device=dev)[:10]
        x[rows] = 0                  # NaN rows, as prepare() leaves them
        valid[rows] = False
        c[7] = float("nan")          # an empty cluster's centroid
    prev = torch.randint(0, k + 1, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    return x.to(dtype).contiguous(), valid, prev, c


# (shape, ragged, dtypes, metrics) held kernel against plain twin: the
# headline shape, a ragged edge with invalid rows and a NaN centroid, and
# the 1M-row bf16 main-path shape, where the segment sum's scratch cap
# sets its number of row ranges
KERNEL_CASES = (
    (HEADLINE, False, (torch.float32, torch.bfloat16),
     (D.DistanceMetric.L2, D.DistanceMetric.COSINE)),
    (RAGGED, True, (torch.float32, torch.bfloat16),
     (D.DistanceMetric.L2, D.DistanceMetric.COSINE)),
    (BF16_RUN, False, (torch.bfloat16,), (D.DistanceMetric.L2,)),
)


def check_kernels(errs):
    """Kernel vs plain twin, B1 == B2 bitwise, B1 sums repeat bitwise.

    B1's sums, counts and reassignment count are always held against the
    plain segment sum and count of B1's own assignment, which no near-tie
    can change; where no assignment differs from the plain twin's they
    are also held against the twin's."""
    for shape, ragged, dtypes, metrics in KERNEL_CASES:
        for dtype in dtypes:
            for metric in metrics:
                n, f, k = shape["n"], shape["f"], shape["k"]
                x, valid, prev, c = make_inputs(n, f, k, dtype, metric,
                                                ragged, 7)
                kw = dict(n_clusters=k, metric=metric)
                ref = K.fused_lloyd_pass_reference(x, valid, prev, c, **kw)
                b1 = K.fused_lloyd_pass(x, valid, prev, c, **kw)
                b2 = K.assign_only_pass(x, valid, prev, c, **kw)
                b1_again = K.fused_lloyd_pass(x, valid, prev, c, **kw)
                torch.cuda.synchronize()
                differ = b1[0] != ref[0]
                ties = K.near_ties(x, c, metric)
                bad = int((differ & ~ties).sum())
                if bad:
                    raise AssertionError("%d assignments differ off ties"
                                         % bad)
                same = ~differ
                torch.testing.assert_close(b1[1][same], ref[1][same],
                                           rtol=1e-5, atol=0)
                best_err = float((b1[1][same] - ref[1][same]).abs().max())
                atol = 1e-5 * float(x.float().abs().mean())
                sums_own, counts_own = K.segment_sum_reference(x, b1[0], k)
                if not torch.equal(b1[3], counts_own):
                    raise AssertionError("counts differ from the plain count "
                                         "of the kernel's assignment")
                if int(b1[4]) != int((b1[0] != prev).sum()):
                    raise AssertionError("changed differs from the plain "
                                         "count of the kernel's assignment")
                torch.testing.assert_close(b1[2], sums_own, rtol=1e-5,
                                           atol=atol)
                sums_err = float((b1[2] - sums_own).abs().max())
                if not differ.any():
                    if not (torch.equal(b1[3], ref[3])
                            and int(b1[4]) == int(ref[4])):
                        raise AssertionError("counts or changed differ")
                    torch.testing.assert_close(b1[2], ref[2], rtol=1e-5,
                                               atol=atol)
                if not (torch.equal(b1[0], b2[0]) and torch.equal(b1[1], b2[1])
                        and int(b1[4]) == int(b2[2])):
                    raise AssertionError("B1 and B2 differ")
                if not torch.equal(b1[2], b1_again[2]):
                    raise AssertionError("B1 sums do not repeat bitwise")
                plan = K.segment_plan(n, f, k, x.element_size())
                if ragged and not bool((b1[0][~valid] == k).all()):
                    raise AssertionError("invalid rows not assigned k")
                errs["fused_lloyd_pass"] = max(
                    errs["fused_lloyd_pass"], best_err, sums_err)
                errs["assign_only_pass"] = max(
                    errs["assign_only_pass"], best_err)
                print("check %dx%d k=%d %s %s: ok; %d near-tie rows, %d "
                      "assignments differ there; max |d best| %.3g, max "
                      "|d sums| %.3g (%d chunks of %d rows); B1 == B2 "
                      "bitwise; B1 sums repeat bitwise"
                      % (n, f, k, str(dtype)[6:], metric.name,
                         int(ties.sum()), int(differ.sum()), best_err,
                         sums_err, -(-n // plan.chunk), plan.chunk), flush=True)
                del x, valid, prev, c, ref, b1, b2, b1_again, sums_own


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: the kernels whose ptxas lines kernel_report prints
KERNEL_NAMES = ("assign_kernel", "walk_kernel", "seg_count_kernel",
                "seg_scan_kernel", "seg_starts_kernel", "seg_place_kernel",
                "seg_reduce_kernel", "seg_fix_kernel")


def _kernel_name(mangled: str):
    """'assign_kernel<bf16>' etc. for a mangled name, or None."""
    for name in KERNEL_NAMES:
        if name in mangled:
            if name in ("assign_kernel", "walk_kernel", "seg_reduce_kernel"):
                return "%s<%s>" % (name, "bf16" if "nv_bfloat16" in mangled
                                   else "float")
            return name
    return None


def kernel_report():
    """ptxas's registers, shared memory and spills of every kernel (from
    the build log), the HGMMA (wgmma) instructions in the SASS of the
    assignment and walk kernels (``cuobjdump -sass`` of the built library),
    and the float atomics in the segment sum's SASS; fails unless both
    instantiations of each run on wgmma and the segment sum has no float
    atomic.  Returns the HGMMA counts."""
    log = _build.build_log_path().read_text().splitlines()
    for i, line in enumerate(log):
        name = ("Compiling entry function" in line) and _kernel_name(line)
        if name:
            print("ptxas %s: %s; %s"
                  % (name, log[i + 3].split(":", 1)[1].strip(),
                     log[i + 2].strip()), flush=True)
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path())],
                          capture_output=True, text=True, check=True).stdout
    counts = {}
    float_atomics = 0
    for section in sass.split("Function : ")[1:]:
        name = _kernel_name(section.split("\n", 1)[0])
        if name and not name.startswith("seg_"):
            counts[name] = section.count("HGMMA")
        elif name:
            float_atomics += sum(
                1 for l in section.splitlines()
                if ("ATOM" in l or "RED" in l) and "F32" in l)
    print("SASS HGMMA instructions: %s; float atomics in the segment sum: "
          "%d" % (", ".join("%s %d" % kv for kv in sorted(counts.items())),
                  float_atomics), flush=True)
    for name in ("assign_kernel<bf16>", "assign_kernel<float>",
                 "walk_kernel<bf16>", "walk_kernel<float>"):
        if not counts.get(name):
            raise AssertionError("%s does not run on wgmma" % name)
    if float_atomics:
        raise AssertionError("the segment sum has float atomics")
    return counts


def score_ulps(rows=4096):
    """B2's best scores against fp64 on the first ``rows`` rows of the
    headline inputs, in ulps of the fp32 score, beside the plain twin's.
    The fp64 score takes the panel in the storage dtype and the fp32
    |c|^2, as both do.  Returns the largest kernel error."""
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for metric in (D.DistanceMetric.L2, D.DistanceMetric.COSINE):
            n, f, k = HEADLINE["n"], HEADLINE["f"], HEADLINE["k"]
            x, valid, prev, c = make_inputs(n, f, k, dtype, metric, False,
                                            7)
            x, valid, prev = x[:rows], valid[:rows], prev[:rows]
            kw = dict(n_clusters=k, metric=metric)
            got = K.assign_only_pass(x, valid, prev, c, **kw)
            ref = K.assign_only_pass_reference(x, valid, prev, c, **kw)
            panel, c_sq = pad_clusters(c, dtype)
            out = []
            for aid, best in (got[:2], ref[:2]):
                a = aid.long()
                prod = (x.double() * panel.double()[a]).sum(dim=1)
                s64 = -prod if metric == D.DistanceMetric.COSINE \
                    else c_sq.double()[a] - 2.0 * prod
                mag = s64.abs().float()
                ulp = (torch.nextafter(mag, torch.full_like(mag, np.inf))
                       - mag).double()
                out.append(((best.double() - s64).abs() / ulp))
            print("score error vs fp64, %d rows %dx%d k=%d %s %s: kernel "
                  "max %.2f ulps (mean %.3f), plain twin max %.2f (mean "
                  "%.3f)" % (rows, n, f, k, str(dtype)[6:], metric.name,
                             float(out[0].max()), float(out[0].mean()),
                             float(out[1].max()), float(out[1].mean())),
                  flush=True)
            worst = max(worst, float(out[0].max()))
    return worst


def time_kernels(tag, shape, dtype, reps):
    """B1, B2 and B1's segment sum at one main-path shape, each in turns
    with its plain twin and library yardstick (plain, kernel, kernel,
    plain, library); returns {name: {ms, plain_ms, library_ms, library,
    bound_ms, bound_by}}.  B2's yardstick is ``torch.matmul(x, panel.T)``
    in the storage dtype: the score product only.  The segment sum's is
    ``torch.zeros(k, f).index_add_(0, aid, x.float())``; the kernel is
    launched through ``K.launch_segment_sum``, which counts no launch.  B1
    has none: no single call scores, picks and sums."""
    n, f, k = shape["n"], shape["f"], shape["k"]
    x, valid, prev, c = make_inputs(n, f, k, dtype, D.DistanceMetric.L2,
                                    False, 11)
    kw = dict(n_clusters=k, metric=D.DistanceMetric.L2)
    panel, _c_sq = pad_clusters(c, dtype)
    aid = K.assign_only_pass(x, valid, prev, c, **kw)[0]
    aid_long = aid.long()
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    name_dt = str(dtype)[6:]
    fns = {
        "fused_lloyd_pass": (
            lambda: K.fused_lloyd_pass(x, valid, prev, c, **kw),
            lambda: K.fused_lloyd_pass_reference(x, valid, prev, c, **kw),
            None, None, R.fused_bound(n, f, k, name_dt)),
        "assign_only_pass": (
            lambda: K.assign_only_pass(x, valid, prev, c, **kw),
            lambda: K.assign_only_pass_reference(x, valid, prev, c, **kw),
            lambda: torch.matmul(x, panel.T),
            "torch.matmul(x, panel.T), product only",
            R.assign_bound(n, f, k, name_dt)),
        "segment_sum": (
            lambda: K.launch_segment_sum(lib, x, aid, k, stream),
            lambda: K.segment_sum_reference(x, aid, k),
            lambda: torch.zeros((k, f), device=x.device).index_add_(
                0, aid_long, x.float()),
            "torch.zeros(k, f).index_add_(0, aid, x.float())",
            R.segment_sum_bound(n, f, k, name_dt)),
    }
    out = {}
    for name, (kern, plain, library, label, bnd) in fns.items():
        p1 = time_ms(plain, reps)
        k1 = time_ms(kern, reps)
        k2 = time_ms(kern, reps)
        p2 = time_ms(plain, reps)
        lib_ms = time_ms(library, reps) if library else None
        out[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                     "library_ms": lib_ms, "library": label,
                     "bound_ms": bnd["ms"], "bound_by": bnd["by"]}
        print("%s time %s %dx%d k=%d %s: kernel %.4f ms (%.4f/%.4f), plain "
              "%.4f ms (%.4f/%.4f), library %s, bound %.4f ms (%s; %.4g "
              "bytes, %s)"
              % (tag, name, n, f, k, name_dt, out[name]["ms"], k1, k2,
                 out[name]["plain_ms"], p1, p2,
                 "%.4f ms (%s)" % (lib_ms, label) if lib_ms else "none",
                 bnd["ms"], bnd["by"], bnd["bytes"],
                 ", ".join("%.4g %s" % (v, kind)
                           for kind, v in bnd["ops"].items())), flush=True)
    del x, valid, prev, c, panel, aid, aid_long
    return out


def check_result(x, k, c, a, metric):
    """Centroids finite or NaN rows of empty clusters (never assigned),
    assignments in [0, k), and equal to the plain assignment against the
    centroids they were computed with, off near-ties.  For fp32 those are
    the returned centroids; bf16 input gets them back rounded to bf16, so
    there the check restarts one iteration from the returned centroids
    through the same public call, whose assignment is computed against
    exactly them.  Returns (empty clusters, near-tie rows that differ)."""
    nan_rows = torch.isnan(c).any(dim=1)
    if not bool((torch.isnan(c).all(dim=1) | torch.isfinite(c).all(dim=1))
                .all()):
        raise AssertionError("centroid rows mix NaN and numbers")
    if int(a.min()) < 0 or int(a.max()) >= k:
        raise AssertionError("assignments out of [0, k)")
    if bool(nan_rows[a.long()].any()):
        raise AssertionError("a sample is assigned to a NaN centroid")
    c_used = c.float()
    if c.dtype != torch.float32:
        _c, a = kmeans_cuda(x, k, init=c_used, tolerance=0.0, yinyang_t=0,
                            max_iterations=1)
    valid = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    ref, _best, _ch = K.assign_only_pass_reference(
        x, valid, a, c_used, n_clusters=k, metric=metric)
    differ = ref != a
    if bool((differ & ~K.near_ties(x, c_used, metric)).any()):
        raise AssertionError("final assignment is not the argmin against "
                             "the centroids it was computed with")
    return int(nan_rows.sum()), int(differ.sum())


def count_iterations(out: str) -> int:
    return sum(1 for l in out.splitlines() if l.startswith("iteration "))


def iteration_lines(out: str) -> list:
    return [l for l in out.splitlines() if l.startswith("iteration ")]


def check_row_independence():
    """B2 over all rows and over a gathered, sorted random 10% of them
    gives those rows bitwise the same assignments and best scores, at the
    headline shape in fp32 and at 1M x 256 in bf16."""
    for shape, dtype in ((HEADLINE, torch.float32),
                         (BF16_RUN, torch.bfloat16)):
        n, f, k = shape["n"], shape["f"], shape["k"]
        x, valid, prev, c = make_inputs(n, f, k, dtype, D.DistanceMetric.L2,
                                        False, 3)
        kw = dict(n_clusters=k, metric=D.DistanceMetric.L2)
        full = K.assign_only_pass(x, valid, prev, c, **kw)
        g = torch.Generator(device="cuda").manual_seed(5)
        rows = torch.sort(torch.randperm(n, generator=g,
                                         device="cuda")[:n // 10]).values
        sub = K.assign_only_pass(x[rows], valid[rows], prev[rows], c, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(sub[0], full[0][rows])
                and torch.equal(sub[1], full[1][rows])):
            raise AssertionError("B2 on gathered rows differs from B2 over "
                                 "all rows")
        if int(sub[2]) != int((full[0][rows] != prev[rows]).sum()):
            raise AssertionError("B2 on gathered rows miscounts changes")
        print("check B2 row independence %dx%d k=%d %s: %d gathered rows "
              "bitwise equal to the launch over all rows"
              % (n, f, k, str(dtype)[6:], rows.numel()), flush=True)
        del x, valid, prev, c, full, sub, rows


def nan_equal(a, b) -> bool:
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


def run_marked(fn):
    """Run ``fn`` with stdout captured and the launch counts set to 0;
    returns (result, log, launches, marks): ``marks`` are the counts when
    the Yinyang grouping starts and ends, so the counts after the second
    mark are the Yinyang loop's."""
    marks = []
    group = Y._group_centroids

    def marked(*args, **kwargs):
        marks.append(dict(K.LAUNCHES))
        out = group(*args, **kwargs)
        marks.append(dict(K.LAUNCHES))
        return out

    Y._group_centroids = marked
    K.reset_launch_counts()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out = fn()
        torch.cuda.synchronize()
    finally:
        Y._group_centroids = group
    return out, buf.getvalue(), dict(K.LAUNCHES), marks


def yinyang_vs_lloyd(label, x, k, metric, **kw):
    """The same call with yinyang_t=0.1 and 0 (verbosity 2): identical
    assignments, centroids and iteration lines, and the Yinyang loop
    launched B2.  Returns ((c, a), Yinyang log, Yinyang launches, Lloyd
    launches)."""
    yy, yy_log, yy_n, marks = run_marked(lambda: kmeans_cuda(
        x, k, yinyang_t=0.1, metric=metric, verbosity=2, **kw))
    ll, ll_log, ll_n, _ = run_marked(lambda: kmeans_cuda(
        x, k, yinyang_t=0, metric=metric, verbosity=2, **kw))
    print(yy_log, end="", flush=True)
    if len(marks) != 2:
        raise AssertionError("%s: the Yinyang loop was not entered" % label)
    loop = {name: yy_n[name] - marks[1][name] for name in yy_n}
    if loop["assign_only_pass"] == 0:
        raise AssertionError("%s: the Yinyang loop never launched B2"
                             % label)
    if iteration_lines(yy_log) != iteration_lines(ll_log):
        raise AssertionError("%s: Yinyang and Lloyd iteration lines differ"
                             % label)
    if not (torch.equal(yy[1], ll[1]) and nan_equal(yy[0], ll[0])):
        raise AssertionError("%s: Yinyang and Lloyd results differ" % label)
    empty, ties = check_result(x, k, yy[0], yy[1], metric)
    print("%s: Yinyang == Lloyd bitwise (assignments, centroids, %d "
          "iteration lines); launches: draft %s, grouping %s, Yinyang loop "
          "%s, Lloyd run %s; %d empty clusters, %d near-tie rows differ "
          "from the plain argmin"
          % (label, count_iterations(yy_log), marks[0],
             {n: marks[1][n] - marks[0][n] for n in marks[0]}, loop, ll_n,
             empty, ties), flush=True)
    return yy, yy_log, yy_n, ll_n


def yinyang_profile(log: str) -> str:
    """The phase times, the Yinyang loop's ms per iteration and its
    per-iteration candidate/passed counts of a verbosity-2 Yinyang log."""
    lines = log.splitlines()
    phases = [l.split("yinyang: ")[1] for l in lines
              if l.startswith("yinyang: ") and (" phase " in l
                                                or "main loop" in l)]
    counts = ["%s/%s" % (l.split()[1], l.split()[3])
              for l in lines if "passed the global" in l]
    loop_s = [float(l.split()[3]) for l in lines
              if l.startswith("yinyang: main loop ")]
    per_it = ("%.3f" % (1e3 * loop_s[0] / len(counts))
              if loop_s and counts else "-")
    return ("%s; Yinyang loop %s ms per iteration; candidates/passed per "
            "Yinyang iteration: %s" % ("; ".join(phases), per_it,
                                       " ".join(counts)))


def timed_init(x, k, metric, method, seed, m=0):
    """Seconds of one init on a prepared problem, synchronized, and its
    centroids."""
    p = prepare(x, k, metric, x.device, Logger(0))
    torch.cuda.synchronize()
    t = time.perf_counter()
    c = I.init_centroids(p, method, seed, afkmc2_m=m)
    torch.cuda.synchronize()
    return time.perf_counter() - t, c


def wall_s(fn) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def default_call_phase(tag, x):
    """``kmeans_cuda(x, 1024)`` with every default (k-means++, Yinyang)
    against ``yinyang_t=0`` on the headline data; then both walls from one
    imported k-means++ start, so the init's host-paced time stays out of
    their ratio.  Returns the launch counts of the default calls."""
    k = HEADLINE["k"]
    kw = dict(seed=1, tolerance=0.002, max_iterations=60)
    L2 = D.DistanceMetric.L2
    timed_init(x, k, L2, I.InitMethod.PLUS_PLUS, 1)
    pp_s, c0 = timed_init(x, k, L2, I.InitMethod.PLUS_PLUS, 1)
    _out, log, yy_n, ll_n = yinyang_vs_lloyd(
        "default call 100000x256 fp32 k=1024", x, k, L2, **kw)
    walls = {0.1: [], 0: []}
    for _ in range(3):
        for yt in (0, 0.1):
            walls[yt].append(wall_s(lambda: kmeans_cuda(
                x, k, init=c0, yinyang_t=yt, tolerance=0.002,
                max_iterations=60)))
    yy_s, ll_s = min(walls[0.1]), min(walls[0])
    its = count_iterations(log)
    print("%s default call 100000x256 fp32 k=1024 (k-means++, tolerance "
          "0.002, %d iterations): k-means++ %.4f s; from its centroids "
          "imported: Yinyang wall %.4f s (min of 3: %s), Lloyd wall %.4f s "
          "(min of 3: %s, %.3f ms per iteration), Yinyang / Lloyd %.3f; %s"
          % (tag, its, pp_s, yy_s,
             ", ".join("%.4f" % w for w in walls[0.1]), ll_s,
             ", ".join("%.4f" % w for w in walls[0]), 1e3 * ll_s / its,
             yy_s / ll_s, yinyang_profile(log)), flush=True)
    return yy_n, ll_n


def bf16_yinyang_phase(tag, xb):
    """Yinyang == Lloyd at 1M x 256 bf16 (random init, tolerance 0, 30
    iterations); returns the launch counts of both runs."""
    k = BF16_RUN["k"]
    kw = dict(init="random", seed=1, tolerance=0.0, max_iterations=30)
    _out, log, yy_n, ll_n = yinyang_vs_lloyd(
        "1000000x256 bf16 k=1024 Yinyang", xb, k, D.DistanceMetric.L2, **kw)
    yy_s = wall_s(lambda: kmeans_cuda(xb, k, yinyang_t=0.1, **kw))
    ll_s = wall_s(lambda: kmeans_cuda(xb, k, yinyang_t=0, **kw))
    print("%s 1000000x256 bf16 k=1024, 30 iterations: Yinyang wall %.4f s, "
          "Lloyd wall %.4f s (one run each), Yinyang / Lloyd %.3f; %s"
          % (tag, yy_s, ll_s, yy_s / ll_s, yinyang_profile(log)),
          flush=True)
    return yy_n, ll_n


def spherical_phase(tag):
    """AFK-MC2 at the JAX bench's spherical configuration
    (bench.py:180-191); returns the call's launch counts."""
    s = SPHERICAL
    cos = D.DistanceMetric.COSINE
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(s["n"], s["f"], generator=g, device="cuda")
    x = x / x.norm(dim=1, keepdim=True)
    init_s, _ = timed_init(x, s["k"], cos, I.InitMethod.AFKMC2, 7, s["m"])
    K.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t = time.perf_counter()
        c, a = kmeans_cuda(x, s["k"], init=("afkmc2", s["m"]), seed=7,
                           metric="cos", tolerance=0.01, yinyang_t=0,
                           max_iterations=20, verbosity=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launches = dict(K.LAUNCHES)
    log = buf.getvalue()
    print(log, end="", flush=True)
    empty, ties = check_result(x, s["k"], c, a, cos)
    print("%s spherical 1000000x256 cos k=1024 AFK-MC2 (m=%d), tolerance "
          "0.01, %d iterations: init %.4f s, wall %.4f s (one run, init "
          "included); launches %s; %d empty clusters, %d near-tie rows "
          "differ from the plain argmin"
          % (tag, s["m"], count_iterations(log), init_s, wall, launches,
             empty, ties), flush=True)
    return launches


def blob_fixture():
    """The 13K blob mixture of tests/test_kmeans.py."""
    rng = np.random.RandomState(0)
    xs = np.empty((13000, 2), dtype=np.float32)
    xs[:2000] = rng.rand(2000, 2) + [0, 0.5]
    xs[2000:4000] = rng.rand(2000, 2) + [0, 1.5]
    xs[4000:6000] = rng.rand(2000, 2) - [0, 0.5]
    xs[6000:8000] = rng.rand(2000, 2) + [0.5, 0]
    xs[8000:10000] = rng.rand(2000, 2) - [0.5, 0]
    xs[10000:] = rng.rand(3000, 2) * 5 - [2, 2]
    return xs


def check_small_yinyang_agreement():
    """Yinyang on a CUDA and a CPU tensor of the 13K fixture (k=50,
    tolerance 0.002) from one imported start: identical assignments and
    iteration lines, centroids within rtol 1e-5 / atol 1e-6, and the
    card run launches B2."""
    xs = blob_fixture()
    c0 = torch.from_numpy(xs[np.random.RandomState(2).choice(13000, 50,
                                                             replace=False)])
    kw = dict(tolerance=0.002, yinyang_t=0.1, verbosity=1)
    (c_gpu, a_gpu), log_gpu, launches, marks = run_marked(
        lambda: kmeans_cuda(torch.from_numpy(xs).cuda(), 50,
                            init=c0.cuda(), **kw))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        c_cpu, a_cpu = kmeans_cuda(torch.from_numpy(xs), 50, init=c0, **kw)
    if iteration_lines(buf.getvalue()) != iteration_lines(log_gpu):
        raise AssertionError("13K Yinyang: card and CPU iteration lines "
                             "differ")
    if not torch.equal(a_gpu.cpu(), a_cpu):
        raise AssertionError("13K Yinyang: card and CPU assignments differ")
    torch.testing.assert_close(c_gpu.cpu(), c_cpu, rtol=1e-5, atol=1e-6)
    if len(marks) != 2 or launches["assign_only_pass"] \
            == marks[1]["assign_only_pass"]:
        raise AssertionError("13K Yinyang: the loop never launched B2")
    print("small Yinyang input: card and CPU give identical assignments and "
          "iteration lines (%d iterations), centroids within rtol 1e-5 / "
          "atol 1e-6; launches %s" % (count_iterations(log_gpu), launches),
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    tag = "[%s]" % card
    nvcc_version = subprocess.run(
        [_build.nvcc(), "--version"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[-1]
    print("python %s, torch %s, CUDA %s, nvcc: %s, device: %s"
          % (sys.version.split()[0], torch.__version__, torch.version.cuda,
             nvcc_version, torch.cuda.get_device_name(0)), flush=True)
    D.disable_tf32()
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on")
    print("TF32 off: matmul.allow_tf32=%s cudnn.allow_tf32=%s"
          % (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32), flush=True)

    t0 = time.perf_counter()
    _build.library()
    print("kernel build %.1f s" % (time.perf_counter() - t0), flush=True)
    kernel_report()

    errs = {"fused_lloyd_pass": 0.0, "assign_only_pass": 0.0}
    check_kernels(errs)
    score_ulps()
    times = time_kernels(tag, HEADLINE, torch.float32, 20)
    times_bf16 = time_kernels(tag, BF16_RUN, torch.bfloat16, 5)

    dev = torch.device("cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(HEADLINE["n"], HEADLINE["f"], generator=g, device=dev)
    g = torch.Generator(device="cuda").manual_seed(0)
    xb = torch.rand(BF16_RUN["n"], BF16_RUN["f"], generator=g,
                    device=dev).to(torch.bfloat16)
    k = HEADLINE["k"]
    headline = dict(init="random", seed=1, tolerance=0.002, yinyang_t=0,
                    max_iterations=15)
    runs = [
        ("headline 100000x256 fp32 k=1024", lambda c: kmeans_cuda(
            x, k, verbosity=1, **headline)),
        ("restart from its centroids, 5 iterations", lambda c: kmeans_cuda(
            x, k, init=c, tolerance=0.0, yinyang_t=0, max_iterations=5,
            verbosity=1)),
        ("1000000x256 bf16 k=1024", lambda c: kmeans_cuda(
            xb, k, init="random", seed=1, tolerance=0.002, yinyang_t=0,
            max_iterations=10, verbosity=1)),
    ]
    total = {name: 0 for name in K.LAUNCHES}
    centroids = None
    iterations = {}
    for label, run in runs:
        K.reset_launch_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            c, a = run(centroids)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        log = buf.getvalue()
        print(log, end="", flush=True)
        for name, count in launches.items():
            if count == 0:
                raise AssertionError("%s: %s never launched" % (label, name))
            total[name] += count
        data = xb if "bf16" in label else x
        empty, ties = check_result(data, k, c, a, D.DistanceMetric.L2)
        iterations[label] = count_iterations(log)
        print("%s: %d iterations, launches %s, %d empty clusters, final "
              "assignment equals the plain argmin (%d near-tie rows differ)"
              % (label, iterations[label], launches, empty, ties),
              flush=True)
        if centroids is None:
            centroids = c

    for label, data, kw in (
            ("headline 100000x256 fp32 k=1024", x, headline),
            ("1000000x256 bf16 k=1024", xb, dict(
                headline, max_iterations=10))):
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            kmeans_cuda(data, k, **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        wall = min(walls)
        print("%s wall %s: %.4f s (min of 3: %s), %d iterations, %.3f ms per "
              "iteration" % (tag, label, wall,
                             ", ".join("%.4f" % w for w in walls),
                             iterations[label],
                             1e3 * wall / iterations[label]), flush=True)

    check_small_input_agreement()

    check_row_independence()
    paths = [("default call", *default_call_phase(tag, x)),
             ("1M bf16 Yinyang", *bf16_yinyang_phase(tag, xb))]
    del xb
    paths.append(("spherical AFK-MC2", spherical_phase(tag)))
    for label, *counts in paths:
        for launches in counts:
            for name, count in launches.items():
                if count == 0:
                    raise AssertionError("%s: %s never launched"
                                         % (label, name))
                total[name] += count
    check_small_yinyang_agreement()

    knn = knn_phase(tag)

    # top-level numbers at the headline shape (100K x 256 fp32, k=1024);
    # "bf16_1m" the same at 1M x 256 bf16; B1 also carries its segment sum
    def numbers(t):
        return {key: t[key] for key in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")}

    kernels = []
    for name, line in (("fused_lloyd_pass", 81), ("assign_only_pass", 127)):
        entry = {
            "name": name, "route": "cuda",
            "source": "kmcuda_torch/csrc/assign.cu",
            "replaces": "kmcuda_tpu/ops/assign_pallas.py:%d" % line,
            "launches": total[name], "max_abs_err": errs[name],
            **numbers(times[name]), "library": times[name]["library"],
            "shape": "100000x256 fp32 k=1024",
            "bf16_1m": numbers(times_bf16[name])}
        if name == "fused_lloyd_pass":
            entry["segment_sum"] = {
                **numbers(times["segment_sum"]),
                "library": times["segment_sum"]["library"],
                "bf16_1m": numbers(times_bf16["segment_sum"])}
        kernels.append(entry)
    kernels.append({
        "name": "knn_walk", "route": "cuda",
        "source": "kmcuda_torch/csrc/knn_walk.cu",
        "replaces": "kmcuda_tpu/ops/knn_pallas.py:150", **knn,
        "library_ms": None, "library": "no single call"})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def check_small_input_agreement():
    """Whole slice: the same call on a CUDA tensor (kernels) and on a CPU
    tensor (plain twins) from the same start gives identical assignments
    and iteration logs on separated blobs, centroids within rtol 1e-5 /
    atol 1e-6, and launches the fused kernel."""
    rng = np.random.RandomState(1)
    centers = rng.rand(32, 16).astype(np.float32) * 20
    xs = (centers[rng.randint(0, 32, size=4096)]
          + 0.1 * rng.randn(4096, 16)).astype(np.float32)
    c0 = torch.from_numpy(xs[rng.choice(4096, 32, replace=False)])
    kw = dict(tolerance=0.0, yinyang_t=0, verbosity=1, max_iterations=30)
    K.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        c_gpu, a_gpu = kmeans_cuda(torch.from_numpy(xs).cuda(), 32,
                                   init=c0.cuda(), **kw)
    log_gpu = buf.getvalue()
    launches = K.LAUNCHES["fused_lloyd_pass"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        c_cpu, a_cpu = kmeans_cuda(torch.from_numpy(xs), 32, init=c0, **kw)
    if buf.getvalue() != log_gpu:
        raise AssertionError("card and CPU iteration logs differ")
    if not torch.equal(a_gpu.cpu(), a_cpu):
        raise AssertionError("card and CPU assignments differ")
    torch.testing.assert_close(c_gpu.cpu(), c_cpu, rtol=1e-5, atol=1e-6)
    if launches == 0:
        raise AssertionError("small input: fused_lloyd_pass never launched")
    print("small input: card and CPU give identical assignments and "
          "iteration logs (%d iterations), centroids within rtol 1e-5 / "
          "atol 1e-6" % count_iterations(log_gpu), flush=True)


def blobs_on_card(n, f, k, seed, metric=D.DistanceMetric.L2, nan_rows=0):
    """The JAX bench's kNN data (bench.py:272-278), made on the card:
    centers = U(0, 1) * 10, x = centers[which] + 0.5 * N(0, 1).  Cosine
    normalizes rows and centers; ``nan_rows`` random rows become NaN."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    centers = torch.rand(k, f, generator=g, device=dev) * 10.0
    which = torch.randint(0, k, (n,), generator=g, device=dev)
    x = centers[which] + 0.5 * torch.randn(n, f, generator=g, device=dev)
    if metric == D.DistanceMetric.COSINE:
        x = x / x.norm(dim=1, keepdim=True)
        centers = centers / centers.norm(dim=1, keepdim=True)
    if nan_rows:
        x[torch.randperm(n, generator=g, device=dev)[:nan_rows]] = \
            float("nan")
    return x, centers


def cluster(x, centers, metric):
    """k-means from the blob centers, 5 iterations, through the public
    call: the clustering a kNN user would feed in."""
    return kmeans_cuda(x, centers.shape[0], init=centers, tolerance=0.01,
                       yinyang_t=0, max_iterations=5, metric=metric)


def knn_plan(x, c, a, metric):
    """The kNN layout of (x, c, a), as ``knn_cuda`` plans it."""
    p = prepare(x, c.shape[0], metric, x.device, Logger(0))
    return TK.plan_pruned(p, c.float(), a)


def check_walk(label, plan, k, kn, metric, chunk_base, n_chunks):
    """B3 vs its plain twin on one batch of a layout; returns (the
    comparison's numbers, the walk's (args, kwargs))."""
    args, kw = TK.batch_walk_inputs(plan, chunk_base, n_chunks,
                                    k_neighbors=kn, n_clusters=k,
                                    metric=metric)
    out = KK.compare_walks(args, kw)
    torch.cuda.synchronize()
    in_smem = (kw["kk"] * kw["chunk"] * 8
               <= KK.smem_buffer_bytes(args[0].dtype))
    print("check B3 %s: ok; chunks %d..%d of %d (kk %d, chunk %d, tile_m "
          "%d, group %d, buffer in %s); %d tie rows (%d of them where the "
          "candidate buffers part at their edge; exact fp64 neighbours "
          "there: kernel %d, plain %d), %d chunks' examined differ, "
          "examined %d, max |d dist| %.3g"
          % (label, chunk_base, chunk_base + n_chunks - 1,
             plan.m_total // plan.q_chunk, kw["kk"], kw["chunk"],
             plan.tile_m, plan.group, "shared memory" if in_smem
             else "global scratch", out["tie_rows"], out["edge_rows"],
             *out["edge_hits"], out["chunks_differ"], out["examined"],
             out["max_abs_err"]), flush=True)
    return out, args, kw


def check_recall(x, nb, kn, nq=1024, seed=13):
    """recall@kn and tie-aware recall of ``nb`` on nq random queries
    against a chunked fp32 brute force on the card (TF32 off) with a 3 * kn
    window, adjudicated in fp64 as bench.py:314-367 does: a returned slot
    counts when its fp64 distance is within one fp32 tie window of the true
    profile's slot."""
    n = x.shape[0]
    g = torch.Generator(device="cuda").manual_seed(seed)
    qi = torch.randperm(n, generator=g, device=x.device)[:nq]
    kc = 3 * kn
    x_sq = D.row_sq_norms(x)
    exact = []
    for s in range(0, nq, 256):
        qb = qi[s:s + 256]
        sq = x_sq[qb, None] + x_sq[None, :] - 2.0 * D.matmul_f32(x[qb], x.T)
        sq[torch.arange(qb.numel(), device=x.device), qb] = float("inf")
        exact.append(torch.topk(sq, kc, dim=1, largest=False).indices)
        del sq
    exact = torch.cat(exact)
    got = nb[qi].long()
    recall = float(np.mean([
        len(set(e) & set(r)) / kn for e, r in zip(
            exact[:, :kn].tolist(), got.tolist())]))
    union = torch.cat([exact, got], dim=1)
    d64 = torch.linalg.norm(
        x[union].double() - x[qi].double()[:, None, :], dim=2)
    order = torch.argsort(union, dim=1, stable=True)
    srt = torch.gather(union, 1, order)
    dup_sorted = torch.zeros_like(srt, dtype=torch.bool)
    dup_sorted[:, 1:] = srt[:, 1:] == srt[:, :-1]
    dup = torch.zeros_like(dup_sorted).scatter_(1, order, dup_sorted)
    true_prof = torch.sort(torch.where(dup, float("inf"), d64),
                           dim=1).values[:, :kn]
    got_prof = torch.sort(d64[:, kc:], dim=1).values
    ok = got_prof <= true_prof * (1.0 + 1e-5) + 1e-6
    return recall, float(ok.double().mean())


def time_walk(tag, args, kw, reps=3):
    """B3 and walk_reference on one batch, in turns (plain, kernel,
    kernel, plain), and B3's bound on it; returns {ms, plain_ms, bound_ms,
    bound_by, chunks}."""
    p1 = time_ms(lambda: KK.walk_reference(*args, **kw), reps)
    k1 = time_ms(lambda: KK.walk(*args, **kw), reps)
    k2 = time_ms(lambda: KK.walk(*args, **kw), reps)
    p2 = time_ms(lambda: KK.walk_reference(*args, **kw), reps)
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    chunks = args[0].shape[0] // kw["chunk"]
    bnd = walk_bound(args, kw)
    print("%s time knn_walk %d chunks x %d rows, f=%d, kk=%d: kernel %.4f "
          "ms, plain %.4f ms (%.4f/%.4f, %.4f/%.4f), bound %.4f ms (%s)"
          % (tag, chunks, kw["chunk"], args[0].shape[1], kw["kk"], ms,
             plain_ms, k1, k2, p1, p2, bnd["ms"], bnd["by"]), flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd["ms"],
            "bound_by": bnd["by"], "chunks": chunks}


def walk_bound(args, kw):
    """B3's bound on one batch (``roofline.walk_bound``): the pairs its
    walks examined, and the distinct member rows of the tiles they
    visited, from one more run of the kernel on the batch."""
    _bi, examined, steps = KK.walk(*args, **kw)
    tile_order, tile_nvalid = args[6].cpu(), args[8].cpu()
    group, nt = kw["group"], tile_nvalid.shape[0]
    visited = torch.zeros(nt, dtype=torch.bool)
    for c, s in enumerate(steps.cpu().tolist()):
        tiles = tile_order[c, :s * group].long()
        visited[tiles[tiles < nt]] = True
    xq = args[0]
    bnd = R.walk_bound(int(examined.sum()), int(tile_nvalid[visited].sum()),
                       xq.shape[0], xq.shape[1], kw["kk"], steps.numel(),
                       str(xq.dtype)[6:])
    print("B3 bound on %d chunks: %d examined pairs, %d distinct member "
          "rows: %.4f ms (%s)" % (steps.numel(), int(examined.sum()),
                                  int(tile_nvalid[visited].sum()),
                                  bnd["ms"], bnd["by"]), flush=True)
    return bnd


def fraction(log: str) -> float:
    lines = [l for l in log.splitlines() if l.startswith("calculated ")]
    if not lines:
        raise AssertionError("no 'calculated ... of all the distances' line")
    return float(lines[-1].split()[1])


def knn_phase(tag):
    """kNN: B3 against its twin on three layouts, the public call at the
    bench shape (launch count, wall, examined fraction), its exactness,
    and the card against the CPU on the 13K fixture.  Returns the kernel
    line's numbers for B3."""
    L2, COS = D.DistanceMetric.L2, D.DistanceMetric.COSINE
    b = KNN_BENCH
    x, centers = blobs_on_card(b["n"], b["f"], b["k"], 11)
    c, a = cluster(x, centers, L2)
    torch.cuda.synchronize()
    errs = []

    # 1(a): 32 chunks from the middle of the bench layout, and one full
    # 65,536-query batch (256 chunks, as knn_cuda launches it): timing
    plan = knn_plan(x, c, a, L2)
    nchunks = plan.m_total // plan.q_chunk
    out, args, kw = check_walk("1000000x256 fp32 L2 kn=16", plan, b["k"],
                               b["kn"], L2, nchunks // 2 - 16, 32)
    errs.append(out["max_abs_err"])
    walk_times = time_walk(tag, args, kw)
    batch = TK.batch_walk_inputs(plan, nchunks // 2 - 128, 256,
                                 k_neighbors=b["kn"], n_clusters=b["k"],
                                 metric=L2)
    walk_times["full_batch"] = time_walk(tag, *batch)
    del plan, args, kw, batch

    # 2: the public call; the walk launch count is read from this run
    KK.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        nb = knn_cuda(b["kn"], x, c, a, verbosity=1)
    torch.cuda.synchronize()
    launches = KK.LAUNCHES["knn_walk"]
    print(buf.getvalue(), end="", flush=True)
    if launches == 0:
        raise AssertionError("knn_cuda: knn_walk never launched")
    frac = fraction(buf.getvalue())
    if nb.shape != (b["n"], b["kn"]) or nb.dtype != torch.int32 \
            or int(nb.min()) < 0 or int(nb.max()) >= b["n"]:
        raise AssertionError("knn_cuda: neighbours out of shape or range")
    if bool((nb == torch.arange(b["n"], device=nb.device)[:, None]).any()):
        raise AssertionError("knn_cuda: a sample is its own neighbour")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        knn_cuda(b["kn"], x, c, a)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    print("%s wall knn_cuda %dx%d fp32 k=%d %d-NN: %.4f s (min of 3: %s), "
          "examined fraction %.6f, knn_walk launches %d"
          % (tag, b["n"], b["f"], b["k"], b["kn"], min(walls),
             ", ".join("%.4f" % w for w in walls), frac, launches),
          flush=True)

    # 3: exactness at 1M
    recall, tie_recall = check_recall(x, nb, b["kn"])
    print("1M exactness: recall@16 %.6f, tie-aware recall@16 %.6f on 1024 "
          "queries" % (recall, tie_recall), flush=True)
    if tie_recall != 1.0:
        raise AssertionError("tie-aware recall %.6f != 1" % tie_recall)
    del c, a, nb

    # 4: clustered as the JAX bench does (AFK-MC2, m=200, bench.py:286-287)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t = time.perf_counter()
        c, a = kmeans_cuda(x, b["k"], init=("afkmc2", 200), seed=11,
                           tolerance=0.01, yinyang_t=0, max_iterations=200,
                           verbosity=1)
        torch.cuda.synchronize()
        km_s = time.perf_counter() - t
        nb = knn_cuda(b["kn"], x, c, a, verbosity=1)
        torch.cuda.synchronize()
    frac_mc2 = fraction(buf.getvalue())
    walls = [wall_s(lambda: knn_cuda(b["kn"], x, c, a)) for _ in range(3)]
    recall, tie_recall = check_recall(x, nb, b["kn"])
    print("%s wall knn_cuda %dx%d fp32 k=%d %d-NN, AFK-MC2-seeded clusters "
          "(k-means %d iterations, %.4f s): %.4f s (min of 3: %s), examined "
          "fraction %.6f (blob-center clusters: %.6f); recall@16 %.6f, "
          "tie-aware recall@16 %.6f on 1024 queries"
          % (tag, b["n"], b["f"], b["k"], b["kn"],
             count_iterations(buf.getvalue()), km_s, min(walls),
             ", ".join("%.4f" % w for w in walls), frac_mc2, frac, recall,
             tie_recall), flush=True)
    if tie_recall != 1.0:
        raise AssertionError("AFK-MC2 clusters: tie-aware recall %.6f != 1"
                             % tie_recall)
    del x, c, a, nb

    # 1(b): ragged, 10 NaN rows, fp32 and bf16 x L2 and cosine, 64 chunks
    r = KNN_RAGGED
    for metric in (L2, COS):
        x, centers = blobs_on_card(r["n"], r["f"], r["k"], 5, metric,
                                   nan_rows=10)
        c, a = cluster(x, centers, metric)
        for dtype in (torch.float32, torch.bfloat16):
            # bf16 storage reuses the fp32 clustering: a bf16-rounded unit
            # vector fails the cosine norm probe of the public call
            plan = knn_plan(x.to(dtype), c, a, metric)
            out, _args, _kw = check_walk(
                "%dx%d k=%d %s %s kn=%d" % (r["n"], r["f"], r["k"],
                                            str(dtype)[6:], metric.name,
                                            r["kn"]),
                plan, r["k"], r["kn"], metric, 0, 64)
            errs.append(out["max_abs_err"])
            del plan

    # 1(c): f = 2560 and kk = 300, past both bounds of the TPU kernel
    w = KNN_WIDE
    x, centers = blobs_on_card(w["n"], w["f"], w["k"], 7)
    c, a = cluster(x, centers, L2)
    plan = knn_plan(x, c, a, L2)
    out, _args, _kw = check_walk(
        "%dx%d fp32 k=%d L2 kn=%d" % (w["n"], w["f"], w["k"], w["kn"]),
        plan, w["k"], w["kn"], L2, 0, plan.m_total // plan.q_chunk)
    errs.append(out["max_abs_err"])
    del x, c, a, plan

    check_small_knn_agreement()
    full = walk_times.pop("full_batch")
    return {"launches": launches, "max_abs_err": max(errs), **walk_times,
            "full_batch": full}


def check_small_knn_agreement():
    """Whole call: knn_cuda on a CUDA and on a CPU tensor of the 13K blob
    fixture (tests/test_knn.py), from one clustering, gives neighbours
    identical off fp64 ties and identical 'calculated' lines, and the card
    run launches the walk kernel."""
    rng = np.random.RandomState(0)
    xs = np.empty((13000, 2), dtype=np.float32)
    xs[:2000] = rng.rand(2000, 2) + [0, 0.5]
    xs[2000:4000] = rng.rand(2000, 2) + [0, 1.5]
    xs[4000:6000] = rng.rand(2000, 2) - [0, 0.5]
    xs[6000:8000] = rng.rand(2000, 2) + [0.5, 0]
    xs[8000:10000] = rng.rand(2000, 2) - [0.5, 0]
    xs[10000:] = rng.rand(3000, 2) * 5 - [2, 2]
    x = torch.from_numpy(xs)
    c, a = kmeans_cuda(x, 50, init=x[rng.choice(13000, 50, replace=False)],
                       tolerance=0.01, yinyang_t=0)
    KK.reset_launch_counts()
    logs = []
    outs = []
    for dev in ("cuda", "cpu"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            outs.append(knn_cuda(10, x.to(dev), c.to(dev), a.to(dev),
                                 verbosity=1).cpu())
        logs.append(buf.getvalue())
        if dev == "cuda":
            launches = KK.LAUNCHES["knn_walk"]
    if logs[0] != logs[1]:
        raise AssertionError("card and CPU kNN logs differ: %r vs %r"
                             % (logs[0], logs[1]))
    if launches == 0:
        raise AssertionError("13K kNN: knn_walk never launched")
    rows = torch.nonzero((outs[0] != outs[1]).any(dim=1))[:, 0]
    x64 = x.double()
    for r in rows.tolist():
        prof = [torch.sort(torch.linalg.norm(x64[o[r].long()] - x64[r],
                                             dim=1)).values for o in outs]
        if not torch.allclose(prof[0], prof[1], rtol=1e-6, atol=0):
            raise AssertionError("13K kNN: row %d differs off ties" % r)
    print("small kNN input: card and CPU agree (%d tie rows), identical "
          "log: %s" % (rows.numel(), logs[0].strip()), flush=True)


if __name__ == "__main__":
    sys.exit(main())
