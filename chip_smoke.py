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

The init step (``kmt_point_min``, k-means++ and AFK-MC2): held against
its twin (``check_point_min``: fp32 and bf16 from fp16 input, L2 and
cosine, first and later steps, invalid rows, f in 3, 8, 256, 257 and row
counts at ragged edges), timed beside its twin, ``torch.mv`` (the product
alone) and its bound at 100K fp32 and 1M bf16, and at 8M and 40M bf16 in
the scale phase; x_sq over row blocks against the whole pass at both
shapes (``check_row_sq_norms``); k-means++ through the kernels and through
the twins in lockstep at the headline and at 8M (``kmeanspp_picks``: equal
picks, or a first moved pick explained by the draw's boundary).

The init step's draw (``kmt_weighted_draw``): held bitwise against its
twin (``init_kernels.weighted_draw_reference``) at 100K fp32, 1M, 8M and
40M bf16 over a k-means++ step's weights (``check_weighted_draw``: the
index, the copied row, a repeat, the all-zero fallback), timed beside the
twin, ``torch.multinomial`` (n <= 2**24) and its bound; k-means++ at the
headline traced: three launches a step and no copy to the host
(``kmeanspp_launches``).  The start's repeat gate
(``start_repeat_gate``): bench.py's 8M k-means++ start bitwise equal
before and after ``check_delta_sum``, with a second stream busy on B2,
and from a second process; the bench's 8M run must take this process's
iteration count.

The sparse iteration's delta (``kmt_delta_sum``): held against its twin
(``compact.delta_compacted``, the one-hot product over chunks) and fp64
sums at 100K fp32, 1M bf16 (and skewed: half the moved rows to one
cluster), k=16,384, and bench.py's 8M config at the moved-row counts of
its sparse iterations (79,484, 204,209 and 630,524, and skewed), each
timed beside the twin, ``index_add_`` of both sides and its bound
(``check_delta_sum``, ``time_delta_sum``); the 8M run must launch it.

Lloyd: the public ``kmeans_cuda`` at the reference benchmark's headline
configuration (100,000 x 256 fp32, k=1024, random init, seed 1, tolerance
0.002, 15 iterations), a 5-iteration restart from its centroids (so the
low-churn arm runs) and a 1,000,000 x 256 bf16 run.

The default call, ``kmeans_cuda(x, 1024)`` (k-means++ and Yinyang), on the
headline data (seed 1, tolerance 0.002, at most 60 iterations) against
the same call with ``yinyang_t=0``: identical assignments, centroids and
iteration lines, and B2 launched by the Yinyang loop (both walls are
timed from one imported k-means++ start); the same at
1,000,000 x 256 bf16 (random init, tolerance 0, 60 iterations, with the
count of each Yinyang iteration variant and the rows the moved-row patch
walked); the JAX bench's 15-iteration pair, which the budget gate hands to
Lloyd (gate line, no grouping, bitwise, walls); Yinyang against Lloyd,
bitwise, under forced schedules (revoke always, which must revoke; dense
fraction 0.01 and 0.99; bf16 lower bounds) on the headline data and the
13K blob fixture; Yinyang against Lloyd, bitwise, on 1,000,000 x 256 fp16
blobs far from the origin (1,024 centers U(0, 8)^256, spread 0.3: d^2 far
below |x| |c|, where the bf16 panel's score error is absolute) from one
imported k-means++ start, with the argmin on a row sample, the variants
and both walls (``bf16_blob_yinyang_phase``);
the JAX bench's deep-tail restart (2,000,000 x 256 fp32 merged blobs,
45 iterations from 15 of Lloyd: walls, candidates per iteration, the
controller's decisions); AFK-MC2 at the JAX bench's spherical
configuration (1,000,000 x 256 unit rows, cosine, k=1024, m=100); and
Yinyang on a CUDA and a CPU tensor of the 13K blob fixture from one
start.

kNN: the JAX bench's configuration (1,000,000 x 256 fp32 blobs, k=1024,
16 neighbours) through the public ``knn_cuda``, clustered from the blob
centers and, as the JAX bench seeds it, by AFK-MC2 (m=200); recall
against a brute force on the card; and the same call on a CUDA and a CPU
tensor of the 13K blob fixture.  bf16 cosine (``bf16_cosine_knn_phase``):
1,000,000 x 256 unit rows around 1,024 random directions, neighbours at
angles of about 10^-2, fp16 input, clustered through ``kmeans_cuda(...,
metric="cos")``, ``knn_cuda`` at 16-NN (wall, examined fraction),
tie-aware recall 1.0 on 1,024 queries against a blocked fp64 brute force
of the rescore's measure (the angle of the chord of the stored rows), and
B3 against its twin on one full batch, timed there with its bound.

The C ABI (``kmcuda_torch.capi`` with ``KMTPU_PLATFORM`` unset):
``kmeans_from_pointers`` at the headline configuration from one imported
start, Lloyd and Yinyang, bitwise equal to ``kmeans_cuda`` on the same
numpy arrays (assignments, centroids, average distance, iteration lines),
walls beside the call's; the handle protocol at the kNN configuration
(upload, k-means from the blob centers, 16-NN, one fetch) bitwise equal
to ``kmeans_cuda`` / ``knn_cuda`` on CUDA tensors, with tie-aware
recall@16 of 1.0, its wall and the bytes it copied each way (from a
traced repeat); then ``native_torch`` built with cmake and ninja and the
C smoke of ``native/`` run against it, or a line naming what the host
lacks for the build; then the R package's testthat suite
(``r/kmtputorch/tests/test-kmtputorch.R``) where the host has Rscript,
testthat and reticulate, or a line naming what it lacks.

Multi-device (``multidevice_phase``): the public calls over 1, 2 and 4
logical shards of card 0 (the device mask answered with cuda:0 d times),
which runs the port's shard loop, per-shard kernel launches and
fixed-order reductions, but no peer copy between cards: Lloyd at the
headline and the default call on its data (d = 4 repeats bitwise, Yinyang
equals Lloyd bitwise at d = 4, the final assignment is the argmin, d = 1
is bitwise the call without a mask, the k-means++ picks are d = 1's;
Lloyd at d = 2 and 4 meets tests/test_kmeans.py:277-309's contract
against d = 1: iteration counts within 1, at most 0.2% of the
assignments differ, 96% of the centroids within rtol 1e-4 / atol 1e-5;
the default call meets that contract over its first 4 iterations from
the same start at d = 2 and 4, its whole runs' iteration counts are
within 1 of d = 1's, and where their reassignment counts part by fp32
rounding is printed);
1M x 256 bf16 Lloyd at d = 4 (bitwise repeat, argmin); kNN at 1M x 256
fp32 16-NN (neighbours d = 1's up to fp64 ties, tie-aware recall@16 1.0,
examined fractions beside d = 1's); walls of d = 1, 2 and 4.  With
several cards, numpy input over all of them, with the same checks.

Scale (``scale_phase``): the JAX package's largest documented shapes, each
made on the card from a seed and deleted before the next.  The reference's
overflow run (tests/test_scale.py:35: 167,772,160 x 8 fp32, more than
2**32 bytes, k=50, k-means++ seed 3, tolerance 0.142) and bench.py's 8M
config (bench.py:383-439: 8,000,000 x 256 bf16, k=1024, k-means++ seed 17,
tolerance 0.01; a warm, a timed and a one-iteration run, printed under
bench.py's five metric names, and k-means++ alone with one step's
distance pass and draw), each with the argmin on a sample of rows and the
kernels timed at its shape and held there over every row (B1's sums
against fp64 sums); B1 and B2 at 9,000,000 x 256 bf16, past 2**31
elements, held against the plain twin on rows both sides of the first row
whose offset row * f reaches 2**31, then ``kmeans_cuda`` there;
``knn_cuda`` at k=16,384 (tests/test_scale.py:97, the projection relabel)
with tie-aware recall 1.0 over every row and the walk against its twin;
and k=2048 Yinyang (tests/test_scale.py:136) equal to Lloyd bitwise, at
the JAX test's 3 iterations and over 8, where sparse iterations filter
rows; and a 40,000,000 x 256 bf16 corpus (``capacity_run``: 20.48 GB of
samples, k-means++ seed 17, 5 iterations at most, the argmin on a row
sample, peak at most 1.5x the samples).  The 8M and 40M runs must peak at
most 1.5x their samples; the 8M one also times a prepare of fp16 numpy
samples.  Each run prints its wall, iterations, peak memory and launches.
The phase needs about 62 GB of card memory (the plain twin's fp32 copy of
the 40M samples, timed beside the kernel).

The port's benchmark (``bench_phase``, last): ``python3 bench_torch.py``
at full size in a process of its own, its lines echoed, after this
process returns its cached card memory.  It must exit 0 with bench.py's
final line (five keys, the headline, the 18 metrics in ``extra``, no
``failed``), tie-aware recall@16 1.0, every wall positive, at least one 8M
iteration and every kernel launched; its launches join the ``kernels``
line.  The deep-tail, spherical, 8M and kNN data of the phases above, the
headline samples and the recall check are ``bench_torch``'s fixtures, so
one definition serves both.

Prints the card's name and power limit beside every time, the smoke's
wall, a JSON line of the kernels, and as its last line a JSON object with
``"ok": true``.  Any failure raises, so the exit code is non-zero; so it
is without a CUDA device, or outside a checkout of the repository.

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
- B1's sums past 2**31 elements: within rtol 1e-5 / atol 1e-5 * mean |x|
  of fp64 sums of its own assignment (a cluster there holds ~10^5 rows,
  and the plain segment sum's fp32 atomics round past rtol 1e-5 of fp64);
  counts bitwise a bincount of its assignment.
- B3 (``ops.knn_kernels.compare_walks``, after the shared exact rescore):
  per-chunk examined counts equal unless the step where the walks part has
  its bound within 1e-5 relative of tau; neighbour ids equal except where
  their fp64 distance profiles agree to rtol 1e-6 (ties), bf16 cosine
  included; distances rtol 1e-6 where the ids are equal.
- The delta (``check_delta_sum``): counts bitwise the twin's and fp64's;
  sums within 1e-5 of fp64 relative to the magnitude of the sums being
  differenced (the fp64 sum of |x_r| over both sides of a cluster: each
  side is an fp32 sum in another order, and the difference can cancel);
  a repeat bitwise.
- The draw (``check_weighted_draw``): the index bitwise the twin's (the
  same tree and order), the copied row bitwise the drawn row as fp32.
- The init step (``check_point_min``): distances within 1e-6 (x_sq +
  |c|^2) of the twin's in the d^2 domain (L2), within 1e-6 |x| |c| in the
  cos domain (cosine); no further from an fp64 pass than the twin plus
  that; a later step bitwise the minimum of its input and the kernel's
  distances; invalid rows 0; repeats bitwise.  x_sq over row blocks:
  bitwise the whole pass, else within rtol f 2**-24 of fp64 (printed).
- kNN recall: tie-aware, a returned slot within (1 + 1e-5) d + 1e-6 of
  the exact fp64 profile's (L2, ``bench_torch.recall_of``), or within
  rtol 1e-6 of it (bf16 cosine, the chord's angle, ``chord_recall``).
"""

import contextlib
import ctypes
import gc
import hashlib
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import sysconfig
import time

import numpy as np
import torch

from kmcuda_torch import capi, config, kmeans_cuda, knn_cuda
from kmcuda_torch.models import initialization as I
from kmcuda_torch.models import knn as TK
from kmcuda_torch.models import yinyang as Y
from kmcuda_torch.models.problem import prepare
from kmcuda_torch.ops import _build
from kmcuda_torch.ops import assign_kernels as K
from kmcuda_torch.ops import compact as C
from kmcuda_torch.ops import distance as D
from kmcuda_torch.ops import init_kernels as IK
from kmcuda_torch.ops import knn_kernels as KK
from kmcuda_torch.ops import yinyang as YY
from kmcuda_torch.ops import assign as A
from kmcuda_torch.ops.assign import pad_clusters
from kmcuda_torch.parallel import devices as DEV
from kmcuda_torch.parallel.devices import Topology
from kmcuda_torch.utils.logging import Logger
import bench_torch as B
import capacity as CAP
import roofline as R

HEADLINE = dict(n=100_000, f=256, k=1024)
BF16_RUN = dict(n=1_000_000, f=256, k=1024)
RAGGED = dict(n=100_003, f=250, k=1000)
KNN_BENCH = dict(n=1_000_000, f=256, k=1024, kn=16)
KNN_RAGGED = dict(n=100_003, f=250, k=1000, kn=10)
KNN_WIDE = dict(n=16_384, f=2_560, k=16, kn=200)
SPHERICAL = dict(n=1_000_000, f=256, k=1024, m=100)
#: bf16 blobs far from the origin (the card test's layout at scale):
#: centers U(0, 8)^256, spread 0.3, fp16 input
BF16_BLOBS = dict(n=1_000_000, f=256, k=1024, spread=0.3)
#: unit rows around random directions, fp16 input; a row's nearest
#: neighbours lie at angles of about 10^-2 (spread 5e-4 per feature)
KNN_COS = dict(n=1_000_000, f=256, k=1024, kn=16, spread=5e-4)


card_line = B.card_line


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
                "seg_tile_kernel", "seg_scan_kernel", "seg_counts_kernel",
                "seg_place_kernel", "seg_reduce_kernel", "seg_fix_kernel",
                "point_min_kernel", "draw_partials_kernel",
                "draw_pick_kernel")


def _kernel_name(mangled: str):
    """'assign_kernel<bf16>' etc. for a mangled name, or None."""
    for name in KERNEL_NAMES:
        if name in mangled:
            if name in ("assign_kernel", "walk_kernel", "seg_reduce_kernel",
                        "point_min_kernel"):
                # the reduction's signed instantiation (the delta's)
                signed = ", signed" if "ELb1E" in mangled else ""
                return "%s<%s%s>" % (name, "bf16" if "nv_bfloat16" in mangled
                                     else "float", signed)
            return name
    return None


def kernel_report():
    """ptxas's registers, shared memory and spills of every kernel (from
    the build log), the HGMMA (wgmma) instructions in the SASS of the
    assignment and walk kernels (``cuobjdump -sass`` of the built library),
    and the float atomics in the SASS of the segment sum (B1' and the
    delta) and of the draw; fails unless both
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
        if name and not name.startswith(("seg_", "point_min", "draw_")):
            counts[name] = section.count("HGMMA")
        elif name and name.startswith(("seg_", "draw_")):
            float_atomics += sum(
                1 for l in section.splitlines()
                if ("ATOM" in l or "RED" in l) and "F32" in l)
    print("SASS HGMMA instructions: %s; float atomics in the segment sum, "
          "the delta and the draw: %d"
          % (", ".join("%s %d" % kv for kv in sorted(counts.items())),
             float_atomics), flush=True)
    for name in ("assign_kernel<bf16>", "assign_kernel<float>",
                 "walk_kernel<bf16>", "walk_kernel<float>"):
        if not counts.get(name):
            raise AssertionError("%s does not run on wgmma" % name)
    if float_atomics:
        raise AssertionError("the segment sum, the delta or the draw has "
                             "float atomics")
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


def time_kernels(tag, shape, dtype, reps, errs=None):
    """B1, B2 and B1's segment sum at one main-path shape, each in turns
    with its plain twin and library yardstick (plain, kernel, kernel,
    plain, library); returns {name: {ms, plain_ms, library_ms, library,
    bound_ms, bound_by}}.  B2's yardstick is ``torch.matmul(x, panel.T)``
    in the storage dtype: the score product only.  The segment sum's is
    ``torch.zeros(k, f).index_add_(0, aid, x.float())``; the kernel is
    launched through ``K.launch_segment_sum``, which counts no launch.  B1
    has none: no single call scores, picks and sums.  With ``errs`` (the
    scale shapes, which check_kernels does not reach) B1 and B2 are also
    held on the same inputs, over every row, by :func:`hold_pass`; B1's
    entry then carries its ``sums_vs_fp64``."""
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
    del panel, aid, aid_long
    if errs is not None:
        b1 = K.fused_lloyd_pass(x, valid, prev, c, **kw)
        b2 = K.assign_only_pass(x, valid, prev, c, **kw)
        out["fused_lloyd_pass"]["sums_vs_fp64"] = hold_pass(
            "%s scale: %dx%d %s k=%d" % (tag, n, f, name_dt, k), x, valid,
            prev, c, b1, b2, errs)
        del b1, b2
    del x, valid, prev, c
    return out


def fp64_sums(x, aid, k, step=1 << 20):
    """(k, f) fp64 sums of x over the rows with aid < k, ``step`` rows at a
    time."""
    sums = torch.zeros((k, x.shape[1]), dtype=torch.float64, device=x.device)
    for r in range(0, x.shape[0], step):
        ids = aid[r:r + step]
        keep = ids < k
        sums.index_add_(0, ids[keep].long(), x[r:r + step][keep].double())
    return sums


def hold_pass(label, x, valid, prev, c, b1, b2, errs, rows=None):
    """B1's and B2's results ``b1``, ``b2`` on (x, valid, prev, c) held
    against the plain twin on ``rows`` (every row when None; the twin is
    row-independent, so on a sample it runs on the gathered rows):
    assignments equal off near-ties, best scores within rtol 1e-5 plus
    1e-6 of |x|^2 + |c|^2 (their max |d| goes into ``errs``); B1 == B2 bitwise; B1's reassignment count
    and counts bitwise the plain counts of its own assignment.  B1's sums
    are held to fp64 sums of that assignment within rtol 1e-5: at these
    shapes a cluster holds 10^4 to 10^6 rows, and the plain segment sum
    (fp32 ``index_add_``, atomics in any order) rounds past rtol 1e-5
    there, so it is no reference for them.  Returns the kernel's and the
    plain segment sum's max relative errors against fp64."""
    k = c.shape[0]
    L2 = D.DistanceMetric.L2
    every = rows is None
    if every:
        xs, ref_a, ref_best, _ch = (x, *K.assign_only_pass_reference(
            x, valid, prev, c, n_clusters=k, metric=L2))
        got_a, got_best = b1[0], b1[1]
    else:
        xs = x[rows]
        ref_a, ref_best, _ch = K.assign_only_pass_reference(
            xs, valid[rows], prev[rows], c, n_clusters=k, metric=L2)
        got_a, got_best = b1[0][rows], b1[1][rows]
    differ = torch.nonzero(got_a != ref_a).squeeze(1)
    off_ties = int((~K.near_ties(xs[differ], c, L2)).sum()) \
        if differ.numel() else 0
    if off_ties:
        raise AssertionError("%s: %d assignments differ from the plain "
                             "twin's off ties" % (label, off_ties))
    same = got_a == ref_a
    # |c|^2 - 2 x.c cancels to near 0 where |c|^2 ~ 2 x.c (blobs at f=8):
    # there an ulp of the cancelled terms is past 1e-5 of the score, so
    # the card test's tolerance, rtol 1e-5 plus 1e-6 of |x|^2 + |c|^2
    # (tests/test_torch_kernels.py:_assert_best_close)
    c_sq = torch.cat([D.row_sq_norms(c), c.new_zeros(1)])   # id k: invalid
    size = D.row_sq_norms(xs[same].float()) + c_sq[ref_a[same].long()]
    gap = (got_best[same] - ref_best[same]).abs()
    bad = int((gap > 1e-5 * ref_best[same].abs() + 1e-6 * size).sum())
    if bad:
        raise AssertionError("%s: %d best scores past rtol 1e-5 + 1e-6 (|x|^2"
                             " + |c|^2) of the plain twin's" % (label, bad))
    best_err = float(gap.max())
    del xs, ref_a, ref_best, got_a, got_best, same, size, gap
    if not (torch.equal(b1[0], b2[0]) and torch.equal(b1[1], b2[1])
            and int(b1[4]) == int(b2[2])):
        raise AssertionError("%s: B1 and B2 differ" % label)
    if int(b1[4]) != int((b1[0] != prev).sum()):
        raise AssertionError("%s: changed differs from the plain count of "
                             "B1's assignment" % label)
    sums_own, counts_own = K.segment_sum_reference(x, b1[0], k)
    if not torch.equal(b1[3], counts_own):
        raise AssertionError("%s: B1 counts differ from a bincount of its "
                             "assignment" % label)
    sums64 = fp64_sums(x, b1[0], k)
    atol = 1e-5 * float(x.float().abs().mean())
    torch.testing.assert_close(b1[2].double(), sums64, rtol=1e-5, atol=atol)

    def rel64(sums):
        return float(((sums.double() - sums64).abs()
                      / sums64.abs().clamp(min=atol)).max())
    held = {"max_rel_err": rel64(b1[2]), "plain_max_rel_err": rel64(sums_own)}
    for name in ("fused_lloyd_pass", "assign_only_pass"):
        errs[name] = max(errs[name], best_err)
    plan = K.segment_plan(x.shape[0], x.shape[1], k, x.element_size())
    print("%s: B1 and B2 held against the plain twin on %s rows: "
          "assignments equal off ties (%d near-tie rows differ), max |d "
          "best| %.3g; B1 == B2 bitwise; B1 counts bitwise a bincount of "
          "its assignment (largest cluster %d rows); B1 sums within rtol "
          "1e-5 of fp64 sums of its assignment (max relative error %.3g; "
          "the plain segment sum's %.3g; %d chunks of %d rows)"
          % (label, "all %d" % x.shape[0] if every else "%d sampled"
             % rows.numel(), differ.numel(), best_err, int(b1[3].max()),
             held["max_rel_err"], held["plain_max_rel_err"],
             -(-x.shape[0] // plan.chunk), plan.chunk), flush=True)
    return held


def check_result(x, k, c, a, metric, device=0, rows=None):
    """Centroids finite or NaN rows of empty clusters (never assigned),
    assignments in [0, k), and equal to the plain assignment against the
    centroids they were computed with, off near-ties.  For fp32 those are
    the returned centroids; bf16 input gets them back rounded to bf16, so
    there the check restarts one iteration from the returned centroids
    through the same public call (with the same ``device`` mask, so over
    the same shards), whose assignment is computed against exactly them.
    ``rows`` (a sorted sample of row ids, :func:`sample_rows`) limits the
    plain argmin and the near-tie exemption to those rows: over all rows
    they hold an (n, k) fp32 score matrix, 33 GB at 167,772,160 x 50.
    Returns (empty clusters, near-tie rows that differ)."""
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
                            max_iterations=1, device=device)
    if rows is not None:
        x, a = x[rows], a[rows]
    if x.dtype == torch.float16:   # the call stores fp16 input as bf16
        x = x.to(torch.bfloat16)
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
        marks.append(_launches())
        out = group(*args, **kwargs)
        marks.append(_launches())
        return out

    Y._group_centroids = marked
    _reset_launches()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out = fn()
        torch.cuda.synchronize()
    finally:
        Y._group_centroids = group
    return out, buf.getvalue(), _launches(), marks


def yinyang_vs_lloyd(label, x, k, metric, rows=None, **kw):
    """The same call with yinyang_t=0.1 and 0 (verbosity 2): identical
    assignments, centroids and iteration lines, and the Yinyang loop
    launched B2; the argmin check on ``rows`` (all when None).  Returns
    ((c, a), Yinyang log, Yinyang launches, Lloyd launches)."""
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
    empty, ties = check_result(x, k, yy[0], yy[1], metric, rows=rows)
    print("%s: Yinyang == Lloyd bitwise (assignments, centroids, %d "
          "iteration lines); launches: draft %s, grouping %s, Yinyang loop "
          "%s, Lloyd run %s; %d empty clusters, %d near-tie rows differ "
          "from the plain argmin"
          % (label, count_iterations(yy_log), marks[0],
             {n: marks[1][n] - marks[0][n] for n in marks[0]}, loop, ll_n,
             empty, ties), flush=True)
    return yy, yy_log, yy_n, ll_n


def yinyang_variants(log: str) -> dict:
    """Iterations of each variant and the moved rows the patch walked, from
    the loop's verbosity-2 lines (``yinyang: <variant> iteration, N moved
    rows patched``)."""
    out = {v: 0 for v in YY.VARIANTS}
    out["patched rows"] = 0
    for l in log.splitlines():
        if l.startswith("yinyang: ") and " moved rows patched" in l:
            variant, rest = l[len("yinyang: "):].split(" iteration, ")
            out[variant] += 1
            out["patched rows"] += int(rest.split()[0])
    return out


def controller_events(log: str) -> str:
    """The controller's decisions in a verbosity-2 log: its windows, and
    each revocation and re-probe of the sparse branch."""
    lines = log.splitlines()
    windows = [l.split()[3] for l in lines
               if l.startswith("yinyang: segment of ")]
    revoked = sum(l.startswith("yinyang: sparse branch revoked")
                  for l in lines)
    reprobed = sum(l.startswith("yinyang: re-probing") for l in lines)
    return ("windows %s; sparse branch revoked %d times, re-probed %d "
            "times" % ("/".join(windows), revoked, reprobed))


def yinyang_profile(log: str) -> str:
    """The phase times, the Yinyang loop's ms per iteration, its
    iteration variants and patched rows, its controller decisions and its
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
    return ("%s; Yinyang loop %s ms per iteration; variants %s; %s; "
            "candidates/passed per Yinyang iteration: %s"
            % ("; ".join(phases), per_it, json.dumps(yinyang_variants(log)),
               controller_events(log), " ".join(counts)))


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
    their ratio.  Returns the launch counts of the default calls and the
    k-means++ start."""
    k = HEADLINE["k"]
    kw = dict(seed=1, tolerance=0.002, max_iterations=60)
    L2 = D.DistanceMetric.L2
    timed_init(x, k, L2, I.InitMethod.PLUS_PLUS, 1)
    pp_s, c0 = timed_init(x, k, L2, I.InitMethod.PLUS_PLUS, 1)
    _out, log, yy_n, ll_n = yinyang_vs_lloyd(
        "default call 100000x256 fp32 k=1024", x, k, L2, **kw)
    for launches in (yy_n, ll_n):
        require_launched("default call", launches, ("point_min",))
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
    return yy_n, ll_n, c0


def bf16_yinyang_phase(tag, xb):
    """Yinyang == Lloyd at 1M x 256 bf16 (random init, tolerance 0, 60
    iterations, past the budget gates); returns the launch counts of both
    runs."""
    k = BF16_RUN["k"]
    kw = dict(init="random", seed=1, tolerance=0.0, max_iterations=60)
    _out, log, yy_n, ll_n = yinyang_vs_lloyd(
        "1000000x256 bf16 k=1024 Yinyang", xb, k, D.DistanceMetric.L2, **kw)
    walls = {0.1: [], 0: []}
    for yt in (0, 0.1, 0.1, 0):
        walls[yt].append(wall_s(lambda: kmeans_cuda(xb, k, yinyang_t=yt,
                                                    **kw)))
    yy_s, ll_s = min(walls[0.1]), min(walls[0])
    print("%s 1000000x256 bf16 k=1024, %d iterations: Yinyang wall %.4f s "
          "(min of %s), Lloyd wall %.4f s (min of %s), Yinyang / Lloyd "
          "%.3f; %s"
          % (tag, count_iterations(log), yy_s,
             ", ".join("%.4f" % w for w in walls[0.1]), ll_s,
             ", ".join("%.4f" % w for w in walls[0]), yy_s / ll_s,
             yinyang_profile(log)), flush=True)
    return yy_n, ll_n


def bf16_blobs(seed=21):
    """BF16_BLOBS on the card as fp16: 1,024 centers U(0, 8)^256 and each
    row a center plus 0.3 N(0, 1), so d^2 to the own centroid (~23) is far
    below |x| |c| (~5,500): the bf16 panel's absolute score error (about
    2^-7 |x| |c|) is larger than a margin relative to the distance."""
    b = BF16_BLOBS
    g = torch.Generator(device="cuda").manual_seed(seed)
    centers = torch.rand(b["k"], b["f"], generator=g, device="cuda") * 8.0
    which = torch.randint(0, b["k"], (b["n"],), generator=g, device="cuda")
    x = centers[which] + b["spread"] * torch.randn(
        b["n"], b["f"], generator=g, device="cuda")
    return x.to(torch.float16)


def bf16_blob_yinyang_phase(tag):
    """Yinyang == Lloyd bitwise at BF16_BLOBS from one imported k-means++
    start (tolerance 0.002, at most 60 iterations), the argmin on a row
    sample; the iteration variants and candidate counts, and both walls
    in turns.  Returns the launch counts of both runs."""
    b = BF16_BLOBS
    x = bf16_blobs()
    k = b["k"]
    L2 = D.DistanceMetric.L2
    pp_s, c0 = timed_init(x, k, L2, I.InitMethod.PLUS_PLUS, 4)
    kw = dict(init=c0, tolerance=0.002, max_iterations=60)
    label = "%dx%d fp16 blobs U(0, 8) spread %g k=%d" % (
        b["n"], b["f"], b["spread"], k)
    _out, log, yy_n, ll_n = yinyang_vs_lloyd(label, x, k, L2,
                                             rows=sample_rows(b["n"]), **kw)
    walls = {0.1: [], 0: []}
    for yt in (0, 0.1, 0.1, 0):
        walls[yt].append(wall_s(lambda: kmeans_cuda(x, k, yinyang_t=yt,
                                                    **kw)))
    yy_s, ll_s = min(walls[0.1]), min(walls[0])
    print("%s %s, %d iterations from k-means++ seed 4 (%.4f s): Yinyang "
          "wall %.4f s (min of %s), Lloyd wall %.4f s (min of %s), Yinyang "
          "/ Lloyd %.3f; %s"
          % (tag, label, count_iterations(log), pp_s, yy_s,
             ", ".join("%.4f" % w for w in walls[0.1]), ll_s,
             ", ".join("%.4f" % w for w in walls[0]), yy_s / ll_s,
             yinyang_profile(log)), flush=True)
    return yy_n, ll_n


def bench_pair_phase(tag, x):
    """The JAX bench's 15-iteration pair (bench.py:136-177: the headline
    data, random init, seed 1, tolerance 0.002): the pre-draft budget gate
    hands the Yinyang call to Lloyd, so nothing is grouped and the results
    are Lloyd's bitwise; walls min of 3, interleaved.  Returns the launch
    counts of the Yinyang call."""
    k = HEADLINE["k"]
    kw = dict(init="random", seed=1, tolerance=0.002, max_iterations=15)
    yy, yy_log, yy_n, marks = run_marked(lambda: kmeans_cuda(
        x, k, yinyang_t=0.1, verbosity=2, **kw))
    ll, ll_log, _ll_n, _ = run_marked(lambda: kmeans_cuda(
        x, k, yinyang_t=0, verbosity=2, **kw))
    gate = ("yinyang: budget 15 < YY_MIN_REMAINING=%d; running the Lloyd "
            "driver outright (identical results)" % config.YY_MIN_REMAINING)
    if gate not in yy_log.splitlines():
        raise AssertionError("15-iteration pair: no budget gate line")
    if marks or "group capacity" in yy_log:
        raise AssertionError("15-iteration pair: the centroids were grouped")
    if iteration_lines(yy_log) != iteration_lines(ll_log) or not (
            torch.equal(yy[1], ll[1]) and nan_equal(yy[0], ll[0])):
        raise AssertionError("15-iteration pair: Yinyang and Lloyd differ")
    walls = {0.1: [], 0: []}
    for _ in range(3):
        for yt in (0, 0.1):
            walls[yt].append(wall_s(lambda: kmeans_cuda(x, k, yinyang_t=yt,
                                                        **kw)))
    yy_s, ll_s = min(walls[0.1]), min(walls[0])
    print("%s 15-iteration pair 100000x256 fp32 k=1024 (bench.py:136-177): "
          "gate line '%s'; no grouping; Yinyang == Lloyd bitwise (%d "
          "iterations); Yinyang wall %.4f s (min of 3: %s), Lloyd wall %.4f "
          "s (min of 3: %s), Yinyang / Lloyd %.3f; launches %s"
          % (tag, gate, count_iterations(yy_log), yy_s,
             ", ".join("%.4f" % w for w in walls[0.1]), ll_s,
             ", ".join("%.4f" % w for w in walls[0]), yy_s / ll_s, yy_n),
          flush=True)
    return yy_n


def deep_tail_data():
    """The deep-tail samples (``bench_torch.deep_tail_blobs``, made on the
    card from seed 3) and the centroids of 15 iterations from random
    init."""
    k = B.size("deep_tail")[2]
    x = B.deep_tail_blobs("cuda")
    c_tail, _a = kmeans_cuda(x, k, init="random", seed=3, tolerance=0.0,
                             yinyang_t=0.1, max_iterations=15)
    return x, c_tail


def deep_tail_phase(tag):
    """The JAX bench's deep-tail restart (bench.py:50-133): 2M x 256 fp32
    merged blobs (k=1024 centers U(0, 1) * 2, 0.5 * N(0, 1) noise, seed 3,
    made on the card), 15 iterations from random, then Yinyang and Lloyd
    restarted from those centroids with 45 iterations each: bitwise equal,
    both walls (min of 2, interleaved) and their ratio, the candidate and
    passed counts per iteration and the controller's decisions.  Returns
    the launch counts of both restarts."""
    k = B.size("deep_tail")[2]
    x, c_tail = deep_tail_data()
    kw = dict(init=c_tail, tolerance=0.0, max_iterations=45)
    _out, log, yy_n, ll_n = yinyang_vs_lloyd(
        "deep tail 2000000x256 fp32 k=1024 restart", x, k,
        D.DistanceMetric.L2, **kw)
    walls = {0.1: [], 0: []}
    for yt in (0, 0.1, 0.1, 0):
        walls[yt].append(wall_s(lambda: kmeans_cuda(x, k, yinyang_t=yt,
                                                    **kw)))
    yy_s, ll_s = min(walls[0.1]), min(walls[0])
    print("%s deep tail 2000000x256 fp32 k=1024, restart of %d iterations: "
          "Yinyang wall %.4f s (min of 2: %s), Lloyd wall %.4f s (min of 2: "
          "%s), Yinyang / Lloyd %.3f; %s"
          % (tag, count_iterations(log), yy_s,
             ", ".join("%.4f" % w for w in walls[0.1]), ll_s,
             ", ".join("%.4f" % w for w in walls[0]), yy_s / ll_s,
             yinyang_profile(log)), flush=True)
    del x
    return yy_n, ll_n


#: schedules forced through the Yinyang knobs; each must leave the
#: trajectory Lloyd's
FORCED_SCHEDULES = (
    # margin 0 revokes every judged sparse-heavy window; the dense
    # fraction makes the windows sparse-heavy on uniform data
    ("revoke always", dict(YY_BAILOUT_MARGIN=0.0, YY_PROBE_ITERS=2,
                           YY_DENSE_FRACTION=0.99)),
    ("dense fraction 0.01", dict(YY_DENSE_FRACTION=0.01)),
    ("dense fraction 0.99", dict(YY_DENSE_FRACTION=0.99)),
    ("bf16 bounds", dict(YY_BOUNDS_F32_MAX_BYTES=0)),
)


@contextlib.contextmanager
def knobs(**values):
    """``kmcuda_torch.config`` values set for the block, then restored."""
    saved = {key: getattr(config, key) for key in values}
    try:
        for key, val in values.items():
            setattr(config, key, val)
        yield
    finally:
        for key, val in saved.items():
            setattr(config, key, val)


def forced_schedules(label, x, k, **kw):
    """Yinyang under each of FORCED_SCHEDULES against Lloyd, bitwise
    (assignments, centroids, iteration lines)."""
    ll, ll_log, _n, _m = run_marked(lambda: kmeans_cuda(
        x, k, yinyang_t=0, verbosity=1, **kw))
    for name, values in FORCED_SCHEDULES:
        with knobs(**values):
            yy, yy_log, _n, marks = run_marked(lambda: kmeans_cuda(
                x, k, yinyang_t=0.1, verbosity=2, **kw))
        if len(marks) != 2:
            raise AssertionError("%s, %s: the Yinyang loop was not entered"
                                 % (label, name))
        if iteration_lines(yy_log) != iteration_lines(ll_log) or not (
                torch.equal(yy[1], ll[1]) and nan_equal(yy[0], ll[0])):
            raise AssertionError("%s, %s: Yinyang and Lloyd differ"
                                 % (label, name))
        if name == "bf16 bounds" and "bf16 lower-bound storage" not in yy_log:
            raise AssertionError("%s: bounds not stored in bf16" % label)
        if name == "revoke always" and "sparse branch revoked" not in yy_log:
            raise AssertionError("%s: the sparse branch was never revoked"
                                 % label)
        print("forced schedule '%s' on %s: Yinyang == Lloyd bitwise (%d "
              "iterations); variants %s; %s"
              % (name, label, count_iterations(yy_log),
                 json.dumps(yinyang_variants(yy_log)),
                 controller_events(yy_log)), flush=True)


def spherical_phase(tag):
    """AFK-MC2 at the JAX bench's spherical configuration
    (bench.py:180-191); returns the call's launch counts."""
    s = SPHERICAL
    cos = D.DistanceMetric.COSINE
    x = B.unit_rows("cuda")
    init_s, _ = timed_init(x, s["k"], cos, I.InitMethod.AFKMC2, 7, s["m"])
    _reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t = time.perf_counter()
        c, a = kmeans_cuda(x, s["k"], init=("afkmc2", s["m"]), seed=7,
                           metric="cos", tolerance=0.01, yinyang_t=0,
                           max_iterations=20, verbosity=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launches = _launches()
    require_launched("spherical AFK-MC2", launches, ("point_min",))
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


# ---------------------------------------------------------------------------
# The init step (point_min) and the row-blocked prepare passes

#: (f, row counts) held kernel against twin: f = 3 and 257 take the
#: element-wise loads, f = 8 packs 16 (fp32) or 32 (bf16) rows in a warp,
#: f = 256 is the main path's; the row counts cut the last warp, block and
#: (1,000,003) the grid-stride loop's last round
POINT_MIN_CASES = ((3, (1, 33, 100_003)), (8, (1, 33, 100_003)),
                   (256, (1, 33, 100_003, 1_000_003)),
                   (257, (1, 33, 100_003)))


def point_min_inputs(n, f, metric, fp16, seed):
    """A problem as ``prepare`` leaves it (x in its storage dtype, x_sq,
    valid; 1% of the rows NaN in the input, so zeroed and invalid) from
    U(0, 1) rows (unit rows for cosine), fp32 or fp16 input; and two
    points near valid rows, fp32 (unit for cosine)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(n, f, generator=g, device="cuda")
    if metric == D.DistanceMetric.COSINE:
        x = x / x.norm(dim=1, keepdim=True)
    x[torch.randperm(n, generator=g, device="cuda")[:n // 100]] = \
        float("nan")
    p = prepare(x.half() if fp16 else x, 1, metric, x.device, Logger(0))
    rows = torch.nonzero(p.valid)[:, 0]
    pick = rows[torch.randint(0, rows.numel(), (2,), generator=g,
                              device="cuda")]
    cs = p.x[pick].float() + 0.01 * torch.rand(2, f, generator=g,
                                               device="cuda")
    if metric == D.DistanceMetric.COSINE:
        cs = cs / cs.norm(dim=1, keepdim=True)
    return p, cs


def point_min_errors(p, c, got, ref, metric):
    """(max |got - ref|, the valid rows past the tolerance, the valid rows
    where the kernel is further from fp64 than the twin plus the
    tolerance) for two first-step outputs (the distances): L2 in the d^2
    domain within 1e-6 (x_sq + |c|^2), cosine in the cos domain within
    1e-6 |x| |c|.  The fp64 distance takes c rounded to the storage dtype
    for the product, |c|^2 from the fp32 c."""
    xd = p.x.double()
    cd = c.double()
    prod = xd @ c.to(p.x.dtype).double()
    if metric == D.DistanceMetric.L2:
        tol = 1e-6 * (p.x_sq.double() + (cd * cd).sum())
        want = (xd * xd).sum(dim=1) - 2.0 * prod + (cd * cd).sum()
        dom = lambda d: d.double() ** 2
    else:
        tol = 1e-6 * xd.norm(dim=1) * cd.norm()
        want = prod
        dom = lambda d: torch.cos(d.double())
    sel = p.valid
    g, r, w, t = dom(got)[sel], dom(ref)[sel], want[sel], tol[sel]
    past = int(((g - r).abs() > t).sum())
    worse = int(((g - w).abs() > (r - w).abs() + t).sum())
    return float((got - ref).abs().max()), past, worse


def check_point_min():
    """``kmt_point_min`` against its plain twin on the card: fp32 and bf16
    (fp16 input), L2 and cosine, with invalid rows, at every
    POINT_MIN_CASES shape.  A first step from each of two points: the
    distances agree (:func:`point_min_errors`), the kernel is no further
    from fp64 than the twin plus the tolerance, invalid rows hold 0, a
    repeat is bitwise.  Then a later step from the twin's first: bitwise
    the minimum of its input and the kernel's own distances, NaN-free, so
    never above its input.  Returns the largest |kernel - twin|."""
    worst = 0.0
    for f, ns in POINT_MIN_CASES:
        for n in ns:
            for fp16 in (False, True):
                for metric in (D.DistanceMetric.L2, D.DistanceMetric.COSINE):
                    p, cs = point_min_inputs(n, f, metric, fp16, 5)
                    args = (p.x, p.x_sq, p.valid)
                    label = "point_min %dx%d %s %s" % (
                        n, f, "bf16 (fp16 input)" if fp16 else "fp32",
                        metric.name)
                    firsts, errs = [], []
                    for c in cs:
                        got, again, ref = (
                            step(*args, c, torch.empty_like(p.x_sq), metric,
                                 first=True)
                            for step in (IK.point_min, IK.point_min,
                                         IK.point_min_reference))
                        torch.cuda.synchronize()
                        if not torch.equal(got, again):
                            raise AssertionError("%s: no bitwise repeat"
                                                 % label)
                        if bool((got[~p.valid] != 0).any()):
                            raise AssertionError("%s: an invalid row is not "
                                                 "0" % label)
                        err, past, worse = point_min_errors(p, c, got, ref,
                                                            metric)
                        if past or worse:
                            raise AssertionError(
                                "%s: %d rows past the tolerance, %d further "
                                "from fp64 than the twin" % (label, past,
                                                             worse))
                        firsts.append((got, ref))
                        errs.append(err)
                    start = firsts[0][1]
                    later = IK.point_min(*args, cs[1], start.clone(), metric,
                                         first=False)
                    if not torch.equal(later, torch.minimum(
                            start, firsts[1][0])) or bool(
                                torch.isnan(later).any()):
                        raise AssertionError("%s: the later step is not the "
                                             "minimum" % label)
                    worst = max(worst, *errs)
                    print("check %s: ok (max |kernel - twin| %s; %d invalid "
                          "rows at 0; the later step the minimum, bitwise)"
                          % (label, ", ".join("%.3g" % e for e in errs),
                             int((~p.valid).sum())), flush=True)
                    del p, cs, firsts, start, later
    return worst


def check_row_sq_norms(x):
    """x_sq over row blocks (``ops.distance.row_sq_norms``, at its block
    size and at 1 MB blocks) against the whole-tensor pass on the card:
    prints the rows that differ and by how many ulps; where any differs,
    holds both to fp64 within rtol f * 2**-24.  Returns the differing row
    count."""
    n, f = x.shape
    xf = x.float()
    whole = torch.sum(xf * xf, dim=-1)
    del xf
    differ = 0
    for block in (D.ROW_BLOCK_BYTES, 1 << 20):
        saved, D.ROW_BLOCK_BYTES = D.ROW_BLOCK_BYTES, block
        try:
            blocks = D.row_blocks(n, f)
            blocked = D.row_sq_norms(x)
        finally:
            D.ROW_BLOCK_BYTES = saved
        rows = blocked != whole
        count = int(rows.sum())
        line = ("x_sq over %d blocks of %d rows vs the whole pass, %dx%d %s: "
                "%d rows differ" % (len(blocks), blocks[0][1] - blocks[0][0],
                                    n, f, str(x.dtype)[6:], count))
        if count:
            ulps = (blocked.view(torch.int32)
                    - whole.view(torch.int32)).abs()[rows]
            x64 = torch.cat([(x[s:e].double() ** 2).sum(dim=1)
                             for s, e in blocks])
            line += " (max %d ulps)" % int(ulps.max())
            for name, got in (("blocked", blocked), ("whole", whole)):
                rel = float(((got.double() - x64).abs() / x64).max())
                line += "; %s vs fp64 rtol %.3g" % (name, rel)
                if rel > f * 2.0**-24:
                    raise AssertionError("x_sq (%s) past rtol f * 2**-24 of "
                                         "fp64" % name)
        else:
            line += " (bitwise)"
        print(line, flush=True)
        differ += count
    return differ


def time_point_min(tag, p, reps):
    """The init step at a prepared problem's shape, as the loop runs it (a
    later step, in place): kernel and plain twin in turns (plain, kernel,
    kernel, plain), then ``torch.mv(x, c)`` with c in the storage dtype
    (the product only; timed, never called by the port), beside the bound
    from ``roofline.py``.  Returns {ms, plain_ms, library_ms, library,
    bound_ms, bound_by}."""
    n, f = p.x.shape
    L2 = D.DistanceMetric.L2
    c = p.x[n // 2].float()
    m = IK.point_min(p.x, p.x_sq, p.valid, p.x[0].float(),
                     torch.empty_like(p.x_sq), L2, first=True)
    cs = c.to(p.x.dtype)
    name_dt = str(p.x.dtype)[6:]
    kern = lambda: IK.point_min(p.x, p.x_sq, p.valid, c, m, L2, first=False)
    plain = lambda: IK.point_min_reference(p.x, p.x_sq, p.valid, c, m, L2,
                                           first=False)
    p1 = time_ms(plain, reps)
    k1 = time_ms(kern, reps)
    k2 = time_ms(kern, reps)
    p2 = time_ms(plain, reps)
    lib_ms = time_ms(lambda: torch.mv(p.x, cs), reps)
    bnd = R.point_min_bound(n, f, name_dt, first=False)
    out = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
           "library_ms": lib_ms, "library": "torch.mv(x, c), product only",
           "bound_ms": bnd["ms"], "bound_by": bnd["by"]}
    print("%s time point_min %dx%d %s: kernel %.4f ms (%.4f/%.4f), plain "
          "%.4f ms (%.4f/%.4f), library %.4f ms (torch.mv(x, c), product "
          "only), bound %.4f ms (%s; %.4g bytes)"
          % (tag, n, f, name_dt, out["ms"], k1, k2, out["plain_ms"], p1, p2,
             lib_ms, bnd["ms"], bnd["by"], bnd["bytes"]), flush=True)
    del m
    return out


def kmeanspp_picks(label, x, k, seed):
    """k-means++ on ``x`` twice in lockstep, from one set of draws: each
    step's distances and draw through the kernels (``point_min``,
    ``weighted_draw``) and through their plain twins, each path drawing
    from its own weights.  The picks must be equal; a pick may
    differ only between two adjacent valid rows, with the draw's uniform
    between the two paths' cumulative shares through the lower one (see
    :func:`flip_margin`; checked at the first differing step, whose step
    and margin print; the paths part there).  Where every pick is equal, they must also be the
    rows ``init_centroids`` picks on the same problem.  Returns the first
    differing step or None."""
    L2 = D.DistanceMetric.L2
    p = prepare(x, k, L2, x.device, Logger(0))
    us = torch.rand(k, generator=I.generator(seed)).to(x.device)
    validf = p.valid.float()
    first = IK.weighted_draw(validf, p.valid, us[0:1])
    if not torch.equal(first, IK.weighted_draw_reference(validf, p.valid,
                                                         us[0:1])):
        raise AssertionError("%s: the first draw is not the twin's" % label)
    picks = [int(first)]
    c = p.x[first[0]].float()
    ws = [IK.point_min(p.x, p.x_sq, p.valid, c, torch.empty_like(p.x_sq),
                       L2, first=True),
          IK.point_min_reference(p.x, p.x_sq, p.valid, c,
                                 torch.empty_like(p.x_sq), L2, first=True)]
    draws = (IK.weighted_draw, IK.weighted_draw_reference)
    parted = None
    t = time.perf_counter()
    for i in range(1, k):
        got = [int(draw(wi, p.valid, us[i:i + 1]))
               for draw, wi in zip(draws, ws)]
        if got[0] != got[1]:
            parted = i
            flip_margin(label, i, ws, float(us[i]), got, p.valid)
            break
        picks.append(got[0])
        if i + 1 < k:
            c = p.x[got[0]].float()
            IK.point_min(p.x, p.x_sq, p.valid, c, ws[0], L2, first=False)
            IK.point_min_reference(p.x, p.x_sq, p.valid, c, ws[1], L2,
                                   first=False)
    lock_s = time.perf_counter() - t
    if parted is None:
        cent = I.init_centroids(p, I.InitMethod.PLUS_PLUS, seed)
        if not torch.equal(cent, p.x[torch.tensor(picks, device=x.device)]
                           .float()):
            raise AssertionError("%s: init_centroids picks other rows than "
                                 "the lockstep kernel path" % label)
    print("%s k-means++ picks (seed %d), kernel vs plain twin in lockstep "
          "(%.1f s): %s" % (label, seed, lock_s,
                            "all %d equal, and init_centroids' own" % k
                            if parted is None else
                            "equal up to step %d, where the draw's uniform "
                            "sits on the boundary (above)" % parted),
          flush=True)
    del p, ws
    return parted


def flip_margin(label, step, w, u, got, valid):
    """At a step where the kernel's and the twin's weights ``w`` drew other
    rows ``got``: the draw is explained only when the two picks are
    adjacent valid rows and the uniform u lies between the two paths'
    fp64 cumulative shares through the lower pick, Q_kernel(lo) and
    Q_twin(lo), widened by no more than the fp32 draw's rounding
    (``init_kernels.draw_margin``: (R + 140) 2**-24 of the total, R the
    chunk partials a group of the draw's tree holds).  Prints the step,
    both shares and u's distance outside them; fails otherwise."""
    lo, hi = min(got), max(got)
    n = w[0].numel()
    eps = IK.draw_margin(n)
    q = [float(wi[:lo + 1].double().sum() / wi.double().sum()) for wi in w]
    outside = max(min(q) - u, u - max(q), 0.0)
    between = int(valid[lo + 1:hi].sum())
    print("%s: k-means++ picks part at step %d: kernel row %d, twin row %d; "
          "u %.12f; Q(lo) %.12f (kernel), %.12f (twin), %.3g apart; u %.3g "
          "outside them (draw rounding %.3g); %d valid rows between the "
          "picks" % (label, step, got[0], got[1], u, q[0], q[1],
                     abs(q[0] - q[1]), outside, eps, between), flush=True)
    if between or outside > eps:
        raise AssertionError("%s: picks part at step %d off the draw's "
                             "boundary" % (label, step))


# ---------------------------------------------------------------------------
# The k-means++ step's draw (weighted_draw) and the start's repeat

def draw_weights(p, steps=4):
    """A k-means++ state on the prepared problem ``p``: the running minimum
    distances after ``steps`` steps from rows spread over x (those rows
    weigh 0), with every 50th row also set to 0."""
    n = p.x.shape[0]
    w = torch.empty_like(p.x_sq)
    for s in range(steps):
        IK.point_min(p.x, p.x_sq, p.valid, p.x[s * n // steps].float(), w,
                     D.DistanceMetric.L2, first=s == 0)
    w[::50] = 0
    return w


def check_weighted_draw(tag, label, p, draws, reps):
    """``kmt_weighted_draw`` against its twin on the prepared problem ``p``
    (:func:`draw_weights`): at ``draws`` uniforms from a seed and the ends
    of [0, 1), the index bitwise the twin's and of positive weight, the
    copied row bitwise the drawn row of x as fp32, a repeat bitwise; at
    all-zero weights (the fallback) bitwise the twin's and a valid row.
    Then timed (:func:`time_weighted_draw`).  Returns the times and, as
    ``max_abs_err``, the largest difference measured: between the
    kernel's index and the twin's, a repeat's, the fallback twin's, and
    between a copied row and the drawn row of x (anything but 0
    raises)."""
    n, f = p.x.shape
    w = draw_weights(p)
    us = torch.cat([torch.rand(draws, generator=I.generator(n)),
                    torch.tensor([0.0, 1.0 - 2.0**-24])]).to(p.x.device)
    out = torch.empty(f, device=p.x.device)
    got, want, row_err = [], [], []
    for i in range(us.numel()):
        u = us[i:i + 1]
        got.append(IK.weighted_draw(w, p.valid, u, row_source=p.x,
                                    out_row=out))
        want.append(IK.weighted_draw_reference(w, p.valid, u))
        row_err.append((out - p.x[got[-1][0]].float()).abs().max())
    got, want = torch.cat(got), torch.cat(want)
    row_err = float(torch.stack(row_err).max())
    again = torch.cat([IK.weighted_draw(w, p.valid, us[i:i + 1])
                       for i in range(us.numel())])
    zero = torch.zeros_like(w)
    fall = torch.cat([IK.weighted_draw(zero, p.valid, us[i:i + 1])
                      for i in range(8)])
    fall_twin = torch.cat([IK.weighted_draw_reference(zero, p.valid,
                                                      us[i:i + 1])
                           for i in range(8)])
    err = max(row_err, *(float((a - b).abs().max()) for a, b in (
        (got, want), (got, again), (fall, fall_twin))))
    if not (torch.equal(got, want) and torch.equal(got, again)):
        raise AssertionError("weighted_draw %s: %d of %d indices differ from "
                             "the twin's or the repeat" % (
                                 label, int((got != want).sum()),
                                 got.numel()))
    if row_err != 0 or not bool((w[got] > 0).all()):
        raise AssertionError("weighted_draw %s: a copied row differs from "
                             "x's, or a zero-weight row was drawn" % label)
    if not (torch.equal(fall, fall_twin) and bool(p.valid[fall].all())):
        raise AssertionError("weighted_draw %s: the all-zero fallback is "
                             "not the twin's valid row" % label)
    print("check weighted_draw %s: ok; %d indices bitwise the twin's (and "
          "a repeat), each of positive weight (%d rows of weight 0), every "
          "copied row bitwise x's; all-zero weights: the twin's valid rows"
          % (label, got.numel(), int((w == 0).sum())), flush=True)
    return {**time_weighted_draw(tag, label, p, w, reps), "max_abs_err": err}


def time_weighted_draw(tag, label, p, w, reps):
    """The draw at one shape as the k-means++ loop runs it (one shard: the
    row copied into a centroid row): kernel and twin in turns (plain,
    kernel, kernel, plain), then ``torch.multinomial(w, 1)`` where n <=
    2**24 (its limit; timed, never called by the port), beside the bound
    from ``roofline.py``; and one profiled window, the device time of each
    of the kernel's two launches.  Returns {ms, plain_ms, library_ms,
    library, bound_ms, bound_by, launch_ms}."""
    n, f = p.x.shape
    u = torch.rand(1, generator=I.generator(3)).to(p.x.device)
    out = torch.empty(f, device=p.x.device)
    kern = lambda: IK.weighted_draw(w, p.valid, u, row_source=p.x,
                                    out_row=out)
    plain = lambda: IK.weighted_draw_reference(w, p.valid, u)
    p1 = time_ms(plain, reps)
    k1 = time_ms(kern, reps)
    k2 = time_ms(kern, reps)
    p2 = time_ms(plain, reps)
    lib_ms = (time_ms(lambda: torch.multinomial(w, 1), reps)
              if n <= 2**24 else None)
    name_dt = str(p.x.dtype)[6:]
    bnd = R.draw_bound(n, f, name_dt)
    launch_ms = device_ms(kern, reps)
    out_t = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
             "library_ms": lib_ms,
             "library": "torch.multinomial(w, 1)" if lib_ms else None,
             "bound_ms": bnd["ms"], "bound_by": bnd["by"],
             "launch_ms": launch_ms}
    print("%s time weighted_draw %s: kernel %.4f ms (%.4f/%.4f; device: %s), "
          "plain %.4f ms (%.4f/%.4f), library %s, bound %.4f ms (%s; %.4g "
          "bytes)" % (tag, label, out_t["ms"], k1, k2, ", ".join(
              "%s %.4f" % kv for kv in launch_ms.items()), out_t["plain_ms"],
              p1, p2, "%.4f ms (torch.multinomial(w, 1))" % lib_ms
              if lib_ms else "none (n > 2**24)", bnd["ms"], bnd["by"],
              bnd["bytes"]), flush=True)
    return out_t


def kernel_name(name: str) -> str:
    """A profiler event's short name: the kernel's own name (and its
    template argument), or the copy or set as the profiler names it."""
    m = re.search(r"(\w+_kernel)(<[\w:]+>)?", name)
    return "".join(m.groups("")) if m else name.split(" (")[0]


def device_ms(fn, reps):
    """{kernel name: device ms a call} of ``fn`` over one profiled window
    of ``reps`` calls (kernel intervals from ``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = kernel_name(e.name)
            out[name] = out.get(name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / reps
    return out


def kmeanspp_launches(tag, x, k, seed=1):
    """k-means++ (``init_centroids``) on the headline samples: walls (min
    of 3, after a warm call) and one profiled call, its device kernels,
    copies and sets by name, per step.  Fails unless a step is three
    launches (``point_min`` and the draw's two) and nothing is copied
    from the card.  Returns (the wall, kernels a step)."""
    from torch.profiler import ProfilerActivity, profile
    p = prepare(x, k, D.DistanceMetric.L2, x.device, Logger(0))
    fn = lambda: I.init_centroids(p, I.InitMethod.PLUS_PLUS, seed)
    fn()
    walls = [wall_s(fn) for _ in range(3)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kinds = {"kernel": 0, "Memcpy DtoH": 0, "Memcpy": 0, "Memset": 0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kind = ("Memcpy DtoH" if e.name.startswith("Memcpy DtoH") else
                "Memcpy" if e.name.startswith("Memcpy") else
                "Memset" if e.name.startswith("Memset") else "kernel")
        kinds[kind] += 1
    per_step = kinds["kernel"] / (k - 1)
    print("%s k-means++ %dx%d %s k=%d: %.4f s (min of 3: %s); one call "
          "traced: %d kernels (%.3f a step), %d copies to the host, %d other "
          "copies, %d sets" % (tag, x.shape[0], x.shape[1], str(x.dtype)[6:],
                               k, min(walls), ", ".join("%.4f" % v
                                                        for v in walls),
                               kinds["kernel"], per_step,
                               kinds["Memcpy DtoH"], kinds["Memcpy"],
                               kinds["Memset"]), flush=True)
    if kinds["kernel"] > 3 * k + 8 or kinds["Memcpy DtoH"]:
        raise AssertionError("k-means++: %s, not three launches a step and "
                             "no read" % kinds)
    del p
    return min(walls), per_step


#: the repeat gate's second process prints its digest after this
START_TAG = "8M start: "


def start_digest(x=None, busy=False):
    """bench.py's 8M config's k-means++ start (8,000,000 x 256 bf16,
    k=1024, seed 17: ``init_centroids`` on a prepared problem of its
    samples, made here when ``x`` is None); with ``busy``, while a second
    stream runs B2 at that shape.  Returns the centroids' sha256."""
    x = B.uniform_bf16_rows("cuda") if x is None else x
    k, L2 = BENCH_8M["k"], D.DistanceMetric.L2
    p = prepare(x, k, L2, x.device, Logger(0))
    if busy:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        c = p.x[:k].float()
        with torch.cuda.stream(side):
            for _ in range(60):
                K.assign_only_pass(p.x, p.valid, p.assign0, c, n_clusters=k,
                                   metric=L2)
    cent = I.init_centroids(p, I.InitMethod.PLUS_PLUS, 17)
    torch.cuda.synchronize()
    digest = hashlib.sha256(cent.cpu().numpy().tobytes()).hexdigest()
    del p, cent
    return digest


def start_child():
    """The gate's second process: one start on freshly made samples."""
    print(START_TAG + start_digest(), flush=True)


def start_repeat_gate(tag, starts, x):
    """The start's repeat gate: bench.py's 8M start bitwise equal across
    ``starts``
    (this process's, before and after ``check_delta_sum``), one more with
    a second stream busy on B2 and one from a second process.  Prints the
    digests; fails unless they are one."""
    starts = dict(starts)
    starts["second stream busy on B2"] = start_digest(x, busy=True)
    gc.collect()
    torch.cuda.empty_cache()
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke as S; S.start_child()"],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    line = [l for l in proc.stdout.splitlines() if l.startswith(START_TAG)]
    if proc.returncode != 0 or not line:
        print(proc.stdout + proc.stderr, flush=True)
        raise AssertionError("start repeat gate: the second process "
                             "exited %d" % proc.returncode)
    starts["second process"] = line[-1][len(START_TAG):]
    print("%s start repeat gate, bench.py 8M k-means++ start (seed 17): "
          "%s" % (tag, "; ".join("%s %s" % (cond, d[:16])
                                 for cond, d in starts.items())), flush=True)
    if len(set(starts.values())) != 1:
        raise AssertionError("start repeat gate: the 8M start does not "
                             "repeat: %s" % starts)


# ---------------------------------------------------------------------------
# The sparse iteration's delta (delta_sum)

#: (n, f, k, dtype, [(moved rows, skewed)]) held kernel against twin and
#: fp64: 100K fp32 and 1M bf16 (the headline's and the 1M run's shapes, at
#: moved shares of their sparse iterations), k=16,384, and bench.py's 8M
#: config at the moved-row counts of its last, a middle and its first
#: sparse iteration (79,484, 204,209 and 630,524 rows on the card); a
#: skewed case sends half the moved rows to cluster 0
DELTA_CASES = (
    (100_000, 256, 1024, torch.float32, ((8_000, False), (8_000, True))),
    (1_000_000, 256, 1024, torch.bfloat16, ((80_000, False),
                                             (80_000, True))),
    (1_000_000, 256, 16_384, torch.bfloat16, ((80_000, False),)),
    (8_000_000, 256, 1024, torch.bfloat16,
     ((79_484, False), (204_209, False), (630_524, False),
      (204_209, True))),
)
#: the case whose times stand at the top of the kernel's entry: bench.py's
#: 8M config at its middle sparse iteration's moved rows
DELTA_MAIN = "8000000x256 bfloat16 k=1024 m=204209"


def delta_inputs(x, k, m, skew, seed):
    """A sparse iteration's ids on the card: an old assignment in [0, k)
    with every 997th row invalid (id k), and m moved rows (ascending,
    int32) each given another id (an invalid one a valid id); with
    ``skew`` half of them cluster 0."""
    n = x.shape[0]
    g = torch.Generator(device="cuda").manual_seed(seed)
    old = torch.randint(0, k, (n,), generator=g, device="cuda",
                        dtype=torch.int32)
    old[::997] = k
    rows = torch.sort(torch.randperm(n, generator=g, device="cuda")[:m])[0]
    new = old.clone()
    new[rows] = ((old[rows] + torch.randint(
        1, k, (m,), generator=g, device="cuda", dtype=torch.int32)) % k)
    if skew:
        new[rows[::2]] = 0
    return rows.to(torch.int32), new, old


def fp64_delta(x, rows, new, old, k):
    """(sums, magnitude, counts): the delta in fp64, the fp64 sum of |x_r|
    over both sides of each cluster, and the int64 counts."""
    r = rows.long()
    xs = x[r].double()
    a_new, a_old = new[r].long(), old[r].long()
    f = x.shape[1]
    sums = torch.zeros((k + 1, f), dtype=torch.float64, device=x.device)
    mag = torch.zeros_like(sums)
    sums.index_add_(0, a_new, xs).index_add_(0, a_old, -xs)
    xs.abs_()
    mag.index_add_(0, a_new, xs).index_add_(0, a_old, xs)
    counts = (torch.bincount(a_new, minlength=k + 1)
              - torch.bincount(a_old, minlength=k + 1))
    return sums[:k], mag[:k], counts[:k]


def check_delta_sum(tag):
    """``kmt_delta_sum`` against its twin (``compact.delta_compacted``, the
    one-hot product over chunks of 2048 listed rows) and fp64 at every
    DELTA_CASES case: counts bitwise the twin's and the fp64 counts; sums
    within rtol 1e-5 of fp64, relative to the magnitude of the sums being
    differenced (the fp64 sum of |x_r| over both sides of a cluster: each
    side is an fp32 sum of up to 10^5 rows, and their difference can
    cancel); a repeat bitwise; then each case timed
    (:func:`time_delta_sum`).  Returns (the largest |kernel - twin|, the
    times by case)."""
    worst, times = 0.0, {}
    for n, f, k, dtype, ms in DELTA_CASES:
        g = torch.Generator(device="cuda").manual_seed(n + k)
        x = torch.rand(n, f, generator=g, device="cuda").to(dtype)
        for m, skew in ms:
            label = "%dx%d %s k=%d m=%d%s" % (n, f, str(dtype)[6:], k, m,
                                            " skewed" if skew else "")
            rows, new, old = delta_inputs(x, k, m, skew, m + k)
            got = K.delta_sum(x, rows, new, old, n_clusters=k)
            again = K.delta_sum(x, rows, new, old, n_clusters=k)
            twin = C.delta_compacted(x, new, old, rows, m, n_clusters=k)
            sums64, mag, counts64 = fp64_delta(x, rows, new, old, k)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], again[0])
                    and torch.equal(got[1], again[1])):
                raise AssertionError("delta_sum %s: no bitwise repeat"
                                     % label)
            if not (torch.equal(got[1], twin[1])
                    and torch.equal(got[1].long(), counts64)):
                raise AssertionError("delta_sum %s: counts differ from the "
                                     "twin's or the fp64 counts" % label)
            gap = (got[0].double() - sums64).abs()
            if bool((gap > 1e-5 * mag).any()):
                raise AssertionError("delta_sum %s: sums past rtol 1e-5 of "
                                     "fp64" % label)
            rel = float((gap / mag.clamp(min=1e-30)).max())
            twin_rel = float(((twin[0].double() - sums64).abs()
                              / mag.clamp(min=1e-30)).max())
            err = float((got[0] - twin[0]).abs().max())
            worst = max(worst, err)
            plan = K.segment_plan(m, f, k, x.element_size())
            print("check delta_sum %s: ok; counts bitwise the twin's "
                  "(largest |d count| %d); max |kernel - twin| %.3g; vs fp64 "
                  "relative to the sums' magnitude: kernel %.3g, twin %.3g; "
                  "repeat bitwise (%d chunks of %d)"
                  % (label, int(got[1].abs().max()), err, rel, twin_rel,
                     -(-m // plan.chunk), plan.chunk), flush=True)
            del got, again, twin, sums64, mag, counts64
            times[label] = time_delta_sum(tag, label, x, rows, new, old, k,
                                          3 if n * f > 10**8 else 10)
            del rows, new, old
        del x
    return worst, times


def time_delta_sum(tag, label, x, rows, new, old, k, reps):
    """The delta at one case: the kernel (``K.launch_delta_sum``, no
    checks, no count) and its twin in turns (plain, kernel, kernel,
    plain), then ``torch.zeros(k + 1, f).index_add_(0, new[L],
    x[L].float()).index_add_(0, old[L], -x[L].float())`` (timed, never
    called by the port; row k takes the invalid ids) and the wrapper with
    its checks; beside the bound from ``roofline.py``.  Returns {ms,
    plain_ms, library_ms, library, wrapper_ms, bound_ms, bound_by}."""
    m, f = rows.numel(), x.shape[1]
    r = rows.long()
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    kern = lambda: K.launch_delta_sum(lib, x, rows, new, old, k, stream)
    plain = lambda: C.delta_compacted(x, new, old, rows, m, n_clusters=k)

    def library():
        xs = x[r].float()
        return torch.zeros((k + 1, f), device=x.device).index_add_(
            0, new[r].long(), xs).index_add_(0, old[r].long(), -xs)
    p1 = time_ms(plain, reps)
    k1 = time_ms(kern, reps)
    k2 = time_ms(kern, reps)
    p2 = time_ms(plain, reps)
    lib_ms = time_ms(library, reps)
    wrap_ms = time_ms(lambda: K.delta_sum(x, rows, new, old, n_clusters=k),
                      reps)
    bnd = R.delta_sum_bound(m, f, k, str(x.dtype)[6:])
    label_lib = "index_add_ of both sides"
    out = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
           "library_ms": lib_ms, "library": label_lib, "wrapper_ms": wrap_ms,
           "bound_ms": bnd["ms"], "bound_by": bnd["by"]}
    print("%s time delta_sum %s: kernel %.4f ms (%.4f/%.4f), wrapper with "
          "its checks %.4f ms, plain %.4f ms (%.4f/%.4f), library %.4f ms "
          "(%s), bound %.4f ms (%s; %.4g bytes)"
          % (tag, label, out["ms"], k1, k2, wrap_ms,
             out["plain_ms"], p1, p2, lib_ms, label_lib, bnd["ms"],
             bnd["by"], bnd["bytes"]), flush=True)
    return out


def main() -> int:
    t_start = time.perf_counter()
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

    errs = {"fused_lloyd_pass": 0.0, "assign_only_pass": 0.0,
            "point_min": check_point_min()}
    check_kernels(errs)
    # bench.py's 8M start before and after the delta check (the gate
    # adds a busy stream and a second process in the scale phase)
    starts = {"fresh": start_digest()}
    gc.collect()
    torch.cuda.empty_cache()
    errs["delta_sum"], delta_times = check_delta_sum(tag)
    starts["after check_delta_sum"] = start_digest()
    gc.collect()
    torch.cuda.empty_cache()
    score_ulps()
    times = time_kernels(tag, HEADLINE, torch.float32, 20)
    times_bf16 = time_kernels(tag, BF16_RUN, torch.bfloat16, 5)

    dev = torch.device("cuda")
    x = B.uniform_rows(dev)
    g = torch.Generator(device="cuda").manual_seed(0)
    xb = torch.rand(BF16_RUN["n"], BF16_RUN["f"], generator=g,
                    device=dev).to(torch.bfloat16)
    k = HEADLINE["k"]
    step_times, draw_times = {}, {}
    for name, data in (("headline", x), ("bf16_1m", xb)):
        check_row_sq_norms(data)
        p = prepare(data, k, D.DistanceMetric.L2, dev, Logger(0))
        step_times[name] = time_point_min(tag, p, 20)
        draw_times[name] = check_weighted_draw(
            tag, "%dx%d %s" % (*data.shape, str(p.x.dtype)[6:]), p, 256, 20)
        del p
    kmeanspp_picks("headline 100000x256 fp32 k=1024", x, k, 1)
    pp_wall, pp_per_step = kmeanspp_launches(tag, x, k)
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
    total = {name: 0 for name in (*K.LAUNCHES, *IK.LAUNCHES)}
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
    *default_counts, c_pp = default_call_phase(tag, x)
    paths = [("default call", *default_counts),
             ("1M bf16 Yinyang", *bf16_yinyang_phase(tag, xb)),
             ("15-iteration pair", bench_pair_phase(tag, x))]
    del xb
    paths.append(("1M bf16 blobs Yinyang", *bf16_blob_yinyang_phase(tag)))
    forced_schedules("the headline data from its k-means++ start", x, k,
                     init=c_pp, tolerance=0.002, max_iterations=60)
    xs = blob_fixture()
    forced_schedules("the 13K fixture", torch.from_numpy(xs).cuda(), 50,
                     init=torch.from_numpy(xs[np.random.RandomState(2).choice(
                         13000, 50, replace=False)]).cuda(),
                     tolerance=0.002, max_iterations=100)
    paths.append(("deep tail", *deep_tail_phase(tag)))
    paths.append(("spherical AFK-MC2", spherical_phase(tag)))
    for label, *counts in paths:
        for launches in counts:
            require_launched(label, launches, K.LAUNCHES)
            for name in total:
                total[name] += launches.get(name, 0)
    check_small_yinyang_agreement()

    knn = knn_phase(tag)
    knn["bf16_cos_1m"], cos_km, cos_walks = bf16_cosine_knn_phase(tag)
    knn["launches"] += cos_walks
    knn["max_abs_err"] = max(knn["max_abs_err"],
                             knn["bf16_cos_1m"]["max_abs_err"])
    for name in K.LAUNCHES:
        total[name] += cos_km[name]

    capi_counts = capi_phase(tag, x)
    for name in K.LAUNCHES:
        total[name] += capi_counts[name]
    knn["launches"] += capi_counts["knn_walk"]

    md_counts = multidevice_phase(tag, x)
    for name in total:
        total[name] += md_counts[name]
    knn["launches"] += md_counts["knn_walk"]
    del x

    scale = scale_phase(tag, errs, starts)
    for name in total:
        total[name] += scale["launches"][name]
    knn["launches"] += scale["launches"]["knn_walk"]
    knn["max_abs_err"] = max(knn["max_abs_err"], scale["walk_err"])
    knn["k16384"] = {**scale["walk"], "library_ms": None}

    bench = bench_phase(tag, scale["metrics"]["kmeans_8mx256_iterations"])
    for name in total:
        total[name] += bench[name]
    knn["launches"] += bench["knn_walk"]

    # top-level numbers at the headline shape (100K x 256 fp32, k=1024);
    # "bf16_1m" the same at 1M x 256 bf16, "scale_8m_bf16" at bench.py's
    # 8M x 256 bf16 and "scale_167m_fp32" at the overflow run's 167,772,160
    # x 8 fp32, k=50; B1 also carries its segment sum, and at the scale
    # shapes (and "scale_9m_bf16", past 2**31 elements) its sums' and the
    # plain segment sum's max relative errors against fp64 sums, which
    # are the reference there ("sums_vs_fp64")
    def numbers(t):
        return {key: t[key] for key in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms",
                                        "sums_vs_fp64") if key in t}

    def draw_numbers(t):
        return {**numbers(t), "max_abs_err": t["max_abs_err"]}

    def shapes(name):
        return {"bf16_1m": numbers(times_bf16[name]),
                "scale_8m_bf16": numbers(scale["times_8m"][name]),
                "scale_167m_fp32": numbers(scale["times_167m"][name])}

    kernels = []
    for name, line in (("fused_lloyd_pass", 81), ("assign_only_pass", 127)):
        entry = {
            "name": name, "route": "cuda",
            "source": "kmcuda_torch/csrc/assign.cu",
            "replaces": "kmcuda_tpu/ops/assign_pallas.py:%d" % line,
            "launches": total[name], "max_abs_err": errs[name],
            **numbers(times[name]), "library": times[name]["library"],
            "shape": "100000x256 fp32 k=1024", **shapes(name)}
        if name == "fused_lloyd_pass":
            entry["scale_9m_bf16"] = {"sums_vs_fp64": scale["held_9m"]}
            entry["segment_sum"] = {
                **numbers(times["segment_sum"]),
                "library": times["segment_sum"]["library"],
                **shapes("segment_sum")}
        kernels.append(entry)
    kernels.append({
        "name": "knn_walk", "route": "cuda",
        "source": "kmcuda_torch/csrc/knn_walk.cu",
        "replaces": "kmcuda_tpu/ops/knn_pallas.py:150", **knn,
        "library_ms": None, "library": "no single call"})
    # the init step: XLA work in the JAX package (its product at
    # distance.py:220, in the fori_loop of initialization.py:162-167), a
    # kernel because the card's profile asked for one
    kernels.append({
        "name": "point_min", "route": "cuda",
        "source": "kmcuda_torch/csrc/init_step.cu",
        "replaces": "kmcuda_tpu/ops/distance.py:220",
        "launches": total["point_min"], "max_abs_err": errs["point_min"],
        **numbers(step_times["headline"]),
        "library": step_times["headline"]["library"],
        "shape": "100000x256 fp32",
        "bf16_1m": numbers(step_times["bf16_1m"]),
        **{key: numbers(t) for key, t in scale["point_min"].items()}})
    # the init step's draw: XLA work in the JAX package
    # (initialization.py:87 _weighted_draw), a kernel so that a start
    # repeats on the card
    kernels.append({
        "name": "weighted_draw", "route": "cuda",
        "source": "kmcuda_torch/csrc/draw.cu",
        "replaces": "kmcuda_tpu/models/initialization.py:87",
        "launches": total["weighted_draw"],
        **numbers(draw_times["headline"]),
        "max_abs_err": max(t["max_abs_err"] for t in (
            *draw_times.values(), *scale["weighted_draw"].values())),
        "library": draw_times["headline"]["library"],
        "shape": "100000 weights, rows 100000x256 fp32",
        "launch_ms": draw_times["headline"]["launch_ms"],
        "kmeanspp_headline": {"s": pp_wall, "kernels_per_step": pp_per_step},
        "bf16_1m": draw_numbers(draw_times["bf16_1m"]),
        **{key: draw_numbers(t)
           for key, t in scale["weighted_draw"].items()}})
    # the sparse iteration's delta: XLA work in the JAX package
    # (compact.py:109 delta_compacted, its one-hot chunk product at :86), a
    # kernel because the card's profile asked for one
    kernels.append({
        "name": "delta_sum", "route": "cuda",
        "source": "kmcuda_torch/csrc/segment.cu",
        "replaces": "kmcuda_tpu/ops/compact.py:109",
        "launches": total["delta_sum"], "max_abs_err": errs["delta_sum"],
        **numbers(delta_times[DELTA_MAIN]),
        "library": delta_times[DELTA_MAIN]["library"],
        "shape": DELTA_MAIN,
        "cases": {label: {**numbers(t), "wrapper_ms": t["wrapper_ms"]}
                  for label, t in delta_times.items()}})
    print("%s smoke wall %.1f s" % (tag, time.perf_counter() - t_start),
          flush=True)
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
    x, centers = B.blobs(g, n, f, k, 10.0)
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


def unit_rows_fp16(seed=23):
    """KNN_COS on the card: rows around random unit directions, normalized
    and stored as fp16; rows 0, n // 2 and n - 1 (the rows the cosine
    check probes) are the exact unit vectors e_0, e_1, e_2.  Returns
    (rows, unit centers)."""
    b = KNN_COS
    n, f = b["n"], b["f"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    centers = torch.randn(b["k"], f, generator=g, device="cuda")
    centers = centers / centers.norm(dim=1, keepdim=True)
    which = torch.randint(0, b["k"], (n,), generator=g, device="cuda")
    x = centers[which] + b["spread"] * torch.randn(n, f, generator=g,
                                                   device="cuda")
    x = x / x.norm(dim=1, keepdim=True)
    x[[0, n // 2, n - 1]] = torch.eye(f, device="cuda")[:3]
    return x.to(torch.float16), centers


def chord_recall(xs, nb, kn, nq=1024, seed=13, block=1 << 17):
    """Tie-aware recall@kn of the cosine neighbours ``nb`` of ``nq`` query
    rows (a seeded ``randperm``) under the rescore's measure, the angle
    2 asin(|q - m| / 2) of the stored rows ``xs``: a blocked fp64 brute
    force over every row keeps each block's kn + 16 nearest, their fp64
    subtract-square distances give the exact profile, and a returned
    slot counts when it is within rtol 1e-6 of the exact one
    (``knn_kernels.exact_hits``' rule).  Returns (recall, tie-aware
    recall)."""
    n = xs.shape[0]
    qi = torch.randperm(n, generator=torch.Generator(
        device=xs.device).manual_seed(seed), device=xs.device)[:nq]
    q = xs[qi].double()
    q_sq = (q * q).sum(dim=1)
    best_d, best_i = [], []
    for s in range(0, n, block):
        m = xs[s:s + block].double()
        d2 = q_sq[:, None] + (m * m).sum(dim=1)[None, :] - 2.0 * q @ m.T
        rows = torch.arange(nq, device=xs.device)
        own = (qi >= s) & (qi < s + m.shape[0])
        d2[rows[own], qi[own] - s] = float("inf")
        d2 = torch.where(torch.isnan(d2), float("inf"), d2)
        top = torch.topk(d2, kn + 16, dim=1, largest=False)
        best_d.append(top.values)
        best_i.append(top.indices + s)
        del m, d2
    cand = torch.cat(best_i, dim=1)
    cand = torch.gather(cand, 1, torch.topk(torch.cat(best_d, dim=1),
                                            kn + 16, dim=1,
                                            largest=False).indices)

    def angle(ids):
        chord = torch.linalg.norm(xs[ids].double() - q[:, None, :], dim=2)
        return 2.0 * torch.asin(torch.clamp(0.5 * chord, max=1.0))

    true_prof = torch.sort(angle(cand), dim=1).values[:, :kn]
    got = nb[qi].long()
    got_prof = torch.sort(angle(got.clamp(min=0)), dim=1).values
    recall = float(np.mean([len(set(e) & set(r)) / kn for e, r in zip(
        cand[:, :kn].tolist(), got.tolist())]))
    ok = (got_prof <= true_prof * (1.0 + 1e-6)) & (got >= 0).all(
        dim=1, keepdim=True)
    return recall, float(ok.double().mean())


def bf16_cosine_knn_phase(tag):
    """bf16 cosine kNN at KNN_COS: the rows clustered from their centers
    through ``kmeans_cuda(..., metric="cos")``, ``knn_cuda`` at 16-NN
    (launches, its verbosity-2 plan and batch times, wall, examined
    fraction), tie-aware recall 1.0 on 1,024
    queries against an fp64 brute force of the chord's angle, B3 against
    its twin on one full batch and timed there with its bound.  Returns
    (B3's numbers on the layout, the k-means launches, the kNN call's
    walk launches)."""
    b = KNN_COS
    COS = D.DistanceMetric.COSINE
    x, centers = unit_rows_fp16()
    K.reset_launch_counts()
    c, a = cluster(x, centers, COS)
    torch.cuda.synchronize()
    km_n = dict(K.LAUNCHES)
    require_launched("bf16 cosine clustering", km_n, ("fused_lloyd_pass",))
    KK.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        nb = knn_cuda(b["kn"], x, c, a, metric="cos", verbosity=2)
    torch.cuda.synchronize()
    launches = KK.LAUNCHES["knn_walk"]
    print(buf.getvalue(), end="", flush=True)
    if launches == 0:
        raise AssertionError("bf16 cosine knn_cuda: knn_walk never "
                             "launched")
    frac = fraction(buf.getvalue())
    if nb.shape != (b["n"], b["kn"]) or int(nb.min()) < 0:
        raise AssertionError("bf16 cosine knn_cuda: neighbours out of "
                             "shape or range")
    walls = [wall_s(lambda: knn_cuda(b["kn"], x, c, a, metric="cos"))
             for _ in range(3)]
    recall, tie_recall = chord_recall(x.to(torch.bfloat16), nb, b["kn"])
    print("%s wall knn_cuda %dx%d fp16 (bf16 storage) cosine k=%d %d-NN, "
          "neighbours at angles ~1e-2: %.4f s (min of 3: %s), examined "
          "fraction %.6f, knn_walk launches %d; recall@16 %.6f, tie-aware "
          "recall@16 %.6f on 1024 queries (fp64, the chord's angle)"
          % (tag, b["n"], b["f"], b["k"], b["kn"], min(walls),
             ", ".join("%.4f" % w for w in walls), frac, launches, recall,
             tie_recall), flush=True)
    if tie_recall != 1.0:
        raise AssertionError("bf16 cosine: tie-aware recall %.6f != 1"
                             % tie_recall)
    del nb
    plan = knn_plan(x, c, a, COS)
    nchunks = plan.m_total // plan.q_chunk
    out, args, kw = check_walk("%dx%d bf16 cos kn=%d" % (
        b["n"], b["f"], b["kn"]), plan, b["k"], b["kn"], COS,
        nchunks // 2 - 128, 256)
    times = time_walk(tag, args, kw)
    del plan, args, kw, x, c, a
    return {**times, "max_abs_err": out["max_abs_err"],
            "library_ms": None}, km_n, launches


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
          "%d, group %d, buffer in %s); %d tie rows, %d chunks' examined "
          "differ, examined %d, max |d dist| %.3g"
          % (label, chunk_base, chunk_base + n_chunks - 1,
             plan.m_total // plan.q_chunk, kw["kk"], kw["chunk"],
             plan.tile_m, plan.group, "shared memory" if in_smem
             else "global scratch", out["tie_rows"], out["chunks_differ"],
             out["examined"], out["max_abs_err"]), flush=True)
    return out, args, kw


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
    recall, tie_recall = B.check_recall(x, nb, b["kn"])
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
    recall, tie_recall = B.check_recall(x, nb, b["kn"])
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


def _ptr(arr) -> int:
    return arr.ctypes.data_as(ctypes.c_void_p).value


def _launches() -> dict:
    return {**K.LAUNCHES, **KK.LAUNCHES, **IK.LAUNCHES}


def _reset_launches():
    K.reset_launch_counts()
    KK.reset_launch_counts()
    IK.reset_launch_counts()


def timed_call(fn):
    """``fn()`` with stdout captured, the launch counts set to 0 and the
    peak-memory count reset to what is allocated now; returns (result,
    log, wall s, launches, peak bytes allocated)."""
    _reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    return (out, buf.getvalue(), wall, _launches(),
            torch.cuda.max_memory_allocated())


def memcpy_bytes(trace_path) -> dict:
    """Copies of a ``torch.profiler`` Chrome trace by direction: {"HtoD":
    [count, bytes, largest], ...}, from its ``gpu_memcpy`` events."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    out = {}
    for ev in events:
        if ev.get("cat") != "gpu_memcpy":
            continue
        kind = ev["name"].split()[1]
        nbytes = int(ev.get("args", {}).get("bytes", 0))
        entry = out.setdefault(kind, [0, 0, 0])
        entry[0] += 1
        entry[1] += nbytes
        entry[2] = max(entry[2], nbytes)
    return out


def capi_pointer_headline(tag, x):
    """``kmeans_from_pointers`` at the headline configuration from one
    imported start (rows of x, seed 1), Lloyd and Yinyang, against
    ``kmeans_cuda`` on the same numpy arrays: assignments, centroids and
    average distance bitwise equal, identical iteration lines; walls of
    both, in turns (pointer, call, call, pointer, pointer, call).  Returns
    the capi calls' launch counts."""
    n, f, k = HEADLINE["n"], HEADLINE["f"], HEADLINE["k"]
    xh = x.cpu().numpy()
    c0 = np.ascontiguousarray(
        xh[np.random.RandomState(1).choice(n, k, replace=False)])
    total = {name: 0 for name in _launches()}
    for yt in (0.0, 0.1):
        def pointers(verbosity):
            cent, assign = c0.copy(), np.zeros(n, np.uint32)
            code, avg = capi.kmeans_from_pointers(
                3, 0, 0.002, yt, 0, n, f, k, 1, 0, 0, verbosity, _ptr(xh),
                _ptr(cent), _ptr(assign), 1)
            if code != 0:
                raise AssertionError("kmeans_from_pointers returned %d" % code)
            return cent, assign, avg

        def call(verbosity):
            return kmeans_cuda(xh, k, init=c0, tolerance=0.002, yinyang_t=yt,
                               seed=1, average_distance=True,
                               verbosity=verbosity)

        _reset_launches()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            got = pointers(1)
        launches = _launches()
        got_log = buf.getvalue()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            want = call(1)
        if iteration_lines(got_log) != iteration_lines(buf.getvalue()):
            raise AssertionError("capi yinyang_t=%g: iteration lines differ"
                                 % yt)
        if not (np.array_equal(got[1], want[1])
                and np.array_equal(got[0], want[0], equal_nan=True)
                and got[2] == want[2]):
            raise AssertionError("capi yinyang_t=%g: pointer path differs "
                                 "from kmeans_cuda" % yt)
        walls = {"pointers": [], "call": []}
        for name in ("pointers", "call", "call", "pointers", "pointers",
                     "call"):
            fn = pointers if name == "pointers" else call
            walls[name].append(wall_s(lambda: fn(0)))
        for name, count in launches.items():
            total[name] += count
        print("%s capi kmeans_from_pointers %dx%d fp32 k=%d, yinyang_t %g, "
              "imported start, tolerance 0.002, %d iterations: "
              "bitwise equal to kmeans_cuda on the same numpy arrays "
              "(assignments, centroids, average distance %.9g, iteration "
              "lines); wall %.4f s (min of 3: %s) against the call's %.4f s "
              "(min of 3: %s); launches %s"
              % (tag, n, f, k, yt, count_iterations(got_log), got[2],
                 min(walls["pointers"]),
                 ", ".join("%.4f" % w for w in walls["pointers"]),
                 min(walls["call"]),
                 ", ".join("%.4f" % w for w in walls["call"]),
                 launches), flush=True)
    return total


def capi_handle_pipeline(tag):
    """The handle protocol at the JAX bench's kNN configuration (1M x 256
    fp32 blobs made on the card, copied to the host): upload, k-means from
    the blob centers (import handle), 16-NN, one fetch of the neighbours.
    Both results bitwise equal to ``kmeans_cuda`` / ``knn_cuda`` on the
    CUDA tensors over the same cards (mask 0 on handles names every card
    of the host), tie-aware recall@16 of 1.0; the wall, and the bytes
    copied each way from a traced repeat.  Returns the launch counts."""
    b = KNN_BENCH
    n, f, k, kn = b["n"], b["f"], b["k"], b["kn"]
    x, centers = blobs_on_card(n, f, k, 11)
    xh, ch = x.cpu().numpy(), centers.cpu().numpy()
    nbr = np.zeros((n, kn), np.uint32)

    def pipeline():
        code, hs = capi.upload_from_pointer(_ptr(xh), n, f, 0)
        code2, hi = capi.upload_from_pointer(_ptr(ch), k, f, 0)
        code3, hc, ha, _avg = capi.kmeans_from_handles(
            3, 0, 0.01, 0.0, 0, k, 11, 0, 0, hs, hi, 0)
        code4, hn = capi.knn_from_handles(kn, 0, 0, 0, hs, hc, ha)
        code5 = capi.fetch_to_pointer(hn, _ptr(nbr), nbr.nbytes)
        if (code, code2, code3, code4, code5) != (0,) * 5:
            raise AssertionError("capi handle pipeline returned %s"
                                 % ((code, code2, code3, code4, code5),))
        out = capi._handles[hc], capi._handles[ha]
        for h in (hs, hi, hc, ha, hn):
            capi.release_handle(h)
        return out

    _reset_launches()
    wall = wall_s(pipeline)
    launches = _launches()
    got_c, got_a = pipeline()

    every_card = (1 << torch.cuda.device_count()) - 1

    def tensor_calls():
        c, a = kmeans_cuda(x, k, init=centers, tolerance=0.01, yinyang_t=0,
                           seed=11, device=every_card)
        return c, a, knn_cuda(kn, x, c, a, device=every_card)

    c_ref, a_ref, nb_ref = tensor_calls()
    tensor_s = wall_s(tensor_calls)
    if not (torch.equal(got_c, c_ref) and torch.equal(got_a, a_ref)
            and np.array_equal(nbr, nb_ref.cpu().numpy().view(np.uint32))):
        raise AssertionError("capi handle pipeline differs from kmeans_cuda /"
                             " knn_cuda on CUDA tensors")
    recall, tie_recall = B.check_recall(
        x, torch.from_numpy(nbr.view(np.int32)).to(x.device), kn)
    if tie_recall != 1.0:
        raise AssertionError("capi handle pipeline: tie-aware recall %.6f"
                             % tie_recall)
    trace = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke", "capi_pipeline.pt.trace.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        pipeline()
        torch.cuda.synchronize()
    prof.export_chrome_trace(trace)
    copies = memcpy_bytes(trace)
    h2d, d2h = copies.get("HtoD", [0, 0, 0]), copies.get("DtoH", [0, 0, 0])
    print("%s capi handle pipeline %dx%d fp32 k=%d %d-NN (upload, "
          "kmeans_from_handles from the blob centers, knn_from_handles, one "
          "fetch): wall %.4f s (the same two calls on the CUDA tensors: "
          "%.4f s); bitwise equal to kmeans_cuda / knn_cuda on CUDA "
          "tensors; recall@16 %.6f, tie-aware %.6f on 1024 queries; "
          "launches %s; traced copies: H2D %d bytes in %d copies (samples "
          "%d, centers %d), D2H %d bytes in %d copies (largest %d; the "
          "neighbours are %d, the kNN tour's k x k matrix %d), device to "
          "device %s"
          % (tag, n, f, k, kn, wall, tensor_s, recall, tie_recall, launches,
             h2d[1],
             h2d[0], xh.nbytes, ch.nbytes, d2h[1], d2h[0], d2h[2],
             nbr.nbytes, 4 * k * k, copies.get("DtoD", "none")), flush=True)
    if not copies:
        print("capi handle pipeline: the trace holds no copies (bytes not "
              "measured)", flush=True)
    elif d2h[2] != nbr.nbytes or d2h[1] - d2h[2] - 4 * k * k > 4096:
        # besides the fetch, the kNN plan's greedy tour reads the k x k
        # fp32 center distances on the host (models/knn._tour_relabel);
        # the rest are the host syncs' scalars
        raise AssertionError("capi handle pipeline: D2H beyond the "
                             "neighbours and the tour's matrix: %s" % (d2h,))
    del x, centers, got_c, got_a, c_ref, a_ref, nb_ref
    return launches


def capi_shim(tag):
    """Builds native_torch (cmake, ninja) and runs the C smoke of native/
    against it on the card, with KMTPU_PLATFORM unset.  Where the host
    lacks a piece of the build, prints which and returns."""
    root = os.path.dirname(os.path.abspath(__file__))
    missing = [tool for tool in ("cmake", "ninja", "c++")
               if shutil.which(tool) is None]
    include = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(include, "Python.h")):
        missing.append(os.path.join(include, "Python.h"))
    if missing:
        print("capi shim: not built on this host: %s missing"
              % ", ".join(missing), flush=True)
        return
    build = os.path.join(root, "build", "native_torch")
    shutil.rmtree(build, ignore_errors=True)   # no cache of another host
    t = time.perf_counter()
    for cmd in (["cmake", "-S", os.path.join(root, "native_torch"), "-B",
                 build, "-G", "Ninja"], ["cmake", "--build", build]):
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise AssertionError("native_torch build failed: %s%s"
                                 % (res.stdout, res.stderr))
    build_s = time.perf_counter() - t
    env = {key: val for key, val in os.environ.items()
           if key != "KMTPU_PLATFORM"}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    t = time.perf_counter()
    res = subprocess.run([os.path.join(build, "kmtpu_torch_smoke")], env=env,
                         capture_output=True, text=True, timeout=300)
    run_s = time.perf_counter() - t
    for word in ("KMTPU_SMOKE_OK", "KMTPU_DEVICE_PIPELINE_OK", "calculated "):
        if res.returncode != 0 or word not in res.stdout:
            raise AssertionError("kmtpu_torch_smoke on the card: rc %d\n%s%s"
                                 % (res.returncode, res.stdout, res.stderr))
    print("%s capi shim: libkmtpu_torch.so and kmtpu_torch_smoke built in "
          "%.1f s; the C smoke (native/test_kmtpu.c) passed on the card in "
          "%.1f s (a process of its own: interpreter, torch and CUDA start "
          "included): %s"
          % (tag, build_s, run_s, " | ".join(res.stdout.split("\n")[-4:-1])),
          flush=True)


def capi_phase(tag, x):
    """The C ABI on the card with KMTPU_PLATFORM unset: the pointer path at
    the headline, the handle pipeline at 1M and the compiled shim.
    Returns the capi calls' launch counts; fails unless each of B1, B2 and
    B3 was launched."""
    os.environ.pop("KMTPU_PLATFORM", None)
    counts = capi_pointer_headline(tag, x)
    for name, count in capi_handle_pipeline(tag).items():
        counts[name] += count
    # both start from imported centroids: no init step runs
    require_launched("capi phase", counts, ("fused_lloyd_pass",
                                            "assign_only_pass", "knn_walk"))
    print("capi phase launches (pointer path and handle pipeline): %s"
          % counts, flush=True)
    capi_shim(tag)
    r_suite(tag)
    return counts


def r_suite(tag):
    """The R package's testthat suite (r/kmtputorch/tests/
    test-kmtputorch.R) on the card, where the host has Rscript with
    testthat and reticulate and reticulate finds kmcuda_torch; otherwise a
    line naming what is missing (nothing is installed)."""
    root = os.path.dirname(os.path.abspath(__file__))
    rscript = shutil.which("Rscript")
    if rscript is None:
        print("R suite: not run on this host: Rscript missing", flush=True)
        return
    env = {key: val for key, val in os.environ.items()
           if key != "KMTPU_PLATFORM"}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env["RETICULATE_PYTHON"] = sys.executable
    probe = subprocess.run(
        [rscript, "-e", "library(testthat); library(reticulate); "
         "stopifnot(reticulate::py_module_available('kmcuda_torch'))"],
        env=env, capture_output=True, text=True, timeout=120)
    if probe.returncode != 0:
        print("R suite: not run on this host: %s" % (
            probe.stderr.strip().splitlines() or ["probe failed"])[-1],
            flush=True)
        return
    t = time.perf_counter()
    res = subprocess.run(
        [rscript, os.path.join(root, "r", "kmtputorch", "tests",
                               "test-kmtputorch.R")],
        env=env, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError("R suite on the card: rc %d\n%s%s"
                             % (res.returncode, res.stdout, res.stderr))
    print("%s R suite: test-kmtputorch.R passed on the card in %.1f s: %s"
          % (tag, time.perf_counter() - t,
             " | ".join(res.stdout.strip().splitlines()[-3:])), flush=True)


# ---------------------------------------------------------------------------
# Multi-device: the public calls over logical shards of card 0

#: logical shard counts of the multi-device phase
SHARD_COUNTS = (1, 2, 4)


@contextlib.contextmanager
def logical_shards(d):
    """The public calls' device mask selects ``d`` logical shards of card 0
    (``select_devices`` answers with cuda:0 ``d`` times); yields that
    mask, d bits.  One card holds every shard, so a wall measures the
    shard loop and its reductions, not a multi-GPU speed-up."""
    real = DEV.select_devices
    DEV.select_devices = lambda mask, logger=None: [
        torch.device("cuda", 0)] * d
    try:
        yield (1 << d) - 1
    finally:
        DEV.select_devices = real


def sharded(fn, d):
    """``fn(mask)`` on ``d`` logical shards (:func:`timed_call`); returns
    (result, log, wall s, launches).  A log at verbosity 2 must hold one
    plan line per shard."""
    with logical_shards(d) as mask:
        out, log, wall, launches, _peak = timed_call(lambda: fn(mask))
    plans = [l for l in log.splitlines() if l.startswith("plan: ")]
    if plans and len(plans) != d:
        raise AssertionError("%d plan lines on %d shards" % (len(plans), d))
    return out, log, wall, launches


def check_count_contract(label, one, many):
    """tests/test_kmeans.py:277-309's contract of d shards against one:
    iteration counts within 1, at most 0.2% of the assignments differ,
    and at least 96% of the centroids (that test's 48 of 50) within rtol
    1e-4 / atol 1e-5.  The returned centroids are those the last
    assignment was computed against, so a cluster whose final members
    agree may still differ by the rows the two runs moved one iteration
    earlier.  Returns a summary."""
    (c1, a1), log1 = one
    (cd, ad), logd = many
    it1, itd = count_iterations(log1), count_iterations(logd)
    if abs(it1 - itd) > 1:
        raise AssertionError("%s: %d iterations against %d on one shard"
                             % (label, itd, it1))
    differ = a1 != ad
    nd = int(differ.sum())
    if nd > 0.002 * a1.numel():
        raise AssertionError("%s: %d assignments differ from one shard's"
                             % (label, nd))
    k = c1.shape[0]
    close = torch.isclose(cd.float(), c1.float(), rtol=1e-4, atol=1e-5,
                          equal_nan=True).all(dim=1)
    n_close = int(close.sum())
    if n_close < 0.96 * k:
        raise AssertionError("%s: %d of %d centroids within rtol 1e-4"
                             % (label, n_close, k))
    touched = torch.zeros(k, dtype=torch.bool, device=c1.device)
    touched[a1[differ].long()] = True
    touched[ad[differ].long()] = True
    return ("%d vs %d iterations, %d assignments differ, %d of %d "
            "centroids within rtol 1e-4 (%d apart among the %d clusters "
            "whose final members agree)"
            % (itd, it1, nd, n_close, k, int((~close & ~touched).sum()),
               int((~touched).sum())))


def check_iteration_counts(label, one, many):
    """The first half of :func:`check_count_contract`, for runs whose
    trajectories may part by fp32 rounding (uniform data from k-means++
    starts): iteration counts within 1.  Returns the iteration where the
    reassignment counts first differ and the assignments that differ at
    the end."""
    (_c1, a1), log1 = one
    (_cd, ad), logd = many
    l1, ld = iteration_lines(log1), iteration_lines(logd)
    if abs(len(l1) - len(ld)) > 1:
        raise AssertionError("%s: %d iterations against %d on one shard"
                             % (label, len(ld), len(l1)))
    part = next((i + 1 for i, (u, v) in enumerate(zip(l1, ld)) if u != v),
                None)
    return ("%d vs %d iterations, counts part at %s, %d assignments differ"
            % (len(ld), len(l1), "iteration %d" % part if part else "none",
               int((a1 != ad).sum())))


def check_repeat(label, first, second):
    (c1, a1), log1 = first
    (c2, a2), log2 = second
    if not (torch.equal(a1, a2) and nan_equal(c1, c2)
            and iteration_lines(log1) == iteration_lines(log2)):
        raise AssertionError("%s: two runs differ" % label)


def neighbour_ties(x, got, want):
    """Rows where ``got`` and ``want`` neighbour lists differ; fails
    unless their fp64 distance profiles agree to rtol 1e-6 (ties).
    Returns the number of such rows."""
    rows = torch.nonzero((got != want).any(dim=1))[:, 0]
    if rows.numel():
        x64 = x[rows].double()[:, None, :]
        prof = [torch.sort(torch.linalg.norm(x[nb[rows].long()].double()
                                             - x64, dim=2), dim=1).values
                for nb in (got, want)]
        if not torch.allclose(prof[0], prof[1], rtol=1e-6, atol=0):
            raise AssertionError("neighbours differ off fp64 ties")
    return rows.numel()


def bf16_first_iterations(xb, k, c0, d):
    """The Lloyd loop over one and over ``d`` logical shards of card 0
    from the start ``c0``, two iterations each.  The first assignment
    depends only on each row and ``c0``: it must be bitwise one shard's,
    and so the first update's counts; its centroids differ by the order of
    the fp32 sums only (rtol 1e-5).  The second iteration scores against
    those centroids rounded to bf16: every row where it differs must have
    a cluster whose bf16 panel row differs between the two (a last bit of
    the sums crossing a bf16 rounding boundary) among its candidates (its
    two assignments and the best 4 plain scores against either panel: a
    moved row can push another into or out of the kernel's top 2), or be
    a near-tie.  Returns a summary."""
    L2 = D.DistanceMetric.L2
    steps = {}
    for shards in (1, d):
        p = prepare(xb, k, L2, Topology([torch.device("cuda", 0)] * shards),
                    Logger(0))
        loop = A.lloyd_run(p.xs, p.valids, p.assign0s, c0, n_clusters=k,
                           metric=L2)
        steps[shards] = [next(loop) for _ in range(2)]
        loop.close()
        del p, loop
    one, many = steps[1], steps[d]
    if not (torch.equal(torch.cat(one[0].assign), torch.cat(many[0].assign))
            and torch.equal(one[0].counts, many[0].counts)):
        raise AssertionError("1M bf16 d=%d: the first assignment is not one "
                             "shard's" % d)
    c1, cd = one[0].c_next, many[0].c_next
    if not torch.allclose(cd, c1, rtol=1e-5, atol=1e-6):
        raise AssertionError("1M bf16 d=%d: the first update's centroids "
                             "differ past rtol 1e-5" % d)
    rel = float(((cd - c1).abs() / c1.abs().clamp(min=1e-6)).max())
    steps_bf16 = cd.to(torch.bfloat16) != c1.to(torch.bfloat16)
    moved = steps_bf16.any(dim=1)
    a1, ad = torch.cat(one[1].assign), torch.cat(many[1].assign)
    rows = torch.nonzero(a1 != ad)[:, 0]
    cand = [a1[rows, None].long(), ad[rows, None].long()]
    ties = torch.zeros(rows.numel(), dtype=torch.bool, device=xb.device)
    if rows.numel():
        for c in (c1, cd):
            panel, c_sq = pad_clusters(c, xb.dtype)
            cand.append(torch.topk(D.scores(xb[rows], panel.T, c_sq, L2), 4,
                                   dim=1, largest=False).indices)
            ties |= K.near_ties(xb[rows], c, L2)
    touch = moved[torch.cat(cand, dim=1)].any(dim=1)
    if bool((~touch & ~ties).any()):
        raise AssertionError("1M bf16 d=%d: %d second-iteration rows differ "
                             "with neither a moved panel row among their "
                             "candidates nor a tie"
                             % (d, int((~touch & ~ties).sum())))
    return ("first assignment and counts bitwise one shard's, first "
            "centroids within %.3g relative; second iteration: %d panel "
            "entries in %d clusters round to another bf16 value, %d rows "
            "differ (%d with one of those clusters among their candidates, %d "
            "near-ties)"
            % (rel, int(steps_bf16.sum()), int(moved.sum()), rows.numel(),
               int(touch.sum()), int((~touch & ties).sum())))


def multidevice_phase(tag, x):
    """The public calls over 1, 2 and 4 logical shards of card 0 (the
    shard loop, the fixed-order reductions and the per-shard kernel
    launches; not peer copies between cards): Lloyd at the headline and
    the default call on its data, 1M x 256 bf16 Lloyd, and kNN at 1M x 256
    fp32 16-NN; then, with several cards, the same calls over them.
    Returns the phase's launch counts; fails unless each of B1, B2 and B3
    was launched."""
    k = HEADLINE["k"]
    L2 = D.DistanceMetric.L2
    counts = {name: 0 for name in _launches()}
    walls = {}

    def run(label, fn, d):
        out, log, wall, launches = sharded(fn, d)
        for name, count in launches.items():
            counts[name] += count
        walls.setdefault(label, {}).setdefault(d, []).append(wall)
        return out, log

    def kmeans(data, kw):
        return lambda mask: kmeans_cuda(data, k, device=mask, **kw)

    # Lloyd at the headline (random init: one start for every d)
    kw = dict(init="random", seed=1, tolerance=0.002, yinyang_t=0,
              max_iterations=15, verbosity=2)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        today = (kmeans_cuda(x, k, **kw), buf.getvalue())
    lloyd = {d: run("headline Lloyd", kmeans(x, kw), d)
             for d in SHARD_COUNTS}
    again = run("headline Lloyd", kmeans(x, kw), 4)
    check_repeat("headline d=1 against the call without a mask", today,
                 lloyd[1])
    check_repeat("headline d=4", lloyd[4], again)
    empty, ties = check_result(x, k, *lloyd[4][0], L2)
    print("multidevice headline Lloyd 100000x256 fp32 k=1024: d=1 bitwise "
          "the call without a mask; d=4 repeats bitwise; d=4 final "
          "assignment is the argmin (%d empty clusters, %d near-tie rows "
          "differ); against d=1: d=2 %s; d=4 %s"
          % (empty, ties, check_count_contract("headline d=2", lloyd[1],
                                               lloyd[2]),
             check_count_contract("headline d=4", lloyd[1], lloyd[4])),
          flush=True)

    # the default call (k-means++, Yinyang) on the same data
    picks = {}
    for d in SHARD_COUNTS:
        p = prepare(x, k, L2, Topology([torch.device("cuda", 0)] * d),
                    Logger(0))
        picks[d] = I.init_centroids(p, I.InitMethod.PLUS_PLUS, 1)
        del p
    same_picks = {d: int((picks[d] == picks[1]).all(dim=1).sum())
                  for d in (2, 4)}
    if min(same_picks.values()) != k:
        raise AssertionError("k-means++ picks differ across shard counts: "
                             "%s of %d" % (same_picks, k))
    dkw = dict(seed=1, tolerance=0.002, max_iterations=60)
    default = {d: run("default call", kmeans(x, dict(dkw, verbosity=2)), d)
               for d in SHARD_COUNTS[:2]}
    with logical_shards(4) as mask:
        yy, yy_log, yy_n, ll_n = yinyang_vs_lloyd(
            "default call 100000x256 fp32 k=1024 on 4 logical shards", x, k,
            L2, device=mask, **dkw)
    for launches in (yy_n, ll_n):
        for name, count in launches.items():
            counts[name] += count
    default[4] = (yy, yy_log)
    check_repeat("default call d=4", default[4],
                 run("default call", kmeans(x, dict(dkw, verbosity=2)), 4))
    # on uniform 256-D data the whole runs part by the shards' fp32 sum
    # order, as the JAX package's do (tests/test_torch_multidevice.py::
    # test_whole_runs_part_on_uniform_data): d=2 and d=4 are held to the
    # contract over the first iterations from one start, and over whole
    # runs on the data tests/test_kmeans.py:277-309 states it for
    early_kw = dict(dkw, init=picks[1], max_iterations=4, verbosity=2)
    early = {d: run("default call, 4 iterations", kmeans(x, early_kw), d)
             for d in SHARD_COUNTS}
    blobs = torch.from_numpy(blob_fixture()).cuda()
    bkw = dict(init="kmeans++", seed=3, tolerance=0.01, yinyang_t=0,
               verbosity=2)
    whole = {d: run("13K fixture", lambda mask: kmeans_cuda(
        blobs, 50, device=mask, **bkw), d) for d in SHARD_COUNTS}
    print("multidevice default call 100000x256 fp32 k=1024: k-means++ picks "
          "equal to d=1's at d=2 and d=4 (%d of %d rows); d=4 repeats "
          "bitwise; Yinyang == Lloyd bitwise at d=4; against d=1 over the "
          "first 4 iterations from the same start: d=2 %s, d=4 %s; whole "
          "runs: d=2 %s, d=4 %s"
          % (min(same_picks.values()), k,
             check_count_contract("default d=2, 4 iterations", early[1],
                                  early[2]),
             check_count_contract("default d=4, 4 iterations", early[1],
                                  early[4]),
             check_iteration_counts("default d=2", default[1], default[2]),
             check_iteration_counts("default d=4", default[1], default[4])),
          flush=True)
    print("multidevice 13K fixture (tests/test_kmeans.py:277-309: k=50, "
          "k-means++ seed 3, tolerance 0.01, Lloyd), whole runs against "
          "d=1: d=2 %s; d=4 %s"
          % (check_count_contract("13K fixture d=2", whole[1], whole[2]),
             check_count_contract("13K fixture d=4", whole[1], whole[4])),
          flush=True)
    del picks, lloyd, again, default, yy, early, blobs, whole

    # 1M x 256 bf16 Lloyd
    g = torch.Generator(device="cuda").manual_seed(0)
    xb = torch.rand(BF16_RUN["n"], BF16_RUN["f"], generator=g,
                    device="cuda").to(torch.bfloat16)
    bkw = dict(kw, max_iterations=10)
    bf = {d: run("1M bf16 Lloyd", kmeans(xb, bkw), d) for d in SHARD_COUNTS}
    check_repeat("1M bf16 d=4", bf[4], run("1M bf16 Lloyd", kmeans(xb, bkw),
                                            4))
    with logical_shards(4) as mask:
        empty, ties = check_result(xb, k, *bf[4][0], L2, device=mask)
    c0 = xb[torch.randperm(xb.shape[0], generator=I.generator(1))[:k]
            .cuda()].float()
    first = {d: run("1M bf16 first iteration", kmeans(
        xb, dict(init=c0, tolerance=0.0, yinyang_t=0, max_iterations=1)), d)
        for d in (1, 4)}
    if not torch.equal(first[1][0][1], first[4][0][1]):
        raise AssertionError("1M bf16 d=4: the public call's first "
                             "assignment is not one shard's")
    print("multidevice 1000000x256 bf16 k=1024, 10 iterations: d=4 repeats "
          "bitwise; d=4 final assignment, restarted on 4 shards, is the "
          "argmin (%d empty clusters, %d near-tie rows differ); from one "
          "start, the public call's first assignment at d=4 is bitwise "
          "d=1's; the loop at d=4 against d=1: %s; after 10 iterations "
          "assignments that differ from d=1's: d=2 %d, d=4 %d"
          % (empty, ties, bf16_first_iterations(xb, k, c0, 4),
             int((bf[2][0][1] != bf[1][0][1]).sum()),
             int((bf[4][0][1] != bf[1][0][1]).sum())), flush=True)
    del xb, bf, first

    # kNN at the JAX bench's configuration, the smoke's blob clusters
    b = KNN_BENCH
    xk, centers = blobs_on_card(b["n"], b["f"], b["k"], 11)
    c, a = cluster(xk, centers, L2)
    knn = {}
    for d, verbosity in ((1, 1), (2, 1), (4, 2), (4, 1)):
        knn[d] = run("kNN 1M 16-NN", lambda mask: knn_cuda(
            b["kn"], xk, c, a, device=mask, verbosity=verbosity), d)
    frac = {d: fraction(knn[d][1]) for d in SHARD_COUNTS}
    ties = {d: neighbour_ties(xk, knn[d][0], knn[1][0]) for d in (2, 4)}
    equal_rows = int((knn[4][0] == knn[1][0]).all(dim=1).sum())
    recall, tie_recall = B.check_recall(xk, knn[4][0], b["kn"])
    if tie_recall != 1.0:
        raise AssertionError("kNN d=4: tie-aware recall %.6f != 1"
                             % tie_recall)
    print("multidevice kNN 1000000x256 fp32 k=1024 16-NN: d=4 neighbours "
          "bitwise equal to d=1's on %d of %d rows, the rest fp64 ties (d=2: "
          "%d tie rows, d=4: %d); examined fraction d=1 %.6f, d=2 %.6f, d=4 "
          "%.6f; d=4 recall@16 %.6f, tie-aware recall@16 %.6f on 1024 "
          "queries" % (equal_rows, b["n"], ties[2], ties[4], frac[1],
                       frac[2], frac[4], recall, tie_recall), flush=True)
    del knn
    for name, count in counts.items():
        if count == 0:
            raise AssertionError("multidevice phase: %s never launched"
                                 % name)

    print("%s multidevice walls on logical shards of one card (the shard "
          "loop and its reductions, not a multi-GPU speed-up): %s; "
          "launches %s" % (tag, "; ".join(
              "%s %s" % (label, ", ".join(
                  "d=%d %.4f s" % (d, min(ws)) + (
                      " (min of %d)" % len(ws) if len(ws) > 1 else "")
                  for d, ws in sorted(per_d.items())))
              for label, per_d in walls.items()), counts), flush=True)

    if torch.cuda.device_count() > 1:
        real_devices_phase(tag, x, xk, c, a, today)
    else:
        print("multidevice over real devices: not run (this host has one "
              "CUDA device)", flush=True)
    return counts


def real_devices_phase(tag, x, xk, c, a, one):
    """Numpy input with mask 0 over every card of the host: the headline
    Lloyd call twice (bitwise repeat, argmin, the contract against the
    one-card call ``one``, ((centroids, assignments), log)) and the kNN
    call against one card's."""
    k = HEADLINE["k"]
    n_dev = torch.cuda.device_count()
    kw = dict(init="random", seed=1, tolerance=0.002, yinyang_t=0,
              max_iterations=15, verbosity=2)
    xn = x.cpu().numpy()
    runs = []
    for _ in range(2):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            t = time.perf_counter()
            cn, an = kmeans_cuda(xn, k, device=0, **kw)
            wall = time.perf_counter() - t
        log = buf.getvalue()
        if len([l for l in log.splitlines() if l.startswith("plan: ")]) \
                != n_dev:
            raise AssertionError("real devices: not one plan line per card")
        runs.append(((torch.from_numpy(cn).cuda(),
                      torch.from_numpy(an.astype(np.int32)).cuda()), log,
                     wall))
    check_repeat("real devices", runs[0][:2], runs[1][:2])
    empty, ties = check_result(x, k, *runs[0][0], D.DistanceMetric.L2)
    contract = check_count_contract("real devices", one, runs[0][:2])
    nb1 = knn_cuda(KNN_BENCH["kn"], xk, c, a).cpu()
    t = time.perf_counter()
    nbn = knn_cuda(KNN_BENCH["kn"], xk.cpu().numpy(), c.cpu().numpy(),
                   a.cpu().numpy().astype(np.uint32), device=0)
    knn_wall = time.perf_counter() - t
    tie_rows = neighbour_ties(xk.cpu(), torch.from_numpy(
        nbn.astype(np.int64)).to(torch.int32), nb1)
    print("%s multidevice over %d real devices (numpy input, mask 0): "
          "headline Lloyd walls %.4f / %.4f s, repeats bitwise, argmin (%d "
          "empty clusters, %d near-tie rows differ), against one card: %s; "
          "kNN 1M 16-NN %.4f s, %d fp64 tie rows against one card"
          % (tag, n_dev, runs[0][2], runs[1][2], empty, ties, contract,
             knn_wall, tie_rows), flush=True)


# ---------------------------------------------------------------------------
# The JAX package's scale tier: its largest documented shapes

#: the reference's overflow run, tests/test_scale.py:35-70: 5.4 GB of fp32
OVERFLOW = dict(n=167_772_160, f=8, k=50)
#: bench.py:383-439's 8M config: 4 GB of bf16
BENCH_8M = dict(n=8_000_000, f=256, k=1024)
#: n * f = 2.304e9 elements: rows from 2**31 // f = 8,388,608 on have
#: row offsets (row * f) past 2**31
PAST_2_31 = dict(n=9_000_000, f=256, k=1024)
#: tests/test_scale.py:97-133: k past KNN_TOUR_MAX_K, 2 rows per cluster
KNN_LARGE_K = dict(n=32_768, f=8, k=16_384, kn=4)
#: tests/test_scale.py:136-150: k=2048 with Yinyang
YY_LARGE_K = dict(n=8192, f=32, k=2048)


def sample_rows(n, count=1 << 16, edge=256):
    """Sorted distinct row ids on the card: the first and last ``edge``
    rows and a stride of about ``count`` across the rest."""
    rows = torch.cat([torch.arange(min(edge, n)),
                      torch.arange(0, n, max(1, n // count)),
                      torch.arange(max(0, n - edge), n)])
    return torch.unique(rows).cuda()


def rows_past_offsets(n, f, count=1 << 16, edge=256):
    """Sorted distinct row ids: ``count`` / 2 strided below the first row
    whose offset row * f reaches 2**31, as many from it on, and the last
    ``edge`` rows."""
    first = 2**31 // f
    half = count // 2
    rows = torch.cat([torch.arange(0, first, max(1, first // half)),
                      torch.arange(first, n, max(1, (n - first) // half)),
                      torch.arange(max(0, n - edge), n)])
    return torch.unique(rows).cuda()


def require_launched(label, launches, names):
    for name in names:
        if launches[name] == 0:
            raise AssertionError("%s: %s never launched" % (label, name))


def gb(nbytes) -> str:
    return "%.2f GB" % (nbytes / 1e9)


def overflow_samples(seed=3):
    """tests/test_scale.py:44-57's samples on the card: 40 blobs, centers
    U(0, 1) * 8, plus 0.3 N(0, 1), made in 8 slabs into one buffer."""
    n, f = OVERFLOW["n"], OVERFLOW["f"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    centers = torch.rand(40, f, generator=g, device="cuda") * 8.0
    x = torch.empty((n, f), device="cuda")
    slab = n // 8
    for i in range(8):
        which = torch.randint(0, 40, (slab,), generator=g, device="cuda")
        x[i * slab:(i + 1) * slab] = centers[which] + 0.3 * torch.randn(
            slab, f, generator=g, device="cuda")
    return x


def overflow_run(tag):
    """The reference's overflow configuration through ``kmeans_cuda``:
    more than 2**32 bytes of samples, assignments in [0, k), finite
    centroids, the argmin on a row sample.  Returns the launch counts."""
    n, f, k = OVERFLOW["n"], OVERFLOW["f"], OVERFLOW["k"]
    x = overflow_samples()
    if x.nbytes <= 2**32:
        raise AssertionError("overflow run: %d bytes of samples" % x.nbytes)
    (c, a), log, wall, launches, peak = timed_call(lambda: kmeans_cuda(
        x, k, init="k-means++", seed=3, tolerance=0.142, yinyang_t=0,
        verbosity=1, donate_samples=True))
    print(log, end="", flush=True)
    require_launched("overflow run", launches, ("point_min", "weighted_draw",
                                                "fused_lloyd_pass"))
    if c.shape != (k, f) or a.shape != (n,) or not bool(
            torch.isfinite(c).all()):
        raise AssertionError("overflow run: centroids not (%d, %d) finite"
                             % (k, f))
    rows = sample_rows(n)
    empty, ties = check_result(x, k, c, a, D.DistanceMetric.L2, rows=rows)
    print("%s scale: overflow run %dx%d fp32 k=%d (tests/test_scale.py:35; "
          "k-means++ seed 3, tolerance 0.142): %d bytes of samples > 2**32; "
          "wall %.4f s, %d iterations, peak memory %s; launches %s; "
          "assignments in [0, %d), centroids finite, the argmin on %d "
          "sampled rows (%d empty clusters, %d near-tie rows differ)"
          % (tag, n, f, k, x.nbytes, wall, count_iterations(log), gb(peak),
             launches, k, rows.numel(), empty, ties), flush=True)
    del x, c, a
    return launches


def bench_8m_run(tag, starts):
    """bench.py:383-439 on the card: one warm run, one timed run and one
    timed run of one iteration, with bench.py's five metrics; k-means++
    alone on the same data, its step's distance pass timed
    (:func:`time_point_min`) and its draw held and timed
    (:func:`check_weighted_draw`); the repeat gate
    (:func:`start_repeat_gate`, with the digests ``starts``); the argmin on
    a row sample; the peak at most 1.5x the samples; then
    :func:`numpy_fp16_prepare`.  Returns the timed run's launch counts,
    the metrics and the step's and the draw's times."""
    n, f, k = BENCH_8M["n"], BENCH_8M["f"], BENCH_8M["k"]
    x = B.uniform_bf16_rows("cuda")
    kw = dict(init="k-means++", seed=17, tolerance=0.01, yinyang_t=0,
              verbosity=1)

    def run(cap=None):
        return timed_call(lambda: kmeans_cuda(x, k, max_iterations=cap,
                                              **kw))

    run()
    (c, a), log, s8m, launches, peak = run()
    print(log, end="", flush=True)
    require_launched("8M run", launches, ("point_min", "weighted_draw",
                                          "fused_lloyd_pass",
                                          "assign_only_pass", "delta_sum"))
    iters = count_iterations(log)
    s_init = run(cap=1)[2]
    pp_s, c_pp = timed_init(x, k, D.DistanceMetric.L2,
                            I.InitMethod.PLUS_PLUS, 17)
    # one k-means++ step's two halves: the distance pass over every row
    # (the init step kernel, timed beside its twin and torch.mv) and the
    # weighted draw
    p = prepare(x, k, D.DistanceMetric.L2, x.device, Logger(0))
    step = time_point_min(tag, p, 5)
    draw = check_weighted_draw(tag, "%dx%d bf16" % (n, f), p, 128, 5)
    del p, c_pp
    kmeanspp_picks("8M %dx%d bf16 k=%d" % (n, f, k), x, k, 17)
    start_repeat_gate(tag, starts, x)
    if peak > 1.5 * x.nbytes:
        raise AssertionError("8M run: peak %s above 1.5x the samples (%s)"
                             % (gb(peak), gb(x.nbytes)))
    metrics = {
        "kmeans_8mx256_k1024_bf16_tol1pct_wall": (s8m, "s"),
        "kmeans_8mx256_iterations": (iters, "iterations"),
        "kmeans_8mx256_s_per_iteration": (s8m / max(iters, 1), "s"),
        "kmeans_8mx256_prep_init_wall": (s_init, "s"),
        "kmeans_8mx256_loop_s_per_iteration": (
            max(s8m - s_init, 0.0) / max(iters - 1, 1), "s"),
    }
    for name, (value, unit) in metrics.items():
        print("%s %s" % (tag, json.dumps({"metric": name, "value": value,
                                           "unit": unit})), flush=True)
    rows = sample_rows(n)
    empty, ties = check_result(x, k, c, a, D.DistanceMetric.L2, rows=rows)
    print("%s scale: bench.py 8M config %dx%d bf16 k=%d (k-means++ seed 17, "
          "tolerance 0.01): wall %.4f s, %d iterations, peak memory %s "
          "(%.3fx the samples); launches %s; k-means++ alone %.4f s (%.3f "
          "ms per step: its distance pass %.3f ms, its draw %.3f ms); the "
          "argmin, restarted from the returned centroids, on %d sampled "
          "rows (%d empty clusters, %d near-tie rows differ)"
          % (tag, n, f, k, s8m, iters, gb(peak), peak / x.nbytes, launches,
             pp_s, 1e3 * pp_s / (k - 1), step["ms"], draw["ms"],
             rows.numel(), empty, ties), flush=True)
    numpy_fp16_prepare(tag, x)
    del x, c, a
    return (launches, {name: v for name, (v, _u) in metrics.items()}, step,
            draw)


def numpy_fp16_prepare(tag, x):
    """What ``prepare`` costs a caller with fp16 numpy samples (the C ABI's
    and numpy users' path): the host array's rows to the card as bf16,
    its wall and the card memory it adds at its peak (over what was
    allocated before it), beside the bf16 samples' bytes; fails above
    1.5x them (a whole fp16 copy on the card beside the bf16 one would
    make it 2x)."""
    xh = x.to(torch.float16).cpu().numpy()
    gc.collect()
    before = torch.cuda.memory_allocated()
    p, _log, wall, _n, peak = timed_call(lambda: prepare(
        xh, 1024, D.DistanceMetric.L2, x.device, Logger(0)))
    added = peak - before
    print("%s prepare of %dx%d fp16 numpy samples: %.4f s, card memory at "
          "its peak %s above the %s allocated before it (%.3fx the %s of "
          "bf16 samples)"
          % (tag, xh.shape[0], xh.shape[1], wall, gb(added), gb(before),
             added / p.x.nbytes, gb(p.x.nbytes)), flush=True)
    if added > 1.5 * p.x.nbytes:
        raise AssertionError("prepare of fp16 numpy samples: %s added, above "
                             "1.5x the samples" % gb(added))
    del p, xh


def past_2_31_run(tag, errs):
    """9M x 256 bf16, n * f past 2**31: B1 and B2 once each from one
    random start, held by :func:`hold_pass` on rows below and past the
    first row offset of 2**31; then ``kmeans_cuda``, 10 iterations, with
    the argmin on a row sample.  Returns the launch counts of both and
    B1's sums against fp64."""
    n, f, k = PAST_2_31["n"], PAST_2_31["f"], PAST_2_31["k"]
    L2 = D.DistanceMetric.L2
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.rand(n, f, generator=g, device="cuda").to(torch.bfloat16)
    if x.numel() <= 2**31 or (n - 1) * f < 2**31:
        raise AssertionError("past 2**31: %d elements" % x.numel())
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    prev = torch.randint(0, k + 1, (n,), generator=g, device="cuda",
                         dtype=torch.int32)
    c0 = x[torch.randperm(n, generator=g, device="cuda")[:k]].float()
    kw = dict(n_clusters=k, metric=L2)
    (b1, b2), _log, pass_s, passes, _peak = timed_call(lambda: (
        K.fused_lloyd_pass(x, valid, prev, c0, **kw),
        K.assign_only_pass(x, valid, prev, c0, **kw)))
    require_launched("past 2**31", passes, ("fused_lloyd_pass",
                                            "assign_only_pass"))
    rows = rows_past_offsets(n, f)
    past = int((rows >= 2**31 // f).sum())
    held = hold_pass("%s scale: past 2**31 elements %dx%d bf16 k=%d (%d "
                     "elements; B1 and B2 from one random start in %.4f s; "
                     "%d sampled rows from row %d on, row * f >= 2**31)"
                     % (tag, n, f, k, x.numel(), pass_s, past, 2**31 // f),
                     x, valid, prev, c0, b1, b2, errs, rows=rows)
    del b1, b2
    (c, a), log, wall, launches, peak = timed_call(lambda: kmeans_cuda(
        x, k, init="random", seed=1, tolerance=0.002, yinyang_t=0,
        max_iterations=10, verbosity=1))
    print(log, end="", flush=True)
    require_launched("past 2**31 k-means", launches, ("fused_lloyd_pass",))
    rows = sample_rows(n)
    empty, nties = check_result(x, k, c, a, L2, rows=rows)
    print("%s scale: past 2**31 elements kmeans_cuda %dx%d bf16 k=%d "
          "(random init seed 1, tolerance 0.002, 10 iterations at most): "
          "wall %.4f s, %d iterations, peak memory %s; launches %s; the "
          "argmin, restarted from the returned centroids, on %d sampled "
          "rows (%d empty clusters, %d near-tie rows differ)"
          % (tag, n, f, k, wall, count_iterations(log), gb(peak), launches,
             rows.numel(), empty, nties), flush=True)
    del x, valid, prev, c0, c, a
    return {name: passes[name] + launches[name] for name in launches}, held


def capacity_run(tag):
    """``capacity.py``'s 40,000,000 x 256 bf16 corpus (20.48 GB of
    samples) through its call (k-means++ seed 17, tolerance 0.01, 5
    iterations at most, Lloyd): wall, iterations, k-means++ seconds and ms per step (the
    init timed inside the call), peak memory, launches; the argmin on a
    row sample; k-means++'s step and its draw timed (the draw held
    against its twin) at this shape.  Fails unless the init step, the draw
    and B1 ran and the peak is at most 1.5x the samples.  Returns the
    launch counts and the step's and the draw's times."""
    n, f, k = CAP.N, CAP.F, CAP.K
    x = CAP.samples()
    spans = []
    init = I.init_centroids

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = init(*args, **kwargs)
        torch.cuda.synchronize()
        spans.append(time.perf_counter() - t)
        return out

    I.init_centroids = timed
    try:
        (c, a), log, wall, launches, peak = timed_call(
            lambda: CAP.call(x, verbosity=1))
    finally:
        I.init_centroids = init
    print(log, end="", flush=True)
    require_launched("capacity run", launches, ("point_min", "weighted_draw",
                                                "fused_lloyd_pass"))
    if peak > 1.5 * x.nbytes:
        raise AssertionError("capacity run: peak %s above 1.5x the samples "
                             "(%s)" % (gb(peak), gb(x.nbytes)))
    rows = sample_rows(n)
    empty, ties = check_result(x, k, c, a, D.DistanceMetric.L2, rows=rows)
    del c, a
    p = prepare(x, k, D.DistanceMetric.L2, x.device, Logger(0))
    step = time_point_min(tag, p, 3)
    draw = check_weighted_draw(tag, "%dx%d bf16" % (n, f), p, 64, 3)
    del p
    print("%s scale: capacity run %dx%d bf16 k=%d (%s of samples; k-means++ "
          "seed 17, tolerance 0.01, 5 iterations at most): wall %.4f s, %d "
          "iterations, k-means++ %.4f s (%.3f ms per step), peak memory %s "
          "(%.3fx the samples); launches %s; the argmin, restarted from the "
          "returned centroids, on %d sampled rows (%d empty clusters, %d "
          "near-tie rows differ)"
          % (tag, n, f, k, gb(x.nbytes), wall, count_iterations(log),
             spans[0], 1e3 * spans[0] / (k - 1), gb(peak), peak / x.nbytes,
             launches, rows.numel(), empty, ties), flush=True)
    del x
    return launches, step, draw


def knn_large_k_run(tag):
    """``knn_cuda`` on tests/test_scale.py:104-115's fixture (32,768 x 8,
    k=16,384 > KNN_TOUR_MAX_K, so the projection relabel), each row
    assigned its nearest centroid on the card: tie-aware recall@4 of 1.0
    over every row against a brute force adjudicated in fp64, and the walk
    against its plain twin over the whole layout.  Returns (launches, the
    walk's max error, its times)."""
    s = KNN_LARGE_K
    n, f, k, kn = s["n"], s["f"], s["k"], s["kn"]
    L2 = D.DistanceMetric.L2
    if k <= config.KNN_TOUR_MAX_K:
        raise AssertionError("k=%d takes the greedy tour" % k)
    rng = np.random.RandomState(7)
    cents_np = rng.rand(k, f).astype(np.float32) * 100.0
    which = rng.randint(0, k, size=n)
    x = torch.from_numpy((cents_np[which] + 0.05 * rng.randn(n, f))
                         .astype(np.float32)).cuda()
    cents = torch.from_numpy(cents_np).cuda()
    c_sq = D.row_sq_norms(cents)
    a = torch.cat([D.scores(x[r:r + 1024], cents.T, c_sq, L2).argmin(dim=1)
                   for r in range(0, n, 1024)]).int()
    nb, log, wall, launches, peak = timed_call(lambda: knn_cuda(
        kn, x, cents, a, verbosity=1))
    print(log, end="", flush=True)
    require_launched("kNN k=16384", launches, ("knn_walk",))
    if nb.shape != (n, kn) or int(nb.min()) < 0 or int(nb.max()) >= n or \
            bool((nb == torch.arange(n, device="cuda")[:, None]).any()):
        raise AssertionError("kNN k=16384: neighbours out of range or self")
    recall, tie_recall = B.check_recall(x, nb, kn, nq=n)
    if tie_recall != 1.0:
        raise AssertionError("kNN k=16384: tie-aware recall %.6f != 1"
                             % tie_recall)
    plan = knn_plan(x, cents, a, L2)
    out, args, kw = check_walk("%dx%d fp32 k=%d L2 kn=%d, projection "
                               "relabel" % (n, f, k, kn), plan, k, kn, L2, 0,
                               plan.m_total // plan.q_chunk)
    walk_times = time_walk(tag, args, kw)
    print("%s scale: kNN %dx%d fp32 k=%d %d-NN (tests/test_scale.py:97): "
          "wall %.4f s, peak memory %s, examined fraction %.6f, knn_walk "
          "launches %d; recall@%d %.6f, tie-aware %.6f over all %d rows"
          % (tag, n, f, k, kn, wall, gb(peak), fraction(log),
             launches["knn_walk"], kn, recall, tie_recall, n), flush=True)
    del x, cents, a, nb, plan, args
    return launches["knn_walk"], out["max_abs_err"], walk_times


def filter_passes(log: str) -> list:
    """P of each ``yinyang: C candidates, P samples passed the global
    filter`` line of a verbosity-2 log, in order."""
    return [int(l.split()[3]) for l in log.splitlines()
            if l.endswith(" samples passed the global filter")]


def yinyang_large_k_run(tag):
    """tests/test_scale.py:136-150 on the card: 8192 x 32 uniform, k=2048,
    k-means++ seed 2, Yinyang == Lloyd bitwise: at the JAX test's tolerance
    0.01 and 3 iterations, whose one Yinyang iteration is a dense refresh
    that filters no row; then at tolerance 0 and 8 iterations, where a
    sparse iteration must filter rows.  The budget gate would hand so few
    iterations to Lloyd before any grouping, so it is off here
    (``YY_MIN_REMAINING`` 0), as the JAX suite's conftest sets it.
    Returns the launch counts of the four runs."""
    s = YY_LARGE_K
    n = s["n"]
    x = torch.from_numpy(np.random.RandomState(0).rand(n, s["f"])
                         .astype(np.float32)).cuda()
    out = []
    for tol, iters in ((0.01, 3), (0.0, 8)):
        with knobs(YY_MIN_REMAINING=0):
            (_c, a), log, yy_n, ll_n = yinyang_vs_lloyd(
                "%s scale: k=%d %dx%d fp32 Yinyang (tests/test_scale.py:136"
                "; tolerance %g, %d iterations at most)"
                % (tag, s["k"], n, s["f"], tol, iters), x, s["k"],
                D.DistanceMetric.L2, init="k-means++", seed=2, tolerance=tol,
                max_iterations=iters)
        filled = int(torch.unique(a).numel())
        if filled <= s["k"] // 2:
            raise AssertionError("k=2048: %d clusters filled" % filled)
        passed = filter_passes(log)
        if iters > 3 and not (passed and min(passed) < n):
            raise AssertionError("k=2048: no Yinyang iteration filtered a "
                                 "row (%s of %d passed)" % (passed, n))
        print("k=2048 Yinyang (%d iterations at most): %d of %d clusters "
              "filled; rows passing the global filter per Yinyang "
              "iteration %s of %d" % (iters, filled, s["k"], passed, n),
              flush=True)
        out += [yy_n, ll_n]
    return out


def scale_phase(tag, errs, starts):
    """The JAX package's scale tier, each run's data made on the card from
    a seed and deleted before the next: the reference's overflow run, the
    kernels timed and held at its shape, bench.py's 8M config, the kernels
    timed and held at its shape, B1/B2 and a k-means run past 2**31
    elements, the 40M x 256 bf16 capacity run, kNN at k=16,384 and Yinyang
    at k=2048.  Returns the phase's launch counts, the kernel times at the
    two shapes, B1's sums against fp64 past 2**31, B3's numbers and the
    init step's and the draw's times at 8M and 40M.  ``starts``: the 8M
    start's digests so far, which :func:`bench_8m_run` completes and
    holds (:func:`start_repeat_gate`)."""
    counts = {name: 0 for name in _launches()}

    def add(launches):
        for name, count in launches.items():
            counts[name] += count

    t = time.perf_counter()
    add(overflow_run(tag))
    times_167m = time_kernels(tag, OVERFLOW, torch.float32, 2, errs)
    launches, metrics, step_8m, draw_8m = bench_8m_run(tag, starts)
    add(launches)
    times_8m = time_kernels(tag, BENCH_8M, torch.bfloat16, 2, errs)
    launches, held_9m = past_2_31_run(tag, errs)
    add(launches)
    launches, step_40m, draw_40m = capacity_run(tag)
    add(launches)
    walk_launches, walk_err, walk_times = knn_large_k_run(tag)
    counts["knn_walk"] += walk_launches
    for launches in yinyang_large_k_run(tag):
        add(launches)
    require_launched("scale phase", counts, counts)
    print("%s scale phase: %.1f s; launches %s"
          % (tag, time.perf_counter() - t, counts), flush=True)
    return {"launches": counts, "times_167m": times_167m,
            "times_8m": times_8m, "held_9m": held_9m, "metrics": metrics,
            "walk_err": walk_err, "walk": walk_times,
            "point_min": {"scale_8m_bf16": step_8m,
                          "capacity_40m_bf16": step_40m},
            "weighted_draw": {"scale_8m_bf16": draw_8m,
                              "capacity_40m_bf16": draw_40m}}


# ---------------------------------------------------------------------------
# The port's benchmark, as a user runs it

#: seconds the bench may take (about 100 s on one H100)
BENCH_TIMEOUT = 480
#: bench.py's final-line keys
BENCH_FINAL_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}


def bench_phase(tag, iterations_8m):
    """``python3 bench_torch.py`` at full size in a process of its own,
    with this process's cached card memory returned first; echoes its
    lines.  Fails unless it exits 0 and its final line has bench.py's five
    keys and headline, all 18 metrics in ``extra`` and no ``failed``,
    tie-aware recall@16 1.0, every wall positive, the 8M run's iteration
    count ``iterations_8m`` (this process's), and every kernel launched.
    Returns the bench's launch counts (its own ``kernel launches``
    line)."""
    gc.collect()
    torch.cuda.empty_cache()
    env = {key: val for key, val in os.environ.items()
           if key not in ("KMTPU_BENCH_SMOKE", "KMTPU_BENCH_CPU")}
    t = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "bench_torch.py"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, start_new_session=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        out, err = proc.communicate(timeout=BENCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)     # the bench and its children
        out, err = proc.communicate()
        print(out + err, flush=True)
        raise AssertionError("bench_torch.py ran past %d s" % BENCH_TIMEOUT)
    wall = time.perf_counter() - t
    for line in out.splitlines():
        print("bench_torch: %s" % line, flush=True)
    if proc.returncode != 0:
        print(err, flush=True)
        raise AssertionError("bench_torch.py exited %d" % proc.returncode)
    lines = out.strip().splitlines()
    final = json.loads(lines[-1])
    extra = final["extra"]
    if set(final) != BENCH_FINAL_KEYS or final["metric"] != B.HEADLINE:
        raise AssertionError("bench_torch.py: final line is not bench.py's: "
                             "%s" % sorted(final))
    if set(extra) != set(B.METRICS):
        raise AssertionError("bench_torch.py: extra holds %s, not bench.py's "
                             "18 metrics" % sorted(extra))
    if extra["knn16_1mx256_tie_aware_recall_at_16"]["value"] != 1.0:
        raise AssertionError("bench_torch.py: tie-aware recall@16 %s" %
                             extra["knn16_1mx256_tie_aware_recall_at_16"])
    walls = {name: rec["value"] for name, rec in extra.items()
             if rec["unit"] == "s"}
    walls[final["metric"]] = final["value"]
    if not all(v > 0 for v in walls.values()):
        raise AssertionError("bench_torch.py: a wall is not positive: %s"
                             % walls)
    if extra["kmeans_8mx256_iterations"]["value"] != iterations_8m:
        raise AssertionError("bench_torch.py: %s 8M iterations, this process "
                             "%d (the start repeats across processes)"
                             % (extra["kmeans_8mx256_iterations"]["value"],
                                iterations_8m))
    launches = json.loads([l for l in lines if l.startswith(
        "kernel launches ")][-1][len("kernel launches "):])
    require_launched("bench_torch.py", launches, launches)
    print("%s bench phase (python3 bench_torch.py, full size): %.1f s, exit "
          "0, 18 metrics, launches %s" % (tag, wall, launches), flush=True)
    return launches


if __name__ == "__main__":
    sys.exit(main())
