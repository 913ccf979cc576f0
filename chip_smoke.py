#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's Lloyd and kNN paths once on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``kmcuda_torch/csrc`` (nvcc, one
process per source, at first use) and holds each against its plain-torch
twin on the card.

Lloyd: the public ``kmeans_cuda`` at the reference benchmark's headline
configuration (100,000 x 256 fp32, k=1024, random init, seed 1, tolerance
0.002, 15 iterations), a 5-iteration restart from its centroids (so the
low-churn arm runs) and a 1,000,000 x 256 bf16 run.

kNN: the JAX bench's configuration (1,000,000 x 256 fp32 blobs, k=1024
clusters clustered from the blob centers, 16 neighbours) through the
public ``knn_cuda``, its recall against a brute force on the card, and the
same call on a CUDA and a CPU tensor of the 13K blob fixture.

Prints the card's name and power limit beside every time, a JSON line of
the kernels, and as its last line a JSON object with ``"ok": true``.  Any
failure raises, so the exit code is non-zero; so it is without a CUDA
device, or outside a checkout of the repository.

Tolerances (kernel vs plain twin on the same tensors):
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
  their fp64 distance profiles agree to rtol 1e-6 (ties); distances
  rtol 1e-6 where the ids are equal.
"""

import contextlib
import io
import json
import subprocess
import sys
import time

import numpy as np
import torch

from kmcuda_torch import kmeans_cuda, knn_cuda
from kmcuda_torch.models import knn as TK
from kmcuda_torch.models.problem import prepare
from kmcuda_torch.ops import _build
from kmcuda_torch.ops import assign_kernels as K
from kmcuda_torch.ops import distance as D
from kmcuda_torch.ops import knn_kernels as KK
from kmcuda_torch.utils.logging import Logger

HEADLINE = dict(n=100_000, f=256, k=1024)
BF16_RUN = dict(n=1_000_000, f=256, k=1024)
RAGGED = dict(n=100_003, f=250, k=1000)
KNN_BENCH = dict(n=1_000_000, f=256, k=1024, kn=16)
KNN_RAGGED = dict(n=100_003, f=250, k=1000, kn=10)
KNN_WIDE = dict(n=16_384, f=2_560, k=16, kn=200)


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
                if ragged and not bool((b1[0][~valid] == k).all()):
                    raise AssertionError("invalid rows not assigned k")
                errs["fused_lloyd_pass"] = max(
                    errs["fused_lloyd_pass"], best_err, sums_err)
                errs["assign_only_pass"] = max(
                    errs["assign_only_pass"], best_err)
                print("check %dx%d k=%d %s %s: ok; %d near-tie rows, %d "
                      "assignments differ there; max |d best| %.3g, max "
                      "|d sums| %.3g (%d row ranges); B1 == B2 bitwise; B1 "
                      "sums repeat bitwise"
                      % (n, f, k, str(dtype)[6:], metric.name,
                         int(ties.sum()), int(differ.sum()), best_err,
                         sums_err, K.segment_parts(n, k, f)), flush=True)
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


def time_kernels(tag, shape, dtype, reps):
    """B1, B2 and their plain twins at one main-path shape, in turns
    (plain, kernel, kernel, plain); returns {name: (ms, plain_ms)}."""
    n, f, k = shape["n"], shape["f"], shape["k"]
    x, valid, prev, c = make_inputs(n, f, k, dtype, D.DistanceMetric.L2,
                                    False, 11)
    kw = dict(n_clusters=k, metric=D.DistanceMetric.L2)
    fns = {
        "fused_lloyd_pass": (
            lambda: K.fused_lloyd_pass(x, valid, prev, c, **kw),
            lambda: K.fused_lloyd_pass_reference(x, valid, prev, c, **kw)),
        "assign_only_pass": (
            lambda: K.assign_only_pass(x, valid, prev, c, **kw),
            lambda: K.assign_only_pass_reference(x, valid, prev, c, **kw)),
    }
    out = {}
    for name, (kern, plain) in fns.items():
        p1 = time_ms(plain, reps)
        k1 = time_ms(kern, reps)
        k2 = time_ms(kern, reps)
        p2 = time_ms(plain, reps)
        out[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print("%s time %s %dx%d k=%d %s: kernel %.4f ms, plain %.4f ms"
              % (tag, name, n, f, k, str(dtype)[6:], out[name][0],
                 out[name][1]), flush=True)
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

    errs = {"fused_lloyd_pass": 0.0, "assign_only_pass": 0.0}
    check_kernels(errs)
    times = time_kernels(tag, HEADLINE, torch.float32, 20)
    time_kernels(tag, BF16_RUN, torch.bfloat16, 5)

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

    knn = knn_phase(tag)

    kernels = []
    for name, line in (("fused_lloyd_pass", 81), ("assign_only_pass", 127)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "kmcuda_torch/csrc/assign.cu",
            "replaces": "kmcuda_tpu/ops/assign_pallas.py:%d" % line,
            "launches": total[name], "max_abs_err": errs[name],
            "ms": times[name][0], "plain_ms": times[name][1]})
    kernels.append({
        "name": "knn_walk", "route": "cuda",
        "source": "kmcuda_torch/csrc/knn_walk.cu",
        "replaces": "kmcuda_tpu/ops/knn_pallas.py:150", **knn})
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
    in_smem = kw["kk"] * kw["chunk"] * 8 <= KK.SMEM_BUFFER_BYTES
    print("check B3 %s: ok; chunks %d..%d of %d (kk %d, chunk %d, tile_m "
          "%d, group %d, buffer in %s); %d tie rows, %d chunks' examined "
          "differ, examined %d, max |d dist| %.3g"
          % (label, chunk_base, chunk_base + n_chunks - 1,
             plan.m_total // plan.q_chunk, kw["kk"], kw["chunk"],
             plan.tile_m, plan.group, "shared memory" if in_smem
             else "global scratch", out["tie_rows"], out["chunks_differ"],
             out["examined"], out["max_abs_err"]), flush=True)
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
    kernel, plain); returns (ms, plain_ms)."""
    p1 = time_ms(lambda: KK.walk_reference(*args, **kw), reps)
    k1 = time_ms(lambda: KK.walk(*args, **kw), reps)
    k2 = time_ms(lambda: KK.walk(*args, **kw), reps)
    p2 = time_ms(lambda: KK.walk_reference(*args, **kw), reps)
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    print("%s time knn_walk %d chunks x %d rows, f=%d, kk=%d: kernel %.4f "
          "ms, plain %.4f ms (%.4f/%.4f, %.4f/%.4f)"
          % (tag, args[0].shape[0] // kw["chunk"], kw["chunk"],
             args[0].shape[1], kw["kk"], ms, plain_ms, k1, k2, p1, p2),
          flush=True)
    return ms, plain_ms


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

    # 1(a): 32 chunks from the middle of the bench layout, then 5: timing
    plan = knn_plan(x, c, a, L2)
    nchunks = plan.m_total // plan.q_chunk
    out, args, kw = check_walk("1000000x256 fp32 L2 kn=16", plan, b["k"],
                               b["kn"], L2, nchunks // 2 - 16, 32)
    errs.append(out["max_abs_err"])
    ms, plain_ms = time_walk(tag, args, kw)
    del plan, args, kw

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
    return {"launches": launches, "max_abs_err": max(errs), "ms": ms,
            "plain_ms": plain_ms}


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
