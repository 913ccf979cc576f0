#!/usr/bin/env python3
"""Where the time goes in the port's k-means and kNN calls on one CUDA card.

    python3 chip_profile.py [phase ...]

Phases (all by default): ``init`` (k-means++ at 100,000 x 256 fp32,
k=1024), ``default`` (the default call ``kmeans_cuda(x, 1024)`` on that
data, tolerance 0.002, at most 60 iterations, against ``yinyang_t=0``),
``spherical`` (AFK-MC2, m=100, and the 20-iteration cosine call at
1,000,000 x 256 unit rows), ``bf16`` (Yinyang against Lloyd at
1,000,000 x 256 bf16, random init, tolerance 0, 60 iterations) and
``knn`` (``knn_cuda`` at 1,000,000 x 256 fp32 blobs, k=1024, 16-NN) and
``walk`` (the walk kernel alone, ``knn_kernels.walk``, on 32 query chunks
from the middle of that layout at 16 and 32 neighbours, kk = 32 and 48,
in fp32 and in bf16 storage of the same rows and clustering: CUDA-event
ms per launch, mean of 5, twice in turns) and ``crossover`` (the Yinyang
candidate fraction at which a sparse iteration costs one dense-floor
iteration, on the deep-tail samples of ``chip_smoke.py`` in fp32 and in
bf16 storage, from random init and from the 15-iteration restart, read
from the loop's own per-iteration walls; see
:func:`crossover`; the source of ``YY_DENSE_FRACTION``) and
``yinyang`` (Yinyang and Lloyd walls, min of 2 in turns after a warm-up,
for the default call from its k-means++ start, 1,000,000 x 256 bf16 at 60
iterations and the deep-tail restart; through ``kmeans_cuda`` alone, so a
copy of this script and ``chip_smoke.py`` in an older checkout times that
checkout's Yinyang on the same data) and ``tail`` (the deep-tail restart's
Yinyang and Lloyd traced) and ``grouping`` (the Yinyang grouping of
1024 centroids into 102 groups, warm: its k-means++, its Lloyd, the
whole step).  The data is
``chip_smoke.py``'s.  The ``walk`` phase uses only entry points that
earlier versions of the port have too, so a copy of this script times an
older checkout's kernel on the same inputs.

For each: untraced walls (synchronized), then one warm run under
``torch.profiler``: the traced wall, the device busy time (the union of the
CUDA kernel and memcpy intervals) as a share of it, the number of device
operations, and the device time of the busiest operations by name.  Every
line carries the card's name and power limit.
"""

import collections
import contextlib
import io
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as S
from kmcuda_torch import config, kmeans_cuda, knn_cuda
from kmcuda_torch.models import initialization as I
from kmcuda_torch.models import knn as TK
from kmcuda_torch.models import lloyd as L
from kmcuda_torch.models import yinyang as Y
from kmcuda_torch.models.problem import prepare
from kmcuda_torch.ops import distance as D
from kmcuda_torch.ops import knn_kernels as KK
from kmcuda_torch.utils.logging import Logger

PHASES = ("init", "default", "spherical", "bf16", "knn", "walk", "crossover",
          "yinyang", "tail", "grouping")


def yinyang_walls(card, label, x, k, **kw):
    """Yinyang and Lloyd walls of one call (after a warm-up of each), min of
    2 in turns, and their ratio."""
    walls = {0.1: [], 0: []}
    for yt in (0, 0.1, 0, 0.1, 0.1, 0):
        walls[yt].append(S.wall_s(lambda: kmeans_cuda(x, k, yinyang_t=yt,
                                                      **kw)))
    yy, ll = min(walls[0.1][1:]), min(walls[0][1:])
    print("[%s] yinyang walls, %s: Yinyang %.4f s (%s), Lloyd %.4f s (%s), "
          "Yinyang / Lloyd %.3f"
          % (card, label, yy, ", ".join("%.4f" % w for w in walls[0.1][1:]),
             ll, ", ".join("%.4f" % w for w in walls[0][1:]), yy / ll),
          flush=True)


def loop_iterations(log: str) -> list:
    """(candidates, passed, variant, seconds) of each Yinyang loop
    iteration in a verbosity-2 log whose controller windows are one
    iteration long."""
    out, cur = [], None
    for l in log.splitlines():
        w = l.split()
        if "passed the global filter" in l:
            cur = [int(w[1]), int(w[3])]
        elif l.startswith("yinyang: ") and " moved rows patched" in l:
            cur.append(l[len("yinyang: "):].split(" iteration, ")[0])
        elif l.startswith("yinyang: segment of 1 iterations in "):
            out.append((*cur, float(w[6])))
    return out


def crossover(card, label, x, k, starts, iterations=45):
    """The Yinyang candidate fraction at which a sparse iteration costs one
    dense-floor iteration, read from the loop itself: ``x`` clustered from
    each of ``starts`` ((name, kmeans_cuda keywords) pairs) through
    ``kmeans_cuda`` with ``YY_DENSE_FRACTION`` 1 (every iteration the
    controller allows goes sparse) and 0 (every one dense), each iteration
    a controller window of its own that is never revoked, so the
    verbosity-2 lines give its wall (host clock, ms resolution) beside its
    candidates, survivors and variant.  A start far from convergence
    begins the loop where many rows are candidates, a late one where few
    are.  The two runs of a start share one trajectory (checked bitwise),
    so their walls pair by iteration and churn-driven costs cancel.  A window ends before its iteration's bound
    work has run on the card, so the next window carries it: only pairs of
    a sparse keep and a dense plain iteration that each follow one of
    their own kind are fitted, sparse minus dense ms against the candidate
    fraction by least squares; the crossover is where the fit crosses 0."""
    n = x.shape[0]
    pairs, plain = [], []
    for name, start in starts:
        runs = {}
        for frac in (1.0, 0.0):
            knobs = dict(YY_DENSE_FRACTION=frac, YY_PROBE_ITERS=1,
                         YY_WINDOW_MAX_ITERS=1,
                         YY_BAILOUT_MARGIN=float("inf"), YY_MIN_REMAINING=0)
            saved = {key: getattr(config, key) for key in knobs}
            try:
                for key, val in knobs.items():
                    setattr(config, key, val)
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    out = kmeans_cuda(x, k, tolerance=0.0,
                                      max_iterations=iterations, verbosity=2,
                                      **start)
            finally:
                for key, val in saved.items():
                    setattr(config, key, val)
            runs[frac] = (out, loop_iterations(buf.getvalue()))
        (cs, a_s), sparse_its = runs[1.0]
        (cd, a_d), dense_its = runs[0.0]
        if not (torch.equal(a_s, a_d) and S.nan_equal(cs, cd)):
            raise AssertionError("crossover %s, %s: the runs differ"
                                 % (label, name))
        for frac, its in ((1, sparse_its), (0, dense_its)):
            print("[%s] crossover %s, %s, dense fraction %d: per loop "
                  "iteration candidates/survivors as fractions of the rows, "
                  "variant, ms: %s" % (card, label, name, frac, " ".join(
                      "%.4f/%.4f/%s:%.0f" % (c / n, pa / n,
                                             v.replace(" ", "_"), 1e3 * t)
                      for c, pa, v, t in its)), flush=True)
        pairs += [(sp[0] / n, 1e3 * (sp[3] - dn[3]))
                  for i, (sp, dn) in enumerate(zip(sparse_its, dense_its))
                  if i > 0 and sp[2] == sparse_its[i - 1][2] == "sparse keep"
                  and dn[2] == dense_its[i - 1][2] == "dense plain"]
        plain += [1e3 * t for i, (_c, _p, v, t) in enumerate(dense_its)
                  if i > 0 and v == dense_its[i - 1][2] == "dense plain"]
    plain.sort()
    if len(pairs) < 2:
        print("[%s] crossover %s: %d pairs, no fit" % (card, label,
                                                         len(pairs)),
              flush=True)
        return
    fx = torch.tensor([f for f, _d in pairs], dtype=torch.float64)
    fd = torch.tensor([d for _f, d in pairs], dtype=torch.float64)
    slope = float(((fx - fx.mean()) * (fd - fd.mean())).sum()
                  / ((fx - fx.mean()) ** 2).sum())
    icpt = float(fd.mean()) - slope * float(fx.mean())
    at = -icpt / slope if slope > 0 else float("inf")
    print("[%s] crossover %s: dense plain %.0f ms (median of %d); sparse "
          "keep minus dense plain ms = %.3f + %.3f x candidate fraction over "
          "%d pairs (fractions %.4f-%.4f); 0 at candidate fraction %.3f"
          % (card, label, plain[len(plain) // 2], len(plain), icpt, slope,
             len(pairs), float(fx.min()), float(fx.max()), at), flush=True)


def traced(card, label, fn, top=14):
    """One warm run of ``fn`` under the profiler; prints its busy share and
    its busiest device operations."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    intervals = []
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            start, end = e.time_range.start, e.time_range.end
            intervals.append((start, end))
            by_name[e.name][0] += 1
            by_name[e.name][1] += (end - start) / 1e3
    busy_us, cur_s, cur_e = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_e is None or start > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    busy = busy_us / 1e6
    print("[%s] %s traced: wall %.4f s, device busy %.4f s (%.1f%%), %d "
          "device ops" % (card, label, wall, busy, 100 * busy / wall,
                          len(intervals)), flush=True)
    for name, (n, ms) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:top]:
        print("   %9.3f ms %6d x  %s" % (ms, n, name[:110]), flush=True)


def untraced(card, label, fn, reps=2):
    walls = [S.wall_s(fn) for _ in range(reps)]
    print("[%s] untraced %s: %s s" % (card, label,
                                      ", ".join("%.4f" % w for w in walls)),
          flush=True)


def quiet(fn):
    def run():
        with contextlib.redirect_stdout(io.StringIO()):
            return fn()
    return run


def phase_lines(fn):
    """The Yinyang phase and per-iteration lines of a verbosity-2 run."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return S.yinyang_profile(buf.getvalue())


def main(phases) -> int:
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    card = S.card_line()
    print(card, flush=True)
    D.disable_tf32()
    dev = torch.device("cuda")
    L2, COS = D.DistanceMetric.L2, D.DistanceMetric.COSINE
    k = S.HEADLINE["k"]
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(S.HEADLINE["n"], S.HEADLINE["f"], generator=g, device=dev)

    if "init" in phases:
        p = prepare(x, k, L2, dev, Logger(0))
        pp = lambda: I.init_centroids(p, I.InitMethod.PLUS_PLUS, 1)
        pp()
        untraced(card, "k-means++ 100000x256 fp32 k=1024", pp)
        traced(card, "k-means++ 100000x256 fp32 k=1024", pp)

    if "default" in phases:
        kw = dict(seed=1, tolerance=0.002, max_iterations=60)
        yy = lambda: kmeans_cuda(x, k, **kw)
        ll = lambda: kmeans_cuda(x, k, yinyang_t=0, **kw)
        yy(), ll()
        untraced(card, "default call Yinyang", yy)
        untraced(card, "default call Lloyd", ll)
        print("[%s] default call Yinyang: %s" % (card, phase_lines(
            lambda: kmeans_cuda(x, k, verbosity=2, **kw))), flush=True)
        traced(card, "default call Yinyang 100000x256 fp32 k=1024", yy)
        traced(card, "default call Lloyd 100000x256 fp32 k=1024", ll)

    if "spherical" in phases:
        s = S.SPHERICAL
        g = torch.Generator(device="cuda").manual_seed(7)
        xs = torch.randn(s["n"], s["f"], generator=g, device=dev)
        xs = xs / xs.norm(dim=1, keepdim=True)
        ps = prepare(xs, s["k"], COS, dev, Logger(0))
        mc2 = lambda: I.init_centroids(ps, I.InitMethod.AFKMC2, 7,
                                       afkmc2_m=s["m"])
        sph = lambda: kmeans_cuda(xs, s["k"], init=("afkmc2", s["m"]), seed=7,
                                  metric="cos", tolerance=0.01, yinyang_t=0,
                                  max_iterations=20)
        mc2()
        untraced(card, "AFK-MC2 1000000x256 cos k=1024 m=100", mc2)
        untraced(card, "spherical call", sph)
        traced(card, "AFK-MC2 1000000x256 cos k=1024 m=100", mc2)
        traced(card, "spherical call (AFK-MC2 + 20 Lloyd iterations)", sph)
        del xs, ps

    if "bf16" in phases:
        g = torch.Generator(device="cuda").manual_seed(0)
        xb = torch.rand(S.BF16_RUN["n"], S.BF16_RUN["f"], generator=g,
                        device=dev).to(torch.bfloat16)
        kb = dict(init="random", seed=1, tolerance=0.0, max_iterations=60)
        yb = lambda: kmeans_cuda(xb, k, yinyang_t=0.1, **kb)
        lb = lambda: kmeans_cuda(xb, k, yinyang_t=0, **kb)
        untraced(card, "1000000x256 bf16 Yinyang", yb, reps=1)
        untraced(card, "1000000x256 bf16 Lloyd", lb, reps=1)
        print("[%s] 1000000x256 bf16 Yinyang: %s" % (card, phase_lines(
            lambda: kmeans_cuda(xb, k, yinyang_t=0.1, verbosity=2, **kb))),
            flush=True)
        traced(card, "1000000x256 bf16 Yinyang, 60 iterations", yb)
        traced(card, "1000000x256 bf16 Lloyd, 60 iterations", lb)
        del xb

    if "knn" in phases:
        b = S.KNN_BENCH
        xk, centers = S.blobs_on_card(b["n"], b["f"], b["k"], 11)
        c, a = S.cluster(xk, centers, L2)
        nn = lambda: knn_cuda(b["kn"], xk, c, a)
        nn()
        untraced(card, "knn_cuda 1000000x256 fp32 k=1024 16-NN", nn)
        traced(card, "knn_cuda 1000000x256 fp32 k=1024 16-NN", nn)

    if "walk" in phases:
        b = S.KNN_BENCH
        xk, centers = S.blobs_on_card(b["n"], b["f"], b["k"], 11)
        c, a = S.cluster(xk, centers, L2)
        for dtype in (torch.float32, torch.bfloat16):
            plan = S.knn_plan(xk.to(dtype), c, a, L2)
            base = plan.m_total // plan.q_chunk // 2 - 16
            for kn in (16, 32):
                args, kw = TK.batch_walk_inputs(plan, base, 32,
                                                k_neighbors=kn,
                                                n_clusters=b["k"], metric=L2)
                fn = lambda: KK.walk(*args, **kw)
                fn()
                ms = [S.time_ms(fn, 5) for _ in range(2)]
                print("[%s] walk kernel 32 chunks x %d rows of %dx%d %s, "
                      "%d-NN (kk %d): %s ms" % (
                          card, kw["chunk"], b["n"], b["f"], str(dtype)[6:],
                          kn, kw["kk"], ", ".join("%.4f" % t for t in ms)),
                      flush=True)
            del plan, args, kw
        del xk, c, a

    if "crossover" in phases:
        xt, ct = S.deep_tail_data()
        starts = (("from random init", dict(init="random", seed=3)),
                  ("restart after 15 iterations", dict(init=ct)))
        for dtype in (torch.float32, torch.bfloat16):
            crossover(card, "deep tail 2000000x256 %s k=1024, 45 iterations"
                      % str(dtype)[6:], xt.to(dtype), k, starts)
        del xt, ct

    if "grouping" in phases:
        # the Yinyang grouping of k=1024 centroids (102 groups), warm: the
        # group k-means++ and Lloyd, then the whole models.yinyang step
        L2 = D.DistanceMetric.L2
        c = x[:k].clone()
        for rep in range(3):
            t0 = time.perf_counter()
            sub = prepare(c, k // 10, L2, dev, Logger(0))
            c0 = I._init_plus_plus(sub, I.generator(0x77))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            L.run(sub, c0, sub.assign0, 0.02)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            Y._group_centroids(c, k // 10, L2, I.generator(0x77))
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            print("[%s] grouping %d centroids into %d groups: group "
                  "k-means++ %.1f ms, its Lloyd %.1f ms; the whole grouping "
                  "%.1f ms" % (card, k, k // 10, 1e3 * (t1 - t0),
                               1e3 * (t2 - t1), 1e3 * (t3 - t2)), flush=True)

    if "tail" in phases:
        xt, ct = S.deep_tail_data()
        kt = dict(init=ct, tolerance=0.0, max_iterations=45)
        yt = lambda: kmeans_cuda(xt, k, yinyang_t=0.1, **kt)
        lt = lambda: kmeans_cuda(xt, k, yinyang_t=0, **kt)
        print("[%s] deep tail Yinyang: %s" % (card, phase_lines(
            lambda: kmeans_cuda(xt, k, yinyang_t=0.1, verbosity=2, **kt))),
            flush=True)
        traced(card, "deep tail 2000000x256 fp32 Yinyang, 45-iteration "
               "restart", yt)
        traced(card, "deep tail 2000000x256 fp32 Lloyd, 45-iteration "
               "restart", lt)
        del xt, ct

    if "yinyang" in phases:
        # walls only, through kmeans_cuda alone, so a copy of this script
        # in an older checkout times that checkout's Yinyang
        L2 = D.DistanceMetric.L2
        p = prepare(x, k, L2, dev, Logger(0))
        c_pp = I.init_centroids(p, I.InitMethod.PLUS_PLUS, 1)
        yinyang_walls(card, "default call 100000x256 fp32 k=1024 from its "
                      "k-means++ start, tolerance 0.002, budget 60", x, k,
                      init=c_pp, tolerance=0.002, max_iterations=60)
        g = torch.Generator(device="cuda").manual_seed(0)
        xb = torch.rand(S.BF16_RUN["n"], S.BF16_RUN["f"], generator=g,
                        device=dev).to(torch.bfloat16)
        yinyang_walls(card, "1000000x256 bf16 k=1024, random init, 60 "
                      "iterations", xb, k, init="random", seed=1,
                      tolerance=0.0, max_iterations=60)
        del xb
        xt, ct = S.deep_tail_data()
        yinyang_walls(card, "deep tail 2000000x256 fp32 k=1024, 45-iteration "
                      "restart", xt, k, init=ct, tolerance=0.0,
                      max_iterations=45)
        del xt, ct

    print("[%s] peak memory %.2f GB"
          % (card, torch.cuda.max_memory_allocated() / 1e9), flush=True)
    return 0


if __name__ == "__main__":
    unknown = set(sys.argv[1:]) - set(PHASES)
    if unknown:
        sys.exit("chip_profile: unknown phase(s) %s; phases: %s"
                 % (" ".join(sorted(unknown)), " ".join(PHASES)))
    sys.exit(main(sys.argv[1:] or PHASES))
