#!/usr/bin/env python3
"""Where the time goes in the port's k-means and kNN calls on one CUDA card.

    python3 chip_profile.py [phase ...]

Phases (all by default): ``init`` (k-means++ at 100,000 x 256 fp32,
k=1024), ``default`` (the default call ``kmeans_cuda(x, 1024)`` on that
data, tolerance 0.002, at most 60 iterations, against ``yinyang_t=0``),
``spherical`` (AFK-MC2, m=100, and the 20-iteration cosine call at
1,000,000 x 256 unit rows), ``bf16`` (Yinyang against Lloyd at
1,000,000 x 256 bf16, random init, tolerance 0, 30 iterations) and
``knn`` (``knn_cuda`` at 1,000,000 x 256 fp32 blobs, k=1024, 16-NN).  The
data is ``chip_smoke.py``'s.

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
from kmcuda_torch import kmeans_cuda, knn_cuda
from kmcuda_torch.models import initialization as I
from kmcuda_torch.models.problem import prepare
from kmcuda_torch.ops import distance as D
from kmcuda_torch.utils.logging import Logger

PHASES = ("init", "default", "spherical", "bf16", "knn")


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
        kb = dict(init="random", seed=1, tolerance=0.0, max_iterations=30)
        yb = lambda: kmeans_cuda(xb, k, yinyang_t=0.1, **kb)
        lb = lambda: kmeans_cuda(xb, k, yinyang_t=0, **kb)
        untraced(card, "1000000x256 bf16 Yinyang", yb, reps=1)
        untraced(card, "1000000x256 bf16 Lloyd", lb, reps=1)
        print("[%s] 1000000x256 bf16 Yinyang: %s" % (card, phase_lines(
            lambda: kmeans_cuda(xb, k, yinyang_t=0.1, verbosity=2, **kb))),
            flush=True)
        traced(card, "1000000x256 bf16 Yinyang, 30 iterations", yb)
        traced(card, "1000000x256 bf16 Lloyd, 30 iterations", lb)
        del xb

    if "knn" in phases:
        b = S.KNN_BENCH
        xk, centers = S.blobs_on_card(b["n"], b["f"], b["k"], 11)
        c, a = S.cluster(xk, centers, L2)
        nn = lambda: knn_cuda(b["kn"], xk, c, a)
        nn()
        untraced(card, "knn_cuda 1000000x256 fp32 k=1024 16-NN", nn)
        traced(card, "knn_cuda 1000000x256 fp32 k=1024 16-NN", nn)

    print("[%s] peak memory %.2f GB"
          % (card, torch.cuda.max_memory_allocated() / 1e9), flush=True)
    return 0


if __name__ == "__main__":
    unknown = set(sys.argv[1:]) - set(PHASES)
    if unknown:
        sys.exit("chip_profile: unknown phase(s) %s; phases: %s"
                 % (" ".join(sorted(unknown)), " ".join(PHASES)))
    sys.exit(main(sys.argv[1:] or PHASES))
