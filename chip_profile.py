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
whole step) and ``devices`` (with several cards: headline Lloyd, the
default call, 1,000,000 x 256 bf16 Lloyd and kNN at 1,000,000 x 256 fp32
16-NN over 1, 2, 4 and 8 real cards, as many as the host has: a CUDA
tensor on card 0 with the mask of the first d cards, its rows scattered
over them; walls, bitwise repeats, the contract against one card;
k-means++ alone over 1, 2, 4, 8 cards (walls, picks bitwise one card's);
then the headline, the default call, its k-means++ and kNN traced over
all the cards (the default call and k-means++ also over one), busy share
per card and the host's torch op count;
with one card it says it did not run) and ``shards`` (k-means++ and the
default call on 1, 2 and 4 logical shards of card 0: walls, picks, and
traces at 1 and 4 shards with the host's torch op count) and ``lloyd8m``
(bench.py's 8M config restarted from its centroids after 20 iterations:
three sparse Lloyd iterations timed, traced, and split into their pieces
for each sparse arm the checkout has; see :func:`lloyd8m_phase`) and
``start8m`` (that config's k-means++ picks and first iterations in this
process, before and after ``chip_smoke.check_delta_sum``; see
:func:`start8m_phase`).  The data is
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
import subprocess
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
from kmcuda_torch.parallel.devices import Topology
from kmcuda_torch.ops import assign as A
from kmcuda_torch.ops import assign_kernels as K
from kmcuda_torch.ops import compact as C
from kmcuda_torch.ops import distance as D
from kmcuda_torch.ops import init_kernels as IK
from kmcuda_torch.ops import knn_kernels as KK
from kmcuda_torch.utils.logging import Logger

PHASES = ("init", "default", "spherical", "bf16", "knn", "walk", "crossover",
          "yinyang", "tail", "grouping", "devices", "shards", "lloyd8m",
          "start8m")


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


def traced(card, label, fn, top=14, setup=None):
    """One warm run of ``fn`` under the profiler; prints its busy share and
    its busiest device operations.  With ``setup``, each run is
    ``fn(setup())``, the setup outside the window."""
    run = (lambda: fn(setup())) if setup else fn
    run()
    arg = setup() if setup else None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn(arg) if setup else fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    intervals = collections.defaultdict(list)
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            start, end = e.time_range.start, e.time_range.end
            intervals[e.device_index].append((start, end))
            by_name[e.name][0] += 1
            by_name[e.name][1] += (end - start) / 1e3
    busy = {dev: union_us(iv) / 1e6 for dev, iv in intervals.items()}
    lead = min(busy) if busy else 0
    host_ops = sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and e.cpu_parent is None and e.name.startswith("aten::"))
    print("[%s] %s traced: wall %.4f s, device busy %.4f s (%.1f%%), %d "
          "device ops, %d host torch ops%s" % (
              card, label, wall, busy.get(lead, 0.0),
              100 * busy.get(lead, 0.0) / wall,
              sum(len(iv) for iv in intervals.values()), host_ops,
              "" if len(busy) < 2 else "; busy per card: " + ", ".join(
                  "cuda:%d %.4f s (%.1f%%)" % (dev, b, 100 * b / wall)
                  for dev, b in sorted(busy.items()))), flush=True)
    for name, (n, ms) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:top]:
        print("   %9.3f ms %6d x  %s" % (ms, n, name[:110]), flush=True)


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_e is None or start > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def devices_phase(card, x, k):
    """The public calls over 1, 2, 4 and 8 real cards (as many as the host
    has): a CUDA tensor on card 0 with the mask of the first d cards, its
    rows scattered over them and its results back on card 0.  Two runs
    per d (bitwise equal; walls min of 2); headline Lloyd held to the
    contract against one card (``chip_smoke.check_count_contract``), the
    default call too from 4 cards up (to its iteration counts at 2), 1M
    bf16 to one card's first assignment from one start, k-means++ to one
    card's picks, kNN to one card's neighbours up to fp64 ties; then the
    traces."""
    n_dev = torch.cuda.device_count()
    if n_dev < 2:
        print("[%s] devices: not run (this host has one CUDA device)"
              % card, flush=True)
        return
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print("devices: %d cards: %s" % (n_dev, " | ".join(cards)), flush=True)
    counts = [d for d in (1, 2, 4, 8) if d <= n_dev]

    def timed(fn):
        buf = io.StringIO()
        sync_all()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = fn()
        sync_all()
        return out, buf.getvalue(), time.perf_counter() - t

    g = torch.Generator(device="cuda").manual_seed(0)
    xb = torch.rand(S.BF16_RUN["n"], S.BF16_RUN["f"], generator=g,
                    device="cuda").to(torch.bfloat16)
    lloyd = dict(init="random", seed=1, tolerance=0.002, yinyang_t=0,
                 max_iterations=15)
    cases = (("headline Lloyd 100000x256 fp32", x, lloyd),
             ("default call 100000x256 fp32", x,
              dict(seed=1, tolerance=0.002, max_iterations=60)),
             ("1M bf16 Lloyd", xb, dict(lloyd, max_iterations=10)))
    for label, data, kw in cases:
        res, walls = {}, {}
        for d in counts:
            runs = [timed(lambda: kmeans_cuda(data, k, device=(1 << d) - 1,
                                              verbosity=2, **kw))
                    for _ in range(2)]
            S.check_repeat("%s on %d cards" % (label, d), runs[0][:2],
                           runs[1][:2])
            plans = [l for l in runs[0][1].splitlines()
                     if l.startswith("plan: ")]
            if len(plans) != d:
                raise AssertionError("%s: %d plan lines on %d cards"
                                     % (label, len(plans), d))
            res[d], walls[d] = runs[0][:2], min(r[2] for r in runs)
        against = []
        for d in counts[1:]:
            if label.startswith("headline"):
                against.append("d=%d %s" % (d, S.check_count_contract(
                    label, res[1], res[d])))
            elif label.startswith("default") and d == 2:
                against.append("d=%d %s" % (d, S.check_iteration_counts(
                    label, res[1], res[d])))
            elif label.startswith("default"):
                against.append("d=%d %s" % (d, S.check_count_contract(
                    label, res[1], res[d])))
            else:
                against.append("d=%d %d assignments differ" % (
                    d, int((res[d][0][1] != res[1][0][1]).sum())))
        print("[%s] devices %s: repeats bitwise at every d; walls %s; "
              "against one card: %s" % (card, label, ", ".join(
                  "d=%d %.4f s" % (d, w) for d, w in walls.items()),
                  "; ".join(against)), flush=True)
    c0 = xb[torch.randperm(xb.shape[0], generator=I.generator(1))[:k]
            .cuda()].float()
    first = {d: kmeans_cuda(xb, k, init=c0, tolerance=0.0, yinyang_t=0,
                            max_iterations=1, device=(1 << d) - 1)[1]
             for d in counts}
    for d in counts[1:]:
        if not torch.equal(first[d], first[1]):
            raise AssertionError("1M bf16 on %d cards: the first assignment "
                                 "is not one card's" % d)
    print("[%s] devices 1M bf16 Lloyd: from one start the first assignment "
          "is bitwise one card's at every d" % card, flush=True)
    del xb, first

    # k-means++ alone, the default call's first phase
    L2 = D.DistanceMetric.L2
    picks, pp_walls = {}, {}
    for d in counts:
        p = prepare(x, k, L2, Topology([torch.device("cuda", i)
                                        for i in range(d)]), Logger(0))
        runs = [timed(lambda: I.init_centroids(p, I.InitMethod.PLUS_PLUS, 1))
                for _ in range(2)]
        picks[d], pp_walls[d] = runs[0][0], min(r[2] for r in runs)
        if not torch.equal(picks[d], picks[1]):
            raise AssertionError("k-means++ on %d cards: picks differ from "
                                 "one card's" % d)
        del p
    print("[%s] devices k-means++ 100000x256 fp32 k=1024: picks bitwise one "
          "card's at every d; walls %s" % (card, ", ".join(
              "d=%d %.4f s" % (d, w) for d, w in pp_walls.items())),
          flush=True)
    b = S.KNN_BENCH
    xk, centers = S.blobs_on_card(b["n"], b["f"], b["k"], 11)
    c, a = S.cluster(xk, centers, D.DistanceMetric.L2)
    nbs, walls, fracs = {}, {}, {}
    for d in counts:
        runs = [timed(lambda: knn_cuda(b["kn"], xk, c, a,
                                       device=(1 << d) - 1, verbosity=1))
                for _ in range(2)]
        if not torch.equal(runs[0][0], runs[1][0]):
            raise AssertionError("kNN on %d cards: two runs differ" % d)
        nbs[d], walls[d] = runs[0][0], min(r[2] for r in runs)
        fracs[d] = S.fraction(runs[0][1])
    ties = {d: S.neighbour_ties(xk, nbs[d], nbs[1]) for d in counts[1:]}
    print("[%s] devices kNN 1000000x256 fp32 k=1024 16-NN: repeats "
          "bitwise; walls %s; examined fractions %s; rows off one card's "
          "(all fp64 ties) %s" % (card, ", ".join(
              "d=%d %.4f s" % (d, w) for d, w in walls.items()),
              fracs, ties), flush=True)
    mask = (1 << counts[-1]) - 1
    traced(card, "headline Lloyd over %d cards" % counts[-1],
           lambda: kmeans_cuda(x, k, device=mask, **lloyd))
    for d in sorted({1, counts[-1]}):
        traced(card, "default call over %d cards" % d,
               lambda: kmeans_cuda(x, k, device=(1 << d) - 1, seed=1,
                                   tolerance=0.002, max_iterations=60))
        p = prepare(x, k, L2, Topology([torch.device("cuda", i)
                                        for i in range(d)]), Logger(0))
        traced(card, "k-means++ over %d cards" % d,
               lambda: I.init_centroids(p, I.InitMethod.PLUS_PLUS, 1))
        del p
    traced(card, "kNN 1M 16-NN over %d cards" % counts[-1],
           lambda: knn_cuda(b["kn"], xk, c, a, device=mask))


def shards_phase(card, x, k):
    """k-means++ and the default call on 1, 2 and 4 logical shards of card
    0 (``Topology([cuda:0] * d)``; the calls through
    ``chip_smoke.logical_shards``): walls, min of 2 in turns, picks bitwise
    one shard's; then both traced at d = 1 and 4.  One card has no peer
    copies, so this is the host's share of the shard loop alone."""
    L2 = D.DistanceMetric.L2
    dev = torch.device("cuda", 0)
    problems = {d: prepare(x, k, L2, Topology([dev] * d), Logger(0))
                for d in S.SHARD_COUNTS}
    pp = {d: (lambda p=problems[d]: I.init_centroids(
        p, I.InitMethod.PLUS_PLUS, 1)) for d in S.SHARD_COUNTS}

    def default(d):
        def call():
            with S.logical_shards(d) as mask:
                return kmeans_cuda(x, k, device=mask, seed=1,
                                   tolerance=0.002, max_iterations=60)
        return call

    picks = {d: pp[d]() for d in S.SHARD_COUNTS}
    for d in S.SHARD_COUNTS:
        if not torch.equal(picks[d], picks[1]):
            raise AssertionError("k-means++ on %d logical shards: picks "
                                 "differ from one shard's" % d)
    for label, fns in (("k-means++ 100000x256 fp32 k=1024", pp),
                       ("default call 100000x256 fp32 k=1024",
                        {d: default(d) for d in S.SHARD_COUNTS})):
        fns[1]()
        walls = {d: [] for d in fns}
        for _ in range(2):
            for d, fn in fns.items():
                walls[d].append(S.wall_s(fn))
        print("[%s] shards %s on logical shards of one card: %s" % (
            card, label, ", ".join("d=%d %.4f s" % (d, min(w))
                                   for d, w in walls.items())), flush=True)
        for d in (1, 4):
            traced(card, "%s on %d logical shards" % (label, d), fns[d])


def sparse_arms() -> list:
    """(name, moved rows, delta) of each sparse Lloyd arm this checkout
    has: the sort and the chunk walk of ``ops.compact`` (the one-hot
    product, the arm before ``kmt_delta_sum``) and, where the checkout has
    it, the ascending nonzero with ``kmt_delta_sum``.  ``moved(aid, a)``
    gives the rows, ``delta(x, rows, aid, a, changed, k)`` the (sums,
    counts) delta."""
    arms = [("sort + chunk walk",
             lambda aid, a: C.stable_partition(aid != a)[0],
             lambda x, rows, aid, a, ch, k: C.delta_compacted(
                 x, aid, a, rows, ch, n_clusters=k))]
    if hasattr(K, "delta_sum"):
        arms.append(("nonzero + kmt_delta_sum", C.moved_rows,
                     lambda x, rows, aid, a, ch, k: K.delta_sum(
                         x, rows, aid, a, n_clusters=k)))
    return arms


def lloyd8m_phase(card, restart_at=20, sparse=3):
    """bench.py's 8M config (8,000,000 x 256 bf16, k=1024, k-means++ seed
    17, tolerance 0.01) restarted from its centroids and assignment after
    ``restart_at`` iterations through ``ops.assign.lloyd_run``: its first
    iteration is dense, the ``sparse`` after it take the sparse arm.
    Those are timed untraced (min of 2 restarts), traced once (busy share,
    busiest device operations), and replayed piece by piece with a
    synchronize after each (B2, the count's read, the moved-row
    partition, the delta with its chunk count, the running sums and
    normalize) for each of :func:`sparse_arms`, a warm pass first."""
    b = S.BENCH_8M
    k, L2 = b["k"], D.DistanceMetric.L2
    x = S.B.uniform_bf16_rows("cuda")
    c0, a0 = kmeans_cuda(x, k, init="k-means++", seed=17, tolerance=0.01,
                         yinyang_t=0, max_iterations=restart_at)
    p = prepare(x, k, L2, x.device, Logger(0))
    label = ("lloyd8m %dx%d bf16 k=%d, restart after %d iterations"
             % (b["n"], b["f"], k, restart_at))

    def restart():
        it = A.lloyd_run(p.x, p.valid, a0, c0, n_clusters=k, metric=L2)
        first = next(it)
        torch.cuda.synchronize()
        return it, first

    def run_sparse(state):
        out = [next(state[0]).changed for _ in range(sparse)]
        torch.cuda.synchronize()
        return out

    walls = []
    for _ in range(2):
        state = restart()
        t = time.perf_counter()
        moved = run_sparse(state)
        walls.append(time.perf_counter() - t)
    print("[%s] %s: dense restart iteration %d moved; sparse iterations "
          "moved %s; untraced %s ms per sparse iteration (%d iterations, "
          "min of 2: %s s)"
          % (card, label, state[1].changed, moved, "%.3f" % (
              1e3 * min(walls) / sparse), sparse,
             ", ".join("%.4f" % w for w in walls)), flush=True)
    traced(card, "%s, %d sparse iterations" % (label, sparse), run_sparse,
           setup=restart)
    first = restart()[1]
    for name, moved_rows, delta in sparse_arms():
        for rep in range(2):
            a, c = first.assign, first.c_next
            sums, counts = first.sums, first.counts
            for i in range(sparse):
                t = [time.perf_counter()]
                aid, _best, ch_t = K.assign_only_pass(
                    p.x, p.valid, a, c, n_clusters=k, metric=L2)
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                ch = int(ch_t)
                t.append(time.perf_counter())
                rows = moved_rows(aid, a)
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                d_sums, d_counts = delta(p.x, rows, aid, a, ch, k)
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                sums, counts = sums + d_sums, counts + d_counts
                c = D.normalize_centroids(sums, counts.float(), L2)
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                a = aid
                ms = [1e3 * (t1 - t0) for t0, t1 in zip(t, t[1:])]
                if rep:
                    print("[%s] %s, %s, sparse iteration %d: %d moved rows "
                          "(%d chunks of %d); B2 %.3f ms, count read %.3f "
                          "ms, partition %.3f ms, delta %.3f ms, sums and "
                          "normalize %.3f ms; %.3f ms in all, %.3f beyond "
                          "B2" % (card, label, name, i + 1, ch,
                                  -(-ch // config.DEFAULT_SAMPLE_CHUNK),
                                  config.DEFAULT_SAMPLE_CHUNK, *ms, sum(ms),
                                  sum(ms[1:])), flush=True)
    del x, p, c0, a0


def start8m_phase(card, iterations=4):
    """bench.py's 8M config's start twice in one process: k-means++ (seed
    17) on a prepared problem and ``kmeans_cuda`` capped at
    ``iterations`` (verbosity 1), first with nothing run before, then
    after ``chip_smoke.check_delta_sum`` (what the smoke runs before its
    8M run); prints the first pick that differs and both runs' iteration
    lines.  Then k-means++ twice on one prepared problem, and the draw's
    first-level scan (``torch.cumsum`` of the block sums of one distance
    pass) 50 times, counting distinct results.  Everything on the path is
    meant to be a function of the data and the seed."""
    b = S.BENCH_8M
    k, L2 = b["k"], D.DistanceMetric.L2
    x = S.B.uniform_bf16_rows("cuda")

    def start():
        p = prepare(x, k, L2, x.device, Logger(0))
        picks = I.init_centroids(p, I.InitMethod.PLUS_PLUS, 17)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            kmeans_cuda(x, k, init="k-means++", seed=17, tolerance=0.01,
                        yinyang_t=0, verbosity=1, max_iterations=iterations)
        lines = [l.split(": ")[1].split()[0] for l in
                 buf.getvalue().splitlines() if l.startswith("iteration ")]
        del p
        return picks, lines

    def first_differ(a, b):
        rows = torch.nonzero((a != b).any(dim=1)).squeeze(1)
        return ("equal" if rows.numel() == 0
                else "first differ at step %d" % int(rows[0]))

    fresh = start()
    S.check_delta_sum("[%s]" % card)
    after = start()
    print("[%s] start8m %dx%d bf16 k=%d: k-means++ picks %s; iteration "
          "counts fresh %s, after the delta check %s"
          % (card, b["n"], b["f"], k, first_differ(fresh[0], after[0]),
             fresh[1], after[1]), flush=True)
    # the same problem twice in a row, then the draw's pieces repeated:
    # one distance pass and the first level of the draw's inverse CDF (the
    # cumulative block sums, torch.cumsum on the card)
    p = prepare(x, k, L2, x.device, Logger(0))
    picks = [I.init_centroids(p, I.InitMethod.PLUS_PLUS, 17)
             for _ in range(2)]
    w = torch.empty_like(p.x_sq)
    IK.point_min(p.x, p.x_sq, p.valid, p.x[0].float(), w, L2, first=True)
    bs = I._draw_block_size(w.numel())
    sums = w.view(-1, bs).sum(1)
    scans = [torch.cumsum(sums, 0) for _ in range(50)]
    distinct = len({bytes(t.cpu().numpy().tobytes()) for t in scans})
    print("[%s] start8m: init_centroids twice on one prepared problem: %s; "
          "the draw's cumsum over %d block sums, 50 repeats: %d distinct "
          "results (max |difference| %.3g of a total %.6g)"
          % (card, first_differ(*picks), sums.numel(), distinct,
             max(float((t - scans[0]).abs().max()) for t in scans),
             float(scans[0][-1])), flush=True)
    del x, p


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

    if "devices" in phases:
        devices_phase(card, x, k)

    if "shards" in phases:
        shards_phase(card, x, k)

    if "lloyd8m" in phases:
        lloyd8m_phase(card)

    if "start8m" in phases:
        start8m_phase(card)

    print("[%s] peak memory %.2f GB"
          % (card, torch.cuda.max_memory_allocated() / 1e9), flush=True)
    return 0


if __name__ == "__main__":
    unknown = set(sys.argv[1:]) - set(PHASES)
    if unknown:
        sys.exit("chip_profile: unknown phase(s) %s; phases: %s"
                 % (" ".join(sorted(unknown)), " ".join(PHASES)))
    sys.exit(main(sys.argv[1:] or PHASES))
