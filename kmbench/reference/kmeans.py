"""Plain PyTorch k-means: the yardstick that judges kmcuda_torch's k-means
results, and, computed in a lower precision, the control that the
judgement has to fail.

Nothing here imports the program.  It works from the samples alone (and
from the results it judges): every distance, mean and pick it needs it
computes again.

The functions of the judgement take the samples as one tensor or as row
parts, one a card (:func:`shard`): each part is worked on its own card,
in a thread of its own, and what the parts give is put together in row
order (a widest gap the largest of theirs, fp64 sums and counts added in
part order), so parts give the numbers the whole tensor would, up to
fp64 rounding.

Precision names: ``fp64`` judges; ``fp32`` is plain
float32 with TF32 off; ``tf32`` rounds each product's operands to TF32's
10 mantissa bits and accumulates in fp32; ``bf16`` and ``fp8`` (e4m3)
round them to those types.  A rounded product is how the lower-precision
storage or tensor-core path of a program would compute it.
"""

import contextlib
from concurrent.futures import ThreadPoolExecutor

import torch

#: the stop rule on a churn that no longer falls: a count counts as a new
#: best only when it beats the best so far by a 64th; stop after this many
#: iterations without one (the stagnation rule of the kmcuda_torch API)
PATIENCE = 50

#: entries of a (rows, k) score block, so a block stays near 1 GB in fp64
BLOCK_ENTRIES = 1 << 27


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to nearest even on TF32's 10 mantissa bits."""
    i = t.float().contiguous().view(torch.int32)
    i = (i + (0x0FFF + ((i >> 13) & 1))) & -0x2000
    return i.view(torch.float32)


def rounded(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` as a product's operand in ``precision``: fp64 for fp64, else
    fp32 holding the rounded values."""
    if precision == "fp64":
        return t.double()
    if precision == "fp32":
        return t.float()
    if precision == "tf32":
        return _tf32(t)
    if precision == "bf16":
        return t.to(torch.bfloat16).float()
    if precision == "fp8":
        return t.float().clamp(-448, 448).to(torch.float8_e4m3fn).float()
    raise ValueError("unknown precision %r" % precision)


@contextlib.contextmanager
def tf32_off():
    """Products run as written: no TF32 behind a float32 matmul."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def shard(x: torch.Tensor, devices) -> list:
    """``x``'s rows cut into one contiguous part a device, the first
    ``n % d`` one row longer, each copied to its device (in threads):
    [(first row, rows), ...] in row order."""
    d = len(devices)
    base, extra = divmod(x.shape[0], d)
    starts = [i * base + min(i, extra) for i in range(d + 1)]
    return map_parts(lambda i, dev: (starts[i], x[starts[i]:starts[i + 1]]
                                     .to(dev)), list(enumerate(devices)))


def parts(x) -> list:
    """[(first row, rows), ...]: a tensor is one part; the parts of
    :func:`shard` are taken as they are."""
    return [(0, x)] if isinstance(x, torch.Tensor) else list(x)


def _on(device, fn, *args):
    if device.type != "cuda":
        return fn(*args)
    with torch.cuda.device(device):
        return fn(*args)


def map_parts(fn, items) -> list:
    """``fn(*item)`` for each (first, rows)-like item, each in a thread on
    its rows' card where there are several, results in item order.  TF32
    is off for the whole of it: the threads share torch's flags."""
    if len(items) == 1:
        return [fn(*items[0])]
    dev = [it[1] if isinstance(it[1], torch.device) else it[1].device
           for it in items]
    with tf32_off(), ThreadPoolExecutor(len(items)) as ex:
        return list(ex.map(lambda i: _on(dev[i], fn, *items[i]),
                           range(len(items))))


def rows_at(x, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (global ids) of ``x`` (a tensor or parts), on
    ``idx``'s device, in the order of ``idx``."""
    ps = parts(x)
    if len(ps) == 1:
        return ps[0][1][idx.to(ps[0][1].device)].to(idx.device)
    out = torch.empty((idx.numel(), ps[0][1].shape[1]), dtype=ps[0][1].dtype,
                      device=idx.device)
    for s, xs in ps:
        m = (idx >= s) & (idx < s + xs.shape[0])
        out[m] = xs[(idx[m] - s).to(xs.device)].to(idx.device)
    return out


def block_rows(k: int) -> int:
    return max(1, BLOCK_ENTRIES // max(1, k))


def valid_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows whose features are all finite (the others take no part); a
    block of rows at a time, so no float copy of all the rows is made."""
    ok = torch.empty(x.shape[0], dtype=torch.bool, device=x.device)
    step = block_rows(x.shape[1] if x.dim() > 1 else 1)
    for s in range(0, x.shape[0], step):
        ok[s:s + step] = torch.isfinite(x[s:s + step].float()).all(dim=1)
    return ok


def sq_distances(xb: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(rows, k) squared L2 distances of rounded operands, in their dtype:
    |x|^2 + |c|^2 - 2 x.c; a centroid with a non-finite entry is +inf."""
    bad = ~torch.isfinite(c).all(dim=1)
    c = torch.where(bad[:, None], torch.zeros_like(c), c)
    d = ((xb * xb).sum(1, keepdim=True) + (c * c).sum(1)[None, :]
         - 2.0 * (xb @ c.T))
    return d.masked_fill(bad[None, :], float("inf"))


def assign(x, c, precision="fp64"):
    """(assignments int64, best squared distance): each row's nearest
    centroid of ``c`` in ``precision``, ties to the lowest id; rows with
    non-finite features get id k and distance 0."""
    k = c.shape[0]
    cr = rounded(c, precision)
    out_a = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    out_d = torch.empty(x.shape[0], dtype=cr.dtype, device=x.device)
    step = block_rows(k)
    with tf32_off():
        for s in range(0, x.shape[0], step):
            xb = x[s:s + step]
            ok = valid_rows(xb)
            d = sq_distances(rounded(torch.where(ok[:, None], xb,
                                                 torch.zeros_like(xb)),
                                     precision), cr)
            best, idx = d.min(dim=1)
            out_a[s:s + step] = torch.where(ok, idx, torch.full_like(idx, k))
            out_d[s:s + step] = torch.where(ok, best, torch.zeros_like(best))
    return out_a, out_d


def means(x, a, k, precision="fp64"):
    """((k, f) fp64 means of the rows of each id in ``a``, (k,) counts);
    ids outside [0, k) take no part; an empty cluster's mean is NaN.
    ``x`` a tensor or parts: each part's sums and counts, added on the
    first part's card in part order."""
    got = map_parts(lambda s, xs: _sums(xs, a[s:s + xs.shape[0]], k,
                                        precision), parts(x))
    sums, counts = got[0]
    for ps, pc in got[1:]:
        sums = sums + ps.to(sums.device)
        counts = counts + pc.to(counts.device)
    mean = sums / counts.clamp(min=1)[:, None].double()
    return mean.masked_fill((counts == 0)[:, None], float("nan")), counts


def _sums(x, a, k, precision):
    f = x.shape[1]
    a = a.to(x.device)
    sums = torch.zeros((k, f), dtype=torch.float64, device=x.device)
    counts = torch.zeros(k, dtype=torch.int64, device=x.device)
    step = block_rows(f)
    for s in range(0, x.shape[0], step):
        ab = a[s:s + step].long()
        ok = (ab >= 0) & (ab < k)
        xb = rounded(x[s:s + step][ok], precision).double()
        sums.index_add_(0, ab[ok], xb)
        counts += torch.bincount(ab[ok], minlength=k)
    return sums, counts


def kmeanspp(x, k, gen, precision="fp64"):
    """k-means++ picks (int64 row ids) as kmcuda makes them: the first
    uniform over the valid rows, each next one drawn with probability
    proportional to its distance (kmcuda's weight, not the squared one) to
    the nearest pick so far (a uniform from ``gen`` against the fp64
    running sum of those distances)."""
    ok = valid_rows(x)
    rows = torch.nonzero(ok).squeeze(1)
    first = rows[int(torch.randint(rows.numel(), (1,), generator=gen))]
    xr = rounded(torch.where(ok[:, None], x, torch.zeros_like(x)), precision)
    x_sq = (xr * xr).sum(1)
    picks = [int(first)]
    dmin = torch.full((x.shape[0],), float("inf"), dtype=xr.dtype,
                      device=x.device)
    with tf32_off():
        for _ in range(1, k):
            c = xr[picks[-1]]
            d = (x_sq + (c * c).sum() - 2.0 * (xr @ c)).clamp(min=0)
            dmin = torch.minimum(dmin, d)
            w = torch.where(ok, dmin, torch.zeros_like(dmin)).double().sqrt()
            cum = torch.cumsum(w, 0)
            total = cum[-1]
            u = float(torch.rand((), generator=gen, dtype=torch.float64))
            if float(total) > 0:
                t = (u * total).reshape(1)
                i = int(torch.searchsorted(cum, t, right=True)
                        .clamp(max=x.shape[0] - 1))
            else:
                i = int(rows[int(u * rows.numel())])
            picks.append(i)
    return torch.tensor(picks, dtype=torch.int64, device=x.device)


def kmeans(x, k, *, tolerance, init="k-means++", seed=0,
           max_iterations=None, precision="fp64", **_ignored):
    """Lloyd k-means in ``precision`` from a random or k-means++ start
    drawn from ``seed``: assign every row, stop once no more than
    int(tolerance * n) rows changed or after ``max_iterations``, else move
    each centroid to its rows' mean; stop too after :data:`PATIENCE`
    iterations in which the count set no new best.  Keywords it has no
    use for (such as ``yinyang_t``: Yinyang's results are Lloyd's) are
    ignored.

    Returns (centroids, assignments int32, log lines): the centroids the
    assignments were computed against (fp32, or x's dtype for bf16/fp16
    x), and the ``iteration N: M reassignments`` lines."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    n = x.shape[0]
    ok = valid_rows(x)
    if init == "random":
        rows = torch.nonzero(ok).squeeze(1)
        picks = rows[torch.randperm(rows.numel(), generator=gen)[:k]
                     .to(rows.device)]
    elif init in ("k-means++", "kmeans++"):
        picks = kmeanspp(x, k, gen, precision)
    else:
        raise ValueError("unknown init %r" % (init,))
    c = x[picks].float()
    cap = max_iterations if max_iterations is not None else 1 << 16
    prev = torch.full((n,), k, dtype=torch.int64, device=x.device)
    lines = []
    t, mark, stale = 0, 1 << 31, 0
    while True:
        t += 1
        a, _ = assign(x, c, precision)
        changed = int((a != prev).sum())
        lines.append("iteration %d: %d reassignments" % (t, changed))
        if changed < mark - (mark >> 6):
            mark, stale = changed, 0
        else:
            stale += 1
        if changed <= int(tolerance * n) or t >= cap or stale >= PATIENCE:
            break
        # the sums as the one-hot products a tensor-core path takes them
        # in: the rows rounded to ``precision`` (fp32 and fp64 exactly)
        mean, _counts = means(x, a, k, "fp64" if precision in
                              ("fp32", "fp64") else precision)
        c, prev = mean.float(), a
    out_c = c.to(x.dtype) if x.dtype in (torch.bfloat16, torch.float16) else c
    return out_c, a.to(torch.int32), lines


# --- the judgement ---------------------------------------------------------

def assign_gap(x, c, a) -> tuple:
    """(gap, bad): over the valid rows, the widest amount by which the
    fp64 squared distance to a row's assigned centroid exceeds that to
    its nearest one, as a share of the mean nearest distance; and the
    count of rows whose id is out of range or names a non-finite
    centroid (or, for an invalid row, is not k).  ``x`` a tensor or
    parts: the widest of the parts' gaps over the mean of all their
    nearest distances."""
    got = map_parts(lambda s, xs: _gap_part(xs, c, a[s:s + xs.shape[0]]),
                    parts(x))
    widest = max(g[0] for g in got)
    bad = sum(g[1] for g in got)
    if len(got) == 1:
        scale = got[0][2]
    else:
        count = sum(g[4] for g in got)
        scale = sum(g[3] for g in got) / count if count else 1.0
    return widest / scale, bad


def _gap_part(x, c, a) -> tuple:
    """(widest gap, bad, mean nearest distance or 1.0, sum of the nearest
    distances, valid rows) of rows ``x`` and their ids ``a``."""
    k = c.shape[0]
    c = c.to(x.device)
    a = a.to(x.device).long()
    best_a, best_d = assign(x, c, "fp64")
    ok = valid_rows(x)
    in_range = (a >= 0) & (a < k)
    bad = int((ok & ~in_range).sum()) + int((~ok & (a != k)).sum())
    step = block_rows(k)
    cd = c.double()
    widest = 0.0
    with tf32_off():
        for s in range(0, x.shape[0], step):
            m = ok[s:s + step] & in_range[s:s + step]
            ab = a[s:s + step][m]
            xb = x[s:s + step][m].double()
            chosen = ((xb - cd[ab]) ** 2).sum(1)
            gap = chosen - best_d[s:s + step][m]
            if gap.numel():
                if not bool(torch.isfinite(gap).all()):
                    bad += int((~torch.isfinite(gap)).sum())
                    gap = gap[torch.isfinite(gap)]
                if gap.numel():
                    widest = max(widest, float(gap.max()))
    near = best_d[ok]
    n_ok = near.numel()
    scale = float(near.mean()) if n_ok else 1.0
    return widest, bad, scale, float(near.sum()), n_ok


def mean_gap(x, c_next, a_prev) -> float:
    """How far the centroids ``c_next`` lie from the fp64 means of the
    rows of each id in ``a_prev``: the widest absolute difference over
    every entry, as a share of the largest mean entry.  A cluster that
    ``a_prev`` leaves empty must come out non-finite, and one it fills
    finite; either fault reads +inf."""
    return mean_numbers(x, c_next, a_prev)["mean_gap"]


#: stored mantissa bits of a centroid dtype: its step between values
MANTISSA_BITS = {torch.bfloat16: 7, torch.float16: 10, torch.float32: 23}
#: how far past half a step an entry may lie and still count as the
#: mean rounded: room for the fp32 sums and division behind it
ROUNDING_SLACK = 1 / 16


def mean_numbers(x, c_next, a_prev) -> dict:
    """The numbers of :func:`mean_gap` and :func:`mean_off_rounding` from
    one pass of fp64 means over ``x``."""
    k = c_next.shape[0]
    mean, counts = means(x, a_prev, k, "fp64")
    cd = c_next.to(mean.device).double()
    filled = counts > 0
    finite = torch.isfinite(cd).all(dim=1)
    inf = float("inf")
    if bool((filled & ~finite).any()) or bool((~filled & finite).any()) \
            or not bool(filled.any()):
        return {"mean_gap": inf, "mean_off_rounding": inf}
    m, diff = mean[filled], (cd[filled] - mean[filled]).abs()
    _, e = torch.frexp(m)
    step = torch.ldexp(torch.ones_like(m),
                       e - 1 - MANTISSA_BITS.get(c_next.dtype, 23))
    return {"mean_gap": float(diff.max() / m.abs().max()),
            "mean_off_rounding": int((diff > (0.5 + ROUNDING_SLACK)
                                      * step).sum())}


def mean_off_rounding(x, c_next, a_prev) -> float:
    """How many entries of the centroids ``c_next`` are not the fp64 means
    of the rows of each id in ``a_prev`` rounded to ``c_next``'s dtype:
    entries farther from the mean than half a step of that dtype there,
    plus :data:`ROUNDING_SLACK` of a step.  A program that rounds the
    exact mean reads 0, whatever the cluster's size; means over part of
    the rows read the entries that part moved past a rounding (+inf as
    :func:`mean_gap` for a cluster filled or emptied wrongly)."""
    return mean_numbers(x, c_next, a_prev)["mean_off_rounding"]


def shard_share(x, rows) -> float:
    """The largest share of ``rows`` (row ids, such as a start's picks)
    that falls in one part of ``x``, times the number of parts: near 1
    where the parts hold like shares, the number of parts where one part
    holds them all; 1 for one part."""
    ps = parts(x)
    rows = torch.as_tensor(rows).reshape(-1)
    if len(ps) == 1 or not rows.numel():
        return 1.0
    counts = [int(((rows >= s) & (rows < s + xs.shape[0])).sum())
              for s, xs in ps]
    return max(counts) * len(ps) / rows.numel()


def start_rows(x, c0) -> tuple:
    """(row ids, off): for each starting centroid of ``c0``, in order, the
    valid row of ``x`` nearest to it in fp64 (the first such row on a
    tie); and how many of them are no such row (not equal to it in every
    feature), plus how many rows were picked more than once.  ``x`` a
    tensor or parts."""
    got = map_parts(lambda s, xs: _nearest_rows(xs, c0, s), parts(x))
    best, idx = got[0]
    for bd, bi in got[1:]:
        bd, bi = bd.to(best.device), bi.to(idx.device)
        better = bd < best
        best = torch.where(better, bd, best)
        idx = torch.where(better, bi, idx)
    k = idx.numel()
    rows = rows_at(x, idx)
    same = (rows.double() == c0.to(idx.device).double()).all(dim=1) \
        & valid_rows(rows)
    return idx, int((~same).sum()) + (k - int(torch.unique(idx).numel()))


def _nearest_rows(x, c0, first: int) -> tuple:
    """(fp64 squared distance, global row id) of the valid row of ``x``
    nearest to each of ``c0``, the first on a tie; rows of ``x`` start at
    ``first``."""
    ok = valid_rows(x)
    cd = c0.to(x.device).double()
    k = cd.shape[0]
    best = torch.full((k,), float("inf"), dtype=torch.float64,
                      device=x.device)
    idx = torch.zeros(k, dtype=torch.int64, device=x.device)
    step = block_rows(k)
    with tf32_off():
        for s in range(0, x.shape[0], step):
            xb = x[s:s + step].double()
            nan = torch.full_like(xb, float("nan"))
            d = sq_distances(cd, torch.where(ok[s:s + step][:, None], xb,
                                             nan))
            bd, bi = d.min(dim=1)
            better = bd < best
            best = torch.where(better, bd, best)
            idx = torch.where(better, bi + first + s, idx)
    return best, idx


def init_off_rows(x, c0) -> int:
    """How many of the starting centroids ``c0`` are not a valid row of
    ``x``, plus how many rows were picked more than once."""
    return start_rows(x, c0)[1]


def weight_shortfall(x, starts) -> float:
    """How far the k-means++ starts ``starts`` ((B, k) row ids, each row
    of it in the order picked) fall short of kmcuda's weighting.  At each
    pick j >= 1 of a start let w be every valid row's distance to its
    nearest earlier pick: a pick drawn in proportion to w expects
    sum(w^2) / sum(w), a uniform pick among the rows not picked yet
    expects sum(w) / (rows left).  Returns 1 - (the sum, over every pick
    of every start, of the pick's w less the uniform expectation) / (the
    same sum of the weighted expectation less the uniform one): about 0
    for starts drawn as kmcuda draws them, about 1 for uniform picks.
    fp32 products, TF32 off, sums in fp64.  ``x`` a tensor or parts:
    each pick's sums added over the parts in part order."""
    ps = parts(x)
    lead = ps[0][1].device
    starts = torch.as_tensor(starts).to(lead).long()
    if starts.dim() == 1:
        starts = starts[None]
    b, k = starts.shape
    oks = [valid_rows(xs) for _s, xs in ps]
    n_ok = sum(int(ok.sum()) for ok in oks)
    if k < 2 or n_ok <= k:
        return 0.0
    state = []
    for (s, xs), ok in zip(ps, oks):
        xr = xs.to(torch.float32, copy=True).masked_fill_(~ok[:, None], 0.0)
        state.append((s, xr, (xr * xr).sum(1), ok,
                      torch.full((xs.shape[0], b), float("inf"),
                                 dtype=torch.float32, device=xs.device)))
    cols = torch.arange(b, device=lead)
    got = torch.zeros((k - 1, b), dtype=torch.float64, device=lead)
    s1 = torch.zeros_like(got)
    s2 = torch.zeros_like(got)
    with tf32_off():
        for j in range(1, k):
            c = rows_at(x, starts[:, j - 1]).float()
            c = c.masked_fill_(~valid_rows(c)[:, None], 0.0)
            pick = starts[:, j]
            for i, (s, xr, x_sq, ok, dmin) in enumerate(state):
                cp = c.to(xr.device)
                d = (x_sq[:, None] + (cp * cp).sum(1)[None, :]
                     - 2.0 * (xr @ cp.T)).clamp(min=0)
                dmin = torch.minimum(dmin, d.masked_fill_(~ok[:, None], 0.0))
                state[i] = (s, xr, x_sq, ok, dmin)
                w = dmin.double().sqrt()
                here = (pick >= s) & (pick < s + xr.shape[0])
                got[j - 1][here] = w[(pick[here] - s).to(w.device),
                                     cols[here].to(w.device)].to(lead)
                s1[j - 1] += w.sum(0).to(lead)
                s2[j - 1] += (w * w).sum(0).to(lead)
    left = n_ok - torch.arange(1, k, dtype=torch.float64,
                               device=lead)[:, None]
    uniform = s1 / left
    weighted = s2 / s1.clamp(min=1e-300)
    lift = float((weighted - uniform).sum())
    if lift <= 0:
        return 0.0
    return 1.0 - float((got - uniform).sum()) / lift


def stop_early(counts, tol_count: int, cap=None) -> int:
    """By how many rows a run whose reassignment counts per iteration were
    ``counts`` stopped above the tolerance without cause: 0 where its last
    count is at most ``tol_count``, or it reached ``cap`` iterations, or
    the stagnation rule (:data:`PATIENCE`) stopped it; else the last count
    less ``tol_count``."""
    t = len(counts)
    mark, stale = (1 << 31) - 1, 0
    for changed in counts:
        if changed < mark - (mark >> 6):
            mark, stale = changed, 0
        else:
            stale += 1
    last = counts[-1] if counts else 0
    if last <= tol_count or (cap is not None and t >= cap) \
            or stale >= PATIENCE:
        return 0
    return int(last - tol_count)
