"""Plain PyTorch k-means: the yardstick that judges kmcuda_torch's k-means
results, and, computed in a lower precision, the control that the
judgement has to fail.

Nothing here imports the program.  It works from the samples alone (and
from the results it judges): every distance, mean and pick it needs it
computes again.

Precision names: ``fp64`` judges; ``fp32`` is plain
float32 with TF32 off; ``tf32`` rounds each product's operands to TF32's
10 mantissa bits and accumulates in fp32; ``bf16`` and ``fp8`` (e4m3)
round them to those types.  A rounded product is how the lower-precision
storage or tensor-core path of a program would compute it.
"""

import contextlib

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


def block_rows(k: int) -> int:
    return max(1, BLOCK_ENTRIES // max(1, k))


def valid_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows whose features are all finite (the others take no part)."""
    return torch.isfinite(x.float()).all(dim=1)


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
    ids outside [0, k) take no part; an empty cluster's mean is NaN."""
    f = x.shape[1]
    sums = torch.zeros((k, f), dtype=torch.float64, device=x.device)
    counts = torch.zeros(k, dtype=torch.int64, device=x.device)
    step = block_rows(f)
    for s in range(0, x.shape[0], step):
        ab = a[s:s + step].long()
        ok = (ab >= 0) & (ab < k)
        xb = rounded(x[s:s + step][ok], precision).double()
        sums.index_add_(0, ab[ok], xb)
        counts += torch.bincount(ab[ok], minlength=k)
    mean = sums / counts.clamp(min=1)[:, None].double()
    return mean.masked_fill((counts == 0)[:, None], float("nan")), counts


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
    centroid (or, for an invalid row, is not k)."""
    k = c.shape[0]
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
    scale = float(best_d[ok].mean()) if bool(ok.any()) else 1.0
    return widest / scale, bad


def mean_gap(x, c_next, a_prev) -> float:
    """How far the centroids ``c_next`` lie from the fp64 means of the
    rows of each id in ``a_prev``: the widest absolute difference over
    every entry, as a share of the largest mean entry.  A cluster that
    ``a_prev`` leaves empty must come out non-finite, and one it fills
    finite; either fault reads +inf."""
    k = c_next.shape[0]
    mean, counts = means(x, a_prev.to(x.device), k, "fp64")
    cd = c_next.to(x.device).double()
    filled = counts > 0
    finite = torch.isfinite(cd).all(dim=1)
    if bool((filled & ~finite).any()) or bool((~filled & finite).any()):
        return float("inf")
    if not bool(filled.any()):
        return float("inf")
    diff = (cd[filled] - mean[filled]).abs().max()
    return float(diff / mean[filled].abs().max())


def start_rows(x, c0) -> tuple:
    """(row ids, off): for each starting centroid of ``c0``, in order, the
    valid row of ``x`` nearest to it in fp64; and how many of them are no
    such row (not equal to it in every feature), plus how many rows were
    picked more than once."""
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
            idx = torch.where(better, bi + s, idx)
    same = (x[idx].double() == cd).all(dim=1) & ok[idx]
    return idx, int((~same).sum()) + (k - int(torch.unique(idx).numel()))


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
    fp32 products, TF32 off, sums in fp64."""
    starts = torch.as_tensor(starts).to(x.device).long()
    if starts.dim() == 1:
        starts = starts[None]
    b, k = starts.shape
    ok = valid_rows(x)
    n_ok = int(ok.sum())
    if k < 2 or n_ok <= k:
        return 0.0
    xr = x.to(torch.float32, copy=True).masked_fill_(~ok[:, None], 0.0)
    x_sq = (xr * xr).sum(1)
    cols = torch.arange(b, device=x.device)
    dmin = torch.full((x.shape[0], b), float("inf"), dtype=torch.float32,
                      device=x.device)
    got = torch.zeros((k - 1, b), dtype=torch.float64, device=x.device)
    s1 = torch.zeros_like(got)
    s2 = torch.zeros_like(got)
    with tf32_off():
        for j in range(1, k):
            c = xr[starts[:, j - 1]]
            d = (x_sq[:, None] + (c * c).sum(1)[None, :]
                 - 2.0 * (xr @ c.T)).clamp(min=0)
            dmin = torch.minimum(dmin, d.masked_fill_(~ok[:, None], 0.0))
            w = dmin.double().sqrt()
            got[j - 1] = w[starts[:, j], cols]
            s1[j - 1] = w.sum(0)
            s2[j - 1] = (w * w).sum(0)
    left = n_ok - torch.arange(1, k, dtype=torch.float64,
                               device=x.device)[:, None]
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
