"""Plain PyTorch brute-force k-nearest neighbours: the yardstick that judges
kmcuda_torch's ``knn_cuda`` results, and, in a lower precision, the
control that the judgement has to fail.  Imports nothing of the program.
"""

import torch

from kmbench.reference.kmeans import (rounded, sq_distances, tf32_off,
                                      valid_rows)

#: entries of a (queries, n) distance block, near 1 GB in fp64
BLOCK_ENTRIES = 1 << 27


def _blocks(n: int):
    step = max(1, BLOCK_ENTRIES // max(1, n))
    return range(0, n, step), step


def _distances(x, valid, q0, q1, precision):
    """(q1 - q0, n) squared distances of queries x[q0:q1] to every row in
    ``precision``; a row to itself, and to or from an invalid row, +inf."""
    xr = rounded(torch.where(valid[:, None], x, torch.zeros_like(x)),
                 precision)
    d = sq_distances(xr[q0:q1], xr)
    d = d.masked_fill(~valid[None, :], float("inf"))
    rows = torch.arange(q0, q1, device=x.device)
    d[rows - q0, rows] = float("inf")
    return d


def knn(kk, x, precision="fp64", **_ignored):
    """(n, kk) int32 ids of each row's kk nearest other valid rows by
    ``precision`` distances, nearest first; -1 for invalid rows."""
    n = x.shape[0]
    valid = valid_rows(x)
    out = torch.full((n, kk), -1, dtype=torch.int32, device=x.device)
    starts, step = _blocks(n)
    with tf32_off():
        for q0 in starts:
            q1 = min(n, q0 + step)
            d = _distances(x, valid, q0, q1, precision)
            idx = torch.topk(d, kk, dim=1, largest=False).indices
            out[q0:q1] = torch.where(valid[q0:q1, None], idx.int(),
                                     torch.full_like(idx.int(), -1))
    return out


def knn_gap(x, nbr) -> tuple:
    """(gap, bad) of neighbour lists ``nbr`` (n, kk): the fp64 distances of
    each valid row's listed neighbours, sorted, against the kk smallest
    fp64 distances to other valid rows, slot by slot; gap is the widest
    excess as a share of the true distance in that slot.  bad counts
    listed ids out of range, of the row itself, of an invalid row, listed
    twice in a row, or a valid row's -1, and invalid rows not all -1."""
    n, kk = nbr.shape
    nbr = nbr.to(x.device).long()
    valid = valid_rows(x)
    bad = int((~valid[:, None] & (nbr != -1)).sum())
    widest = 0.0
    starts, step = _blocks(n)
    with tf32_off():
        for q0 in starts:
            q1 = min(n, q0 + step)
            d = _distances(x, valid, q0, q1, "fp64")
            ids = nbr[q0:q1]
            ok = valid[q0:q1]
            ids, d = ids[ok], d[ok]
            in_range = (ids >= 0) & (ids < n)
            got = d.gather(1, ids.clamp(0, n - 1))
            got = torch.where(in_range, got,
                              torch.full_like(got, float("inf")))
            srt = torch.sort(ids, dim=1).values
            dup = (srt[:, 1:] == srt[:, :-1]).sum()
            inf = ~torch.isfinite(got)
            bad += int(dup) + int(inf.sum())
            true = torch.topk(d, kk, dim=1, largest=False).values
            got = torch.sort(torch.where(inf, true, got), dim=1).values
            gap = (got - true) / true.clamp(min=1e-30)
            if gap.numel():
                widest = max(widest, float(gap.max()))
    return widest, bad
