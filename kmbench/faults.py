"""Faults planted in the program where its result is produced, under the
harness, which the judgement has to catch (``correct`` false):

- ``unchanged``: a k-means call that returns the state it started from
  (its start and that start's assignment), as a step that left its state
  unchanged would;
- ``half``: centroids that are the means of every second row of those
  the assignment gives them, half of the rows left out;
- ``moved``: one assignment moved to the next centroid id; one kNN
  neighbour swapped for the row farthest from its query;
- ``early``: a k-means call that stops early, the same way each time: it
  runs with ten times the tolerance asked for;
- ``uniform``: a k-means++ start whose picks are uniform over the rows
  (the call runs with ``init="random"``).

Two more are planted inside the program, in the code a call over several
cards runs (:data:`INSIDE`), for the way such a call fails where the
cards exchange their work:

- ``exchange``: the Lloyd loop's sums and counts of the last card's row
  shard left out of the reduction on the leader, every iteration; the
  rows are still assigned against the means of the other shards;
- ``lead_draw``: every k-means++ draw made from the leader's row shard
  alone, the other cards' weights left out.

``control.py --fault`` reads them at a cell's own size; the CPU tests
plant them at a small one.
"""

import contextlib

import torch

from kmbench.harness import Program, samples_on
from kmbench.reference import kmeans as RK

FAULTS = ("unchanged", "half", "moved", "early", "uniform", "exchange",
          "lead_draw")
#: the faults planted inside the program's code, not on its results
INSIDE = ("exchange", "lead_draw")


@contextlib.contextmanager
def planted(fault: str):
    """Inside the block, the program's code carries ``fault`` (one of
    :data:`INSIDE`; any other plants nothing here)."""
    if fault == "exchange":
        from kmcuda_torch.ops import assign as A
        real = A.Topology

        class LastLeftOut(real):
            def reduce(self, parts):
                return super().reduce(parts[:-1] if len(parts) > 1
                                      else parts)

        A.Topology = LastLeftOut
        try:
            yield
        finally:
            A.Topology = real
    elif fault == "lead_draw":
        from kmcuda_torch.models import initialization as I
        real = I._draw_row

        def lead_only(problem, weights, valid, u, out):
            if len(problem.xs) > 1:
                weights = weights.clone()
                weights[problem.shards[0].stop:] = 0
            return real(problem, weights, valid, u, out)

        I._draw_row = lead_only
        try:
            yield
        finally:
            I._draw_row = real
    else:
        yield


class Broken(Program):
    """kmcuda_torch with the fault ``fault`` planted; ``devices``: the
    cards of the cell, where the references take the samples."""

    def __init__(self, fault: str, devices=()):
        super().__init__()
        if fault not in FAULTS:
            raise ValueError("unknown fault %r" % fault)
        self.fault, self.devices = fault, list(devices)

    def kmeans(self, x, k, **kw):
        if self.fault == "early":
            kw = dict(kw, tolerance=10 * kw["tolerance"])
        elif self.fault == "uniform" and kw.get("init", "k-means++") in (
                "k-means++", "kmeans++"):
            kw = dict(kw, init="random")
        with planted(self.fault):
            c, a, lines = super().kmeans(x, k, **kw)
        if self.fault == "unchanged":
            c, a, _ = super().kmeans(x, k, **dict(kw, max_iterations=1))
        elif self.fault == "half":
            # every second row takes no part (an id out of range)
            every2 = a.clone()
            every2[1::2] = -1
            mean, _ = RK.means(samples_on(x, self.devices or [x.device]),
                               every2, k)
            mean = mean.to(c.device)
            c = torch.where(torch.isfinite(mean), mean,
                            c.double()).to(c.dtype)
        elif self.fault == "moved":
            a = a.clone()
            a[17] = (a[17] + 1) % k
        return c, a, lines

    def knn(self, kk, x, c, a, **kw):
        nbr, lines = super().knn(kk, x, c, a, **kw)
        if self.fault == "moved":
            nbr = nbr.clone()
            d = ((x[5:6].float() - x.float()) ** 2).sum(1)
            nbr[5, 0] = int(torch.argmax(d))
        return nbr, lines
