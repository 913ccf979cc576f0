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

The exchange between cards has no fault here: every cell runs on one
card.  ``control.py --fault`` reads them at a cell's own size; the CPU
tests plant them at a small one.
"""

import torch

from kmbench.harness import Program
from kmbench.reference import kmeans as RK

FAULTS = ("unchanged", "half", "moved", "early", "uniform")


class Broken(Program):
    """kmcuda_torch with the fault ``fault`` planted in its results."""

    def __init__(self, fault: str):
        super().__init__()
        if fault not in FAULTS:
            raise ValueError("unknown fault %r" % fault)
        self.fault = fault

    def kmeans(self, x, k, **kw):
        if self.fault == "early":
            kw = dict(kw, tolerance=10 * kw["tolerance"])
        elif self.fault == "uniform" and kw.get("init", "k-means++") in (
                "k-means++", "kmeans++"):
            kw = dict(kw, init="random")
        c, a, lines = super().kmeans(x, k, **kw)
        if self.fault == "unchanged":
            c, a, _ = super().kmeans(x, k, **dict(kw, max_iterations=1))
        elif self.fault == "half":
            every2 = torch.arange(x.shape[0], device=x.device) % 2 == 0
            mean, _ = RK.means(x[every2], a.to(x.device)[every2], k)
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
