"""The kNN plan's pruning: the share of all n^2 (query, row) distances the
search computed, from the program's ``calculated F of all the
distances`` line; the mean over the traced calls."""

from kmbench.harness import examined_fraction


def read(run):
    fr = [examined_fraction(c.lines) for c in run.calls]
    if not fr or None in fr:
        return None
    return sum(fr) / len(fr)
