"""The whole call's share of the card's peak (``trace.mfu``).  Serves
every ``mfu.<cell>`` entry."""

from kmbench import trace as T


def read(run):
    return T.mfu(run)
