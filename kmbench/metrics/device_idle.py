"""Share of the traced calls' time in which no operation ran on the card:
100 - the busy share (``trace.idle_percent``).  Serves every
``device_idle.<cell>`` entry."""

from kmbench import trace as T


def read(run):
    return T.idle_percent(run)
