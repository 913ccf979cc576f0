"""API, prepare and init of the traced k-means calls
(``trace.prepare_init_s``).  Serves every ``prepare_init_s.<cell>``
entry."""

from kmbench import trace as T


def read(run):
    return T.prepare_init_s(run)
