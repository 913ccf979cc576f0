"""B2's share of its bound in the traced k-means calls
(``trace.assign_roofline``).  Serves every ``assign_roofline.<cell>``
entry."""

from kmbench import trace as T


def read(run):
    return T.assign_roofline(run)
