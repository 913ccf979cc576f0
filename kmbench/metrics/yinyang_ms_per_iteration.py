"""The Yinyang schedule (draft, grouping, loop): from each traced call's
first ``assign_kernel`` start to the end of its span, over its iteration
lines (draft and loop number on); ms an iteration over all the traced
calls (``trace.loop_ms_per_iteration``).  Serves every
``yinyang_ms_per_iteration.<cell>`` entry."""

from kmbench import trace as T


def read(run):
    return T.loop_ms_per_iteration(run)
