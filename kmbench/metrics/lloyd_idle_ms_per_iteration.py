"""The Lloyd loop: the device's idle time inside the program's
``kmt.lloyd`` spans over the iterations its counters report (one
``lloyd.dense`` a dense iteration, one ``lloyd.moved_rows`` sample a
sparse one), in ms an iteration over all the traced calls.  For cells
where Lloyd runs alone: a Yinyang call counts its draft's iterations,
and its grouping's Lloyd is a ``kmt.lloyd`` span of its own.  Serves
every ``lloyd_idle_ms_per_iteration.<cell>`` entry."""

from kmbench import spans as S


def read(run):
    recs = S.records(run)
    loops = S.spans(run, "kmt.lloyd")
    if recs is None or not loops:
        return None
    its = (sum(S.samples(recs, "lloyd.dense"))
           + len(S.samples(recs, "lloyd.moved_rows")))
    return S.idle_ns(run, loops) / 1e6 / its if its else None
