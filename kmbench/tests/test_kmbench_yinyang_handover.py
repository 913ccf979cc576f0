"""The reader of Yinyang's Lloyd handover (``yinyang_handover_share``) on
synthetic counter records whose answer is known, in each cell that lists
it."""

import pytest

from kmbench_tree import REPO, H
from kmbench import trace as T
from kmcuda_torch.utils import profiling

MS = 1_000_000  # ns
SPANS = [(0, 100 * MS), (200 * MS, 300 * MS)]
CELLS = {"default_call": "100k_fp32.default_call",
         "k40k": "k40k_f480_bf16.random_yinyang",
         "default_8m": "8m_bf16.default_call"}


def _run(cell_name):
    cell = H.find_cell(REPO, cell_name)
    host = [T.Event(T.CALL_SPAN, a, b) for a, b in SPANS]
    window_s = sum(b - a for a, b in SPANS) / 1e9
    return H.TraceRun(cell, [H.Call(1, 0.0, [], None, "")] * len(SPANS),
                      SPANS, [], host, window_s, 0.0)


def _record(span, counters):
    return {"kind": "kmeans", "start_ns": span[0] + 1, "end_ns": span[1] - 1,
            "counters": [list(c) for c in counters]}


def _loop(bound, lloyd, mark=True):
    """The counters of a loop that ran ``bound`` iterations on the bound
    path and then ``lloyd`` on the Lloyd path; ``mark``: the program
    records the arm's 0 as the loop starts."""
    out = [("yinyang.rows", 100)]
    if mark:
        out.append(("yinyang.handed_over", 0))
    for _ in range(bound):
        out += [("yinyang.candidates", 100), ("yinyang.passed", 100),
                ("yinyang.refreshed_rows", 100)]
    for _ in range(lloyd):
        out += [("yinyang.handed_over", 1), ("yinyang.passed", 100)]
    return out


CASES = {
    # the arm never engaged: 0, not nothing
    "no handover": ([_loop(5, 0), _loop(3, 0)], 0.0),
    # one call handed 6 of its 8 iterations over, the other none
    "one handover": ([_loop(2, 6), _loop(4, 0)], 6 / 12),
    "both calls": ([_loop(2, 3), _loop(2, 1)], 4 / 8),
    # calls that ran no Yinyang loop (the budget gates, Lloyd)
    "no yinyang records": ([[("lloyd.dense", 1)], []], None),
    # an older program: a loop, but no handover counter at all
    "older program": ([_loop(5, 0, mark=False)] * 2, None),
}


@pytest.mark.parametrize("suffix", sorted(CELLS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_handover_share(case, suffix, monkeypatch):
    counters, want = CASES[case]
    recs = [_record(s, c) for s, c in zip(SPANS, counters)]
    monkeypatch.setattr(profiling, "records", lambda: list(recs))
    got = H.metric_reader(REPO / "kmbench", "yinyang_handover_share."
                          + suffix)(_run(CELLS[suffix]))
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)


def test_no_records_read_nothing(monkeypatch):
    """A program that keeps no records, or has no ``records`` at all."""
    monkeypatch.setattr(profiling, "records", lambda: [])
    run = _run(CELLS["default_8m"])
    reader = H.metric_reader(REPO / "kmbench",
                             "yinyang_handover_share.default_8m")
    assert reader(run) is None
    monkeypatch.delattr(profiling, "records")
    assert reader(run) is None
