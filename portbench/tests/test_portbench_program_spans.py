"""The readers of the program's own spans and counters
(``tpuvec_torch/utils/timing.py``, in ``Run.timers``): known totals give
the known number, and missing entries (a program without the spans) give
None."""

import pytest

from portbench import harness
from portbench.harness import Run, Window

TIMERS = {
    "search.descent": (0.060, 3),          # host seconds, calls
    "search.descent.sync": (0.036, 93),
    "descent.steps": (90, 3),               # total, times counted
    "descent.query_steps": (368_640, 90),
    "descent.moved": (73_728, 90),
    "rerank.topk": (0.012, 4),
    "rerank.gather.device": (0.0048, 4),
}
# metric: (its value from TIMERS, the entries without which it reads None)
WANT = {
    "descent_steps": (30.0, ["search.descent"]),
    "descent_launch_ms": ((0.060 - 0.036) / 3 * 1e3, ["search.descent"]),
    "descent_moving_share": (20.0, ["descent.query_steps"]),
    "rerank_gather_ms": (1.2, ["rerank.gather.device", "rerank.topk"]),
}


def _run(timers: dict) -> Run:
    return Run(cell={}, config={}, mix={}, setup_s=0.0, window=Window(), judged={}, timers=timers)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_reads_known_totals(metric):
    assert harness.reader(metric).read(_run(TIMERS)) == pytest.approx(WANT[metric][0])


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_without_its_entries_reads_none(metric):
    assert harness.reader(metric).read(_run({})) is None
    for name in WANT[metric][1]:
        assert harness.reader(metric).read(_run({k: v for k, v in TIMERS.items() if k != name})) is None
