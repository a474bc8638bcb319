"""On the card only: a traced run of a small cut of a search cell reads the
device's metrics (the loop kernel's roofline share, the idle share), and
the result line names the card."""

import time

import pytest

from portbench import harness

pytestmark = pytest.mark.card


def test_traced_run_reads_the_device(card):
    cell = "f32cos-1m-768.knn-b4096"
    result, lines = harness.run_cell(
        cell, 2**31 + 99, 2.0, True, t_start=time.perf_counter(), device="cuda",
        config_overrides={"rows": 20_000}, mix_overrides={"batch": 1024, "sample_queries": 2048})
    assert result["correct"] is True, lines
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    roofline = result["metrics"]["loop_roofline"]["value"]
    assert 0 < roofline <= 105
    assert 0 <= result["metrics"]["idle_share.query"]["value"] < 100
