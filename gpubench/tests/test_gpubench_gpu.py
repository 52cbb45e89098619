"""On the card: a cell's whole run at a small size, correct: traced, with
the device's busy time and the kernels' roofline read from the trace,
and untraced, with the card's time a query."""

import time

import pytest

from gpubench import run


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["able-groupby-c8", "taxi-sql-c8"])
def test_small_cell_on_the_card(cuda, cell):
    out = run.run_cell(cell, 2**40 + 9, 2.0, True, cuda, time.time(),
                       cfg_over={"shards": 16, "chunk_shards": 8})
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    share = out["metrics"].get("kernels.roofline", {}).get("value")
    assert share is None or 0 < share <= 105


@pytest.mark.gpu
def test_untraced_run_reads_the_card(cuda):
    out = run.run_cell("able-groupby-c8", 2**40 + 10, 2.0, False, cuda,
                       time.time(), cfg_over={"shards": 16, "chunk_shards": 8})
    assert out["correct"], out["checks"]
    assert out["metrics"]["device_ms_per_query"]["value"] > 0
    assert set(out["metrics"]) == {"device_ms_per_query", "setup_s"}
