"""On the card: a short run of each cell comes out correct and reads the
device; the control fails the limit at the cell's own size."""

import time

import pytest

from portbench import control, harness, spec

CELLS = ("orbit16.capture", "nr64.capture")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_card(card, name):
    cell = spec.find_cell(spec.load_spec(spec.BENCH_DIR.parent), name)
    out = harness.run_cell(cell, 2**31 + 101, 1.0, True, device=card,
                           started=time.perf_counter())
    res = out["result"]
    assert res["correct"], out["checks"]
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert 0 < res["metrics"]["data_roofline_pct"]["value"] <= 100
    assert 0 < res["metrics"]["pilot_roofline_pct"]["value"] <= 100


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(card, name):
    cell = spec.find_cell(spec.load_spec(spec.BENCH_DIR.parent), name)
    r = control.readings(cell, 2**31 + 102, 2, card)
    assert r["program"] < cell.config["limits"]["out_err"] < r["control"]
