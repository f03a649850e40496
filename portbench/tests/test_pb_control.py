"""The control, the port's own bf16 speed mode in place of the exact path,
comes out not correct; the program as configured comes out correct."""

import json

import pytest
import torch

from portbench import control, spec


@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_control_fails_the_limit_the_program_meets(tiny, seed):
    root, bench = tiny
    cell = spec.find_cell(spec.load_spec(root), "tiny.capture", bench)
    limit = cell.config["limits"]["out_err"]
    r = control.readings(cell, seed, 3, torch.device("cpu"), bench)
    assert r["program"] < limit / 10
    assert r["control"] > limit * 10


def test_the_limits_lie_between_the_readings_kept():
    for name in ("orbit_16x1024", "nr100_64t_4096"):
        config = json.loads((spec.BENCH_DIR / "configs" / f"{name}.json").read_text())
        assert 2.4e-6 < config["limits"]["out_err"] < 1.29e-2
