"""A run whose timed path is broken underneath comes out not correct: a
call that hands back the last call's output unchanged, half of a capture's
frames left out (the rest given their mean), one output altered where it is
made.  One chip a cell: no exchange between chips to leave out."""

import pytest
import torch

from conftest import run_tiny
from portbench import harness


def stale(entry):
    last = {}

    def call(frames):
        out = last.get("out")
        last["out"] = entry(frames)
        return out if out is not None else last["out"]
    return call


def half_batch(entry):
    def call(frames):
        k = frames.shape[0] // 2
        out = entry(frames[:k])
        re, im = out.re.mean(0, keepdim=True), out.im.mean(0, keepdim=True)
        return harness.carray(torch.cat([out.re, re.expand_as(out.re)]),
                              torch.cat([out.im, im.expand_as(out.im)]))
    return call


def altered(entry):
    def call(frames):
        out = entry(frames)
        out.re[-1, -1, 7] = -out.re[-1, -1, 7] + 1e-3
        return out
    return call


@pytest.mark.parametrize("fault", [stale, half_batch, altered])
@pytest.mark.parametrize("cell", ["tiny.capture", "tiny.open"])
def test_a_broken_timed_path_is_not_correct(tiny, fault, cell):
    out = run_tiny(*tiny, cell, seconds=0.15, entry_wrapper=fault)
    assert out["result"]["correct"] is False
    assert out["result"]["failed"] > 0
    assert out["checks"]["out_err"]["value"] > out["checks"]["out_err"]["limit"]


def test_the_same_run_unbroken_is_correct(tiny):
    assert run_tiny(*tiny, seconds=0.15)["result"]["correct"] is True
