"""The last line's shape, the traced run's metrics, and the refusal to run
without a card."""

import json
import subprocess
import sys

from conftest import REPO, run_tiny
from portbench import run


def test_untraced_line_has_the_end_to_end_metrics_and_checks_last(tiny):
    out = run_tiny(*tiny)
    line = json.loads(run.result_line(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"samples_per_s", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert line["metrics"]["samples_per_s"]["unit"] == "samples/s"
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["checks"]["out_err"]["limit"] == 2e-4
    assert run.check_lines(out["checks"])[0].startswith("check out_err ")


def test_traced_line_has_the_per_layer_metrics(tiny):
    line = json.loads(run.result_line(run_tiny(*tiny, traced=True)))
    # on the CPU the trace holds no device operation: only the host's metric
    assert set(line["metrics"]) == {"host_call_us"}
    assert line["correct"] is True


def test_open_loop_line(tiny):
    out = run_tiny(*tiny, "tiny.open", seconds=0.1)
    line = json.loads(run.result_line(out))
    assert set(line["metrics"]) == {"slot_latency_p95_us", "setup_s"}
    assert line["attempted"] == 50 and line["correct"] is True
    traced = run_tiny(*tiny, "tiny.open", seconds=0.1, traced=True)["result"]["metrics"]
    assert set(traced) == {"host_call_us.slot", "generator_lag_p95_us"}


def test_without_a_card_the_run_prints_no_result(tmp_path):
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "orbit16.capture",
                          "--seed", str(2**31 + 11), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=REPO,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                              "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert res.stdout.strip() == ""
