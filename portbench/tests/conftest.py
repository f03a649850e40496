"""Fixtures of the benchmark's tests: a tiny cell that runs on the CPU.

The tiny cell is the ORBIT configuration at 4 antennas x 256-point FFT x
5 symbols (256: the smallest F the bf16 control covers), in a benchmark
folder of its own beside the real one: its metrics, references and traffic
files are the real ones, copied, plus the tiny configuration and traffic.
"""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import spec  # noqa: E402

TINY = {"num_antennas": 4, "fft_size": 256, "frame_len": 5}
TINY_CLOSED = {"loop": "closed", "frames_per_call": 4, "in_flight": 2, "buffers": 2,
               "backoff_db": 12, "sample_calls": 3}
TINY_OPEN = {"loop": "open", "period_us": 2000, "sectors": 2, "slots_per_sector": 1,
             "buffers": 2, "backoff_db": 12, "sample_calls": 3}


@pytest.fixture
def tiny(tmp_path):
    """(root, bench_dir): a checkout root with a BENCHMARK.json that adds the
    cells tiny.capture and tiny.open to the real ones, and its folder."""
    bench = tmp_path / "bench"
    for sub in ("metrics", "references", "traffic", "configs"):
        shutil.copytree(spec.BENCH_DIR / sub, bench / sub)
    config = json.loads((spec.BENCH_DIR / "configs" / "orbit_16x1024.json").read_text())
    config.update(TINY)
    (bench / "configs" / "tiny.json").write_text(json.dumps(config))
    (bench / "traffic" / "tiny_closed.json").write_text(json.dumps(TINY_CLOSED))
    (bench / "traffic" / "tiny_open.json").write_text(json.dumps(TINY_OPEN))
    bm = json.loads((REPO / "BENCHMARK.json").read_text())
    bm["configs"].append({"name": "tiny", "source": "test", "file": "bench/configs/tiny.json",
                          "reduced": [], "why": "test"})
    bm["workloads"] += [
        {"name": "tiny.capture", "config": "tiny", "traffic": "tiny_closed", "chips": 1,
         "why": "test"},
        {"name": "tiny.open", "config": "tiny", "traffic": "tiny_open", "chips": 1,
         "why": "test"}]
    for m in bm["end_to_end"] + bm["per_layer"]:
        if "samples_per_s" in (m["name"], m.get("moves")):
            m.setdefault("workloads", []).append("tiny.capture")
    bm["end_to_end"].append({"name": "slot_latency_p95_us", "unit": "us", "better": "lower",
                             "bound": 0.25, "source": "host_clock", "workloads": ["tiny.open"]})
    bm["per_layer"] += [
        {"name": n, "unit": u, "better": "lower", "source": "program_span", "layer": "test",
         "moves": "slot_latency_p95_us", "workloads": ["tiny.open"]}
        for n, u in (("host_call_us.slot", "us"), ("generator_lag_p95_us", "us"),
                     ("device_idle_pct.slot", "%"))]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bm))
    return tmp_path, bench


def run_tiny(root: Path, bench: Path, cell: str = "tiny.capture", *, seed: int = 2**31 + 7,
             seconds: float = 0.2, traced: bool = False, **kw) -> dict:
    """One CPU run of a tiny cell through the harness."""
    import torch

    from portbench import harness

    torch.set_num_threads(1)
    c = spec.find_cell(spec.load_spec(root), cell, bench)
    return harness.run_cell(c, seed, seconds, traced, device=torch.device("cpu"),
                            started=time.perf_counter(), bench_dir=bench, **kw)


@pytest.fixture
def card():
    """The card, or a skip: decided here and not at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
