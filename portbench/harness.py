"""One run of one cell: set up, the measured window, the check, the metrics.

The system under test is ``ofdm_ls_mrc_tpu_torch``'s uplink receiver,
driven through its normal entry, ``UplinkReceiver(cfg, pilot,
pipeline="fused", exact=...).demod_capture``, on captures whose cyclic
prefix was stripped before the card.  Everything else here is the
yardstick.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from portbench import check, inputs, loops, spec, trace

WARM_CALLS = 3       # warm-up calls on every buffer before the window


@dataclasses.dataclass
class Run:
    """What the metric readers read (metrics/<name>.py ``read(run)``)."""
    config: dict
    traffic: dict
    frames_per_call: int
    setup_s: float
    loop: loops.LoopRecord
    ops: Optional[List[trace.Op]] = None      # device operations in the traced window


def frames_per_call(traffic: dict) -> int:
    """Frames (slots) one call of the entry takes: a closed loop's
    capture, or an open loop's batch of every sector's slots."""
    if "frames_per_call" in traffic:
        return int(traffic["frames_per_call"])
    return int(traffic["sectors"]) * int(traffic["slots_per_sector"])


def receiver(config: dict, pilot: torch.Tensor, device: torch.device):
    """The port's receiver for the configuration, on frames whose cyclic
    prefix the fronthaul stripped."""
    from ofdm_ls_mrc_tpu_torch.config import FrameConfig
    from ofdm_ls_mrc_tpu_torch.models.uplink import UplinkReceiver

    cfg = FrameConfig(num_antennas=config["num_antennas"], fft_size=config["fft_size"],
                      cyclic_prefix=0, frame_len=config["frame_len"])
    x = pilot.cpu().numpy().astype(np.complex64)
    return UplinkReceiver(cfg, x, pipeline="fused", exact=bool(config["exact"]), device=device)


def carray(re: torch.Tensor, im: torch.Tensor):
    from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray

    return CArray(re, im)


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, *,
             device: torch.device, started: float, bench_dir: Path = spec.BENCH_DIR,
             traffic_override: Optional[dict] = None,
             entry_wrapper: Optional[Callable] = None) -> dict:
    """Run the cell; returns the result's fields and the check's numbers.

    ``started`` is the process's start on ``time.perf_counter``'s clock:
    set-up is the time from it to the window.  ``entry_wrapper`` wraps the
    entry (the tests break the timed path with it)."""
    config, traffic = cell.config, dict(cell.traffic, **(traffic_override or {}))
    reference = spec.reference(config, bench_dir)
    k = frames_per_call(traffic)
    shape = (k, config["frame_len"], config["num_antennas"], config["fft_size"])

    gen = inputs.generator(seed, device)
    pilot = inputs.pilot(gen, config["fft_size"], device).to(torch.complex64)
    planes, clipped = inputs.buffers(gen, int(traffic["buffers"]), shape,
                                     float(traffic["backoff_db"]), device)
    rx = receiver(config, pilot, device)
    entry = rx.demod_capture
    if entry_wrapper is not None:
        entry = entry_wrapper(entry)
    bufs = [carray(re, im) for re, im in planes]

    # Warm up the cell's one shape, and leave the allocator holding as many
    # outputs as the window keeps alive at once.
    held = [entry(b) for _ in range(WARM_CALLS) for b in bufs]
    held += [entry(bufs[0]) for _ in range(int(traffic["sample_calls"]) + 2)]
    loops.synchronize(device)
    del held

    loop = loops.LOOPS[traffic["loop"]]
    if traced:
        with trace.profiled(device) as ops:
            setup_s = time.perf_counter() - started
            rec = loop(entry, bufs, traffic, seconds, seed, device, spans=True)
        if device.type == "cuda":
            inside = trace.within(ops, rec.epoch_ns)
            print(f"trace: {len(ops)} device operations, {len(inside)} in the window",
                  file=sys.stderr)
            ops = inside
        else:
            ops = None
    else:
        setup_s = time.perf_counter() - started
        rec = loop(entry, bufs, traffic, seconds, seed, device, spans=False)
        ops = None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del rx, entry

    run = Run(config, traffic, k, setup_s, rec, ops)
    metrics = spec.read_metrics(cell.per_layer if traced else cell.end_to_end, run, bench_dir)

    errs = [check.out_err(out.re, out.im, *planes[buf], pilot, reference)
            for _, buf, out in rec.kept]
    missing = rec.calls - rec.done
    limit = float(config["limits"]["out_err"])
    worst = max(errs) if errs else float("inf")
    failed = sum(e > limit for e in errs) + missing
    checks = {"out_err": {"value": worst if math.isfinite(worst) else None, "limit": limit},
              "missing": {"value": missing, "limit": 0}}
    correct = bool(errs) and worst <= limit and missing == 0
    result = {"correct": correct, "attempted": rec.calls, "failed": int(failed),
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                                  else "cpu"),
                         "count": cell.chips, "memory_peak_bytes": int(peak)}}
    if traced and ops is not None:
        busy_ns, gaps = trace.busy(ops, rec.epoch_ns)
        window_ns = rec.epoch_ns[1] - rec.epoch_ns[0]
        result["device"]["busy_s"] = busy_ns / 1e9
        result["device"]["window_s"] = window_ns / 1e9
        idle = trace.label_gaps(gaps, rec.spans)
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in trace.top_ops(ops)],
            "idle_gaps": [[f"{label} ({n} gaps)", ns / 1e9] for label, (ns, n)
                          in sorted(idle.items(), key=lambda kv: -kv[1][0])[:10]]}
    return {"result": result, "checks": checks, "clipped": clipped, "compared": len(errs),
            "record": rec}
