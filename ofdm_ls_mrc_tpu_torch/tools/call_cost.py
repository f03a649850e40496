"""Per-call cost of the port's kernel wrappers and of ``demod_capture``.

A wrapper's call is the host's launch work (Python checks, ctypes, the
driver) plus the kernel; on one frame the host's part is the larger.  This
tool times each call three times over: CUDA events around n back-to-back
calls, and the host's clock over the loop that issues them, so the spread
between repetitions shows how much the host's own noise moves a per-call
reading.

  python ofdm_ls_mrc_tpu_torch/tools/call_cost.py

It imports ``ofdm_ls_mrc_tpu_torch`` by absolute name, so that
``PYTHONPATH=<another checkout>`` times that checkout's package with the
same calls (the first line names the package it loaded): two trees in one
run on the same card are compared in the order X Y Y X.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

import ofdm_ls_mrc_tpu_torch
from ofdm_ls_mrc_tpu_torch import FrameConfig, golden
from ofdm_ls_mrc_tpu_torch.models import UplinkReceiver
from ofdm_ls_mrc_tpu_torch.ops import ls
from ofdm_ls_mrc_tpu_torch.ops import pipeline as pipe
from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray

ANTENNAS, FFT, SYMBOLS, CP, FRAMES = 16, 1024, 101, 72, 20


def call_us(fn, n: int):
    """(device-clock us per call, host-clock us per call of the issuing
    loop) over n back-to-back calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / n, (t1 - t0) * 1e6 / n


def main() -> int:
    if not torch.cuda.is_available():
        print("call_cost: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"package {ofdm_ls_mrc_tpu_torch.__file__}  [{card}]")
    rng = np.random.default_rng(0)
    shape = (SYMBOLS, ANTENNAS, FFT + CP)
    z = 0.1 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    y = CArray.from_numpy(z.astype(np.complex64), dev)[..., CP:]
    x_full = ls.pad_pilot(np.exp(2j * np.pi * rng.random(FFT - 1)).astype(np.complex64), dev)
    h, inv = pipe.estimate_pilot_plain(y[0], x_full)
    shape = (FRAMES, SYMBOLS, ANTENNAS, FFT)
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    cap = CArray(torch.from_numpy(golden.io.plane_to_sc16(z.real)).to(dev),
                 torch.from_numpy(golden.io.plane_to_sc16(z.imag)).to(dev))
    del z
    rx = UplinkReceiver(FrameConfig(num_antennas=ANTENNAS, fft_size=FFT, cyclic_prefix=0,
                                    frame_len=SYMBOLS),
                        np.exp(2j * np.pi * rng.random(FFT - 1)).astype(np.complex64), device=dev)
    calls = (("estimate_pilot_fused, one 16x1024 f32 pilot",
              lambda: pipe.estimate_pilot_fused(y[0], x_full), 200),
             ("fused_pipeline, one 16x1024x100 f32 frame",
              lambda: pipe.fused_pipeline(y[1:], h, inv), 100),
             (f"demod_capture, {FRAMES} sc16 frames", lambda: rx.demod_capture(cap), 10),
             (f"estimate_pilot_fused, the capture's {FRAMES} sc16 pilots",
              lambda: pipe.estimate_pilot_fused(cap[:, 0], rx.x_full), 100))
    for label, fn, n in calls:
        runs = [call_us(fn, n) for _ in range(3)]
        print(f"per call {label}: events " + ", ".join(f"{d:.2f}" for d, _ in runs)
              + " us; host loop " + ", ".join(f"{t:.2f}" for _, t in runs) + f" us  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
