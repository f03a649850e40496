#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ofdm_ls_mrc_tpu_torch``) once on one GPU.

  python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

1. toolchain: Python, torch, CUDA, nvcc, triton/ninja, the card's name and
   power limit; the card must be compute capability 9.0 (Hopper).
2. build: compiles csrc/ with nvcc for sm_90a (ptxas report printed).
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (16 antennas x 1024 bins, 101 symbols), f32 and
   int16 input, cyclic prefix 0 and 72, max-rel below 2e-5 (both are fp32
   FFTs summed in a different order).
4. main path: UplinkReceiver(16 x 1024, cp 72, 101 symbols, fused, cuda) on
   a 16-QAM frame through a 16-tap 25 dB channel: EVM below -30 dB, max-rel
   below 5e-5 against the NumPy golden, and both kernels launched.
5. timing (CUDA events): each kernel and its plain version on the main
   path's frame, then demod_capture over 20 device-resident sc16 frames with
   the prefix stripped on the host (bench.py's default mode, seed 0).

The second-to-last lines are the kernels' JSON record and the card's
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

ANTENNAS, FFT, SYMBOLS, CP = 16, 1024, 101, 72
CAPTURE_FRAMES = 20
KERNEL_TOL = 2e-5
GOLDEN_TOL = 5e-5
EVM_MAX_DB = -30.0
REPLACES = {
    "pilot_ls": "ofdm_ls_mrc_tpu/ops/pallas_pipeline.py:222",
    "fft_mrc": "ofdm_ls_mrc_tpu/ops/pallas_pipeline.py:320",
}


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def max_rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from ofdm_ls_mrc_tpu_torch import FrameConfig, golden, sim
    from ofdm_ls_mrc_tpu_torch.kernels import build
    from ofdm_ls_mrc_tpu_torch.models import UplinkReceiver
    from ofdm_ls_mrc_tpu_torch.ops import ls
    from ofdm_ls_mrc_tpu_torch.ops import pipeline as pipe
    from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray

    dev = torch.device("cuda", 0)

    # -- 1. toolchain -----------------------------------------------------
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    print("nvcc:", run([build.find_nvcc(), "--version"]).splitlines()[-1])
    for mod in ("triton", "ninja"):
        try:
            __import__(mod)
            print(f"{mod}: importable")
        except ImportError:
            print(f"{mod}: not importable")
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    print("card:", card)
    cap = torch.cuda.get_device_capability(dev)
    require(cap == (9, 0), f"needs compute capability 9.0, got {cap}")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    build.build_library(verbose=True)
    build.load_library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")

    # -- 3. each kernel against its plain version ---------------------------
    rng = np.random.default_rng(1)
    pilot = np.exp(2j * np.pi * rng.random(FFT - 1)).astype(np.complex64)
    x_full = ls.pad_pilot(pilot, dev)
    max_abs = {"pilot_ls": 0.0, "fft_mrc": 0.0}
    for dtype in ("f32", "int16"):
        for cp in (0, CP):
            shape = (SYMBOLS, ANTENNAS, FFT + cp)
            z = 0.1 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            if dtype == "int16":
                frame = CArray(torch.from_numpy(golden.io.plane_to_sc16(z.real)).to(dev),
                               torch.from_numpy(golden.io.plane_to_sc16(z.imag)).to(dev))
            else:
                frame = CArray.from_numpy(z.astype(np.complex64), dev)
            y = frame[..., cp:]
            h_k, inv_k = pipe.estimate_pilot_fused(y[0], x_full)
            h_p, inv_p = pipe.estimate_pilot_plain(y[0], x_full)
            out_k = pipe.fused_pipeline(y[1:], h_p, inv_p)
            out_p = pipe.fused_pipeline_plain(y[1:], h_p, inv_p)
            torch.cuda.synchronize()
            errs = {
                "pilot_ls": (max_rel(h_k.to_numpy(), h_p.to_numpy()),
                             # sum_a|h|^2: inv, its reciprocal, peaks at the weakest bin
                             max_rel(1 / inv_k.cpu().numpy(), 1 / inv_p.cpu().numpy())),
                "fft_mrc": (max_rel(out_k.to_numpy(), out_p.to_numpy()),),
            }
            max_abs["pilot_ls"] = max(max_abs["pilot_ls"], float(
                np.max(np.abs(h_k.to_numpy() - h_p.to_numpy()))))
            max_abs["fft_mrc"] = max(max_abs["fft_mrc"], float(
                np.max(np.abs(out_k.to_numpy() - out_p.to_numpy()))))
            print(f"check {dtype} cp={cp}: " + "  ".join(
                f"{name} max-rel {max(e):.3e}" for name, e in errs.items()))
            for name, e in errs.items():
                require(max(e) < KERNEL_TOL,
                        f"{name} {dtype} cp={cp}: max-rel {max(e):.3e} >= {KERNEL_TOL}")

    # -- 4. the main path through the port ----------------------------------
    cfg = FrameConfig(num_antennas=ANTENNAS, fft_size=FFT, cyclic_prefix=CP,
                      frame_len=SYMBOLS)
    rng = np.random.default_rng(7)
    data, _ = sim.random_symbols(rng, (cfg.num_data_symbols, cfg.num_subcarriers), "16qam")
    pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)).astype(np.complex64)
    rx_frame = sim.ChannelModel(ANTENNAS, FFT, num_taps=16, snr_db=25.0, seed=9).apply(
        sim.make_tx_frame(data, pilot, CP), CP)
    rx = UplinkReceiver(cfg, pilot, pipeline="fused", device=dev)
    frame_dev = CArray.from_numpy(rx_frame, dev)
    torch.cuda.synchronize()
    pipe.reset_launch_counts()
    out_dev = rx.demod_frame(frame_dev)
    torch.cuda.synchronize()
    launches = dict(pipe.launch_counts)
    out = out_dev.to_numpy()
    evm = sim.evm_db(np.fft.fftshift(out, axes=-1), data)
    rel = max_rel(out, golden.demod_frame(rx_frame, pilot, CP))
    print(f"main path: shape {out.shape}  EVM {evm:.2f} dB  max-rel vs golden "
          f"{rel:.3e}  launches {launches}")
    require(out.shape == (SYMBOLS - 1, FFT - 1) and np.all(np.isfinite(out)),
            f"bad output: shape {out.shape}")
    require(evm < EVM_MAX_DB, f"EVM {evm:.2f} dB >= {EVM_MAX_DB}")
    require(rel < GOLDEN_TOL, f"max-rel vs golden {rel:.3e} >= {GOLDEN_TOL}")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the main path")

    # -- 5. timing ----------------------------------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def call_ms(fn, n: int) -> float:
        """Per call, CUDA events around n back-to-back calls: the host's
        launch work is inside when it is slower than the device."""
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    def device_ms(fn, n: int) -> dict:
        """Per call, the device time of each CUDA kernel it runs, by name
        (torch.profiler); empty when the profiler saw no device activity."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return {e.key: e.self_device_time_total / n / 1e3 for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}

    def measure(kernel_fn, plain_fn, n: int):
        """Events in the order plain, kernel, kernel, plain (mean of each
        pair), then the profiler's device time of each."""
        p1, k1, k2, p2 = (call_ms(f, n) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn))
        k_dev, p_dev = device_ms(kernel_fn, n), device_ms(plain_fn, n)
        return {"kernel_call": (k1 + k2) / 2, "plain_call": (p1 + p2) / 2,
                "kernel_dev": sum(k_dev.values()), "plain_dev": sum(p_dev.values()),
                "kernel_split": k_dev, "plain_split": p_dev}

    def report(label: str, t: dict, frames: int = 1) -> None:
        samples = frames * SYMBOLS * ANTENNAS * FFT
        for who in ("kernel", "plain"):
            call, dev = t[f"{who}_call"], t[f"{who}_dev"]
            print(f"time {label} {who}: device {dev * 1e3 / frames:.2f} us/frame "
                  f"({samples / (dev * 1e-3) if dev else 0:.4g} samples/s), "
                  f"per call {call * 1e3 / frames:.2f} us/frame "
                  f"({samples / (call * 1e-3):.4g} samples/s)  [{card}]")
            for key, ms in sorted(t[f"{who}_split"].items(), key=lambda kv: -kv[1])[:4]:
                print(f"    {ms / dev if dev else 0:6.1%}  {ms * 1e3:9.2f} us/call  {key[:90]}")

    y = frame_dev[..., CP:]
    x_full = rx.x_full
    h, inv = pipe.estimate_pilot_plain(y[0], x_full)
    times = {
        "pilot_ls": measure(lambda: pipe.estimate_pilot_fused(y[0], x_full),
                            lambda: pipe.estimate_pilot_plain(y[0], x_full), 200),
        "fft_mrc": measure(lambda: pipe.fused_pipeline(y[1:], h, inv),
                           lambda: pipe.fused_pipeline_plain(y[1:], h, inv), 100),
    }
    for name, t in times.items():
        report(f"{name} (one frame, f32, cp {CP})", t)
    # The per-kernel "ms" below is device time; where the profiler saw no
    # device activity it falls back to the event time per call.
    kernel_ms = {name: (t["kernel_dev"] or t["kernel_call"], t["plain_dev"] or t["plain_call"])
                 for name, t in times.items()}
    if not all(t["kernel_dev"] for t in times.values()):
        print("note: the profiler reported no device time; ms are CUDA-event times per call")

    # demod_capture: bench.py's default frames (seed 0, sc16, CP stripped on host).
    rng = np.random.default_rng(0)
    pilot = np.exp(2j * np.pi * rng.random(FFT - 1)).astype(np.complex64)
    shape = (CAPTURE_FRAMES, SYMBOLS, ANTENNAS, FFT + CP)
    frames = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    payload = frames[..., CP:]
    cap = CArray(torch.from_numpy(golden.io.plane_to_sc16(payload.real)).to(dev),
                 torch.from_numpy(golden.io.plane_to_sc16(payload.imag)).to(dev))
    del frames, payload
    rx_cap = UplinkReceiver(FrameConfig(num_antennas=ANTENNAS, fft_size=FFT,
                                        cyclic_prefix=0, frame_len=SYMBOLS),
                            pilot, device=dev)

    def capture_plain():
        h, inv = pipe.estimate_pilot_plain(cap[:, 0], rx_cap.x_full)
        return pipe.fused_pipeline_plain(cap[:, 1:], h, inv)

    rel = max_rel(rx_cap.demod_capture(cap).to_numpy(), capture_plain().to_numpy())
    print(f"demod_capture {CAPTURE_FRAMES} sc16 frames: max-rel vs plain {rel:.3e}")
    require(rel < KERNEL_TOL, f"demod_capture vs plain: max-rel {rel:.3e}")
    report(f"demod_capture ({CAPTURE_FRAMES} sc16 frames, cp stripped on host)",
           measure(lambda: rx_cap.demod_capture(cap), capture_plain, 10), CAPTURE_FRAMES)

    require("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"ofdm_ls_mrc_tpu_torch/csrc/{name}.cu",
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": max_abs[name], "ms": kernel_ms[name][0],
         "plain_ms": kernel_ms[name][1]}
        for name in ("pilot_ls", "fft_mrc")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
