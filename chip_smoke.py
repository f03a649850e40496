#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ofdm_ls_mrc_tpu_torch``) once on one GPU.

  python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

1. toolchain: Python, torch, CUDA, nvcc, triton/ninja, the card's name and
   power limit; the card must be compute capability 9.0 (Hopper).
2. build: compiles csrc/ with nvcc for sm_90a, one process per source, all
   at once (ptxas report printed, then the registers, spills and shared
   memory of the pilot and the two data kernels at F = 1024).
3. kernels: each kernel against its plain PyTorch version on the card, max-rel
   below 2e-5 (both sides fp32 FFTs or sums taken in another order):
   pilot_ls, fft_mrc and mrc_demod at the main path's shapes (16 antennas x
   1024 bins, 101 symbols), f32 and int16 input, cyclic prefix 0 and 72
   (rows 16-byte aligned: the cp.async loads) and 1 (the element-by-element
   loads); pilot_ls also at every F of 256-4096 x 1, 3, 5, 16 and 64
   antennas, f32 and int16, cp 0, 1 and 72, 3 frames in one call (one
   cluster each; the cluster shape is printed); mrc_demod also at F = 64,
   4 antennas; the io probes auto, manual2, manual3s and manual4 with
   compute 0 and 2 on one 16 x 1024 x 101 f32 frame, manual4 also at ts 1,
   and manual2 and manual4s at ts 8 on a 4-antenna frame.
4. main path: UplinkReceiver(16 x 1024, cp 72, 101 symbols, fused, cuda) on
   a 16-QAM frame through a 16-tap 25 dB channel: EVM below -30 dB, max-rel
   below 5e-5 against the NumPy golden, pilot_ls and fft_mrc launched.
5. split-phase path: estimate_channel + demod_data on the same frame: the
   same EVM and golden bounds, mrc_demod launched.
6. streaming path: StreamingDemodulator over the same frame, symbol by
   symbol, composed and fused bodies: max-rel below 2e-5 against
   demod_frame, the fused body through pilot_ls and fft_mrc; per-symbol
   latency p50/p99 (CUDA events and host clock, device-resident symbols).
7. probe path: tools/dma_probe over 20 device-resident 16 x 1024 x 101 f32
   frames, auto, manual2, manual3s and manual4 with compute 0 and 2; the
   fastest variant without compute gives the measured io floor.
8. timing: each kernel, its plain version and the PyTorch library call
   (torch.fft.fft over the same rows for the FFT kernels, one torch.sum for
   the probes) at the main path's shapes; the profiler's split of one
   estimate_pilot_fused call must hold one kernel; a within-call
   comparison (X Y Y X) of io_auto against torch.sum; demod_capture
   over 20 device-resident sc16 frames with the prefix stripped on the host
   (bench.py's default mode, seed 0) and pilot_ls on its 20 pilots; fft_mrc
   and pilot_ls on one 64-antenna frame (64 x 1024 x 101, f32, cp 72).

The second-to-last lines are the kernels' JSON record and the card's
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import re
import subprocess
import sys
import time

import numpy as np

ANTENNAS, FFT, SYMBOLS, CP = 16, 1024, 101, 72
CAPTURE_FRAMES = 20
PROBE_FRAMES, PROBE_TS = 20, 2
PROBE_VARIANTS = ("auto", "manual2", "manual3s", "manual4")
# (variant, ts, antennas) of the probes' checks: ts 8 fits 227 KB only below
# 16 antennas.
PROBE_CHECKS = (("auto", 2, 16), ("manual2", 2, 16), ("manual3s", 2, 16), ("manual4", 2, 16),
                ("manual4", 1, 16), ("manual2", 8, 4), ("manual4s", 8, 4))
PILOT_ANTENNAS, PILOT_FRAMES = (1, 3, 5, 16, 64), 3
STREAM_FRAMES = 3           # timed passes of the streaming path over the frame
KERNEL_TOL = 2e-5
GOLDEN_TOL = 5e-5
EVM_MAX_DB = -30.0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (published)
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores (published)
KERNELS = {  # name -> (source, TPU kernel it replaces)
    "pilot_ls": ("pilot_ls.cu", "ofdm_ls_mrc_tpu/ops/pallas_pipeline.py:222"),
    "fft_mrc": ("fft_mrc.cu", "ofdm_ls_mrc_tpu/ops/pallas_pipeline.py:320"),
    "mrc_demod": ("mrc_demod.cu", "ofdm_ls_mrc_tpu/ops/pallas_mrc.py:62"),
    "io_auto": ("io_probe.cu", "tools/dma_probe.py:63"),
    "io_manual": ("io_probe.cu", "tools/dma_probe.py:99"),
}


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def max_rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def max_abs(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.max(np.abs(got - want)))


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def fft_flops(rows: int, f: int) -> float:
    return 5.0 * rows * f * math.log2(f)


def bound_ms(nbytes: float, flops: float) -> tuple:
    """(least time in ms, 'bytes' or 'operations') at the published peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def ptxas_lines(report: str):
    """One line per instantiation of the pilot and data kernels at F = 1024
    from nvcc's -Xptxas -v report: registers, spills and the dynamic shared
    memory the launch asks for (ops/fft_plan.py smem_bytes; for the pilot,
    its plan at 16 antennas)."""
    from ofdm_ls_mrc_tpu_torch.ops import fft_plan

    pat = (r"Compiling entry function "
           r"'_ZN4ofdm\d+(fft_mrc|mrc_demod|pilot_ls)_kernelILi(\d+)E(\w)Lb(\d)E"
           r"[^']*'.*?(\d+) bytes spill stores.*?Used (\d+) registers")
    for name, f, t, aligned, spill, regs in re.findall(pat, report, re.S):
        f = int(f)
        if f != 1024:
            continue
        if name == "pilot_ls":
            plan = fft_plan.pilot_plan(ANTENNAS, f)
            smem, threads = plan.smem_bytes, f"{plan.threads} threads a block (16 antennas)"
        else:
            smem, threads = fft_plan.smem_bytes(f), f"{fft_plan.plan(f).block} threads a block"
        yield (f"ptxas {name}<{f}, {'int16' if t == 's' else 'float'}, "
               f"{'cp.async' if aligned == '1' else 'element'} loads>: {regs} registers, "
               f"{spill} B spilled, {smem} B dynamic shared memory, {threads}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from ofdm_ls_mrc_tpu_torch import FrameConfig, golden, sim
    from ofdm_ls_mrc_tpu_torch.kernels import build
    from ofdm_ls_mrc_tpu_torch.models import StreamingDemodulator, UplinkReceiver
    from ofdm_ls_mrc_tpu_torch.ops import fft as fft_ops
    from ofdm_ls_mrc_tpu_torch.ops import fft_plan, fused_mrc, ls
    from ofdm_ls_mrc_tpu_torch.ops import pipeline as pipe
    from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray
    from ofdm_ls_mrc_tpu_torch.tools import dma_probe

    dev = torch.device("cuda", 0)
    counters = (pipe.launch_counts, fused_mrc.launch_counts, dma_probe.launch_counts)

    def reset_counts() -> None:
        for c in counters:
            for name in c:
                c[name] = 0

    def counts() -> dict:
        return {name: n for c in counters for name, n in c.items()}

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
    ptxas = io.StringIO()
    with contextlib.redirect_stdout(ptxas):
        build.build_library(verbose=True)
    build.load_library()
    print(ptxas.getvalue(), end="")
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    summary = list(ptxas_lines(ptxas.getvalue()))
    require(len(summary) == 12, f"ptxas report: {len(summary)} kernels at F = 1024, want 12")
    print("\n".join(summary))

    # -- 3. each kernel against its plain version ---------------------------
    def frame_of(rng, shape, dtype):
        z = 0.1 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
        if dtype == "int16":
            return CArray(torch.from_numpy(golden.io.plane_to_sc16(z.real)).to(dev),
                          torch.from_numpy(golden.io.plane_to_sc16(z.imag)).to(dev))
        return CArray.from_numpy(z.astype(np.complex64), dev)

    def composed_estimate(pilot_rows, x_full):
        return ls.estimate_channel_full(fft_ops.fft(pipe.widen_sc16(pilot_rows)), x_full)

    def check(name, label, pairs, abs_pairs=None, quiet=False):
        """pairs: (kernel, plain) numpy arrays held to the max-rel bound;
        max-abs over abs_pairs (the kernel's outputs), by default the same.
        Returns the max-rel."""
        rel = max(max_rel(k, p) for k, p in pairs)
        err = max(max_abs(k, p) for k, p in (abs_pairs or pairs))
        errs_abs[name] = max(errs_abs[name], err)
        if not quiet:
            print(f"check {name} {label}: max-rel {rel:.3e}  max-abs {err:.3e}")
        require(rel < KERNEL_TOL, f"{name} {label}: max-rel {rel:.3e} >= {KERNEL_TOL}")
        return rel

    def check_pilot(label, y, x, quiet=False):
        """estimate_pilot_fused against estimate_pilot_plain: max-rel on h
        and sum_a|h|^2 (inv, its reciprocal, peaks at the weakest bin);
        max-abs on the kernel's outputs, h and inv."""
        h_k, inv_k = pipe.estimate_pilot_fused(y, x)
        h_p, inv_p = pipe.estimate_pilot_plain(y, x)
        torch.cuda.synchronize()
        h_k, h_p = h_k.to_numpy(), h_p.to_numpy()
        inv_k, inv_p = inv_k.cpu().numpy(), inv_p.cpu().numpy()
        return check("pilot_ls", label, [(h_k, h_p), (1 / inv_k, 1 / inv_p)],
                     [(h_k, h_p), (inv_k, inv_p)], quiet=quiet)

    errs_abs = {name: 0.0 for name in KERNELS}
    rng = np.random.default_rng(1)
    pilot = np.exp(2j * np.pi * rng.random(FFT - 1)).astype(np.complex64)
    x_full = ls.pad_pilot(pilot, dev)
    for dtype in ("f32", "int16"):
        for cp in (0, 1, CP):
            label = f"{dtype} cp={cp}"
            frame = frame_of(rng, (SYMBOLS, ANTENNAS, FFT + cp), dtype)
            y = frame[..., cp:]
            check_pilot(label, y[0], x_full)
            h_p, inv_p = pipe.estimate_pilot_plain(y[0], x_full)
            out_k = pipe.fused_pipeline(y[1:], h_p, inv_p)
            out_p = pipe.fused_pipeline_plain(y[1:], h_p, inv_p)
            hconj, hsqrd = composed_estimate(y[0], x_full)
            eq_k = fused_mrc.fused_demod(y[1:], hconj, hsqrd)
            eq_p = fused_mrc.fused_demod_plain(y[1:], hconj, hsqrd)
            torch.cuda.synchronize()
            check("fft_mrc", label, [(out_k.to_numpy(), out_p.to_numpy())])
            check("mrc_demod", label, [(eq_k.to_numpy(), eq_p.to_numpy())])
    # pilot_ls at every F and cluster shape: PILOT_FRAMES pilots [K, A, F]
    # read in place from frames of 2 symbols, one launch, one cluster each.
    for f in pipe.FUSED_FFT_SIZES:
        x_f = ls.pad_pilot(np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64), dev)
        for a in PILOT_ANTENNAS:
            plan = fft_plan.pilot_plan(a, f)
            rels = [check_pilot(f"F={f} A={a} {dtype} cp={cp}",
                                frame_of(rng, (PILOT_FRAMES, 2, a, f + cp), dtype)[:, 0, :, cp:],
                                x_f, quiet=True)
                    for dtype in ("f32", "int16") for cp in (0, 1, CP)]
            print(f"check pilot_ls F={f} A={a}: cluster of {plan.clusters} blocks x "
                  f"{plan.teams} teams x {plan.rows} rows, {PILOT_FRAMES} frames a call, "
                  f"f32/int16 x cp 0/1/{CP}: max-rel {max(rels):.3e}")
    for dtype in ("f32", "int16"):  # the 64-bin geometry: 8 symbols a block
        frame = frame_of(rng, (SYMBOLS, 4, 64), dtype)
        small_x = ls.pad_pilot(pilot[:63], dev)
        hconj, hsqrd = composed_estimate(frame[0], small_x)
        eq_k = fused_mrc.fused_demod(frame[1:], hconj, hsqrd)
        eq_p = fused_mrc.fused_demod_plain(frame[1:], hconj, hsqrd)
        torch.cuda.synchronize()
        check("mrc_demod", f"F=64 A=4 {dtype}", [(eq_k.to_numpy(), eq_p.to_numpy())])
    probe_frames = {a: dma_probe.make_frames(1, SYMBOLS, a, FFT, dev, seed=2)
                    for a in sorted({a for _, _, a in PROBE_CHECKS})}
    for variant, ts, a in PROBE_CHECKS:
        pre, pim, bias, wmat = probe_frames[a]
        bias = bias + 0.5
        name = "io_manual" if variant.startswith("manual") else "io_auto"
        for compute in (0, 2):
            got = dma_probe.io_probe(pre[0], pim[0], bias, wmat, variant=variant,
                                     ts=ts, compute=compute)
            want = dma_probe.io_probe_plain(pre[0], pim[0], bias, wmat, compute)
            torch.cuda.synchronize()
            check(name, f"{variant} ts={ts} A={a} compute={compute}",
                  [(g.cpu().numpy(), w.cpu().numpy()) for g, w in zip(got, want)])
    del probe_frames, pre, pim

    # -- 4. the main path through the port ----------------------------------
    cfg = FrameConfig(num_antennas=ANTENNAS, fft_size=FFT, cyclic_prefix=CP,
                      frame_len=SYMBOLS)
    rng = np.random.default_rng(7)
    data, _ = sim.random_symbols(rng, (cfg.num_data_symbols, cfg.num_subcarriers), "16qam")
    pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)).astype(np.complex64)
    rx_frame = sim.ChannelModel(ANTENNAS, FFT, num_taps=16, snr_db=25.0, seed=9).apply(
        sim.make_tx_frame(data, pilot, CP), CP)
    gold = golden.demod_frame(rx_frame, pilot, CP)
    rx = UplinkReceiver(cfg, pilot, pipeline="fused", device=dev)
    frame_dev = CArray.from_numpy(rx_frame, dev)

    def check_output(label, out, need):
        evm = sim.evm_db(np.fft.fftshift(out, axes=-1), data)
        rel = max_rel(out, gold)
        print(f"{label}: shape {out.shape}  EVM {evm:.2f} dB  max-rel vs golden "
              f"{rel:.3e}  launches {need}")
        require(out.shape == (SYMBOLS - 1, FFT - 1) and np.all(np.isfinite(out)),
                f"{label}: bad output, shape {out.shape}")
        require(evm < EVM_MAX_DB, f"{label}: EVM {evm:.2f} dB >= {EVM_MAX_DB}")
        require(rel < GOLDEN_TOL, f"{label}: max-rel vs golden {rel:.3e} >= {GOLDEN_TOL}")
        for name, n in need.items():
            require(n > 0, f"kernel {name} was not launched on the {label}")

    torch.cuda.synchronize()
    reset_counts()
    out_dev = rx.demod_frame(frame_dev)
    torch.cuda.synchronize()
    launches = counts()
    whole = out_dev.to_numpy()
    check_output("main path", whole, {k: launches[k] for k in ("pilot_ls", "fft_mrc")})

    # -- 5. the split-phase path ---------------------------------------------
    reset_counts()
    split = rx.demod_data(frame_dev[1:], *rx.estimate_channel(frame_dev[0]))
    torch.cuda.synchronize()
    split_counts = counts()
    launches["mrc_demod"] = split_counts["mrc_demod"]
    check_output("split-phase path", split.to_numpy(), {"mrc_demod": launches["mrc_demod"]})

    # -- 6. the streaming path -----------------------------------------------
    stream_launches = {}
    for body in ("composed", "fused"):
        sd = StreamingDemodulator(cfg, pilot, pipeline=body, device=dev)
        torch.cuda.synchronize()
        reset_counts()
        sd.push_pilot(frame_dev[0])
        rows = np.stack([sd.push_symbol(frame_dev[i], slot=i).to_numpy()
                         for i in range(1, SYMBOLS)])
        torch.cuda.synchronize()
        stream_launches[body] = counts()
        rel = max_rel(rows, whole)
        ev_us, host_us = [], []
        for _ in range(STREAM_FRAMES):
            sd.push_pilot(frame_dev[0])
            for i in range(1, SYMBOLS):
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                sd.push_symbol(frame_dev[i], slot=i)
                end.record()
                torch.cuda.synchronize()
                host_us.append((time.perf_counter() - t0) * 1e6)
                ev_us.append(start.elapsed_time(end) * 1e3)
        print(f"streaming {body}: {SYMBOLS - 1} symbols, max-rel vs demod_frame "
              f"{rel:.3e}, launches {stream_launches[body]}")
        print(f"streaming {body} per-symbol latency ({len(ev_us)} symbols, device-resident "
              f"16x1024 cp {CP}): CUDA events p50 {np.percentile(ev_us, 50):.2f} us "
              f"p99 {np.percentile(ev_us, 99):.2f} us; host clock p50 "
              f"{np.percentile(host_us, 50):.2f} us p99 {np.percentile(host_us, 99):.2f} us"
              f"  [{card}]")
        require(rel < KERNEL_TOL, f"streaming {body}: max-rel {rel:.3e} >= {KERNEL_TOL}")
    for name in ("pilot_ls", "fft_mrc"):
        require(stream_launches["fused"][name] > 0,
                f"kernel {name} was not launched on the fused streaming path")

    # -- 7. the probe path: the io floor ----------------------------------------
    yre, yim, bias, wmat = dma_probe.make_frames(PROBE_FRAMES, SYMBOLS, ANTENNAS, FFT, dev)
    sre, sim_ = dma_probe.as_symbols(yre), dma_probe.as_symbols(yim)
    b_in, b_out = dma_probe.frame_bytes(SYMBOLS, ANTENNAS, FFT)
    probe_s = {}
    torch.cuda.synchronize()
    reset_counts()
    for compute in (0, 2):
        for variant in PROBE_VARIANTS:
            t = dma_probe.time_per_frame(
                lambda: dma_probe.io_probe(sre, sim_, bias, wmat, variant=variant,
                                           ts=PROBE_TS, compute=compute),
                PROBE_FRAMES, passes=10, reps=3)
            probe_s[variant, compute] = t
            print(f"probe {variant:9s} compute={compute}: {t * 1e6:8.2f} us/frame  "
                  f"({b_in / t / 1e9:7.1f} GB/s in, {(b_in + b_out) / t / 1e9:7.1f} GB/s "
                  f"in+out)  [{card}]")
    probe_counts = counts()
    launches["io_auto"], launches["io_manual"] = probe_counts["io_auto"], probe_counts["io_manual"]
    floor_variant = min(PROBE_VARIANTS, key=lambda v: probe_s[v, 0])
    io_floor = (b_in + b_out) / probe_s[floor_variant, 0]
    print(f"io floor (measured): {io_floor / 1e9:.1f} GB/s in+out, "
          f"{b_in / probe_s[floor_variant, 0] / 1e9:.1f} GB/s in, by {floor_variant} over "
          f"{PROBE_FRAMES} frames of {ANTENNAS}x{FFT}x{SYMBOLS} f32 "
          f"({io_floor / HBM_BYTES_PER_S:.1%} of 3.35 TB/s)  [{card}]")
    for name in ("io_auto", "io_manual"):
        require(launches[name] > 0, f"kernel {name} was not launched on the probe path")

    # -- 8. timing ----------------------------------------------------------
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
        (torch.profiler); empty when the profiler gave no whole trace in
        three tries (it now and then returns one without the device's
        events, or with only some of the calls' kernels: a kernel seen a
        number of times that is not a multiple of n)."""
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
            if events and all(e.count % n == 0 for e in events):
                return {e.key: e.self_device_time_total / n / 1e3 for e in events}
        return {}

    def measure(kernel_fn, plain_fn, n: int, library_fn=None):
        """Events in the order plain, kernel, kernel, plain (mean of each
        pair), then the profiler's device time of each (and of the library
        call, where there is one)."""
        p1, k1, k2, p2 = (call_ms(f, n) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn))
        k_dev, p_dev = device_ms(kernel_fn, n), device_ms(plain_fn, n)
        t = {"kernel_call": (k1 + k2) / 2, "plain_call": (p1 + p2) / 2,
             "kernel_dev": sum(k_dev.values()), "plain_dev": sum(p_dev.values()),
             "kernel_split": k_dev, "plain_split": p_dev}
        if library_fn is not None:
            t["library_call"] = call_ms(library_fn, n)
            t["library_dev"] = sum(device_ms(library_fn, n).values())
        return t

    def report(label: str, t: dict, frames: int = 1, antennas: int = ANTENNAS) -> None:
        samples = frames * SYMBOLS * antennas * FFT
        for who in ("kernel", "plain"):
            call, dev_t = t[f"{who}_call"], t[f"{who}_dev"]
            print(f"time {label} {who}: device {dev_t * 1e3 / frames:.2f} us/frame "
                  f"({samples / (dev_t * 1e-3) if dev_t else 0:.4g} samples/s), "
                  f"per call {call * 1e3 / frames:.2f} us/frame "
                  f"({samples / (call * 1e-3):.4g} samples/s)  [{card}]")
            for key, ms in sorted(t[f"{who}_split"].items(), key=lambda kv: -kv[1])[:4]:
                print(f"    {ms / dev_t if dev_t else 0:6.1%}  {ms * 1e3:9.2f} us/call  {key[:90]}")
        if "library_call" in t:
            print(f"time {label} library: device {t['library_dev'] * 1e3 / frames:.2f} "
                  f"us/frame, per call {t['library_call'] * 1e3 / frames:.2f} us/frame  [{card}]")

    y = frame_dev[..., CP:]
    x_full = rx.x_full
    h, inv = pipe.estimate_pilot_plain(y[0], x_full)
    hconj, hsqrd = rx.estimate_channel(frame_dev[0])
    pilot_c = torch.complex(y[0].re.contiguous(), y[0].im.contiguous())
    data_c = torch.complex(y[1:].re.contiguous(), y[1:].im.contiguous())
    times = {
        "pilot_ls": measure(lambda: pipe.estimate_pilot_fused(y[0], x_full),
                            lambda: pipe.estimate_pilot_plain(y[0], x_full), 200,
                            lambda: torch.fft.fft(pilot_c, dim=-1)),
        "fft_mrc": measure(lambda: pipe.fused_pipeline(y[1:], h, inv),
                           lambda: pipe.fused_pipeline_plain(y[1:], h, inv), 100,
                           lambda: torch.fft.fft(data_c, dim=-1)),
        "mrc_demod": measure(lambda: fused_mrc.fused_demod(y[1:], hconj, hsqrd),
                             lambda: fused_mrc.fused_demod_plain(y[1:], hconj, hsqrd), 100,
                             lambda: torch.fft.fft(data_c, dim=-1)),
    }
    del pilot_c, data_c
    for name, t in times.items():
        report(f"{name} (one frame, f32, cp {CP})", t)
    pilot_split = times["pilot_ls"]["kernel_split"]
    print(f"pilot_ls: the profiler's split of one estimate_pilot_fused call holds "
          f"{len(pilot_split)} kernel(s): " + ", ".join(k[:60] for k in pilot_split))
    require(len(pilot_split) <= 1,
            f"one estimate_pilot_fused call ran {len(pilot_split)} kernels, want one")

    sd = StreamingDemodulator(cfg, pilot, pipeline="fused", device=dev)
    sd.push_pilot(frame_dev[0])
    split = device_ms(lambda: sd.push_symbol(frame_dev[1], slot=1), 100)
    print(f"time streaming fused push_symbol: device {sum(split.values()) * 1e3:.2f} us/symbol "
          "(" + ", ".join(f"{k[:40]} {v * 1e3:.2f} us" for k, v in split.items())
          + f")  [{card}]")
    # "ms" below is device time; where the profiler saw no device activity
    # it is the event time per call.
    ms = {name: (t["kernel_dev"] or t["kernel_call"], t["plain_dev"] or t["plain_call"],
                 t["library_dev"] or t["library_call"]) for name, t in times.items()}
    if not all(t["kernel_dev"] for t in times.values()):
        print("note: the profiler reported no device time; ms are CUDA-event times per call")

    # The probes: per frame over the 20-frame batch (one launch a pass).
    y2 = torch.stack([sre, sim_])
    manual_variant = min(PROBE_VARIANTS[1:], key=lambda v: probe_s[v, 0])
    plain_s = dma_probe.time_per_frame(
        lambda: dma_probe.io_probe_plain(sre, sim_, bias, wmat), PROBE_FRAMES, 10, 3)
    library_s = dma_probe.time_per_frame(lambda: torch.sum(y2, dim=2), PROBE_FRAMES, 10, 3)
    ms["io_auto"] = (probe_s["auto", 0] * 1e3, plain_s * 1e3, library_s * 1e3)
    ms["io_manual"] = (probe_s[manual_variant, 0] * 1e3, plain_s * 1e3, library_s * 1e3)
    print(f"time io probes (per frame, 20 frames, compute 0): plain {plain_s * 1e6:.2f} us, "
          f"library torch.sum {library_s * 1e6:.2f} us  [{card}]")

    def xyyx(fx, fy):
        """us per frame over the batch, in the order X Y Y X."""
        return [dma_probe.time_per_frame(fn, PROBE_FRAMES, 10, 3) * 1e6
                for fn in (fx, fy, fy, fx)]

    a1, s1, s2, a2 = xyyx(lambda: dma_probe.io_probe(sre, sim_, bias, wmat),
                          lambda: torch.sum(y2, dim=2))
    print(f"compare io_auto vs torch.sum (per frame, 20 frames, X Y Y X): auto {a1:.2f}, "
          f"{a2:.2f} us; torch.sum {s1:.2f}, {s2:.2f} us; ratio of means "
          f"{(a1 + a2) / (s1 + s2):.4f}  [{card}]")

    del y2, yre, yim, sre, sim_

    # demod_capture: bench.py's default frames (seed 0, sc16, CP stripped on host).
    rng = np.random.default_rng(0)
    cap_pilot = np.exp(2j * np.pi * rng.random(FFT - 1)).astype(np.complex64)
    shape = (CAPTURE_FRAMES, SYMBOLS, ANTENNAS, FFT + CP)
    frames = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    payload = frames[..., CP:]
    cap = CArray(torch.from_numpy(golden.io.plane_to_sc16(payload.real)).to(dev),
                 torch.from_numpy(golden.io.plane_to_sc16(payload.imag)).to(dev))
    del frames, payload
    rx_cap = UplinkReceiver(FrameConfig(num_antennas=ANTENNAS, fft_size=FFT,
                                        cyclic_prefix=0, frame_len=SYMBOLS),
                            cap_pilot, device=dev)

    def capture_plain():
        h, inv = pipe.estimate_pilot_plain(cap[:, 0], rx_cap.x_full)
        return pipe.fused_pipeline_plain(cap[:, 1:], h, inv)

    rel = max_rel(rx_cap.demod_capture(cap).to_numpy(), capture_plain().to_numpy())
    print(f"demod_capture {CAPTURE_FRAMES} sc16 frames: max-rel vs plain {rel:.3e}")
    require(rel < KERNEL_TOL, f"demod_capture vs plain: max-rel {rel:.3e}")
    report(f"demod_capture ({CAPTURE_FRAMES} sc16 frames, cp stripped on host)",
           measure(lambda: rx_cap.demod_capture(cap), capture_plain, 10), CAPTURE_FRAMES)
    cap_bytes = SYMBOLS * ANTENNAS * FFT * 4 + (SYMBOLS - 1) * (FFT - 1) * 8
    print(f"bound demod_capture: {cap_bytes / 1e6:.3f} MB a frame (sc16 in, f32 out) -> "
          f"{cap_bytes / HBM_BYTES_PER_S * 1e6:.2f} us at 3.35 TB/s, "
          f"{cap_bytes / io_floor * 1e6:.2f} us at the measured io floor  [{card}]")
    # pilot_ls on the capture's 20 pilots: one launch, 20 clusters.
    cap_pilot_c = torch.complex(cap[:, 0].re.float(), cap[:, 0].im.float())
    t_cap_pilot = measure(lambda: pipe.estimate_pilot_fused(cap[:, 0], rx_cap.x_full),
                          lambda: pipe.estimate_pilot_plain(cap[:, 0], rx_cap.x_full), 100,
                          lambda: torch.fft.fft(cap_pilot_c, dim=-1))
    report(f"pilot_ls ({CAPTURE_FRAMES} sc16 pilots of the capture, one launch)", t_cap_pilot,
           CAPTURE_FRAMES)
    del cap, cap_pilot_c

    # fft_mrc on a 64-antenna frame (64 x 1024 x 101, f32, cp 72).
    wide = frame_of(np.random.default_rng(3), (SYMBOLS, 64, FFT + CP), "f32")[..., CP:]
    h64, inv64 = pipe.estimate_pilot_plain(wide[0], x_full)
    rel = max_rel(pipe.fused_pipeline(wide[1:], h64, inv64).to_numpy(),
                  pipe.fused_pipeline_plain(wide[1:], h64, inv64).to_numpy())
    require(rel < KERNEL_TOL, f"fft_mrc 64 antennas vs plain: max-rel {rel:.3e}")
    wide_c = torch.complex(wide[1:].re.contiguous(), wide[1:].im.contiguous())
    t64 = measure(lambda: pipe.fused_pipeline(wide[1:], h64, inv64),
                  lambda: pipe.fused_pipeline_plain(wide[1:], h64, inv64), 50,
                  lambda: torch.fft.fft(wide_c, dim=-1))
    del wide_c
    print(f"fft_mrc 64 antennas: max-rel vs plain {rel:.3e}")
    report("fft_mrc (one 64-antenna frame, 64x1024x101 f32, cp 72)", t64, antennas=64)
    s64 = SYMBOLS - 1
    b64 = s64 * 64 * FFT * 8 + 64 * FFT * 8 + FFT * 4 + s64 * (FFT - 1) * 8
    f64 = fft_flops(s64 * 64, FFT) + 8.0 * s64 * 64 * FFT + 2.0 * s64 * FFT
    b64_ms, b64_by = bound_ms(b64, f64)
    k64_ms = t64["kernel_dev"] or t64["kernel_call"]
    print(f"bound fft_mrc 64 antennas: {b64 / 1e6:.3f} MB, {f64 / 1e6:.1f} MFLOP -> "
          f"{b64_ms * 1e3:.2f} us ({b64_by}) at the published peaks, "
          f"{b64 / io_floor * 1e6:.2f} us at the measured io floor; kernel "
          f"{k64_ms * 1e3:.2f} us  [{card}]")
    # pilot_ls on the 64-antenna pilot: a cluster of 8 blocks x 4 teams x 2 rows.
    wide_pc = torch.complex(wide[0].re.contiguous(), wide[0].im.contiguous())
    t64p = measure(lambda: pipe.estimate_pilot_fused(wide[0], x_full),
                   lambda: pipe.estimate_pilot_plain(wide[0], x_full), 200,
                   lambda: torch.fft.fft(wide_pc, dim=-1))
    del wide_pc
    report("pilot_ls (one 64-antenna pilot, 64x1024 f32, cp 72)", t64p, antennas=64)
    p64 = fft_plan.pilot_plan(64, FFT)
    bp64_ms, bp64_by = bound_ms(64 * FFT * 16 + FFT * 12, fft_flops(64, FFT) + 15.0 * 64 * FFT)
    kp64_ms = t64p["kernel_dev"] or t64p["kernel_call"]
    print(f"bound pilot_ls 64 antennas: {bp64_ms * 1e3:.2f} us ({bp64_by}); kernel "
          f"{kp64_ms * 1e3:.2f} us, cluster of {p64.clusters} blocks x {p64.teams} teams x "
          f"{p64.rows} rows  [{card}]")

    # Work of each kernel at the timed shapes (f32 in, one frame; the probes
    # one frame of 101 symbols): each input read once, each output written once.
    a, f, s = ANTENNAS, FFT, SYMBOLS - 1
    work = {
        "pilot_ls": (a * f * 8 + f * 8 + a * f * 8 + f * 4,
                     fft_flops(a, f) + 15.0 * a * f),
        "fft_mrc": (s * a * f * 8 + a * f * 8 + f * 4 + s * (f - 1) * 8,
                    fft_flops(s * a, f) + 8.0 * s * a * f + 2.0 * s * f),
        "mrc_demod": (s * a * f * 8 + a * f * 8 + f * 4 + s * f * 8,
                      fft_flops(s * a, f) + 8.0 * s * a * f + 3.0 * s * f),
        "io_auto": (b_in + f * 4 + b_out, 2.0 * SYMBOLS * a * f),
    }
    work["io_manual"] = work["io_auto"]
    records = []
    for name, (src, replaces) in KERNELS.items():
        nbytes, flops = work[name]
        b_ms, b_by = bound_ms(nbytes, flops)
        k_ms, p_ms, l_ms = ms[name]
        rec = {"name": name, "route": "cuda", "source": f"ofdm_ls_mrc_tpu_torch/csrc/{src}",
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": errs_abs[name], "ms": k_ms, "plain_ms": p_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
               "floor_ms": nbytes / io_floor * 1e3}
        if name == "io_manual":
            rec["variant"] = manual_variant
        if name in ("pilot_ls", "fft_mrc"):
            rec["launches_streaming"] = stream_launches["fused"][name]
        if name == "fft_mrc":
            rec["ms_64_antennas"], rec["bound_ms_64_antennas"] = k64_ms, b64_ms
        if name == "pilot_ls":
            rec["ms_capture_per_frame"] = ((t_cap_pilot["kernel_dev"] or t_cap_pilot["kernel_call"])
                                           / CAPTURE_FRAMES)
            rec["ms_64_antennas"], rec["bound_ms_64_antennas"] = kp64_ms, bp64_ms
        records.append(rec)
        print(f"bound {name}: {nbytes / 1e6:.3f} MB, {flops / 1e6:.1f} MFLOP -> "
              f"{b_ms * 1e3:.2f} us ({b_by}) at the published peaks, "
              f"{nbytes / io_floor * 1e6:.2f} us at the measured io floor; kernel "
              f"{k_ms * 1e3:.2f} us  [{card}]")

    require("jax" not in sys.modules, "jax was imported")
    require(not any(m == "ofdm_ls_mrc_tpu" or m.startswith("ofdm_ls_mrc_tpu.")
                    for m in sys.modules), "the JAX package was imported")
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
