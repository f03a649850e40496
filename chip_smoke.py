#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ofdm_ls_mrc_tpu_torch``) once on one GPU.

  python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

1. toolchain: Python, torch, CUDA, nvcc, triton/ninja, the card's name and
   power limit; the card must be compute capability 9.0 (Hopper).
2. build: compiles csrc/ with nvcc for sm_90a, one process per source, all
   at once (ptxas report printed, then the registers, spills and shared
   memory of the pilot and the two data kernels at F = 1024, of the pilot
   and fft_mrc at F = 64 and 128, of the two speed kernels at F = 256, 1024
   and 4096, and the registers and spills of the probe kernels and their
   burn).
3. kernels: each kernel against its plain PyTorch version on the card, max-rel
   below 2e-5 (both sides fp32 FFTs or sums taken in another order):
   pilot_ls, fft_mrc and mrc_demod at the main path's shapes (16 antennas x
   1024 bins, 101 symbols), f32 and int16 input, cyclic prefix 0 and 72
   (rows 16-byte aligned: the cp.async loads) and 1 (the element-by-element
   loads); pilot_ls also at every F of 256-4096 x 1, 3, 5, 16 and 64
   antennas, f32 and int16, cp 0, 1 and 72, 3 frames in one call (one
   cluster each; the cluster shape is printed); pilot_ls and fft_mrc at F =
   64 and 128 x 1, 4, 16 and 64 antennas, f32 and int16, cp 0, 1 and 8, 3
   frames of 9 symbols in one call; mrc_demod also at F = 64, 4 antennas;
   fft_mrc and mrc_demod at F = 256, 512, 2048 and 4096 (the side form,
   csrc/fft_side.cuh: a launch's antenna rows side by side over the card)
   on a 16 x F x 101 frame, f32 at cp 72, int16 at cp 0 and at cp 1, 64
   antennas, one streamed symbol and a 20-frame sc16 capture, each leg
   twice (one launch of each kernel a run), then each timed once on the
   f32 frame beside its plain version, torch.fft.fft of its rows and its
   bound (the records 'fft_mrc F=...', 'mrc_demod F=...'; phase 2 prints
   their ptxas lines and holds them to 16 B of spills, none for mrc_demod
   at 2048); the io probes auto, manual2, manual3s and manual4 with
   compute 0 and 2 on one 16 x 1024 x 101 f32 frame, manual4 also at ts 1,
   and manual2 and manual4s at ts 8 on a 4-antenna frame, auto also at
   every A of 1, 3, 16, 17 and 64 x F of 128, 1024 and 4096 on 13 symbols;
   at each probe shape the compute-2 burn with burn_scale=1 against the
   plain chain, within 2^-6 of the largest burn term (bf16 rounding after
   each product flips where two f32 sums round apart).
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
   frames, auto, manual2, manual3s and manual4 with compute 0 and 2, best
   of two rounds; the fastest variant without compute gives the measured
   io floor; the compute-2 bound (bytes, and the burn at the bf16 tensor
   rate).
8. timing: each kernel, its plain version and the PyTorch library call
   (torch.fft.fft over the same rows for the FFT kernels, one torch.sum for
   the probes) at the main path's shapes; the profiler's split of one
   estimate_pilot_fused call must hold one kernel; a within-call
   comparison (X Y Y X) of io_auto against torch.sum; demod_capture
   over 20 device-resident sc16 frames with the prefix stripped on the host
   (bench.py's default mode, seed 0) and pilot_ls on its 20 pilots; fft_mrc
   and pilot_ls on one 64-antenna frame (64 x 1024 x 101, f32, cp 72).
9. live path: this script is the ring master (the port's SymbolRing, 16 x
   (1024 + 72) sc16, 101 slots) and writes 20 distinct 16-QAM frames
   through the 16-tap 25 dB channel with backpressure; ``python -m
   ofdm_ls_mrc_tpu_torch.apps.demod_app`` drains the ring as the slave in a
   subprocess on the card, once whole frame, once ``--batch-frames 10
   --sc16-native`` and once ``--per-symbol``.  Each run must exit 0, write
   every frame with every index line clean, reach an EVM below -30 dB, stay
   within 5e-5 max-rel of the golden on the quantized frames, and launch
   pilot_ls and fft_mrc 20 and 20, 2 and 2, and 20 and 2000 times.  The
   app's output (phase table, throughput, feed split, per-symbol latency)
   is printed; then one frame's host time split in this process: ring
   copy-out, pinned H2D copy, device time, D2H plus file append.

10. three processes, each ``python -m ofdm_ls_mrc_tpu_torch...``: ``tx_app``
   writes 20 16-QAM frames (16 x 1024 x 101, cp 72, a 16-tap 25 dB channel,
   one PN preamble, cf32, the default pilot); ``rx_app`` PN-syncs it (native
   correlator) as the sc16 ring master with backpressure and an aligned dump;
   ``demod_app`` drains it whole frame on the card (exit 0, every index line
   clean, EVM below -30 dB, within 5e-5 max-rel of the golden of the dump
   quantized as the ring quantizes, which clips no sample, and pilot_ls and
   fft_mrc launched 20 and 20 times); ``compare_app`` holds the app's output
   to that golden at -70 dB.  Then ``tx_app --pn-every-frame`` (10 frames)
   with 11 samples inserted before frame 5's PN, ``rx_app --continuous-sync``
   (one drift correction at least, every frame delivered) and ``demod_app
   --per-symbol`` with the same bounds (10 and 1000 launches).  Then
   ``ops/correlate`` on the card over antenna 0 of the first capture:
   ``pn_correlate`` against the NumPy sliding dot (rtol 1e-3, atol 1e-4),
   ``find_frame_start`` at rx_app's start, their device time beside the host
   native correlator's; and the port's gate, which must pass at -70 dB
   with its accuracy sweep (the unsharded bodies, the bf16 leg at -35 dB,
   and the sharded ones on 2x2 and 2x1 meshes of gloo ranks on the card).

11. the BASELINE configs 1-2 (BASELINE.json, tests/test_baseline_configs.py's
   frames): UplinkReceiver(1 x 64, then 4 x 64, cp 8, 9 symbols, fused,
   cuda), EVM below -25 and -28 dB, max-rel below 5e-5 against the golden,
   pilot_ls and fft_mrc launched; at 4 x 64 the split-phase leg (mrc_demod
   launched) and the fused streaming leg (within 2e-5 of demod_frame); a 4 x
   128 frame the same way (the other new size); each kernel timed on one
   frame at F = 64 and 128 beside its plain version and torch.fft.fft over
   the same rows; demod_capture over 4,096 device-resident 4 x 64 x 9 f32
   frames (cp 8, 85 MB): within 2e-5 of the plain versions, device time per
   frame, samples/s, the bound and torch.fft.fft over the same rows.
12. downlink: ``python -m ofdm_ls_mrc_tpu_torch.apps.dl_app`` (4 users x 16
   antennas x 1024, cp 72, 11 symbols, 10 frames, --simulate-channel
   --verify), then 8 users x 64 antennas with --out-format sc16: exit 0, ZF
   separation EVM below -40 dB, the capture within 2e-3 max-abs of the NumPy
   chain golden.modulate_symbol(golden.apply_precoder(golden.zf_precoder(h),
   x)) and of the C++ oracle (io/native_dsp) on the same h and symbols; the
   app's per-symbol and frames/s lines; precode and modulate per symbol on
   device-resident inputs (CUDA events and profiler device time).

13. sharded paths (``ofdm_ls_mrc_tpu_torch.parallel``): (a) BASELINE config
   4, one 64 x 1024 x 101 sc16 frame (cp stripped on the host, 16-QAM, a
   16-tap 25 dB channel) through ``ShardedUplinkReceiver`` at world size 1
   over NCCL: EVM below -30 dB, within 5e-5 max-rel of the golden and 2e-5
   of ``UplinkReceiver(fused)``, pilot_ls_sum and fft_mrc launched (pilot_ls
   not), one all-reduce of 2 (S-1)(F-1) + F words; the pilot's sum|h|^2
   variant against its plain version (this pilot and a 64-antenna f32 one
   at cp 72), timed beside the plain version and torch.fft.fft of its rows;
   the sharded frame's device time beside the unsharded one's and the
   all-reduce's share.  (c) ``ShardedStreamingDemodulator`` over the same
   frame symbol by symbol (within 2e-5 of (a), 1 and 100 launches, 101
   all-reduces).  (d) ``ShardedDownlinkTransmitter`` at world size 1 on
   dl_app's 4 x 16 geometry against ``DownlinkTransmitter`` and the NumPy
   chain.  (b) ``demod_app --distributed`` as two processes on the card
   over gloo (2 x 32 antennas), each fed by its own sc16 ring by this
   script: 3 frames, rank 0's output within 5e-5 of the golden and 2e-5 of
   (a) on frame 0, every index line clean, 3 launches of each kernel and 3
   all-reduces on each rank.

14. the bf16 speed mode (exact=False; csrc/fft_mrc_bf16.cu): (a)
   pilot_ls_bf16 and fft_mrc_bf16 against their plain versions on phase 4's
   16 x 1024 x 101 f32 frame (cp 72) and on the 20-frame sc16 capture: EVM
   of the kernel against its plain version at least 20 dB below the plain
   version's EVM against the exact path, max-rel under 1e-2 (h and
   sum|h|^2 for the pilot); (b) launch counts, each set to 0 just before
   and read just after its path: UplinkReceiver(exact=False) whole frame
   (1 and 1, the exact kernels 0), demod_capture of the 20 frames (1 and
   1), ShardedUplinkReceiver(exact=False) at world size 1 over NCCL on
   BASELINE config 4 (pilot_ls_sum 1, fft_mrc_bf16 1) and its streaming
   module (1, 100); (c) through the 16-tap 25 dB channel EVM at most -35 dB
   against the golden and below -30 dB against the sent symbols; (d)
   ``demod_app --kernel-precision bf16`` whole frame and ``--batch-frames 10
   --sc16-native`` on phase 9's ring shape (every index line clean, the
   bf16 kernels 20/20 and 2/2, the exact ones 0), ``--per-symbol`` with bf16
   on 5 frames (the exact kernels 5/500, the note on stderr); (e) phase 10's
   gate with its sweep passed, the bf16 leg among its 12 legs; (f) device
   time of each speed kernel beside its plain version, torch.fft.fft of its
   rows, a bf16 torch.matmul of its stage-2 shape and its bound (bytes,
   float32 FLOPs, bf16 tensor FLOPs), the exact kernel beside it in the
   order exact, speed, speed, exact, and demod_capture speed against exact
   the same way; (g) both kernels against their plain versions on a 16 x F
   x 101 frame at F = 256 and 4096, f32 (cp 72) and int16 (cp 0), and
   their device times there beside the exact kernels, their plain versions
   and torch.fft.fft of their rows; (h) the main frame through
   UplinkReceiver(pipeline="fast", fft_impl="four_step") (plain torch
   GEMMs, no kernel of the repo) beside the fused receiver: within 5e-5
   max-rel of the golden, device and per-call times (no claim of speed).

15. the large-F geometry (DVB-T2's 8K, 16K and 32K modes), for F = 8192,
   16384 and 32768 each: a 16 x F x 101 f32 frame, cp 72 F / 1024, 16-QAM
   through a 16-tap 25 dB channel, every kernel against its plain version
   (pilot_ls, its sum variant, fft_mrc and mrc_demod below 2e-5 max-rel;
   pilot_ls_bf16 and fft_mrc_bf16 by phase 14's criteria), also on the
   capture and, at 8192, on int16 rows at an odd offset (the element
   loads); then the paths, each with counts set to 0 just before and read
   just after, no fallback RuntimeWarning: UplinkReceiver(fused)
   demod_frame (EVM below -30 dB against the sent symbols, within 5e-5 of
   the golden), demod_parts, the split phase (mrc_demod), exact=False
   (EVM at most -35 dB against the golden) and its demod_parts, the fused
   StreamingDemodulator (1 and 100 launches), ShardedUplinkReceiver exact
   and exact=False and ShardedStreamingDemodulator at world size 1 over
   NCCL (pilot_ls_sum), demod_capture exact and bf16 over a device-made
   sc16 capture, cp stripped (20 frames at 8192, 10 at 16384, 5 at 32768:
   1.06 GB each); each kernel's device time on the frame beside its plain
   version, torch.fft.fft of its rows and its bound (3.35 TB/s and the
   measured io floor), the capture's per frame, and the ptxas lines of
   every new instantiation (35, the ring kernels', the 8192 pilot's and
   the 8192 data kernels' spread over the card among them); the one-launch
   legs: fft_mrc and mrc_demod (at 8192 their rows spread over the card,
   fft_plan.spread_plan; at 16384 and 32768 on their ring of symbol
   slots), and at 8192 to 32768 fft_mrc_bf16 on its ring, against their
   plain versions (below 2e-5; the bf16 one by phase 14's criteria) at 16
   and 64 antennas, f32 rows with the 72 F / 1024 prefix and int16 rows, a
   streamed symbol (S = 1) and full frames (fft_mrc and fft_mrc_bf16 over
   K = 2 frames of 100 symbols), each leg twice back to back with the
   counts set to 0 before each; the three
   pilots on a 64-antenna pilot (f32 and int16) against their plain
   versions; for each pilot at each F one line with its time, its
   column-pass and row-pass times (at 8192 the exact pilot is one kernel,
   a cluster per antenna row), its parent form's time (PERF.md, the kernel
   table), torch.fft.fft's, its bound and its ptxas lines; then
   ``demod_app --fft-size 8192
   --sc16-native``, exact and ``--kernel-precision bf16``, whole frame on a
   ring of 4 sc16 frames (every index line clean, 4/4 launches).
16. tools: each tool and example of the port through its command line on
   the card (exit 0 required): ``utils.profiling.trace`` around 20
   demod_frame calls of the main frame, whose ``summarize_trace`` must list
   pilot_ls and fft_mrc 20 times each within 10% of ``device_time``'s
   reading of the same kernels; ``tools.latency_probe`` (every body, 16 x
   1024, batch 256, its book); ``tools.waterfall`` (64-QAM, 16 x 1024 x
   101, cp 72, SNRs 10-30 dB, one seed, golden/fused/fast/composed,
   ``--fail-above-db 0.5``); ``tools.ring_bench`` (sc16, the int16 batch
   read, then ``--decompose``); ``tools.soak`` (20 s, 16 x 1024 x 101 sc16
   ``--sc16-native --rate 4e6 --num-frames 3``: pass, worst rcs 0);
   ``tools.scaling_bench`` (fused, NCCL at one rank with 64 antennas, gloo
   at 1 and 2 ranks with 64, beside the examples: one
   all-reduce of the expected words, the same at both); the four
   ``examples`` (OK), all at once.  Each leg's
   kernel launches join the kernels' record (``launches_tools``).
17. bench: ``python -m ofdm_ls_mrc_tpu_torch.bench`` as a process on the
   card in its default mode (sc16-exact, recorded into a book of the
   phase's own), ``--input f32``, ``--kernel-precision bf16``, ``--mesh
   1x1`` and ``--pipeline fast``: each record must name its mode, backend
   cuda and a positive value, and each run launch its kernels (none under
   'fast'); the event and device readings per frame, their ratio and any
   ``host-bound`` note are printed; the default mode's device time per
   frame must agree within 15% with phase 14's exact demod_capture.  Then
   ``tools.latency_probe --bodies fused,fused-sc16 --record`` into the
   phase's latency book, and ``tools.gate --skip-accuracy --perf --latency
   --books <that directory>`` must exit 0 (floors taken minutes earlier on
   the same card).  Each run's launches join the kernels' record
   (``launches_bench``).

The second-to-last lines are the kernels' JSON record (with the live path's
and the three processes' launches; each record's ``time_source`` says where
each of its times comes from: torch.profiler device time, from a trace shown
whole or a partial one, or CUDA events) and the card's ``nvidia-smi`` name and
power limit; the last line is ``{"ok": true, "device": {...}}``.  Exits
non-zero without CUDA.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import uuid

import numpy as np

ANTENNAS, FFT, SYMBOLS, CP = 16, 1024, 101, 72
CAPTURE_FRAMES = 20
PROBE_FRAMES, PROBE_TS = 20, 2
PROBE_REPS = 10             # timed repetitions of 10 passes (1 ms each), best kept
PROBE_VARIANTS = ("auto", "manual2", "manual3s", "manual4")
# (variant, ts, symbols, antennas, F) of the probes' checks: ts 8 fits
# 227 KB only below 16 antennas; auto at every A and F below on a ragged S.
PROBE_CHECKS = ((("auto", 2, SYMBOLS, 16, FFT), ("manual2", 2, SYMBOLS, 16, FFT),
                 ("manual3s", 2, SYMBOLS, 16, FFT), ("manual4", 2, SYMBOLS, 16, FFT),
                 ("manual4", 1, SYMBOLS, 16, FFT), ("manual2", 8, SYMBOLS, 4, FFT),
                 ("manual4s", 8, SYMBOLS, 4, FFT))
                + tuple(("auto", 2, 13, a, f) for a in (1, 3, 16, 17, 64)
                        for f in (128, 1024, 4096)))
PILOT_ANTENNAS, PILOT_FRAMES = (1, 3, 5, 16, 64), 3
STREAM_FRAMES = 3           # timed passes of the streaming path over the frame
KERNEL_TOL = 2e-5
GOLDEN_TOL = 5e-5
EVM_MAX_DB = -30.0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (published)
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores (published)
BF16_TENSOR_FLOPS = 989e12  # H100 SXM dense bf16 on the tensor cores (published)
PROBE_COMPUTE = 2           # chained products of the probes' burn leg
KERNELS = {  # name -> (source, TPU kernel it replaces)
    "pilot_ls": ("pilot_ls.cu", "ofdm_ls_mrc_tpu/ops/pallas_pipeline.py:222"),
    "fft_mrc": ("fft_mrc.cu", "ofdm_ls_mrc_tpu/ops/pallas_pipeline.py:320"),
    "mrc_demod": ("mrc_demod.cu", "ofdm_ls_mrc_tpu/ops/pallas_mrc.py:62"),
    "io_auto": ("io_probe.cu", "tools/dma_probe.py:63"),
    "io_manual": ("io_probe.cu", "tools/dma_probe.py:99"),
}
REPO = os.path.dirname(os.path.abspath(__file__))
LIVE_FRAMES = 20
LIVE_GAIN = 0.5   # keeps the channel's peaks inside sc16 full scale
LIVE_MODES = {    # label -> (demod_app flags, pilot_ls and fft_mrc launches of the run)
    "whole frame": ((), (LIVE_FRAMES, LIVE_FRAMES)),
    "batch 10 sc16-native": (("--batch-frames", "10", "--sc16-native"), (2, 2)),
    "per-symbol": (("--per-symbol",), (LIVE_FRAMES, LIVE_FRAMES * (SYMBOLS - 1))),
}
SPLIT_FRAMES, SPLIT_WARM = 12, 2
THREE_FRAMES = 20           # phase 10: tx_app -> rx_app -> demod_app, whole frame
SYNC_FRAMES = 10            # phase 10: --pn-every-frame -> --continuous-sync -> per symbol
SLIP = 11                   # samples inserted before frame SYNC_FRAMES // 2's PN
PN_THRES = 0.4              # rx_app --thres (tests/test_apps.py's continuous-sync run)
CORR_TOL = dict(rtol=1e-3, atol=1e-4)   # tests/test_correlate.py
GEOMETRY = ["--antennas", str(ANTENNAS), "--fft-size", str(FFT), "--cp-size", str(CP),
            "--frame-len", str(SYMBOLS)]
SMALL_FFT = (64, 128)        # the sizes of the 64-subcarrier configurations
SMALL_ANTENNAS = (1, 4, 16, 64)
SMALL_CP, SMALL_SYMBOLS = 8, 9
# BASELINE.json configs 1-2 (tests/test_baseline_configs.py): label ->
# (antennas, F, channel taps, SNR dB, channel seed, EVM bound dB).
BASELINE = {"config 1 (1x64)": (1, 64, 4, 40.0, 1, -25.0),
            "config 2 (4x64)": (4, 64, 4, 35.0, 2, -28.0)}
# No BASELINE config: the other size the path covers, on config 2's channel.
FRAME_128 = {"4x128": (4, 128, 4, 35.0, 2, -28.0)}
SMALL_CAPTURE = 4096         # frames of the 4 x 64 x 9 capture (85 MB of f32 rows)
DL_RUNS = {  # label -> (users, antennas, --out-format) of the dl_app runs
    "4 users x 16 antennas, cf32": (4, 16, "cf32"),
    "8 users x 64 antennas, sc16": (8, 64, "sc16"),
}
DL_FFT, DL_CP, DL_SYMBOLS, DL_FRAMES = 1024, 72, 11, 10
DL_TOL = 2e-3                # max-abs against the NumPy chain (tests/test_ops.py:146)
SHARD_ANTENNAS = 64          # phase 13: BASELINE config 4 (64 x 1024 x 101, sc16)
SHARD_FRAMES, SHARD_RANKS = 3, 2   # leg (b): frames through two ranks' rings
# Phase 14, the bf16 speed mode: name -> (source, TPU kernel, its branch).
SPEED_KERNELS = {
    "pilot_ls_bf16": ("fft_mrc_bf16.cu", "ofdm_ls_mrc_tpu/ops/pallas_pipeline.py:222",
                      "exact=False: _stage2_dots :205-210"),
    "fft_mrc_bf16": ("fft_mrc_bf16.cu", "ofdm_ls_mrc_tpu/ops/pallas_pipeline.py:320",
                     "exact=False under g2: stage2_group :554-590"),
}
SPEED_GAP_DB = 20.0          # kernel vs plain EVM at least this far below plain vs exact
SPEED_REL = 1e-2             # and max-rel against the plain version under this
SPEED_GOLDEN_EVM_DB = -35.0  # the speed mode against the golden (the sweep's bf16 bound)
SPEED_PER_SYMBOL_FRAMES = 5  # frames of the app's per-symbol bf16 run
SPEED_OTHER_FFT = (256, 4096)  # the kernels' end sizes, held and timed beside F = 1024
# Phase 15, the large-F geometry (DVB-T2's 8K, 16K and 32K modes): F -> the
# frames of its sc16 capture (1.06 GB each: 20 frames at 8192, fewer above).
LARGE_FFT = {8192: 20, 16384: 10, 32768: 5}
LARGE_KERNELS = {  # name -> (source, TPU kernel it replaces)
    "pilot_ls": KERNELS["pilot_ls"],
    "pilot_ls_sum": KERNELS["pilot_ls"],
    "fft_mrc": KERNELS["fft_mrc"],
    "mrc_demod": KERNELS["mrc_demod"],
    "pilot_ls_bf16": SPEED_KERNELS["pilot_ls_bf16"][:2],
    "fft_mrc_bf16": SPEED_KERNELS["fft_mrc_bf16"][:2],
}
LARGE_REPS = 5               # calls of each timing at phase 15's sizes
WIDE_PILOT_ANTENNAS = 64     # phase 15 holds the pilots at this width too
# The pilots' parent forms, device us of one 16 x F f32 pilot as PERF.md's
# kernel table records the tree before the 8192 pilot's cluster per antenna
# row (tools/split_compare.py, parent against this form in turns on one
# NVIDIA H100 80GB HBM3, 700 W; the forms at 16384 and 32768 are the same
# kernels in both trees).
LARGE_PILOT_PARENT_US = {"pilot_ls": {8192: 12.9, 16384: 12.1, 32768: 16.6},
                         "pilot_ls_sum": {8192: 12.9, 16384: 12.0, 32768: 17.3},
                         "pilot_ls_bf16": {8192: 15.4, 16384: 17.2, 32768: 17.7}}
LARGE_APP_FFT, LARGE_APP_FRAMES = 8192, 4   # phase 15's demod_app run
# Phase 16, the tools and examples of the port.
TOOL_CALLS = 20              # demod_frame calls in the profiling leg's trace
LATENCY_BODIES = ("fused", "composed", "fused-sc16", "fused-sharded", "fast-sharded")
WATERFALL_SNRS = "10,15,20,25,30"
SOAK_SECONDS = 20
# 64 antennas only: the 16-antenna sharded receiver at one rank is phase 17's
# bench --mesh 1x1 leg.
SCALING_TIMED = ((SHARD_ANTENNAS, ("--shards", "1")),)
SCALING_STRUCTURE = (SHARD_ANTENNAS, ("--shards", "1,2", "--backend", "gloo"))
EXAMPLES = ("loopback_demod", "ring_pipeline", "sharded_mesh", "downlink_zf")
# Phase 17, the bench and the gate's ratchets: label -> (flags, the mode the
# record must name, kernels it must launch, kernels it must not).
BENCH_RUNS = {
    "default": ((), "sc16-exact", ("pilot_ls", "fft_mrc"), ("pilot_ls_bf16", "fft_mrc_bf16")),
    "input f32": (("--input", "f32"), "f32-exact", ("pilot_ls", "fft_mrc"), ("fft_mrc_bf16",)),
    "bf16": (("--kernel-precision", "bf16"), "sc16-bf16", ("pilot_ls_bf16", "fft_mrc_bf16"),
             ("pilot_ls", "fft_mrc")),
    "mesh 1x1": (("--mesh", "1x1"), "sc16-exact-mesh1x1", ("pilot_ls_sum", "fft_mrc"),
                 ("pilot_ls",)),
    "pipeline fast": (("--pipeline", "fast"), "f32-fast", (),
                      ("pilot_ls", "fft_mrc", "pilot_ls_sum", "pilot_ls_bf16", "fft_mrc_bf16")),
}
BENCH_DEVICE_TOL = 0.15      # the default mode's device time against phase 14's capture
GATE_LATENCY_BODIES = "fused,fused-sc16"


def small_records():
    """Record names of the kernels' 64-subcarrier sizes: 'pilot_ls F=64', ..."""
    return [f"{name} F={f}" for name in ("pilot_ls", "fft_mrc") for f in SMALL_FFT]


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def max_rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def max_abs(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.max(np.abs(got - want)))


def evm_db(got: np.ndarray, want: np.ndarray) -> float:
    """EVM of got against want, dB (the sweep's and the gate's measure)."""
    return float(10 * np.log10(np.mean(np.abs(got - want) ** 2) / np.mean(np.abs(want) ** 2)))


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def fft_flops(rows: int, f: int) -> float:
    return 5.0 * rows * f * math.log2(f)


def bound_ms(nbytes: float, flops: float) -> tuple:
    """(least time in ms, 'bytes' or 'operations') at the published peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def ptxas_lines(report: str, sizes=(FFT,), names=("fft_mrc", "mrc_demod", "pilot_ls"),
                antennas: int = ANTENNAS):
    """One line per instantiation of the pilot and data kernels at the given
    F from nvcc's -Xptxas -v report: registers, spills and the dynamic
    shared memory the launch asks for (ops/fft_plan.py smem_bytes; for the
    pilot, its plan at ``antennas`` antennas)."""
    from ofdm_ls_mrc_tpu_torch.ops import fft_plan

    pat = (r"Compiling entry function "
           r"'_ZN4ofdm\d+(fft_mrc|mrc_demod|pilot_ls)_kernelILi(\d+)E(\w)Lb(\d)E"
           r"[^']*'.*?(\d+) bytes spill stores.*?Used (\d+) registers")
    for name, f, t, aligned, spill, regs in re.findall(pat, report, re.S):
        f = int(f)
        if f not in sizes or name not in names:
            continue
        if name == "pilot_ls":
            plan = fft_plan.pilot_plan(antennas, f)
            smem, threads = (plan.smem_bytes, f"{plan.threads} threads a block "
                             f"({antennas} antennas, a cluster of {plan.clusters})")
        else:
            smem, threads = fft_plan.smem_bytes(f), f"{fft_plan.plan(f).block} threads a block"
        yield (f"ptxas {name}<{f}, {'int16' if t == 's' else 'float'}, "
               f"{'cp.async' if aligned == '1' else 'element'} loads>: {regs} registers, "
               f"{spill} B spilled, {smem} B dynamic shared memory, {threads}")


def speed_ptxas_lines(report: str, sizes=(256, FFT, 4096)):
    """Registers, spills and shared memory of the speed kernels at the given
    F from nvcc's -Xptxas -v report (n1 = F / 128 in the instantiation); the
    shared memory is the launch's (ops/fft_plan.py speed_smem_bytes)."""
    from ofdm_ls_mrc_tpu_torch.ops import fft_plan

    pat = (r"Compiling entry function '_ZN4ofdm5speed\d+(\w+?_bf16)_kernelILi(\d+)E(\w)EE[^']*'"
           r".*?(\d+) bytes spill stores.*?Used (\d+) registers")
    for name, n1, t, spill, regs in re.findall(pat, report, re.S):
        f = 128 * int(n1)
        if f in sizes:
            smem = fft_plan.speed_smem_bytes(f, name == "pilot_ls_bf16")
            yield (f"ptxas {name}<F {f}, {'int16' if t == 's' else 'float'}>: "
                   f"{regs} registers, {spill} B spilled, {smem} B dynamic shared memory, "
                   f"{fft_plan.SPEED_THREADS[name == 'pilot_ls_bf16']} threads a block")


def probe_ptxas_lines(report: str):
    """Registers and spills of the probe kernels (io_auto's two, io_manual
    at the timed window ts = 2) and of the out-of-line burn, from nvcc's
    -Xptxas -v report."""
    entry = (r"Compiling entry function '_ZN4ofdm\d+(io_auto_kernel|io_auto_burn_kernel|"
             r"io_manual_kernel)(?:ILi(\d)ELi(\d)ELb(\d)E)?[^']*'.*?(\d+) bytes spill stores"
             r".*?Used (\d+) registers")
    for name, depth, ts, s, spill, regs in re.findall(entry, report, re.S):
        if name == "io_manual_kernel" and ts != "2":
            continue
        label = f"{name}<depth {depth}, ts {ts}{', s' if s == '1' else ''}>" if depth else name
        yield f"ptxas {label}: {regs} registers, {spill} B spilled"
    burn = (r"Function properties for _ZN4ofdm\d+burn_tile\w*\s+(\d+) bytes stack frame, "
            r"(\d+) bytes spill stores")
    for stack, spill in sorted(set(re.findall(burn, report))):
        yield f"ptxas burn_tile: {stack} B stack frame, {spill} B spilled"


def live_frames(golden, sim, pilot, frames=LIVE_FRAMES, antennas=ANTENNAS, seed=11,
                channel_seed=9, f=FFT, cp=CP):
    """``frames`` distinct received frames as the ring's sc16 wire samples
    [n, S, A, 2 (F + CP)], the data each carries, and the golden demod of
    the quantized samples the app reads."""
    rng = np.random.default_rng(seed)
    channel = sim.ChannelModel(antennas, f, num_taps=16, snr_db=25.0, seed=channel_seed)
    wire, sent, gold = [], [], []
    for _ in range(frames):
        data, _ = sim.random_symbols(rng, (SYMBOLS - 1, f - 1), "16qam")
        rx = LIVE_GAIN * channel.apply(sim.make_tx_frame(data, pilot, cp), cp)
        iq = golden.io.complex_to_sc16(rx)
        wire.append(iq)
        sent.append(data)
        gold.append(golden.demod_frame(golden.io.sc16_to_complex(iq).reshape(rx.shape),
                                       pilot, cp))
    return np.stack(wire), np.stack(sent), np.stack(gold)


def run_live_app(flags, wire, pilot_path: str, out: str, stderr: bool = False, f=FFT, cp=CP):
    """Be the ring master for one demod_app run: start the app as the
    slave, write every frame with backpressure, wait for the app; returns
    its standard output (and its standard error when asked).  Stops the app
    and the writer on any failure."""
    from ofdm_ls_mrc_tpu_torch.io.ring import SymbolRing

    uid = f"/ofdm_smoke_{uuid.uuid4().hex[:10]}"
    master = SymbolRing(uid, ANTENNAS, f + cp, SYMBOLS, master=True, timeout=120.0,
                        dtype="sc16")
    cmd = [sys.executable, "-m", "ofdm_ls_mrc_tpu_torch.apps.demod_app", "--shm-uid", uid,
           "--antennas", str(ANTENNAS), "--fft-size", str(f), "--cp-size", str(cp),
           "--frame-len", str(SYMBOLS), "--ring-dtype", "sc16", "--num-frames", str(len(wire)),
           "--pilots", pilot_path, "--output", out, "--timeout", "120", *flags]
    errors = []

    def produce():
        try:
            for frame in wire:
                master.write_batch(frame, wait=True)
            if not master.wait_drained(120.0):
                errors.append("the app did not drain the ring")
        except Exception as e:  # reported by the caller
            errors.append(repr(e))

    app = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    writer = threading.Thread(target=produce, daemon=True)
    writer.start()
    try:
        stdout, err = app.communicate(timeout=300)
    finally:
        if app.poll() is None:
            app.kill()
            app.wait()
        master.shutdown()          # unblocks the writer if the app is gone
        writer.join(timeout=30)
        master.close()
    require(app.returncode == 0,
            f"demod_app {' '.join(flags)} exited {app.returncode}:\n{stdout}\n{err}")
    require(not errors, f"ring producer: {errors}")
    return (stdout, err) if stderr else stdout


def check_live(label, stdout, out, sent, gold, want_launches, card, golden, sim,
               kernels=("pilot_ls", "fft_mrc"), gold_evm_max=None, f=FFT) -> dict:
    """Print the app's output and hold what it wrote to the golden, the
    sent data, the index contract and the launch counts of ``kernels``.
    With ``gold_evm_max`` (the speed mode) the golden bound is that EVM in
    place of the max-rel bound."""
    frames = len(sent)
    for line in stdout.splitlines():
        print(f"app {label}: {line}  [{card}]")
    got = golden.read_output(out, f - 1)
    require(got.shape == (frames * (SYMBOLS - 1), f - 1) and np.all(np.isfinite(got)),
            f"live {label}: output shape {got.shape}")
    got = got.reshape(frames, SYMBOLS - 1, f - 1)
    rel = max(max_rel(got[k], gold[k]) for k in range(frames))
    evm = sim.evm_db(np.fft.fftshift(got, axes=-1), sent)
    index = open(out + ".index").read().splitlines()
    want_index = [f"{k} clean {k * (SYMBOLS - 1)} {(k + 1) * (SYMBOLS - 1)} {k}"
                  for k in range(frames)]
    launches = json.loads(next(ln for ln in stdout.splitlines()
                               if ln.startswith("kernel launches "))[len("kernel launches "):])
    rate = re.search(r"throughput: \d+ frame\(s\) in ([\d.]+) s: ([\d.]+) frames/s, "
                     r"([\d.e+]+) samples/s", stdout)
    evm_gold = evm_db(got, gold)
    p = re.search(r"per-symbol latency .*: p50 ([\d.]+) us, p99 ([\d.]+) us", stdout)
    rec = {"frames_per_s": float(rate.group(2)), "samples_per_s": float(rate.group(3)),
           "seconds": float(rate.group(1)), "max_rel_golden": rel, "evm_db": evm,
           "evm_golden_db": evm_gold, "launches": launches}
    if p:
        rec["p50_us"], rec["p99_us"] = float(p.group(1)), float(p.group(2))
    print(f"live {label}: {frames} frames, EVM {evm:.2f} dB, max-rel vs golden {rel:.3e} "
          f"(EVM {evm_gold:.2f} dB), "
          f"index {sum(a == b for a, b in zip(index, want_index))}/{frames} clean, "
          f"launches {launches}; {rec['frames_per_s']} frames/s, {rec['samples_per_s']:.6g} "
          f"samples/s ring -> output file"
          + (f"; per-symbol p50 {rec['p50_us']} us, p99 {rec['p99_us']} us" if p else "")
          + f"  [{card}]")
    require(index == want_index, f"live {label}: index {index[:3]}... want all clean")
    require(evm < EVM_MAX_DB, f"live {label}: EVM {evm:.2f} dB >= {EVM_MAX_DB}")
    if gold_evm_max is None:
        require(rel < GOLDEN_TOL, f"live {label}: max-rel vs golden {rel:.3e} >= {GOLDEN_TOL}")
    else:
        require(evm_gold <= gold_evm_max,
                f"live {label}: EVM vs golden {evm_gold:.2f} dB > {gold_evm_max}")
    got_launches = tuple(launches[k] for k in kernels)
    require(got_launches == want_launches,
            f"live {label}: {', '.join(kernels)} launched {got_launches}, want {want_launches}")
    return rec


def host_split(wire, pilot, dev, card, workdir: str) -> dict:
    """Where one frame's and one symbol's host time goes, taken apart in
    this process, one stage after another (each ends in a synchronize, so
    the stages add up to the serial time of the step).

    Whole frame (float planes as the whole-frame mode reads them, int16 as
    --sc16-native): the ring's bulk copy-out into pinned planes (CP drop and
    deinterleave), the pinned H2D copy on a side stream, demod_frame, D2H
    (``to_numpy``), the output file append; host clock, plus CUDA events for
    the H2D copy and for demod_frame's device time.  Medians over
    SPLIT_FRAMES - SPLIT_WARM frames.

    Per symbol (the --per-symbol loop's steps, float): the ring read of one
    symbol, its pageable H2D copy, push_symbol_async until its event
    completes, D2H of the row, the append; medians over one frame's data
    symbols after a frame of warm-up."""
    import torch

    from ofdm_ls_mrc_tpu_torch import FrameConfig
    from ofdm_ls_mrc_tpu_torch.golden.io import append_output
    from ofdm_ls_mrc_tpu_torch.io.feed import FrameAssembler
    from ofdm_ls_mrc_tpu_torch.io.ring import SymbolRing
    from ofdm_ls_mrc_tpu_torch.models import StreamingDemodulator, UplinkReceiver
    from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray

    cfg = FrameConfig(num_antennas=ANTENNAS, fft_size=FFT, cyclic_prefix=0, frame_len=SYMBOLS)
    rx = UplinkReceiver(cfg, pilot, device=dev)
    side = torch.cuda.Stream(dev)
    uid = f"/ofdm_split_{uuid.uuid4().hex[:10]}"
    master = SymbolRing(uid, ANTENNAS, FFT + CP, SYMBOLS, master=True, timeout=30.0,
                        dtype="sc16")
    slave = SymbolRing(uid, ANTENNAS, FFT + CP, SYMBOLS, master=False, timeout=30.0,
                       dtype="sc16")

    def report(label, parts, n):
        med = {k: float(np.median(v)) for k, v in parts.items()}
        total = sum(v for k, v in med.items() if not k.endswith("(events)"))
        print(f"host split, {label} (medians of {n}, us): "
              + ", ".join(f"{k} {v:.2f}" for k, v in med.items())
              + f"; serial sum {total:.2f}  [{card}]")
        return {**med, "sum": total}

    def back_to_back(fn, n=50):
        """Median host time of ``fn`` and a synchronize, called n times in a
        row with nothing between: the same step without the live loop's
        other host work around it."""
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e6)
        med = float(np.median(times))
        print(f"host split: the same step back to back ({n} calls, each synchronized): "
              f"median {med:.2f} us  [{card}]")
        return med

    result = {}
    try:
        for kind in ("f32", "int16"):
            buf = FrameAssembler(cfg, np.int16 if kind == "int16" else np.float32, pin=True)
            read = slave.read_frame_planar_i16 if kind == "int16" else slave.read_frame_planar
            parts = {k: [] for k in ("copy-out", "H2D", "demod", "D2H", "append",
                                     "H2D (events)", "demod (events)")}
            out_path = os.path.join(workdir, f"split_{kind}.dat")
            for i in range(SPLIT_FRAMES):
                master.write_batch(wire[i % len(wire)])
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                t = [time.perf_counter()]
                read(SYMBOLS, cp=CP, out_re=buf.re, out_im=buf.im)
                t.append(time.perf_counter())
                with torch.cuda.stream(side):
                    ev[0].record()
                    re = buf.re_t.to(dev, non_blocking=True)
                    im = buf.im_t.to(dev, non_blocking=True)
                    ev[1].record()
                ev[1].synchronize()
                t.append(time.perf_counter())
                torch.cuda.current_stream(dev).wait_stream(side)
                ev[2].record()
                out = rx.demod_frame(CArray(re, im))
                ev[3].record()
                ev[3].synchronize()
                t.append(time.perf_counter())
                rows = out.to_numpy()
                t.append(time.perf_counter())
                append_output(out_path, rows, truncate=(i == 0))
                t.append(time.perf_counter())
                if i >= SPLIT_WARM:
                    for k, (a, b) in zip(("copy-out", "H2D", "demod", "D2H", "append"),
                                         zip(t, t[1:])):
                        parts[k].append((b - a) * 1e6)
                    parts["H2D (events)"].append(ev[0].elapsed_time(ev[1]) * 1e3)
                    parts["demod (events)"].append(ev[2].elapsed_time(ev[3]) * 1e3)
            rec = report(f"one frame, {kind} planes", parts, SPLIT_FRAMES - SPLIT_WARM)
            rec["demod back to back"] = back_to_back(lambda: rx.demod_frame(CArray(re, im)))
            h2d_bytes = 2 * SYMBOLS * ANTENNAS * FFT * buf.re.itemsize
            rec["h2d_share"] = rec["H2D"] / rec["sum"]
            rec["h2d_gb_per_s"] = h2d_bytes / rec["H2D (events)"] / 1e3
            print(f"host split, one frame, {kind} planes: H2D {rec['h2d_share']:.1%} of the "
                  f"serial sum, {rec['h2d_gb_per_s']:.2f} GB/s pinned by events  [{card}]")
            result[kind] = rec

        sd = StreamingDemodulator(cfg, pilot, pipeline="fused", device=dev)
        sd.warmup()
        parts = {k: [] for k in ("read", "H2D", "demod", "D2H", "append")}
        out_path = os.path.join(workdir, "split_symbols.dat")
        for i in range(2):
            master.write_batch(wire[i])
            for slot in range(SYMBOLS):
                t = [time.perf_counter()]
                re, im = slave.read_next_planar(cp=CP)
                t.append(time.perf_counter())
                sym = CArray(torch.from_numpy(re).to(dev), torch.from_numpy(im).to(dev))
                torch.cuda.synchronize(dev)
                t.append(time.perf_counter())
                if slot == 0:
                    sd.push_pilot(sym)
                    continue
                out = sd.push_symbol_async(sym, slot=slot)
                done = torch.cuda.Event()
                done.record()
                done.synchronize()
                t.append(time.perf_counter())
                row = out.to_numpy()
                t.append(time.perf_counter())
                append_output(out_path, row, truncate=(i == 0 and slot == 1))
                t.append(time.perf_counter())
                if i:
                    for k, (a, b) in zip(parts, zip(t, t[1:])):
                        parts[k].append((b - a) * 1e6)
        result["symbol"] = report("one data symbol, f32", parts, SYMBOLS - 1)
        result["symbol"]["demod back to back"] = back_to_back(
            lambda: sd.push_symbol_async(sym, slot=1))
    finally:
        slave.close()
        master.close()
    return result


def port_cli(module: str, args, timeout: float = 300) -> str:
    """Run ``python -m ofdm_ls_mrc_tpu_torch.<module> args`` from the
    checkout; its standard output, or a failure with both streams."""
    r = subprocess.run([sys.executable, "-m", f"ofdm_ls_mrc_tpu_torch.{module}", *args], cwd=REPO,
                       capture_output=True, text=True, timeout=timeout)
    require(r.returncode == 0, f"{module} {' '.join(args)} exited {r.returncode}:\n"
                               f"{r.stdout}\n{r.stderr}")
    return r.stdout


def run_tx(workdir: str, tag: str, frames: int, flags=()):
    """tx_app: frames of 16-QAM through the 16-tap 25 dB channel into a cf32
    capture (the default pilot and PN sequence: no files); returns the
    capture's path and the data sent [frames, S-1, F-1]."""
    none = os.path.join(workdir, "none.dat")
    cap, sent = os.path.join(workdir, f"{tag}.dat"), os.path.join(workdir, f"{tag}_sent.dat")
    t0 = time.perf_counter()
    out = port_cli("apps.tx_app", ["--out", cap, "--data-out", sent, "--pilots", none,
                                   "--pn-file", none, "--snr", "25", "--channel-taps", "16",
                                   "--modulation", "16qam", "--num-frames", str(frames),
                                   *GEOMETRY, *flags])
    print(f"tx {tag}: {out.splitlines()[-1]} in {time.perf_counter() - t0:.1f} s with start-up")
    return cap, np.fromfile(sent, np.complex64).reshape(frames, SYMBOLS - 1, FFT - 1)


def run_rx_demod(workdir: str, cap: str, frames: int, out: str, rx_flags=(), demod_flags=()):
    """rx_app as the sc16 ring master (PN sync, backpressure) and demod_app
    as its slave on the card, concurrently; returns both standard outputs.
    Stops both on any failure."""
    uid = f"/ofdm_smoke3_{uuid.uuid4().hex[:10]}"
    none = os.path.join(workdir, "none.dat")
    ring = ["--shm-uid", uid, "--ring-dtype", "sc16", "--num-frames", str(frames),
            "--timeout", "120", *GEOMETRY]
    mod = [sys.executable, "-m"]
    rx = subprocess.Popen(mod + ["ofdm_ls_mrc_tpu_torch.apps.rx_app", "--file", cap,
                                 "--thres", str(PN_THRES), "--pn-file", none, "--wait-writes",
                                 *ring, *rx_flags],
                          cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    dm = subprocess.Popen(mod + ["ofdm_ls_mrc_tpu_torch.apps.demod_app", "--output", out,
                                 "--pilots", none, *ring, *demod_flags],
                          cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        dm_out, dm_err = dm.communicate(timeout=300)
        rx_out, rx_err = rx.communicate(timeout=150)
    finally:
        for p in (dm, rx):
            if p.poll() is None:
                p.kill()
                p.wait()
    require(rx.returncode == 0, f"rx_app exited {rx.returncode}:\n{rx_out}\n{rx_err}")
    require(dm.returncode == 0, f"demod_app exited {dm.returncode}:\n{dm_out}\n{dm_err}")
    for line in rx_out.splitlines():
        if not line.startswith("RX ch "):
            print(f"rx: {line}")
    return rx_out, dm_out


def ring_golden(frames, golden):
    """golden.demod_frame of received frames [K, S, A, F+CP] after the ring's
    sc16 quantization, and the number of components that quantization
    clipped (counted by golden.io in this process)."""
    before = golden.io.sc16_clipped_samples()
    quant = golden.io.sc16_to_complex(golden.io.complex_to_sc16(frames)).reshape(frames.shape)
    clipped = golden.io.sc16_clipped_samples() - before
    pilot = golden.load_pilot(None, FFT - 1)
    return np.stack([golden.demod_frame(fr, pilot, CP) for fr in quant]), clipped


def payload_frames(rows, starts):
    """[K, S, A, F+CP] frames of a capture's [A, N] rows, frame k's payload
    starting at starts[k]."""
    n = SYMBOLS * (FFT + CP)
    return np.stack([rows[:, s0:s0 + n].reshape(ANTENNAS, SYMBOLS, FFT + CP).transpose(1, 0, 2)
                     for s0 in starts])


def producer_split(rows, golden, card) -> dict:
    """rx_app's host work for one frame of the capture, in this process:
    the [A, S*L] -> [S, A, L] burst copy and the complex64 -> sc16
    conversion its ring write does (medians of 5, ms)."""
    n = SYMBOLS * (FFT + CP)
    times = {"burst copy": [], "sc16 conversion": []}
    for _ in range(5):
        t0 = time.perf_counter()
        burst = np.ascontiguousarray(rows[:, :n].reshape(ANTENNAS, SYMBOLS, FFT + CP)
                                     .transpose(1, 0, 2))
        t1 = time.perf_counter()
        golden.io.complex_to_sc16(burst)
        t2 = time.perf_counter()
        times["burst copy"].append((t1 - t0) * 1e3)
        times["sc16 conversion"].append((t2 - t1) * 1e3)
    med = {k: float(np.median(v)) for k, v in times.items()}
    print("producer split, one frame (rx_app's host steps, medians of 5): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in med.items()) + f"  [{card}]")
    return med


def three_processes(workdir, card, golden, sim, dev, call_ms, device_ms) -> dict:
    """Phase 10 (see the module docstring); returns its records."""
    import torch

    from ofdm_ls_mrc_tpu_torch.io import native_sync
    from ofdm_ls_mrc_tpu_torch.ops.correlate import find_frame_start, pn_correlate
    from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray

    t_phase = time.perf_counter()
    rec = {}
    seq = golden.load_pn_sequence(None)
    per_frame = SYMBOLS * (FFT + CP)

    # tx_app -> rx_app (one-shot PN sync) -> demod_app whole frame -> compare_app
    cap, sent = run_tx(workdir, "capture", THREE_FRAMES, ["--pn-preamble"])
    out = os.path.join(workdir, "Output_three.dat")
    t0 = time.perf_counter()
    rx_out, dm_out = run_rx_demod(workdir, cap, THREE_FRAMES, out,
                                  ["--dump-aligned", "--file-prefix",
                                   os.path.join(workdir, "aligned")])
    print(f"tx-rx whole frame: rx_app and demod_app ran {time.perf_counter() - t0:.1f} s "
          "with start-up")
    m = re.search(r"^PN sync: start=(\d+) peak=([\d.]+) correlator=(\w+)$", rx_out, re.M)
    require(m is not None and m.group(3) == "native", f"rx_app PN sync line: {rx_out}")
    rx_start = int(m.group(1))
    rows = np.stack([np.fromfile(os.path.join(workdir, f"aligned_ch_{a}_binary"), np.complex64)
                     for a in range(ANTENNAS)])
    require(rows.shape == (ANTENNAS, THREE_FRAMES * per_frame), f"aligned dump {rows.shape}")
    rec["producer split"] = producer_split(rows, golden, card)
    gold, clipped = ring_golden(payload_frames(rows, range(0, rows.shape[1], per_frame)), golden)
    del rows
    print(f"sc16 clipped samples (the ring's quantization of rx_app's aligned frames): {clipped}")
    require(clipped == 0, f"the sc16 ring clipped {clipped} components")
    rec["tx-rx whole frame"] = check_live("tx-rx whole frame", dm_out, out, sent, gold,
                                          (THREE_FRAMES, THREE_FRAMES), card, golden, sim)
    rec["tx-rx whole frame"]["pn_start"], rec["tx-rx whole frame"]["pn_peak"] = (
        rx_start, float(m.group(2)))
    gold_path = os.path.join(workdir, "Output_golden.dat")
    golden.append_output(gold_path, gold.reshape(-1, FFT - 1), truncate=True)
    del gold
    for line in port_cli("apps.compare_app", [gold_path, out, "--subcarriers", str(FFT - 1),
                                              "--threshold-db", "-70"]).splitlines():
        print(f"compare_app (golden of the aligned dump vs demod_app): {line}")

    # tx --pn-every-frame, a slip -> rx --continuous-sync -> demod --per-symbol
    cap2, sent2 = run_tx(workdir, "stream", SYNC_FRAMES, ["--pn-every-frame"])
    rows = np.fromfile(cap2, np.complex64).reshape(ANTENNAS, -1)
    per = seq.size + per_frame
    cut = (SYNC_FRAMES // 2) * per
    junk = 0.01 * np.random.default_rng(5).standard_normal((ANTENNAS, SLIP)).astype(np.complex64)
    np.concatenate([rows[:, :cut], junk, rows[:, cut:]], axis=1).tofile(cap2)
    gold2, clipped2 = ring_golden(
        payload_frames(rows, [k * per + seq.size for k in range(SYNC_FRAMES)]), golden)
    del rows
    require(clipped2 == 0, f"the sc16 ring clipped {clipped2} components (continuous leg)")
    out2 = os.path.join(workdir, "Output_stream.dat")
    t0 = time.perf_counter()
    rx_out, dm_out = run_rx_demod(workdir, cap2, SYNC_FRAMES, out2,
                                  ["--continuous-sync", "--frame-size", "16384"], ["--per-symbol"])
    print(f"tx-rx continuous per-symbol: rx_app and demod_app ran "
          f"{time.perf_counter() - t0:.1f} s with start-up; {SLIP} samples inserted before "
          f"frame {SYNC_FRAMES // 2}'s PN")
    m = re.search(r"continuous sync: (\d+) frame\(s\) \((\d+) symbols\), resyncs=(\d+) "
                  r"drift_corrections=(\d+) dropped=(\d+)", rx_out)
    require(m is not None and int(m.group(1)) == SYNC_FRAMES and int(m.group(4)) >= 1
            and int(m.group(5)) == 0,
            f"rx_app --continuous-sync: want {SYNC_FRAMES} frames, a drift correction, "
            f"no drop:\n{rx_out}")
    rec["tx-rx continuous per-symbol"] = check_live(
        "tx-rx continuous per-symbol", dm_out, out2, sent2, gold2,
        (SYNC_FRAMES, SYNC_FRAMES * (SYMBOLS - 1)), card, golden, sim)
    rec["tx-rx continuous per-symbol"].update(resyncs=int(m.group(3)),
                                              drift_corrections=int(m.group(4)))
    del gold2

    # ops/correlate on the card over antenna 0 of the first capture.
    n = os.path.getsize(cap) // 8 // ANTENNAS
    x0 = np.fromfile(cap, np.complex64, count=n)
    xd = CArray.from_numpy(x0, dev)
    mags = pn_correlate(xd, seq).cpu().numpy()
    want = np.abs(np.correlate(x0, np.conj(seq), mode="valid")) / seq.size
    err = float(np.max(np.abs(mags - want)))
    require(np.allclose(mags, want, **CORR_TOL),
            f"pn_correlate vs the sliding dot: max-abs {err:.3e}, beyond {CORR_TOL}")
    start, peak = find_frame_start(xd, seq, PN_THRES)
    require(start == rx_start, f"find_frame_start {start}, rx_app's PN sync start={rx_start}")
    calls = {"pn_correlate": lambda: pn_correlate(xd, seq),
             "find_frame_start": lambda: find_frame_start(xd, seq, PN_THRES)}
    dev_t, call_t = {}, {}
    for name, fn in calls.items():
        d = device_ms(fn, 20)
        dev_t[name] = d["ms"]
        call_t[name] = call_ms(fn, 20)
        print(f"time {name} ({n - seq.size + 1} lags): device {us(d['ms'], d['partial'])} a call "
              f"(torch.profiler, 20 calls), per call {call_t[name] * 1e3:.2f} us (CUDA events, "
              f"20 calls)  [{card}]")
        for key, ms in sorted(d["split"].items(), key=lambda kv: -kv[1])[:8]:
            print(f"    {ms * 1e3:9.2f} us/call  {key[:90]}")
    t0 = time.perf_counter()
    native_sync.corr_mags(x0, seq)
    host_mags_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    native_sync.corr_first(x0, seq, PN_THRES)
    host_first_ms = (time.perf_counter() - t0) * 1e3
    rec["correlate"] = {"samples": n, "max_abs_err": err, "start": start, "peak": peak,
                        "pn_correlate_device_ms": dev_t["pn_correlate"],
                        "find_frame_start_device_ms": dev_t["find_frame_start"],
                        "pn_correlate_call_ms": call_t["pn_correlate"],
                        "find_frame_start_call_ms": call_t["find_frame_start"],
                        "native_corr_mags_ms": host_mags_ms, "native_corr_first_ms": host_first_ms}
    print(f"correlate: antenna 0 of the capture, {n} samples x {seq.size} chips: pn_correlate "
          f"max-abs {err:.3e} vs the NumPy sliding dot; find_frame_start {start} (peak "
          f"{peak:.4f}) = rx_app's start")
    print(f"time correlate on the host: native corr_mags {host_mags_ms:.2f} ms over the same "
          f"lags, corr_first {host_first_ms:.4f} ms (stops at lag {start})  [{card}]")
    del xd, x0, mags, want
    torch.cuda.empty_cache()

    # The port's gate on the card.
    t0 = time.perf_counter()
    gate_out = port_cli("tools.gate", [])
    for line in gate_out.splitlines():
        print(f"gate: {line}  [{card}]")
    gate_launches = json.loads(next(ln for ln in gate_out.splitlines()
                                    if ln.startswith("[gate] kernel launches "))
                               [len("[gate] kernel launches "):])
    require(gate_out.splitlines()[-1] == "[gate] ALL PASS", "the port's gate did not pass")
    require(gate_launches == {"pilot_ls": 1, "fft_mrc": 1, "pilot_ls_sum": 0,
                              "pilot_ls_bf16": 0, "fft_mrc_bf16": 0},
            f"the gate's demod launched {gate_launches}, want pilot_ls and fft_mrc once")
    sweep = [ln for ln in gate_out.splitlines()
             if ln.startswith("[sweep]") or ln.startswith("[gate] accuracy sweep")]
    require(sum(ln.startswith("[gate] accuracy sweep") and ln.endswith("PASS")
                for ln in sweep) == 2, "the gate's accuracy sweep did not pass both leg sets")
    rec["gate"] = {"launches": gate_launches, "seconds": time.perf_counter() - t0,
                   "sweep": sweep}
    print(f"phase 10 (three processes): {time.perf_counter() - t_phase:.1f} s")
    return rec


def run_ranks(wire, pilot_path: str, out: str, store: str) -> list:
    """Leg (b) of phase 13: be the master of one sc16 ring per rank (that
    rank's antennas of every frame), run ``demod_app --distributed`` as
    SHARD_RANKS processes on the one card over gloo, wait for all; returns
    each rank's standard output.  Kills every rank and stops the writers
    on any failure or at the wall limit."""
    from ofdm_ls_mrc_tpu_torch.io.ring import SymbolRing

    a_local = SHARD_ANTENNAS // SHARD_RANKS
    uids = [f"/ofdm_smoke_{uuid.uuid4().hex[:8]}_{i}" for i in range(SHARD_RANKS)]
    masters = [SymbolRing(u, a_local, FFT + CP, SYMBOLS, master=True, timeout=120.0,
                          dtype="sc16") for u in uids]
    errors = []

    def produce(i):
        try:
            for frame in wire:
                masters[i].write_batch(np.ascontiguousarray(
                    frame[:, i * a_local:(i + 1) * a_local]), wait=True)
            if not masters[i].wait_drained(120.0):
                errors.append(f"rank {i} did not drain its ring")
        except Exception as e:  # reported by the caller
            errors.append(repr(e))

    cmds = [[sys.executable, "-m", "ofdm_ls_mrc_tpu_torch.apps.demod_app",
             "--distributed", f"file://{store}", "--num-processes", str(SHARD_RANKS),
             "--process-id", str(i), "--backend", "gloo", "--shm-uid", uids[i],
             "--antennas", str(SHARD_ANTENNAS), "--fft-size", str(FFT), "--cp-size", str(CP),
             "--frame-len", str(SYMBOLS), "--ring-dtype", "sc16", "--sc16-native",
             "--num-frames", str(len(wire)), "--pilots", pilot_path, "--output", out,
             "--timeout", "120"] for i in range(SHARD_RANKS)]
    apps = [subprocess.Popen(c, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True) for c in cmds]
    writers = [threading.Thread(target=produce, args=(i,), daemon=True)
               for i in range(SHARD_RANKS)]
    for w in writers:
        w.start()
    outs = []
    try:
        deadline = time.monotonic() + 300
        for app in apps:
            outs.append(app.communicate(timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for app in apps:
            if app.poll() is None:
                app.kill()
                app.wait()
        for m in masters:
            m.shutdown()            # unblocks a writer whose rank is gone
        for w in writers:
            w.join(timeout=30)
        for m in masters:
            m.close()
    for i, (app, (stdout, stderr)) in enumerate(zip(apps, outs)):
        require(app.returncode == 0,
                f"demod_app --distributed rank {i} exited {app.returncode}:\n{stdout}\n{stderr}")
        for line in (stdout + stderr).splitlines():
            print(f"rank {i}: {line}")
    require(not errors, f"ring producers: {errors}")
    return [stdout for stdout, _ in outs]


def app_json(stdout: str, prefix: str) -> dict:
    return json.loads(next(ln for ln in stdout.splitlines()
                           if ln.startswith(prefix))[len(prefix):])


def sharded_phase(workdir, dev, card, golden, sim, reset_counts, counts, measure, call_ms,
                  device_ms) -> tuple:
    """Phase 13 (see the module docstring).  Returns its records and the
    kernel record's numbers of the pilot's sum|h|^2 variant."""
    import torch

    from ofdm_ls_mrc_tpu_torch import FrameConfig, parallel
    from ofdm_ls_mrc_tpu_torch.models import DownlinkTransmitter, UplinkReceiver
    from ofdm_ls_mrc_tpu_torch.ops import pipeline as pipe
    from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray
    from ofdm_ls_mrc_tpu_torch.parallel import collectives

    t_phase = time.perf_counter()
    rec = {}
    pilot_path = os.path.join(workdir, "Pilots.dat")
    golden.write_pilot(pilot_path, np.exp(2j * np.pi * np.random.default_rng(13).random(
        FFT - 1)).astype(np.complex64))
    pilot = golden.load_pilot(pilot_path, FFT - 1)
    t0 = time.perf_counter()
    wire, sent, gold = live_frames(golden, sim, pilot, SHARD_FRAMES, SHARD_ANTENNAS, 14, 19)
    print(f"phase 13: {SHARD_FRAMES} frames of {SHARD_ANTENNAS}x{FFT}x{SYMBOLS} made in "
          f"{time.perf_counter() - t0:.1f} s")
    # (a) BASELINE config 4: frame 0 as sc16 planes, cp stripped on the host.
    planes = [np.ascontiguousarray(wire[0][..., k::2][..., CP:]) for k in (0, 1)]
    frame = CArray(*(torch.from_numpy(p).to(dev) for p in planes))
    cfg = FrameConfig(num_antennas=SHARD_ANTENNAS, fft_size=FFT, cyclic_prefix=0,
                      frame_len=SYMBOLS)
    parallel.initialize(f"file://{os.path.join(workdir, 'nccl_store')}", 1, 0, "nccl")
    try:
        mesh = parallel.make_mesh(1, 1)
        srx = parallel.ShardedUplinkReceiver(cfg, pilot, mesh, device=dev)
        urx = UplinkReceiver(cfg, pilot, device=dev)
        srx.warmup()
        torch.cuda.synchronize()
        reset_counts()
        collectives.reset()
        out = srx.demod_frame(frame).to_numpy()
        torch.cuda.synchronize()
        launches, sig = counts(), collectives.signature()
        words = parallel.expected_payload_words(cfg)
        unsharded = urx.demod_frame(frame).to_numpy()
        evm = sim.evm_db(np.fft.fftshift(out, axes=-1), sent[0])
        rel_g, rel_u = max_rel(out, gold[0]), max_rel(out, unsharded)
        print(f"sharded config 4 ({SHARD_ANTENNAS}x{FFT}x{SYMBOLS} sc16, cp stripped, world 1, "
              f"nccl): shape {out.shape}  EVM {evm:.2f} dB  max-rel vs golden {rel_g:.3e}, vs "
              f"UplinkReceiver(fused) {rel_u:.3e}  launches {launches}  all-reduce {sig} "
              f"(want (1, {words}))")
        require(out.shape == (SYMBOLS - 1, FFT - 1) and np.all(np.isfinite(out)),
                f"sharded config 4: bad output, shape {out.shape}")
        require(evm < EVM_MAX_DB, f"sharded config 4: EVM {evm:.2f} dB >= {EVM_MAX_DB}")
        require(rel_g < GOLDEN_TOL, f"sharded config 4: max-rel vs golden {rel_g:.3e}")
        require(rel_u < KERNEL_TOL, f"sharded config 4: max-rel vs unsharded {rel_u:.3e}")
        require(launches["pilot_ls_sum"] > 0 and launches["fft_mrc"] > 0
                and launches["pilot_ls"] == 0,
                f"sharded config 4 did not run pilot_ls_sum and fft_mrc: {launches}")
        require(sig == (1, words), f"sharded config 4: all-reduce {sig}, want (1, {words})")
        rec["config 4"] = {"evm_db": evm, "max_rel_golden": rel_g, "max_rel_unsharded": rel_u,
                           "launches": {k: launches[k] for k in ("pilot_ls_sum", "fft_mrc")},
                           "all_reduce": list(sig)}
        # The sum|h|^2 variant against its plain version: this pilot (int16)
        # and a 64-antenna f32 pilot read in place at cp 72.
        x = srx.x_full
        r15 = np.random.default_rng(15)
        f32 = CArray.from_numpy((0.1 * (r15.standard_normal((SHARD_ANTENNAS, FFT + CP)) + 1j
                                        * r15.standard_normal((SHARD_ANTENNAS, FFT + CP)))
                                 ).astype(np.complex64), dev)[:, CP:]
        errs, rels = [], []
        for label, y in (("int16 cp stripped", frame[0]), ("f32 cp 72", f32)):
            h_k, s_k = pipe.estimate_pilot_fused(y, x, invert=False)
            h_p, s_p = pipe.estimate_pilot_plain(y, x, invert=False)
            torch.cuda.synchronize()
            pairs = [(h_k.to_numpy(), h_p.to_numpy()), (s_k.cpu().numpy(), s_p.cpu().numpy())]
            rel = max(max_rel(k, p) for k, p in pairs)
            errs.append(max(max_abs(k, p) for k, p in pairs))
            rels.append(rel)
            print(f"check pilot_ls_sum {SHARD_ANTENNAS}x{FFT} {label}: max-rel {rel:.3e}  "
                  f"max-abs {errs[-1]:.3e}")
            require(rel < KERNEL_TOL, f"pilot_ls_sum {label}: max-rel {rel:.3e} >= {KERNEL_TOL}")
        pc = torch.complex(frame[0].re.float(), frame[0].im.float())
        t_var = measure(lambda: pipe.estimate_pilot_fused(frame[0], x, invert=False),
                        lambda: pipe.estimate_pilot_plain(frame[0], x, invert=False), 200,
                        lambda: torch.fft.fft(pc, dim=-1))
        del pc
        v_ms, v_src = timed(t_var)
        v_bytes = SHARD_ANTENNAS * FFT * 4 + FFT * 8 + SHARD_ANTENNAS * FFT * 8 + FFT * 4
        v_bound, v_by = bound_ms(v_bytes, fft_flops(SHARD_ANTENNAS, FFT) + 15.0 * SHARD_ANTENNAS * FFT)
        print(f"time pilot_ls_sum ({SHARD_ANTENNAS}x{FFT} sc16 pilot): device {us(v_ms)} "
              f"({v_src}); plain {us(timed(t_var, 'plain')[0])}, torch.fft.fft of its rows "
              f"{us(timed(t_var, 'library')[0])}; bound {v_bound * 1e3:.2f} us ({v_by})  [{card}]")
        variant = {"launches": launches["pilot_ls_sum"], "max_abs_err": max(errs),
                   "ms": v_ms, "plain_ms": timed(t_var, "plain")[0],
                   "library_ms": timed(t_var, "library")[0], "bound_ms": v_bound,
                   "bound_by": v_by, "time_source": {k: timed(t_var, w)[1] for k, w in (
                       ("ms", "kernel"), ("plain_ms", "plain"), ("library_ms", "library"))},
                   "shape": f"{SHARD_ANTENNAS}x{FFT} sc16 pilot, one frame"}
        # Device time of the sharded frame beside the unsharded one; the
        # all-reduce's share.
        d_s, d_u = (device_ms(lambda r=r: r.demod_frame(frame), 20) for r in (srx, urx))
        c_s, c_u = (call_ms(lambda r=r: r.demod_frame(frame), 20) for r in (srx, urx))
        ar = sum(v for k, v in d_s["split"].items() if "nccl" in k.lower() or "allreduce" in k.lower())
        share = None if not d_s["ms"] else ar / d_s["ms"]
        print(f"time sharded config 4 frame: device {us(d_s['ms'], d_s['partial'])}, per call "
              f"{c_s * 1e3:.2f} us; unsharded UplinkReceiver device {us(d_u['ms'], d_u['partial'])}"
              f", per call {c_u * 1e3:.2f} us; all-reduce {ar * 1e3:.2f} us"
              + ("" if share is None else f" ({share:.1%} of the sharded frame's device time)")
              + f"  [{card}]")
        for key, v in sorted(d_s["split"].items(), key=lambda kv: -kv[1])[:5]:
            print(f"    {v * 1e3:9.2f} us/call  {key[:90]}")
        rec["config 4"].update({"device_ms": d_s["ms"], "call_ms": c_s,
                                "unsharded_device_ms": d_u["ms"], "unsharded_call_ms": c_u,
                                "all_reduce_ms": ar, "all_reduce_share": share,
                                "partial": d_s["partial"] or d_u["partial"]})

        # (c) the streaming path over the same frame, symbol by symbol.
        sd = parallel.ShardedStreamingDemodulator(cfg, pilot, mesh, device=dev)
        torch.cuda.synchronize()
        reset_counts()
        collectives.reset()
        host_us = []
        sd.push_pilot(frame[0])
        rows = []
        for i in range(1, SYMBOLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows.append(sd.push_symbol(frame[i], slot=i).to_numpy())
            host_us.append((time.perf_counter() - t0) * 1e6)
        stream_launches, stream_sig = counts(), collectives.signature()
        rel = max_rel(np.stack(rows), out)
        pilot_w, sym_w = parallel.expected_streaming_words(cfg)
        want_sig = (SYMBOLS, pilot_w + (SYMBOLS - 1) * sym_w)
        print(f"sharded streaming config 4: {SYMBOLS - 1} symbols, max-rel vs the sharded frame "
              f"{rel:.3e}, launches {stream_launches}, all-reduce {stream_sig}; per symbol (push, "
              f"all-reduce, D2H) host clock p50 {np.percentile(host_us, 50):.2f} us p99 "
              f"{np.percentile(host_us, 99):.2f} us  [{card}]")
        require(rel < KERNEL_TOL, f"sharded streaming: max-rel {rel:.3e} >= {KERNEL_TOL}")
        require(stream_launches["pilot_ls_sum"] == 1
                and stream_launches["fft_mrc"] == SYMBOLS - 1,
                f"sharded streaming launches {stream_launches}")
        require(stream_sig == want_sig, f"sharded streaming all-reduce {stream_sig} != {want_sig}")
        rec["streaming"] = {"max_rel": rel, "all_reduce": list(stream_sig),
                            "p50_us": float(np.percentile(host_us, 50)),
                            "p99_us": float(np.percentile(host_us, 99)),
                            "launches": {k: stream_launches[k] for k in ("pilot_ls_sum", "fft_mrc")}}

        # (d) the sharded downlink at world size 1 on dl_app's geometry.
        u, a = DL_RUNS["4 users x 16 antennas, cf32"][:2]
        dcfg = FrameConfig(num_antennas=a, fft_size=FFT, cyclic_prefix=DL_CP, frame_len=DL_SYMBOLS)
        rng = np.random.default_rng(0)
        h = ((rng.standard_normal((FFT - 1, u, a)) + 1j * rng.standard_normal((FFT - 1, u, a)))
             / np.sqrt(2)).astype(np.complex64)
        xs = np.exp(2j * np.pi * rng.random((u, FFT - 1))).astype(np.complex64)
        tx = parallel.ShardedDownlinkTransmitter(dcfg, mesh, device=dev)
        one = DownlinkTransmitter(dcfg, device=dev)
        ant = tx.precode(h, xs, gather=True)
        td = tx.modulate(ant, gather=True).to_numpy()
        err_one = max(max_abs(ant.to_numpy(), one.precode(h, xs).to_numpy()),
                      max_abs(td, one.modulate(ant).to_numpy()))
        err_np = max_abs(td, golden_downlink(golden, h, xs[:, None], DL_CP))
        print(f"sharded downlink ({u} users x {a} antennas x {FFT}, cp {DL_CP}, world 1): "
              f"max-abs {err_one:.3e} vs DownlinkTransmitter, {err_np:.3e} vs the NumPy chain")
        require(err_one < 1e-6 and err_np <= DL_TOL,
                f"sharded downlink: max-abs {err_one:.3e} / {err_np:.3e}")
        rec["downlink"] = {"max_abs_unsharded": err_one, "max_abs_numpy": err_np}
        del srx, urx, sd, frame, f32
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # (b) two ranks on the one card over gloo, each fed by its own ring.
    out_path = os.path.join(workdir, "Output_dist.dat")
    t0 = time.perf_counter()
    stdouts = run_ranks(wire, pilot_path, out_path, os.path.join(workdir, "gloo_store"))
    wall = time.perf_counter() - t0
    got = golden.read_output(out_path, FFT - 1)
    rel_g = max_rel(got, np.concatenate(list(gold)))
    rel_a = max_rel(got[:SYMBOLS - 1], out)
    index = [ln.split() for ln in open(out_path + ".index").read().splitlines()]
    per_rank = [(app_json(o, "kernel launches "), app_json(o, "all-reduce ")) for o in stdouts]
    fps = float(re.search(r"([\d.]+) frames/s", stdouts[0]).group(1))
    print(f"sharded two ranks (gloo, one H100): {len(index)} frames, max-rel vs golden "
          f"{rel_g:.3e}, frame 0 vs leg (a) {rel_a:.3e}; per rank launches "
          f"{[lc for lc, _ in per_rank]}, all-reduce {[ar for _, ar in per_rank]}; rank 0 "
          f"{fps} frames/s (two ranks on one H100 over gloo), {wall:.1f} s with start-up  [{card}]")
    require(got.shape == (SHARD_FRAMES * (SYMBOLS - 1), FFT - 1), f"two ranks: output {got.shape}")
    require(rel_g < GOLDEN_TOL, f"two ranks: max-rel vs golden {rel_g:.3e}")
    require(rel_a < KERNEL_TOL, f"two ranks: frame 0 vs leg (a) {rel_a:.3e}")
    require(len(index) == SHARD_FRAMES and all(ln[1] == "clean" for ln in index),
            f"two ranks: index {index}")
    for lc, ar in per_rank:
        require(lc["pilot_ls_sum"] == SHARD_FRAMES and lc["fft_mrc"] == SHARD_FRAMES
                and ar["all_reduce"] == SHARD_FRAMES, f"two ranks: launches {lc}, all-reduce {ar}")
    rec["two ranks gloo"] = {"max_rel_golden": rel_g, "max_rel_leg_a": rel_a,
                             "frames_per_s_rank0": fps, "seconds": wall,
                             "launches": [lc for lc, _ in per_rank]}
    print(f"phase 13 (sharded paths): {time.perf_counter() - t_phase:.1f} s")
    return rec, variant


def speed_work(name: str, a: int, f: int, s: int, in_bytes: int = 8) -> tuple:
    """(bytes, float32 FLOPs, bf16 tensor FLOPs) of one frame's call of a
    speed kernel, ``in_bytes`` a complex input sample (8 f32, 4 sc16): each
    input read once, each output written once; stage 1 is the n1-point DFT
    (5 n1 log2 n1 a column) and the twiddle, stage 2 the [2 n1, 128] x
    [128, 256] bf16 product of each row."""
    n1 = f // 128
    rows = a if name == "pilot_ls_bf16" else s * a
    tensor = rows * 2 * n1 * 128 * 256 * 2.0
    stage1 = rows * (5.0 * f * math.log2(n1) + 6.0 * f)
    if name == "pilot_ls_bf16":
        return a * f * in_bytes + f * 8 + a * f * 8 + f * 4, stage1 + 15.0 * a * f, tensor
    return (s * a * f * in_bytes + a * f * 8 + f * 4 + s * (f - 1) * 8,
            stage1 + 8.0 * s * a * f + 2.0 * s * f, tensor)


def speed_bound_ms(nbytes: float, flops: float, tensor_flops: float) -> tuple:
    """(least time in ms, 'bytes' or 'operations', each part in ms): the
    largest of the bytes at 3.35 TB/s, the float32 FLOPs at 67 TFLOP/s and
    the bf16 tensor FLOPs at 989 TFLOP/s (the published peaks)."""
    parts = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "fp32": flops / FP32_FLOPS * 1e3,
             "bf16 tensor": tensor_flops / BF16_TENSOR_FLOPS * 1e3}
    by = max(parts, key=parts.get)
    return parts[by], ("bytes" if by == "bytes" else "operations"), parts


def speed_phase(workdir, dev, card, golden, sim, reset_counts, counts, measure, device_ms,
                gate) -> tuple:
    """Phase 14 (see the module docstring); ``gate`` is phase 10's record of
    the port's gate.  Returns the phase's records and the kernel records of
    the two speed kernels."""
    import torch

    from ofdm_ls_mrc_tpu_torch import FrameConfig, parallel
    from ofdm_ls_mrc_tpu_torch.models import UplinkReceiver
    from ofdm_ls_mrc_tpu_torch.ops import fft_plan
    from ofdm_ls_mrc_tpu_torch.ops import pipeline as pipe
    from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray

    t_phase = time.perf_counter()
    rec, errs = {}, {name: 0.0 for name in SPEED_KERNELS}

    def agree(name, label, kernel, plain, exact):
        """The speed criterion: EVM of the kernel against its plain version
        SPEED_GAP_DB below the plain version's against the exact path, and
        max-rel under SPEED_REL."""
        e_kp, e_pe, rel = evm_db(kernel, plain), evm_db(plain, exact), max_rel(kernel, plain)
        errs[name] = max(errs[name], max_abs(kernel, plain))
        print(f"check {name} {label}: EVM vs plain {e_kp:.2f} dB, plain vs exact {e_pe:.2f} dB, "
              f"max-rel vs plain {rel:.3e}")
        require(e_kp <= e_pe - SPEED_GAP_DB and rel < SPEED_REL,
                f"{name} {label}: EVM {e_kp:.2f} dB vs plain (plain vs exact {e_pe:.2f} dB), "
                f"max-rel {rel:.3e}")

    def hold(label, x, pilot_rows, data_rows):
        """(a): both kernels against their plain versions on these rows."""
        h_k, inv_k = pipe.estimate_pilot_fused(pilot_rows, x, exact=False)
        h_p, inv_p = pipe.estimate_pilot_speed_plain(pilot_rows, x)
        h_e, inv_e = pipe.estimate_pilot_plain(pilot_rows, x)
        torch.cuda.synchronize()
        agree("pilot_ls_bf16", f"{label} h", h_k.to_numpy(), h_p.to_numpy(), h_e.to_numpy())
        agree("pilot_ls_bf16", f"{label} sum|h|^2", *(1 / v.cpu().numpy()
                                                      for v in (inv_k, inv_p, inv_e)))
        out = [fn(data_rows, h_e, inv_e).to_numpy() for fn in (
            lambda *a: pipe.fused_pipeline(*a, exact=False), pipe.fused_pipeline_speed_plain,
            pipe.fused_pipeline_plain)]
        agree("fft_mrc_bf16", label, *out)
        return h_e, inv_e

    # The main path's frame (phase 4's seeds): 16 x 1024 x 101 f32, cp 72,
    # 16-QAM through the 16-tap 25 dB channel.
    cfg = FrameConfig(num_antennas=ANTENNAS, fft_size=FFT, cyclic_prefix=CP, frame_len=SYMBOLS)
    rng = np.random.default_rng(7)
    data, _ = sim.random_symbols(rng, (cfg.num_data_symbols, cfg.num_subcarriers), "16qam")
    pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)).astype(np.complex64)
    rx_frame = sim.ChannelModel(ANTENNAS, FFT, num_taps=16, snr_db=25.0, seed=9).apply(
        sim.make_tx_frame(data, pilot, CP), CP)
    gold = golden.demod_frame(rx_frame, pilot, CP)
    frame = CArray.from_numpy(rx_frame, dev)
    rx = UplinkReceiver(cfg, pilot, exact=False, device=dev)
    y = frame[..., CP:]
    h_e, inv_e = hold(f"{ANTENNAS}x{FFT}x{SYMBOLS} f32 cp {CP}", rx.x_full, y[0], y[1:])
    # bench.py's capture (phase 8's): 20 sc16 frames, cp stripped on the host.
    crng = np.random.default_rng(0)
    cap_pilot = np.exp(2j * np.pi * crng.random(FFT - 1)).astype(np.complex64)
    shape = (CAPTURE_FRAMES, SYMBOLS, ANTENNAS, FFT + CP)
    payload = (crng.standard_normal(shape) + 1j * crng.standard_normal(shape))[..., CP:]
    cap = CArray(torch.from_numpy(golden.io.plane_to_sc16(payload.real)).to(dev),
                 torch.from_numpy(golden.io.plane_to_sc16(payload.imag)).to(dev))
    del payload
    cfg0 = FrameConfig(num_antennas=ANTENNAS, fft_size=FFT, cyclic_prefix=0, frame_len=SYMBOLS)
    rx_cap = UplinkReceiver(cfg0, cap_pilot, exact=False, device=dev)
    hold(f"{CAPTURE_FRAMES} sc16 frames (the capture)", rx_cap.x_full, cap[:, 0], cap[:, 1:])
    # The other sizes the kernels take at their ends, F = 256 and 4096: one
    # 16 x F x 101 frame, f32 (cp 72) and int16 (cp 0), and its timing rows.
    other = {}
    for f_o in SPEED_OTHER_FFT:
        orng = np.random.default_rng(f_o)
        z = 0.1 * (orng.standard_normal((SYMBOLS, ANTENNAS, f_o + CP))
                   + 1j * orng.standard_normal((SYMBOLS, ANTENNAS, f_o + CP)))
        x_o = UplinkReceiver(FrameConfig(num_antennas=ANTENNAS, fft_size=f_o, cyclic_prefix=CP,
                                         frame_len=SYMBOLS),
                             np.exp(2j * np.pi * orng.random(f_o - 1)).astype(np.complex64),
                             exact=False, device=dev).x_full
        y_o = CArray.from_numpy(z.astype(np.complex64), dev)[..., CP:]
        z16 = z[..., CP:]
        y16 = CArray(torch.from_numpy(golden.io.plane_to_sc16(z16.real)).to(dev),
                     torch.from_numpy(golden.io.plane_to_sc16(z16.imag)).to(dev))
        h_o, inv_o = hold(f"{ANTENNAS}x{f_o}x{SYMBOLS} f32 cp {CP}", x_o, y_o[0], y_o[1:])
        hold(f"{ANTENNAS}x{f_o}x{SYMBOLS} int16 cp 0", x_o, y16[0], y16[1:])
        other[f_o] = (x_o, y_o, h_o, inv_o)

    def path(label, fn, want, zero=()):
        """(b): counts set to 0 just before the path and read just after."""
        torch.cuda.synchronize()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        got = counts()
        print(f"speed {label}: launches {got}")
        for k, n in want.items():
            require(got[k] == n, f"speed {label}: {k} launched {got[k]} times, want {n}")
        for k in zero:
            require(got[k] == 0, f"speed {label}: {k} launched {got[k]} times, want 0")
        return out, got

    # (b, c) UplinkReceiver(exact=False) on the main frame: through the
    # channel, against the golden and the sent symbols.
    out, launches = path("main path (UplinkReceiver(exact=False).demod_frame)",
                         lambda: rx.demod_frame(frame).to_numpy(),
                         {"pilot_ls_bf16": 1, "fft_mrc_bf16": 1}, ("pilot_ls", "fft_mrc"))
    e_gold, e_sent = evm_db(out, gold), sim.evm_db(np.fft.fftshift(out, axes=-1), data)
    print(f"speed main path: shape {out.shape}, EVM vs golden {e_gold:.2f} dB, vs sent "
          f"{e_sent:.2f} dB  [{card}]")
    require(out.shape == (SYMBOLS - 1, FFT - 1) and np.all(np.isfinite(out)),
            f"speed main path: bad output, shape {out.shape}")
    require(e_gold <= SPEED_GOLDEN_EVM_DB, f"speed main path: EVM vs golden {e_gold:.2f} dB")
    require(e_sent < EVM_MAX_DB, f"speed main path: EVM vs sent {e_sent:.2f} dB")
    rec["main path"] = {"evm_golden_db": e_gold, "evm_sent_db": e_sent,
                        "launches": {k: launches[k] for k in SPEED_KERNELS}}
    cap_out, cap_launches = path("demod_capture (20 sc16 frames)",
                                 lambda: rx_cap.demod_capture(cap).to_numpy(),
                                 {"pilot_ls_bf16": 1, "fft_mrc_bf16": 1}, ("pilot_ls", "fft_mrc"))
    rel = max_rel(cap_out[3], rx_cap.demod_frame(cap[3]).to_numpy())
    require(cap_out.shape == (CAPTURE_FRAMES, SYMBOLS - 1, FFT - 1) and rel < 1e-6,
            f"speed demod_capture: shape {cap_out.shape}, frame 3 vs demod_frame {rel:.3e}")
    rec["demod_capture"] = {"launches": {k: cap_launches[k] for k in SPEED_KERNELS}}

    # (b, c) the sharded receiver at world size 1 over NCCL on BASELINE
    # config 4 (as phase 13) and its streaming module.
    pilot4 = np.exp(2j * np.pi * np.random.default_rng(13).random(FFT - 1)).astype(np.complex64)
    wire4, sent4, gold4 = live_frames(golden, sim, pilot4, 1, SHARD_ANTENNAS, 14, 19)
    frame4 = CArray(*(torch.from_numpy(np.ascontiguousarray(wire4[0][..., k::2][..., CP:])).to(dev)
                      for k in (0, 1)))
    cfg4 = FrameConfig(num_antennas=SHARD_ANTENNAS, fft_size=FFT, cyclic_prefix=0,
                       frame_len=SYMBOLS)
    parallel.initialize(f"file://{os.path.join(workdir, 'speed_store')}", 1, 0, "nccl")
    try:
        mesh = parallel.make_mesh(1, 1)
        srx = parallel.ShardedUplinkReceiver(cfg4, pilot4, mesh, exact=False, device=dev)
        srx.warmup()
        out4, l4 = path("sharded config 4 (world 1, nccl)", lambda: srx.demod_frame(frame4).to_numpy(),
                        {"pilot_ls_sum": 1, "fft_mrc_bf16": 1},
                        ("pilot_ls", "fft_mrc", "pilot_ls_bf16"))
        e4_gold = evm_db(out4, gold4[0])
        e4_sent = sim.evm_db(np.fft.fftshift(out4, axes=-1), sent4[0])
        print(f"speed sharded config 4: EVM vs golden {e4_gold:.2f} dB, vs sent {e4_sent:.2f} dB"
              f"  [{card}]")
        require(e4_gold <= SPEED_GOLDEN_EVM_DB and e4_sent < EVM_MAX_DB,
                f"speed sharded config 4: EVM {e4_gold:.2f} / {e4_sent:.2f} dB")
        sd = parallel.ShardedStreamingDemodulator(cfg4, pilot4, mesh, exact=False, device=dev)

        def stream():
            sd.push_pilot(frame4[0])
            return np.stack([sd.push_symbol(frame4[i]).to_numpy() for i in range(1, SYMBOLS)])

        rows, ls4 = path("sharded streaming config 4", stream,
                         {"pilot_ls_sum": 1, "fft_mrc_bf16": SYMBOLS - 1},
                         ("pilot_ls", "fft_mrc", "pilot_ls_bf16"))
        rel = max_rel(rows, out4)
        print(f"speed sharded streaming: max-rel vs the sharded frame {rel:.3e}")
        require(rel < KERNEL_TOL, f"speed sharded streaming vs frame: max-rel {rel:.3e}")
        rec["sharded config 4"] = {"evm_golden_db": e4_gold, "evm_sent_db": e4_sent,
                                   "launches": {k: l4[k] for k in ("pilot_ls_sum", "fft_mrc_bf16")}}
        rec["sharded streaming"] = {"max_rel_frame": rel, "launches": {
            k: ls4[k] for k in ("pilot_ls_sum", "fft_mrc_bf16")}}
        del srx, sd
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()

    # (d) the app on phase 9's ring shape: bf16 whole frame and batched; per
    # symbol bf16 runs the exact kernels and says so.
    pilot_path = os.path.join(workdir, "Pilots.dat")
    golden.write_pilot(pilot_path, np.exp(2j * np.pi * np.random.default_rng(12).random(
        FFT - 1)).astype(np.complex64))
    wire, sent, lgold = live_frames(golden, sim, golden.load_pilot(pilot_path, FFT - 1))
    bf16 = ("--kernel-precision", "bf16")
    for label, flags, want in (("whole frame bf16", bf16, (LIVE_FRAMES, LIVE_FRAMES)),
                               ("batch 10 sc16-native bf16",
                                ("--batch-frames", "10", "--sc16-native", *bf16), (2, 2))):
        out_path = os.path.join(workdir, f"Output_{label.replace(' ', '_')}.dat")
        rec[f"app {label}"] = r = check_live(
            label, run_live_app(flags, wire, pilot_path, out_path), out_path, sent, lgold, want,
            card, golden, sim, kernels=SPEED_KERNELS, gold_evm_max=SPEED_GOLDEN_EVM_DB)
        require(r["launches"]["pilot_ls"] == r["launches"]["fft_mrc"] == 0,
                f"app {label}: the exact kernels ran: {r['launches']}")
    n = SPEED_PER_SYMBOL_FRAMES
    out_path = os.path.join(workdir, "Output_per_symbol_bf16.dat")
    stdout, stderr = run_live_app(("--per-symbol", *bf16), wire[:n], pilot_path, out_path,
                                  stderr=True)
    r = check_live("per-symbol bf16", stdout, out_path, sent[:n], lgold[:n],
                   (n, n * (SYMBOLS - 1)), card, golden, sim)
    note = "--per-symbol runs the exact kernels" in stderr
    print(f"app per-symbol bf16: stderr note {'present' if note else 'MISSING'}: "
          + " ".join(ln for ln in stderr.splitlines() if ln.startswith("note:")))
    require(note and r["launches"]["pilot_ls_bf16"] == r["launches"]["fft_mrc_bf16"] == 0,
            f"app per-symbol bf16: note {note}, launches {r['launches']}")
    rec["app per-symbol bf16"] = r
    del wire, sent, lgold

    # (e) the gate's sweep, run on the card by phase 10.
    legs = [ln for ln in gate["sweep"] if ln.startswith("[sweep]") and ln.endswith("PASS")]
    for ln in gate["sweep"]:
        print(f"speed gate (phase 10): {ln}")
    require(any("whole/fused-bf16" in ln for ln in legs) and len(legs) == 12,
            f"the gate's sweep on the card: {len(legs)} legs passed, want 12 with the bf16 leg")
    rec["gate sweep legs passed"] = len(legs)

    # (f) times: each kernel beside its plain version and the library FFT of
    # its rows; the speed kernel beside the exact one, X Y Y X; a bf16
    # torch.matmul of the stage-2 shape.
    x = rx.x_full
    pilot_c = torch.complex(y[0].re.contiguous(), y[0].im.contiguous())
    data_c = torch.complex(y[1:].re.contiguous(), y[1:].im.contiguous())
    w = fft_plan.speed_w(dev)
    n1 = FFT // 128
    lhs = {"pilot_ls_bf16": torch.randn(ANTENNAS * 2 * n1, 128, device=dev).to(torch.bfloat16),
           "fft_mrc_bf16": torch.randn((SYMBOLS - 1) * ANTENNAS * 2 * n1, 128,
                                       device=dev).to(torch.bfloat16)}
    sides = {
        "pilot_ls_bf16": (lambda: pipe.estimate_pilot_fused(y[0], x, exact=False),
                          lambda: pipe.estimate_pilot_speed_plain(y[0], x),
                          lambda: torch.fft.fft(pilot_c, dim=-1),
                          lambda: pipe.estimate_pilot_fused(y[0], x), 200),
        "fft_mrc_bf16": (lambda: pipe.fused_pipeline(y[1:], h_e, inv_e, exact=False),
                         lambda: pipe.fused_pipeline_speed_plain(y[1:], h_e, inv_e),
                         lambda: torch.fft.fft(data_c, dim=-1),
                         lambda: pipe.fused_pipeline(y[1:], h_e, inv_e), 100),
    }
    records = []
    for name, (kernel_fn, plain_fn, fft_fn, exact_fn, n) in sides.items():
        t = measure(kernel_fn, plain_fn, n, fft_fn)
        mm = device_ms(lambda name=name: lhs[name] @ w, n)
        xyyx = [device_ms(fn, n)["ms"] for fn in (exact_fn, kernel_fn, kernel_fn, exact_fn)]
        nbytes, flops, tflops = speed_work(name, ANTENNAS, FFT, SYMBOLS - 1)
        b_ms, b_by, parts = speed_bound_ms(nbytes, flops, tflops)
        k_ms, k_src = timed(t)
        print(f"time {name} (one frame, f32, cp {CP}): device {us(k_ms)} ({k_src}); plain "
              f"{us(timed(t, 'plain')[0])}; torch.fft.fft of its rows "
              f"{us(timed(t, 'library')[0])}; bf16 torch.matmul {tuple(lhs[name].shape)} x "
              f"(128, 256) {us(mm['ms'], mm['partial'])}  [{card}]")
        print(f"compare {name} vs the exact kernel (device, X Y Y X): exact {us(xyyx[0])}, "
              f"{us(xyyx[3])}; speed {us(xyyx[1])}, {us(xyyx[2])}  [{card}]")
        print(f"bound {name}: {nbytes / 1e6:.3f} MB, {flops / 1e6:.1f} MFLOP fp32, "
              f"{tflops / 1e9:.3f} GFLOP bf16 -> " + ", ".join(
                  f"{k} {v * 1e3:.2f} us" for k, v in parts.items())
              + f": {b_ms * 1e3:.2f} us ({b_by})  [{card}]")
        src, replaces, branch = SPEED_KERNELS[name]
        records.append({
            "name": name, "route": "cuda", "source": f"ofdm_ls_mrc_tpu_torch/csrc/{src}",
            "replaces": replaces, "branch": branch, "launches": launches[name],
            "max_abs_err": errs[name], "ms": k_ms, "plain_ms": timed(t, "plain")[0],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": timed(t, "library")[0],
            "bound_parts_ms": parts, "matmul_ms": mm["ms"],
            "exact_ms_xyyx": [xyyx[0], xyyx[3]], "speed_ms_xyyx": [xyyx[1], xyyx[2]],
            "launches_paths": {k: v["launches"][name] for k, v in rec.items()
                               if isinstance(v, dict) and name in v.get("launches", {})},
            "time_source": {"ms": k_src, "plain_ms": timed(t, "plain")[1],
                            "library_ms": timed(t, "library")[1]},
            "shape": f"{ANTENNAS}x{FFT}x{SYMBOLS} f32, cp {CP}, one frame"})
    # F = 256 and 4096: each kernel beside its plain version, torch.fft.fft
    # of its rows and the exact kernel (queue 2 #3).
    for f_o, (x_o, y_o, h_o, inv_o) in other.items():
        for name, kernel_fn, plain_fn, fft_fn, exact_fn in (
                ("pilot_ls_bf16", lambda: pipe.estimate_pilot_fused(y_o[0], x_o, exact=False),
                 lambda: pipe.estimate_pilot_speed_plain(y_o[0], x_o),
                 lambda: torch.fft.fft(torch.complex(y_o[0].re, y_o[0].im), dim=-1),
                 lambda: pipe.estimate_pilot_fused(y_o[0], x_o)),
                ("fft_mrc_bf16", lambda: pipe.fused_pipeline(y_o[1:], h_o, inv_o, exact=False),
                 lambda: pipe.fused_pipeline_speed_plain(y_o[1:], h_o, inv_o),
                 lambda: torch.fft.fft(torch.complex(y_o[1:].re, y_o[1:].im), dim=-1),
                 lambda: pipe.fused_pipeline(y_o[1:], h_o, inv_o))):
            t_o = measure(kernel_fn, plain_fn, 50, fft_fn)
            ex = device_ms(exact_fn, 50)
            nbytes, flops, tflops = speed_work(name, ANTENNAS, f_o, SYMBOLS - 1)
            b_ms, b_by, _ = speed_bound_ms(nbytes, flops, tflops)
            k_ms, k_src = timed(t_o)
            print(f"time {name} F={f_o} (one {'pilot' if 'pilot' in name else 'frame'}, f32, cp "
                  f"{CP}): device {us(k_ms)} ({k_src}); exact kernel {us(ex['ms'], ex['partial'])};"
                  f" plain {us(timed(t_o, 'plain')[0])}; torch.fft.fft of its rows "
                  f"{us(timed(t_o, 'library')[0])}; bound {b_ms * 1e3:.2f} us ({b_by})  [{card}]")
            for r in records:
                if r["name"] == name:
                    r.setdefault("other_sizes", {})[f"F={f_o}"] = {
                        "ms": k_ms, "exact_ms": ex["ms"], "plain_ms": timed(t_o, "plain")[0],
                        "library_ms": timed(t_o, "library")[0], "bound_ms": b_ms}
    del other
    # The fast pipeline (plain torch GEMMs, no kernel of this repo) on the
    # main frame beside the fused one; held to the golden; no claim of speed.
    rx_fast = UplinkReceiver(cfg, pilot, pipeline="fast", fft_impl="four_step", device=dev)
    rx_fused = UplinkReceiver(cfg, pilot, device=dev)
    out_fast = rx_fast.demod_frame(frame).to_numpy()
    rel_fast = max_rel(out_fast, gold)
    t_fast, t_fused = (device_ms(lambda r=r: r.demod_frame(frame), 20) for r in (rx_fast, rx_fused))
    c_fast, c_fused = (call_ms(lambda r=r: r.demod_frame(frame), 20) for r in (rx_fast, rx_fused))
    print(f"fast pipeline (UplinkReceiver(pipeline='fast', fft_impl='four_step'), "
          f"{ANTENNAS}x{FFT}x{SYMBOLS} f32 cp {CP}): max-rel vs golden {rel_fast:.3e}; device "
          f"{us(t_fast['ms'], t_fast['partial'])} ({len(t_fast['split'])} kernels) vs fused "
          f"{us(t_fused['ms'], t_fused['partial'])}; per call {c_fast * 1e3:.2f} us vs "
          f"{c_fused * 1e3:.2f} us  [{card}]")
    require(out_fast.shape == (SYMBOLS - 1, FFT - 1) and rel_fast < GOLDEN_TOL,
            f"fast pipeline: shape {out_fast.shape}, max-rel vs golden {rel_fast:.3e}")
    rec["fast pipeline"] = {"max_rel_golden": rel_fast, "device_ms": t_fast["ms"],
                            "fused_device_ms": t_fused["ms"], "call_ms": c_fast,
                            "fused_call_ms": c_fused}
    del rx_fast, rx_fused
    # The capture per frame: speed and exact demod_capture, X Y Y X.
    rx_cap_exact = UplinkReceiver(cfg0, cap_pilot, device=dev)
    cx = [device_ms(lambda r=r: r.demod_capture(cap), 10)["ms"]
          for r in (rx_cap_exact, rx_cap, rx_cap, rx_cap_exact)]
    cap_bytes = speed_work("fft_mrc_bf16", ANTENNAS, FFT, SYMBOLS - 1, 4)[0] + speed_work(
        "pilot_ls_bf16", ANTENNAS, FFT, 1, 4)[0]
    print(f"compare demod_capture speed vs exact ({CAPTURE_FRAMES} sc16 frames, device per "
          f"frame, X Y Y X): exact {us(cx[0] / CAPTURE_FRAMES)}, {us(cx[3] / CAPTURE_FRAMES)}; "
          f"speed {us(cx[1] / CAPTURE_FRAMES)}, {us(cx[2] / CAPTURE_FRAMES)}; bound "
          f"{cap_bytes / HBM_BYTES_PER_S * 1e6:.2f} us (bytes)  [{card}]")
    for r in records:
        r["capture_ms_per_frame_xyyx"] = {
            "exact": [v / CAPTURE_FRAMES for v in (cx[0], cx[3])],
            "speed": [v / CAPTURE_FRAMES for v in (cx[1], cx[2])]}
    del cap, data_c, pilot_c, lhs
    torch.cuda.empty_cache()
    print(f"phase 14 (speed mode): {time.perf_counter() - t_phase:.1f} s")
    return rec, records


def side_ptxas_lines(report: str):
    """Registers, spills and the launch's dynamic shared memory of every
    instantiation of the exact data kernels' side form (F = 256, 512, 2048
    and 4096, csrc/fft_side.cuh) from nvcc's -Xptxas -v report, with the
    plan of one 16 x F x 100 frame."""
    from ofdm_ls_mrc_tpu_torch.ops import fft_plan

    for name, f, t, aligned, spill, regs in re.findall(
            r"Compiling entry function '_ZN4ofdm\d+(fft_mrc|mrc_demod)_side_kernelILi(\d+)E(\w)"
            r"Lb(\d)E[^']*'.*?(\d+) bytes spill stores.*?Used (\d+) registers", report, re.S):
        f = int(f)
        plan = fft_plan.side_plan(SYMBOLS - 1, ANTENNAS, f)
        yield (f"ptxas {name}_side<{f}, {'int16' if t == 's' else 'float'}, "
               f"{'cp.async' if aligned == '1' else 'element'} loads> (rows side by side over the "
               f"card): {regs} registers, {spill} B spilled, {plan.smem_bytes} B dynamic shared "
               f"memory, {plan.threads} threads a block ({fft_plan.side_teams(f)} row teams), "
               f"{plan.blocks} blocks for a {ANTENNAS}x{f}x{SYMBOLS - 1} frame")


def side_legs(dev, card, reset_counts, counts, measure, errs_abs) -> tuple:
    """Phase 3's legs of the exact data kernels' side form (F = 256, 512,
    2048, 4096): fused_pipeline (exact) and fused_demod against their plain
    versions at max-rel below KERNEL_TOL on a 16 x F x 101 frame (f32 at cp
    72, int16 at cp 0 and at cp 1: the element loads), 64 antennas, one
    streamed symbol (S = 1) and a capture of CAPTURE_FRAMES sc16 frames (the
    split-phase kernel on its 2,000 symbols), each leg twice, the counts set
    to 0 just before each and read just after; then one short timing of each
    kernel on the f32 frame beside its plain version, torch.fft.fft of its
    rows and its bound.  Returns (the legs' record, the kernel records
    'fft_mrc F=...' and 'mrc_demod F=...')."""
    import torch

    from ofdm_ls_mrc_tpu_torch.ops import fft as fft_ops
    from ofdm_ls_mrc_tpu_torch.ops import fft_plan, fused_mrc, ls
    from ofdm_ls_mrc_tpu_torch.ops import pipeline as pipe
    from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray

    t_legs = time.perf_counter()
    rec, records = {}, []
    s = SYMBOLS - 1
    for f in fft_plan.SIDE_FFT_SIZES:
        g = torch.Generator(device=dev).manual_seed(f)
        x_f = ls.pad_pilot(np.exp(2j * np.pi * np.random.default_rng(f).random(f - 1)).astype(
            np.complex64), dev)

        def rows(shape, dtype, g=g):
            if dtype == "int16":
                return CArray(*(torch.randint(-3277, 3277, shape, generator=g, dtype=torch.int16,
                                              device=dev) for _ in range(2)))
            return CArray(*(0.1 * torch.randn(shape, generator=g, device=dev) for _ in range(2)))

        legs = {}
        for label, a, k, cp, dtype in (("f32 cp 72", ANTENNAS, 0, CP, "f32"),
                                       ("int16 cp 0", ANTENNAS, 0, 0, "int16"),
                                       ("int16 cp 1", ANTENNAS, 0, 1, "int16"),
                                       ("64 antennas f32 cp 72", 64, 0, CP, "f32"),
                                       ("S = 1 f32 cp 72", ANTENNAS, 0, CP, "f32"),
                                       (f"capture of {CAPTURE_FRAMES} sc16 frames", ANTENNAS,
                                        CAPTURE_FRAMES, 0, "int16")):
            frame = rows((max(k, 1), SYMBOLS, a, f + cp), dtype)
            y = CArray(frame.re[..., cp:], frame.im[..., cp:])
            h, inv = pipe.estimate_pilot_plain(y[:, 0], x_f)
            hconj, hsqrd = ls.estimate_channel_full(fft_ops.fft(pipe.widen_sc16(y[0, 0])), x_f)
            data = y[:, 1:2] if label.startswith("S = 1") else y[:, 1:]
            if not k:
                data, h, inv = data[0], h[0], inv[0]
            # fused_demod takes [S, A, F]: the capture's symbols as one run.
            flat = data if not k else CArray(data.re.reshape(-1, a, f), data.im.reshape(-1, a, f))
            want = pipe.fused_pipeline_plain(data, h, inv).to_numpy()
            want2 = fused_mrc.fused_demod_plain(flat, hconj, hsqrd).to_numpy()
            rels, launches = [], []
            for _ in range(2):
                torch.cuda.synchronize()
                reset_counts()
                got = pipe.fused_pipeline(data, h, inv)
                got2 = fused_mrc.fused_demod(flat, hconj, hsqrd)
                torch.cuda.synchronize()
                n = counts()
                launches.append({"fft_mrc": n["fft_mrc"], "mrc_demod": n["mrc_demod"]})
                require(launches[-1] == {"fft_mrc": 1, "mrc_demod": 1},
                        f"side F={f} {label}: launches {launches[-1]}, want one of each")
                got, got2 = got.to_numpy(), got2.to_numpy()
                rels.append((max_rel(got, want), max_rel(got2, want2)))
                errs_abs[f"fft_mrc F={f}"] = max(errs_abs.get(f"fft_mrc F={f}", 0.0),
                                                 max_abs(got, want))
                errs_abs[f"mrc_demod F={f}"] = max(errs_abs.get(f"mrc_demod F={f}", 0.0),
                                                   max_abs(got2, want2))
            print(f"check side F={f} {label} ({max(k, 1)} x {data.shape[-3]} x {a} x {f}): "
                  f"fft_mrc max-rel {rels[0][0]:.3e}, {rels[1][0]:.3e}; mrc_demod "
                  f"{rels[0][1]:.3e}, {rels[1][1]:.3e}; launches {launches[0]}")
            for r in rels:
                require(max(r) < KERNEL_TOL, f"side F={f} {label}: max-rel {max(r):.3e} >= "
                                             f"{KERNEL_TOL}")
            legs[label] = {"max_rel": rels, "launches": launches}
            del frame, y, data, flat, want, want2, got, got2
        # One short timing of each kernel on the f32 frame.
        frame = rows((SYMBOLS, ANTENNAS, f + CP), "f32")
        y = CArray(frame.re[..., CP:], frame.im[..., CP:])
        h, inv = pipe.estimate_pilot_plain(y[0], x_f)
        hconj, hsqrd = ls.estimate_channel_full(fft_ops.fft(y[0]), x_f)
        data_c = torch.complex(y[1:].re.contiguous(), y[1:].im.contiguous())
        for name, kernel_fn, plain_fn in (
                ("fft_mrc", lambda: pipe.fused_pipeline(y[1:], h, inv),
                 lambda: pipe.fused_pipeline_plain(y[1:], h, inv)),
                ("mrc_demod", lambda: fused_mrc.fused_demod(y[1:], hconj, hsqrd),
                 lambda: fused_mrc.fused_demod_plain(y[1:], hconj, hsqrd))):
            t = measure(kernel_fn, plain_fn, 5, lambda: torch.fft.fft(data_c, dim=-1))
            nbytes, flops = one_frame_work(name, ANTENNAS, f, s)
            b_ms, b_by = bound_ms(nbytes, flops)
            k_ms, k_src = timed(t)
            print(f"time {name} F={f} side (one frame, f32, cp {CP}): device {us(k_ms)} "
                  f"({k_src}); plain {us(timed(t, 'plain')[0])}; torch.fft.fft of its rows "
                  f"{us(timed(t, 'library')[0])}; bound {b_ms * 1e3:.2f} us ({b_by}, "
                  f"{nbytes / 1e6:.3f} MB)  [{card}]")
            src, replaces = KERNELS[name]
            records.append({
                "name": f"{name} F={f}", "route": "cuda",
                "source": f"ofdm_ls_mrc_tpu_torch/csrc/{src}", "replaces": replaces,
                "side": "ofdm_ls_mrc_tpu_torch/csrc/fft_side.cuh side_rows",
                "side_plan": list(fft_plan.side_plan(s, ANTENNAS, f)),
                "launches": legs["f32 cp 72"]["launches"][0][name],
                "launches_legs": {lb: v["launches"][0][name] for lb, v in legs.items()},
                "max_abs_err": errs_abs[f"{name} F={f}"], "ms": k_ms,
                "plain_ms": timed(t, "plain")[0], "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": timed(t, "library")[0],
                "time_source": {"ms": k_src, "plain_ms": timed(t, "plain")[1],
                                "library_ms": timed(t, "library")[1]},
                "shape": f"{ANTENNAS}x{f}x{SYMBOLS} f32, cp {CP}, one frame"})
        rec[f"F={f}"] = legs
        del frame, y, data_c
        torch.cuda.empty_cache()
    print(f"phase 3 (side form legs and timings): {time.perf_counter() - t_legs:.1f} s")
    return rec, records


def large_ptxas_lines(report: str):
    """Registers, spills and the launch's dynamic shared memory of every
    instantiation of phase 15's geometry from nvcc's -Xptxas -v report: the
    exact data kernels at F = 8192 (their rows spread over the card), the exact pilot at
    8192 (a cluster per antenna row), the split form's column pass and the
    pilots' row passes (F = 16384 and 32768 exact, 8192-32768 bf16), the
    data kernels' rings (exact 16384 and 32768, bf16 8192-32768)."""
    from ofdm_ls_mrc_tpu_torch.ops import fft_plan

    tail = r"[^']*'.*?(\d+) bytes spill stores.*?Used (\d+) registers"
    for name, t, aligned, spill, regs in re.findall(
            r"Compiling entry function '_ZN4ofdm\d+(fft_mrc|mrc_demod)_spread_kernelI(\w)Lb(\d)EE"
            + tail, report, re.S):
        plan = fft_plan.spread_plan(SYMBOLS - 1, ANTENNAS)
        yield (f"ptxas {name}_spread<8192, {'int16' if t == 's' else 'float'}, "
               f"{'cp.async' if aligned == '1' else 'element'} loads> (rows spread over the "
               f"card): {regs} registers, {spill} B spilled, {plan.smem_bytes} B dynamic shared "
               f"memory, {plan.threads} threads a block (one row team), {plan.blocks} blocks for "
               f"a {ANTENNAS}x8192x{SYMBOLS - 1} frame")
    for t, spill, regs in re.findall(
            r"Compiling entry function '_ZN4ofdm\d+pilot_ls_row_kernelI(\w)E" + tail, report, re.S):
        plan = fft_plan.pilot_plan(ANTENNAS, 8192)
        yield (f"ptxas pilot_ls_row<8192, {'int16' if t == 's' else 'float'}> (a cluster per "
               f"antenna row): {regs} registers, {spill} B spilled, {plan.smem_bytes} B dynamic "
               f"shared memory, {plan.threads} threads a block, a cluster of {plan.clusters} "
               f"for each of the {ANTENNAS} rows")
    for n1, spill, regs in re.findall(
            r"Compiling entry function '_ZN4ofdm\d+pilot_ls_rows_kernelILi(\d+)EE" + tail,
            report, re.S):
        f = 128 * int(n1)
        plan = fft_plan.pilot_plan(ANTENNAS, f)
        yield (f"ptxas pilot_ls_rows<F {f}> (row pass): {regs} registers, {spill} B spilled, "
               f"{plan.smem_bytes} B dynamic shared memory, {plan.threads} threads a block, a "
               f"cluster of {plan.clusters} for 8 bins k1 ({ANTENNAS} antennas)")
    yield from ring_ptxas_lines(report)
    for n1, t, spill, regs in re.findall(
            r"Compiling entry function '_ZN4ofdm5split\d+column_pass_kernelILi(\d+)E(\w)EE"
            + tail, report, re.S):
        yield (f"ptxas column_pass<n1 {n1}, {'int16' if t == 's' else 'float'}>: {regs} "
               f"registers, {spill} B spilled, {fft_plan.split_column_smem_bytes(int(n1))} B "
               f"dynamic shared memory, {fft_plan.SPLIT_COLUMN_THREADS} threads a block")
    for n1, spill, regs in re.findall(
            r"Compiling entry function '_ZN4ofdm5speed\d+pilot_rows_kernelILi(\d+)EE" + tail,
            report, re.S):
        f = 128 * int(n1)
        yield (f"ptxas pilot_rows<F {f}, pilot_ls_bf16>: {regs} registers, {spill} B spilled, "
               f"{fft_plan.speed_smem_bytes(f, True)} B dynamic shared memory, "
               f"{fft_plan.SPEED_PILOT_ROWS_THREADS} threads a block, a cluster of "
               f"{fft_plan.speed_cluster(ANTENNAS, f, True)} for 32 bins k1 ({ANTENNAS} antennas)")


def ring_ptxas_lines(report: str):
    """Registers, spills and shared memory of the data kernels' ring form
    (one persistent launch a call, float32 and int16 rows):
    fft_mrc_ring_kernel and mrc_demod_ring_kernel at F = 16384 and 32768,
    fft_mrc_bf16_ring_kernel at 8192 to 32768."""
    from ofdm_ls_mrc_tpu_torch.ops import fft_plan

    tail = r"[^']*'.*?(\d+) bytes spill stores.*?Used (\d+) registers"
    for name, n1, t, spill, regs in re.findall(
            r"Compiling entry function '_ZN4ofdm\d+(fft_mrc|mrc_demod)_ring_kernelILi(\d+)E(\w)EE"
            + tail, report, re.S):
        yield (f"ptxas {name}_ring<F {128 * int(n1)}, {'int16' if t == 's' else 'float'}> "
               f"(one launch, column and row tiles): {regs} registers, {spill} B spilled, "
               f"{fft_plan.split_ring_smem_bytes(128 * int(n1))} B dynamic shared memory, "
               f"{fft_plan.SPLIT_RING_BLOCKS} blocks of 256 threads an SM")
    for n1, t, spill, regs in re.findall(
            r"Compiling entry function '_ZN4ofdm5speed\d+fft_mrc_bf16_ring_kernelILi(\d+)E(\w)EE"
            + tail, report, re.S):
        yield (f"ptxas fft_mrc_bf16_ring<F {128 * int(n1)}, {'int16' if t == 's' else 'float'}> "
               f"(one launch, column tiles and bf16 row tiles of {fft_plan.SPEED_RING_K1} bins "
               f"k1): {regs} registers, {spill} B spilled, "
               f"{fft_plan.speed_ring_smem_bytes(128 * int(n1))} B dynamic shared memory, "
               f"{fft_plan.SPLIT_RING_BLOCKS} blocks of 256 threads an SM")


def ring_legs(dev, f: int, card: str, errs: dict, reset_counts, counts) -> dict:
    """Phase 15's one-launch legs at F: the exact fft_mrc and mrc_demod (F =
    8192, their rows spread over the card, ``fft_plan.spread_plan``; 16384
    and 32768 on their ring) against their plain versions below KERNEL_TOL, and the bf16
    fft_mrc_bf16 (F = 8192 to 32768) against fused_pipeline_speed_plain at
    the speed criterion (EVM against it SPEED_GAP_DB below the plain
    version's against the exact one, max-rel < SPEED_REL), each one launch a
    call, at 16 and 64 antennas, f32 rows with the 72 F / 1024 prefix and
    int16 rows, S = 1 and full frames (K = 2 frames of 100 symbols; the exact
    mrc_demod one frame); each leg runs twice back to back, the counts set
    to 0 before each run.  Returns the legs' max-rel, by label."""
    import torch

    from ofdm_ls_mrc_tpu_torch.ops import fft_plan, fused_mrc
    from ofdm_ls_mrc_tpu_torch.ops import pipeline as pipe
    from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray

    cp = 72 * f // 1024
    out = {}
    for a in (ANTENNAS, WIDE_PILOT_ANTENNAS):
        g = torch.Generator(device=dev).manual_seed(f + a)
        shape = (2, SYMBOLS, a, f + cp)
        raw = [0.1 * torch.randn(shape, generator=g, device=dev) for _ in range(2)]
        rows = {"f32 cp %d" % cp: CArray(raw[0], raw[1])[..., cp:],
                "int16": CArray(*(torch.round(t[..., cp:] * 32767).clamp(-32768, 32767)
                                  .to(torch.int16).contiguous() for t in raw))}
        del raw
        hr = [torch.randn((2, a, f), generator=g, device=dev) for _ in range(2)]
        h = CArray(*hr)
        inv = 1.0 / torch.sum(h.abs2(), dim=-2)
        hc = CArray(hr[0][0].contiguous(), (-hr[1][0]).contiguous())
        hs = 1.0 / inv[0]
        for label, y in rows.items():
            legs = {   # the exact pair at every F of the phase
                "fft_mrc full frames": (
                    "fft_mrc", lambda y=y: pipe.fused_pipeline(y[:, 1:], h, inv),
                    lambda y=y: pipe.fused_pipeline_plain(y[:, 1:], h, inv), slice(None), None),
                "fft_mrc S=1": (
                    "fft_mrc", lambda y=y: pipe.fused_pipeline(y[0, 1:2], h[0], inv[0]),
                    lambda y=y: pipe.fused_pipeline_plain(y[0, 1:2], h[0], inv[0]),
                    slice(None), None),
                "mrc_demod full frame": (
                    "mrc_demod", lambda y=y: fused_mrc.fused_demod(y[0, 1:], hc, hs),
                    lambda y=y: fused_mrc.fused_demod_plain(y[0, 1:], hc, hs),
                    slice(1, None), None),
                "mrc_demod S=1": (
                    "mrc_demod", lambda y=y: fused_mrc.fused_demod(y[1, 1:2], hc, hs),
                    lambda y=y: fused_mrc.fused_demod_plain(y[1, 1:2], hc, hs),
                    slice(1, None), None),
            }
            legs.update({
                "fft_mrc_bf16 full frames": (
                    "fft_mrc_bf16", lambda y=y: pipe.fused_pipeline(y[:, 1:], h, inv, exact=False),
                    lambda y=y: pipe.fused_pipeline_speed_plain(y[:, 1:], h, inv), slice(None),
                    lambda y=y: pipe.fused_pipeline_plain(y[:, 1:], h, inv)),
                "fft_mrc_bf16 S=1": (
                    "fft_mrc_bf16",
                    lambda y=y: pipe.fused_pipeline(y[0, 1:2], h[0], inv[0], exact=False),
                    lambda y=y: pipe.fused_pipeline_speed_plain(y[0, 1:2], h[0], inv[0]),
                    slice(None), lambda y=y: pipe.fused_pipeline_plain(y[0, 1:2], h[0], inv[0])),
            })
            for leg, (name, kernel, plain, bins, exact_fn) in legs.items():
                want = plain().to_numpy()[..., bins]
                e_pe = None if exact_fn is None else evm_db(want, exact_fn().to_numpy()[..., bins])
                items = (2 * (SYMBOLS - 1) if "frames" in leg else
                         SYMBOLS - 1 if "frame" in leg else 1)
                k1 = fft_plan.SPEED_RING_K1 if name == "fft_mrc_bf16" else fft_plan.SPLIT_K1
                if name != "fft_mrc_bf16" and f == fft_plan.SPREAD_FFT:
                    geo = "spread plan (blocks, threads, smem) %s" % (
                        tuple(fft_plan.spread_plan(items, a)),)
                else:
                    geo = "ring (slots, lag) %s" % (fft_plan.split_ring(items, a, f, k1=k1),)
                for run in (1, 2):
                    torch.cuda.synchronize()
                    reset_counts()
                    got = kernel().to_numpy()[..., bins]
                    torch.cuda.synchronize()
                    n = counts()
                    rel = max_rel(got, want)
                    errs[name] = max(errs[name], max_abs(got, want))
                    key = f"{name} F={f} {a}x{label} {leg} run {run}"
                    out[key] = rel
                    if e_pe is None:
                        print(f"ring {key}: max-rel {rel:.3e}, launches {n[name]}, {geo}  "
                              f"[{card}]")
                        ok = rel < KERNEL_TOL
                    else:
                        e_kp = evm_db(got, want)
                        print(f"ring {key}: EVM vs plain {e_kp:.2f} dB, plain vs exact "
                              f"{e_pe:.2f} dB, max-rel {rel:.3e}, launches {n[name]}, {geo}  "
                              f"[{card}]")
                        ok = e_kp <= e_pe - SPEED_GAP_DB and rel < SPEED_REL
                    require(ok and n[name] == 1 and sum(n.values()) == 1,
                            f"ring {key}: max-rel {rel:.3e}, launches {n}")
        del rows, h, hr, inv, hc, hs
        torch.cuda.empty_cache()
    return out


def pilot_ptxas(lines, name: str, f: int) -> list:
    """Phase 15's ptxas lines of one pilot at F: its kernel (at 8192 the
    cluster per antenna row, else the row pass) and, where it runs one, the
    column pass."""
    column = f"column_pass<n1 {f // 128}, float>"
    if name == "pilot_ls_bf16":
        keys = (f"pilot_rows<F {f},", column)
    elif f == 8192:
        keys = ("pilot_ls_row<8192, float>",)
    else:
        keys = (f"pilot_ls_rows<F {f}>", column)
    return [ln for ln in lines if any(k in ln for k in keys)]


def large_fft_phase(workdir, dev, card, golden, sim, reset_counts, counts, measure, io_floor,
                    report) -> tuple:
    """Phase 15 (see the module docstring); ``io_floor`` is phase 7's
    measured floor in bytes/s, ``report`` phase 2's ptxas report.  Returns
    the phase's records and the kernel records of the six kernels at each
    F."""
    import warnings

    import torch

    from ofdm_ls_mrc_tpu_torch import FrameConfig, parallel
    from ofdm_ls_mrc_tpu_torch.models import StreamingDemodulator, UplinkReceiver
    from ofdm_ls_mrc_tpu_torch.ops import fft_plan, fused_mrc
    from ofdm_ls_mrc_tpu_torch.ops import pipeline as pipe
    from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray

    t_phase = time.perf_counter()
    lines = list(large_ptxas_lines(report))
    print("\n".join(lines))
    require(len(lines) == 35, f"ptxas report: {len(lines)} phase-15 instantiations, want 35")
    rec, records = {"ptxas": lines}, []
    s = SYMBOLS - 1

    def leg(label, f, fn, want, zero=()):
        """One path at F: counts set to 0 just before it and read just after,
        each kernel of ``want`` launched that many times, none of ``zero``,
        and no fallback RuntimeWarning."""
        torch.cuda.synchronize()
        reset_counts()
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            out = fn()
        torch.cuda.synchronize()
        got = counts()
        print(f"large F={f} {label}: launches {({k: v for k, v in got.items() if v})}")
        for k, n in want.items():
            require(got[k] == n, f"large F={f} {label}: {k} launched {got[k]} times, want {n}")
        for k in zero:
            require(got[k] == 0, f"large F={f} {label}: {k} launched {got[k]} times, want 0")
        return out, {k: got[k] for k in want}

    parallel.initialize(f"file://{os.path.join(workdir, 'large_store')}", 1, 0, "nccl")
    try:
        mesh = parallel.make_mesh(1, 1)
        for f, frames in LARGE_FFT.items():
            r, errs, launches = {}, {name: 0.0 for name in LARGE_KERNELS}, {}
            cp = 72 * f // 1024

            def exact_check(name, label, pairs):
                rel = max(max_rel(k, p) for k, p in pairs)
                errs[name] = max(errs[name], max(max_abs(k, p) for k, p in pairs))
                print(f"check {name} F={f} {label}: max-rel {rel:.3e}")
                require(rel < KERNEL_TOL, f"{name} F={f} {label}: max-rel {rel:.3e}")

            def speed_check(name, label, kernel, plain, exact):
                e_kp, e_pe, rel = evm_db(kernel, plain), evm_db(plain, exact), max_rel(kernel, plain)
                errs[name] = max(errs[name], max_abs(kernel, plain))
                print(f"check {name} F={f} {label}: EVM vs plain {e_kp:.2f} dB, plain vs exact "
                      f"{e_pe:.2f} dB, max-rel vs plain {rel:.3e}")
                require(e_kp <= e_pe - SPEED_GAP_DB and rel < SPEED_REL,
                        f"{name} F={f} {label}: EVM {e_kp:.2f} dB (plain vs exact {e_pe:.2f}), "
                        f"max-rel {rel:.3e}")

            def hold_pilots(label, x, p_rows):
                """The three pilots against their plain versions on these rows."""
                h_k, inv_k = pipe.estimate_pilot_fused(p_rows, x)
                _, sum_k = pipe.estimate_pilot_fused(p_rows, x, invert=False)
                h_p, inv_p = pipe.estimate_pilot_plain(p_rows, x)
                exact_check("pilot_ls", label, [(h_k.to_numpy(), h_p.to_numpy()),
                                                (1 / inv_k.cpu().numpy(), 1 / inv_p.cpu().numpy())])
                exact_check("pilot_ls_sum", label, [(sum_k.cpu().numpy(), 1 / inv_p.cpu().numpy())])
                hb, ib = pipe.estimate_pilot_fused(p_rows, x, exact=False)
                hbp, ibp = pipe.estimate_pilot_speed_plain(p_rows, x)
                speed_check("pilot_ls_bf16", f"{label} h", hb.to_numpy(), hbp.to_numpy(),
                            h_p.to_numpy())
                speed_check("pilot_ls_bf16", f"{label} sum|h|^2", *(1 / v.cpu().numpy()
                                                                    for v in (ib, ibp, inv_p)))
                return h_p, inv_p

            def hold(label, x, p_rows, d_rows, hc=None, hs=None):
                """Each kernel against its plain version on these rows."""
                h_p, inv_p = hold_pilots(label, x, p_rows)
                exact_check("fft_mrc", label, [(pipe.fused_pipeline(d_rows, h_p, inv_p).to_numpy(),
                                                pipe.fused_pipeline_plain(d_rows, h_p, inv_p)
                                                .to_numpy())])
                if hc is not None:
                    k = fused_mrc.fused_demod(d_rows, hc, hs).to_numpy()
                    exact_check("mrc_demod", label, [(
                        k[..., 1:], fused_mrc.fused_demod_plain(d_rows, hc, hs).to_numpy()[..., 1:])])
                speed_check("fft_mrc_bf16", label, *(fn(d_rows, h_p, inv_p).to_numpy() for fn in (
                    lambda *a: pipe.fused_pipeline(*a, exact=False),
                    pipe.fused_pipeline_speed_plain, pipe.fused_pipeline_plain)))
                return h_p, inv_p

            # The frame: 16 x F x 101 f32, cp 72 F / 1024, 16-QAM through the
            # 16-tap 25 dB channel.
            t0 = time.perf_counter()
            cfg = FrameConfig(num_antennas=ANTENNAS, fft_size=f, cyclic_prefix=cp,
                              frame_len=SYMBOLS)
            rng = np.random.default_rng(f)
            data, _ = sim.random_symbols(rng, (s, f - 1), "16qam")
            pilot = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
            rx_frame = sim.ChannelModel(ANTENNAS, f, num_taps=16, snr_db=25.0, seed=9).apply(
                sim.make_tx_frame(data, pilot, cp), cp)
            gold = golden.demod_frame(rx_frame, pilot, cp)
            frame = CArray.from_numpy(rx_frame, dev)
            del rx_frame
            print(f"large F={f}: {ANTENNAS}x{f}x{SYMBOLS} f32 frame, cp {cp}, made in "
                  f"{time.perf_counter() - t0:.1f} s")
            with warnings.catch_warnings():
                warnings.simplefilter("error", RuntimeWarning)
                rx = UplinkReceiver(cfg, pilot, device=dev)
                rx_speed = UplinkReceiver(cfg, pilot, exact=False, device=dev)
                cfg0 = FrameConfig(num_antennas=ANTENNAS, fft_size=f, cyclic_prefix=0,
                                   frame_len=SYMBOLS)
                rx0 = UplinkReceiver(cfg0, pilot, device=dev)          # demod_parts: CP-free rows
                rx0_speed = UplinkReceiver(cfg0, pilot, exact=False, device=dev)
            require(rx.pipeline == rx_speed.pipeline == "fused",
                    f"large F={f}: the receivers run {rx.pipeline!r}/{rx_speed.pipeline!r}")
            y = frame[..., cp:]
            hc, hs = rx.estimate_channel(frame[0])
            h_e, inv_e = hold(f"{ANTENNAS}x{f}x{SYMBOLS} f32 cp {cp}", rx.x_full, y[0], y[1:],
                              hc, hs)
            # The pilots at 64 antennas (several rows a team, an uneven bf16
            # cluster at 32768), f32 and the same rows as int16.
            g64 = np.random.default_rng(f + WIDE_PILOT_ANTENNAS)
            wide = CArray.from_numpy((0.1 * (g64.standard_normal((WIDE_PILOT_ANTENNAS, f)) + 1j
                                             * g64.standard_normal((WIDE_PILOT_ANTENNAS, f))))
                                     .astype(np.complex64), dev)
            for label, rows in (("f32", wide), ("int16", CArray(*(
                    torch.round(t * 32767).clamp(-32768, 32767).to(torch.int16)
                    for t in (wide.re, wide.im))))):
                hold_pilots(f"{WIDE_PILOT_ANTENNAS}x{f} {label} pilot", rx.x_full, rows)
            del wide
            # The data kernels' one-launch ring (exact from 16384, bf16 from 8192).
            r["ring legs"] = ring_legs(dev, f, card, errs, reset_counts, counts)
            if f == 8192:  # element loads at an odd prefix: the data kernels' and the pilot's
                small = CArray(*(torch.round(t[:6] * 32767).clamp(-32768, 32767)
                                 .to(torch.int16)[..., 1:1 + f] for t in (frame.re, frame.im)))
                hold("16x8192x6 int16 cp 1 (element loads)", rx.x_full, small[0], small[1:],
                     hc, hs)

            # The paths, each at full width.
            out, launches["frame"] = leg("UplinkReceiver(fused).demod_frame", f,
                                         lambda: rx.demod_frame(frame).to_numpy(),
                                         {"pilot_ls": 1, "fft_mrc": 1},
                                         ("pilot_ls_bf16", "fft_mrc_bf16"))
            rel, e_sent = max_rel(out, gold), sim.evm_db(np.fft.fftshift(out, axes=-1), data)
            print(f"large F={f} main path: shape {out.shape}, EVM vs sent {e_sent:.2f} dB, "
                  f"max-rel vs golden {rel:.3e}  [{card}]")
            require(out.shape == (s, f - 1) and np.all(np.isfinite(out)) and rel < GOLDEN_TOL
                    and e_sent < EVM_MAX_DB, f"large F={f} main path: rel {rel:.3e}, EVM {e_sent}")
            r["main path"] = {"evm_sent_db": e_sent, "max_rel_golden": rel}
            parts, launches["parts"] = leg("demod_parts", f, lambda: rx0.demod_parts(
                y[0], y[1:]).to_numpy(), {"pilot_ls": 1, "fft_mrc": 1})
            require(max_rel(parts, out) < 1e-6, f"large F={f}: demod_parts vs demod_frame")
            split, launches["split"] = leg("split phase (estimate_channel + demod_data)", f,
                                           lambda: rx.demod_data(frame[1:], *rx.estimate_channel(
                                               frame[0])).to_numpy(), {"mrc_demod": 1})
            rel_split = max_rel(split, gold)
            require(rel_split < GOLDEN_TOL, f"large F={f} split phase: max-rel {rel_split:.3e}")
            out_b, launches["speed"] = leg("UplinkReceiver(exact=False).demod_frame", f,
                                           lambda: rx_speed.demod_frame(frame).to_numpy(),
                                           {"pilot_ls_bf16": 1, "fft_mrc_bf16": 1},
                                           ("pilot_ls", "fft_mrc"))
            e_gold_b = evm_db(out_b, gold)
            e_sent_b = sim.evm_db(np.fft.fftshift(out_b, axes=-1), data)
            print(f"large F={f} speed path: EVM vs golden {e_gold_b:.2f} dB, vs sent "
                  f"{e_sent_b:.2f} dB; split phase max-rel vs golden {rel_split:.3e}  [{card}]")
            require(e_gold_b <= SPEED_GOLDEN_EVM_DB and e_sent_b < EVM_MAX_DB,
                    f"large F={f} speed path: EVM {e_gold_b:.2f} / {e_sent_b:.2f} dB")
            parts_b, _ = leg("demod_parts(exact=False)", f, lambda: rx0_speed.demod_parts(
                y[0], y[1:]).to_numpy(), {"pilot_ls_bf16": 1, "fft_mrc_bf16": 1})
            require(max_rel(parts_b, out_b) < 1e-6, f"large F={f}: speed demod_parts vs frame")
            r["speed path"] = {"evm_golden_db": e_gold_b, "evm_sent_db": e_sent_b}
            r["split phase"] = {"max_rel_golden": rel_split}
            sd = StreamingDemodulator(cfg, pilot, pipeline="fused", device=dev)

            def stream(sd=sd):
                sd.push_pilot(frame[0])
                return np.stack([sd.push_symbol(frame[i]).to_numpy() for i in range(1, SYMBOLS)])

            rows, launches["streaming"] = leg("StreamingDemodulator(fused)", f, stream,
                                              {"pilot_ls": 1, "fft_mrc": s})
            rel_stream = max_rel(rows, out)
            require(rel_stream < KERNEL_TOL, f"large F={f} streaming vs frame: {rel_stream:.3e}")
            srx = parallel.ShardedUplinkReceiver(cfg, pilot, mesh, device=dev)
            srx_b = parallel.ShardedUplinkReceiver(cfg, pilot, mesh, exact=False, device=dev)
            srx.warmup()
            srx_b.warmup()
            out_s, launches["sharded"] = leg("ShardedUplinkReceiver (world 1, nccl)", f,
                                             lambda: srx.demod_frame(frame).to_numpy(),
                                             {"pilot_ls_sum": 1, "fft_mrc": 1}, ("pilot_ls",))
            out_sb, launches["sharded speed"] = leg(
                "ShardedUplinkReceiver(exact=False)", f, lambda: srx_b.demod_frame(
                    frame).to_numpy(), {"pilot_ls_sum": 1, "fft_mrc_bf16": 1}, ("pilot_ls",))
            ssd = parallel.ShardedStreamingDemodulator(cfg, pilot, mesh, device=dev)

            def sstream(ssd=ssd):
                ssd.push_pilot(frame[0])
                return np.stack([ssd.push_symbol(frame[i]).to_numpy() for i in range(1, SYMBOLS)])

            rows_s, launches["sharded streaming"] = leg("ShardedStreamingDemodulator", f, sstream,
                                                        {"pilot_ls_sum": 1, "fft_mrc": s})
            rels = (max_rel(out_s, out), max_rel(rows_s, out_s), evm_db(out_sb, gold))
            print(f"large F={f} sharded: frame vs unsharded {rels[0]:.3e}, streaming vs frame "
                  f"{rels[1]:.3e}, speed EVM vs golden {rels[2]:.2f} dB; streaming vs frame "
                  f"{rel_stream:.3e}")
            require(rels[0] < KERNEL_TOL and rels[1] < KERNEL_TOL
                    and rels[2] <= SPEED_GOLDEN_EVM_DB, f"large F={f} sharded: {rels}")
            r["streaming"] = {"max_rel_frame": rel_stream}
            r["sharded"] = {"max_rel_unsharded": rels[0], "streaming_max_rel": rels[1],
                            "speed_evm_golden_db": rels[2]}
            del sd, srx, srx_b, ssd, rows, rows_s

            # The capture: sc16 frames, cp stripped on the host, made on the card.
            g = torch.Generator(device=dev).manual_seed(f)
            shape = (frames, SYMBOLS, ANTENNAS, f)
            cap = CArray(*(torch.round(0.1 * torch.randn(shape, generator=g, device=dev) * 32767)
                           .clamp(-32768, 32767).to(torch.int16) for _ in range(2)))
            cap_pilot = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
            rx_cap = UplinkReceiver(cfg0, cap_pilot, device=dev)
            rx_cap_b = UplinkReceiver(cfg0, cap_pilot, exact=False, device=dev)
            hold(f"{frames} sc16 frames (the capture)", rx_cap.x_full, cap[:, 0], cap[:, 1:])
            cap_out, launches["capture"] = leg(f"demod_capture ({frames} sc16 frames)", f,
                                               lambda: rx_cap.demod_capture(cap).to_numpy(),
                                               {"pilot_ls": 1, "fft_mrc": 1})
            cap_b, launches["capture speed"] = leg(
                f"demod_capture(exact=False) ({frames} frames)", f,
                lambda: rx_cap_b.demod_capture(cap).to_numpy(),
                {"pilot_ls_bf16": 1, "fft_mrc_bf16": 1})
            require(max_rel(cap_out[-1], rx_cap.demod_frame(cap[-1]).to_numpy()) < 1e-6
                    and max_rel(cap_b[-1], rx_cap_b.demod_frame(cap[-1]).to_numpy()) < 1e-6,
                    f"large F={f}: a capture frame differs from demod_frame")
            del cap_out, cap_b

            # Times: each kernel beside its plain version and torch.fft.fft
            # of its rows (one frame, f32, cp), the capture per frame.
            x = rx.x_full
            pilot_c = torch.complex(y[0].re.contiguous(), y[0].im.contiguous())
            data_c = torch.complex(y[1:].re.contiguous(), y[1:].im.contiguous())
            sides = {
                "pilot_ls": (lambda: pipe.estimate_pilot_fused(y[0], x),
                             lambda: pipe.estimate_pilot_plain(y[0], x), pilot_c),
                "pilot_ls_sum": (lambda: pipe.estimate_pilot_fused(y[0], x, invert=False),
                                 lambda: pipe.estimate_pilot_plain(y[0], x, invert=False),
                                 pilot_c),
                "fft_mrc": (lambda: pipe.fused_pipeline(y[1:], h_e, inv_e),
                            lambda: pipe.fused_pipeline_plain(y[1:], h_e, inv_e), data_c),
                "mrc_demod": (lambda: fused_mrc.fused_demod(y[1:], hc, hs),
                              lambda: fused_mrc.fused_demod_plain(y[1:], hc, hs), data_c),
                "pilot_ls_bf16": (lambda: pipe.estimate_pilot_fused(y[0], x, exact=False),
                                  lambda: pipe.estimate_pilot_speed_plain(y[0], x), pilot_c),
                "fft_mrc_bf16": (lambda: pipe.fused_pipeline(y[1:], h_e, inv_e, exact=False),
                                 lambda: pipe.fused_pipeline_speed_plain(y[1:], h_e, inv_e),
                                 data_c),
            }
            main_leg = {"pilot_ls": "frame", "fft_mrc": "frame", "mrc_demod": "split",
                        "pilot_ls_sum": "sharded", "pilot_ls_bf16": "speed",
                        "fft_mrc_bf16": "speed"}
            for name, (kernel_fn, plain_fn, rows_c) in sides.items():
                t = measure(kernel_fn, plain_fn, LARGE_REPS,
                            lambda rows_c=rows_c: torch.fft.fft(rows_c, dim=-1))
                if name.endswith("_bf16"):
                    nbytes, flops, tflops = speed_work(name, ANTENNAS, f, s)
                    b_ms, b_by, _ = speed_bound_ms(nbytes, flops, tflops)
                else:
                    nbytes, flops = one_frame_work(name.replace("_sum", ""), ANTENNAS, f, s)
                    b_ms, b_by = bound_ms(nbytes, flops)
                k_ms, k_src = timed(t)
                split = ", ".join(f"{k[:48]} {v * 1e3:.2f} us" for k, v in sorted(
                    t["kernel_split"].items(), key=lambda kv: -kv[1]))
                print(f"time {name} F={f} (one {'pilot' if 'pilot' in name else 'frame'}, f32, "
                      f"cp {cp}): device {us(k_ms)} ({k_src}: {split}); plain "
                      f"{us(timed(t, 'plain')[0])}; torch.fft.fft of its rows "
                      f"{us(timed(t, 'library')[0])}; bound {b_ms * 1e3:.2f} us ({b_by}) at the "
                      f"published peaks, {nbytes / io_floor * 1e6:.2f} us at the measured io "
                      f"floor ({nbytes / 1e6:.3f} MB)  [{card}]")
                passes = {}
                if name in LARGE_PILOT_PARENT_US:
                    col = sum(v for k, v in t["kernel_split"].items() if "column_pass" in k)
                    passes = {"column": col, "row": sum(t["kernel_split"].values()) - col}
                    mine = pilot_ptxas(lines, name, f)
                    print(f"pilot {name} F={f}: device {us(k_ms)} (column pass "
                          f"{passes['column'] * 1e3:.2f} us, row pass {passes['row'] * 1e3:.2f} "
                          f"us); parent form {LARGE_PILOT_PARENT_US[name][f]:.2f} us (PERF.md); "
                          f"torch.fft.fft {us(timed(t, 'library')[0])}; bound "
                          f"{b_ms * 1e3:.2f} us ({b_by}); {' | '.join(mine)}  [{card}]")
                src, replaces = LARGE_KERNELS[name]
                records.append({
                    "name": f"{name} F={f}", "route": "cuda",
                    "source": f"ofdm_ls_mrc_tpu_torch/csrc/{src}", "replaces": replaces,
                    "launches": launches[main_leg[name]][name],
                    "launches_legs": {k: v[name] for k, v in launches.items() if name in v},
                    "max_abs_err": errs[name], "ms": k_ms, "plain_ms": timed(t, "plain")[0],
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": timed(t, "library")[0],
                    "floor_ms": nbytes / io_floor * 1e3, "kernel_split_ms": t["kernel_split"],
                    "time_source": {"ms": k_src, "plain_ms": timed(t, "plain")[1],
                                    "library_ms": timed(t, "library")[1]},
                    "shape": f"{ANTENNAS}x{f}x{SYMBOLS} f32, cp {cp}, one frame",
                    **({"pass_split_ms": passes} if passes else {}),
                    **({"spread": "ofdm_ls_mrc_tpu_torch/csrc/fft_spread.cuh spread_rows",
                        "spread_plan": list(fft_plan.spread_plan(s, ANTENNAS))}
                       if f == fft_plan.SPREAD_FFT and name in ("fft_mrc", "mrc_demod") else
                       {"ring": "ofdm_ls_mrc_tpu_torch/csrc/fft_split.cuh ring_loop"}
                       if (f in pipe.SPLIT_FFT_SIZES and name in ("fft_mrc", "mrc_demod"))
                       or name == "fft_mrc_bf16" else
                       {"column_pass": "ofdm_ls_mrc_tpu_torch/csrc/fft_split.cu"}
                       if f in pipe.SPLIT_FFT_SIZES or name == "pilot_ls_bf16" else {})})
            del pilot_c, data_c
            cap_bytes = (one_frame_work("fft_mrc", ANTENNAS, f, s)[0] - s * ANTENNAS * f * 4
                         + ANTENNAS * f * 4 + f * 12)   # sc16 rows in, the pilot's estimate
            for label, rxc in (("exact", rx_cap), ("bf16", rx_cap_b)):
                d = device_ms(lambda rxc=rxc: rxc.demod_capture(cap), 3)
                per = None if d["ms"] is None else d["ms"] / frames
                print(f"time demod_capture {label} F={f} ({frames} sc16 frames, cp stripped on "
                      f"the host{'; fewer frames than 20 at this F: the same 1.06 GB' if frames < 20 else ''}): "
                      f"device {us(per, d['partial'])}/frame; bound {cap_bytes / 1e6:.3f} MB a "
                      f"frame -> {cap_bytes / HBM_BYTES_PER_S * 1e6:.2f} us at 3.35 TB/s, "
                      f"{cap_bytes / io_floor * 1e6:.2f} us at the measured io floor  [{card}]")
                r[f"capture {label} ms per frame"] = per
            for rc in records:
                if rc["name"] in (f"pilot_ls F={f}", f"fft_mrc F={f}"):
                    rc["capture_ms_per_frame"] = r["capture exact ms per frame"]
                if rc["name"] in (f"pilot_ls_bf16 F={f}", f"fft_mrc_bf16 F={f}"):
                    rc["capture_ms_per_frame"] = r["capture bf16 ms per frame"]
            r["capture frames"] = frames
            r["launches"] = launches
            rec[f"F={f}"] = r
            del frame, y, cap, rx, rx_speed, rx0, rx0_speed, rx_cap, rx_cap_b, hc, hs, h_e, inv_e
            torch.cuda.empty_cache()
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()

    # demod_app at F = 8192 on a ring of a few sc16 frames: exact and bf16,
    # whole frame, --sc16-native.
    f, cp = LARGE_APP_FFT, 72 * LARGE_APP_FFT // 1024
    pilot_path = os.path.join(workdir, "Pilots_large.dat")
    golden.write_pilot(pilot_path, np.exp(2j * np.pi * np.random.default_rng(15).random(
        f - 1)).astype(np.complex64))
    wire, sent, lgold = live_frames(golden, sim, golden.load_pilot(pilot_path, f - 1),
                                    LARGE_APP_FRAMES, seed=16, f=f, cp=cp)
    n = LARGE_APP_FRAMES
    for label, flags, kernels, evm_max in (
            ("F=8192 sc16-native", ("--sc16-native",), ("pilot_ls", "fft_mrc"), None),
            ("F=8192 sc16-native bf16", ("--sc16-native", "--kernel-precision", "bf16"),
             SPEED_KERNELS, SPEED_GOLDEN_EVM_DB)):
        out_path = os.path.join(workdir, f"Output_{label.replace(' ', '_')}.dat")
        rec[f"app {label}"] = check_live(
            label, run_live_app(flags, wire, pilot_path, out_path, f=f, cp=cp), out_path, sent,
            lgold, (n, n), card, golden, sim, kernels=tuple(kernels), gold_evm_max=evm_max, f=f)
    del wire, sent, lgold
    print(f"phase 15 (large F): {time.perf_counter() - t_phase:.1f} s")
    return rec, records


def trace_head(logdir: str) -> dict:
    """The spin kernels a trace() holds and the first three other kernels,
    in time order: where a trace lost events."""
    import glob

    path = glob.glob(os.path.join(logdir, "*.pt.trace.json"))[0]
    with open(path) as fh:
        ev = sorted((e for e in json.load(fh)["traceEvents"] if e.get("cat") == "kernel"),
                    key=lambda e: e["ts"])
    return {"spin": sum("spin_kernel" in e["name"] for e in ev),
            "first": [e["name"][:24] for e in ev if "spin_kernel" not in e["name"]][:3]}


def last_json(stdout: str) -> dict:
    return json.loads([ln for ln in stdout.splitlines() if ln.startswith("{")][-1])


def tools_phase(workdir, card, rx, frame_dev, reset_counts, counts) -> tuple:
    """Phase 16 (see the module docstring): ``rx`` is the main path's
    receiver and ``frame_dev`` its frame on the card.  Returns the phase's
    records and each leg's kernel launches."""
    import torch

    from ofdm_ls_mrc_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    rec, launches = {"leg_seconds": {}}, {}

    def leg(name, t0):
        rec["leg_seconds"][name] = time.perf_counter() - t0
        print(f"tools {name}: {rec['leg_seconds'][name]:.1f} s")

    # profiling: a trace of TOOL_CALLS demod_frame calls of the main frame.
    # Late in this process the profiler now and then drops a device event
    # even behind the spin pad (PERF.md section 7), so, as device_ms does,
    # up to three traces are taken and the first whole one is read.
    t0 = time.perf_counter()
    shown = []
    for attempt in range(3):
        logdir = os.path.join(workdir, f"trace{attempt}")
        torch.cuda.synchronize()
        reset_counts()
        with profiling.trace(logdir):
            for _ in range(TOOL_CALLS):
                rx.demod_frame(frame_dev)
        launches["profiling"] = counts()
        summary = profiling.summarize_trace(logdir)
        named = {k: [(name, s, c) for name, (s, c) in summary.items() if f"{k}_kernel" in name]
                 for k in ("pilot_ls", "fft_mrc")}
        shown.append({**{k: sum(h[2] for h in hits) for k, hits in named.items()},
                      **trace_head(logdir)})
        if all(len(hits) == 1 and hits[0][2] == TOOL_CALLS for hits in named.values()):
            break
    if len(shown) > 1:
        print(f"note: trace() occurrences of pilot_ls and fft_mrc in {len(shown)} traces of "
              f"{TOOL_CALLS} calls: {shown}")
    d = profiling.device_time(lambda _: rx.demod_frame(frame_dev), [None], reps=TOOL_CALLS,
                              device="cuda", detail=True)
    for k, hits in named.items():
        require(len(hits) == 1 and hits[0][2] == TOOL_CALLS,
                f"profiling: summarize_trace lists {hits} for {k} in three traces, want one "
                f"kernel with {TOOL_CALLS} occurrences")
    traced_ms = sum(hits[0][1] for hits in named.values()) * 1e3
    timed_ms = sum(v for key, v in d["split"].items()
                   if "pilot_ls_kernel" in key or "fft_mrc_kernel" in key) * TOOL_CALLS
    require(abs(traced_ms - timed_ms) <= 0.1 * timed_ms,
            f"profiling: the trace's {traced_ms:.4f} ms against device_time's {timed_ms:.4f} ms "
            f"for {TOOL_CALLS} calls")
    print(f"tools profiling: trace() of {TOOL_CALLS} demod_frame calls: "
          + ", ".join(f"{hits[0][0][:40]} x{hits[0][2]} {hits[0][1] * 1e6 / hits[0][2]:.2f} us"
                      for hits in named.values())
          + f"; summed {traced_ms * 1e3:.2f} us against device_time's {timed_ms * 1e3:.2f} us "
            f"({(traced_ms / timed_ms - 1) * 100:+.2f}%); device_time of a call, all kernels "
            f"{d['ms'] * 1e3:.2f} us ({d['source']})  [{card}]")
    rec["profiling"] = {"trace_ms": traced_ms, "device_time_ms": timed_ms, "traces": shown,
                        "call_device_us": d["ms"] * 1e3, "kernels": {
                            k: {"name": h[0][0], "count": h[0][2], "seconds": h[0][1]}
                            for k, h in named.items()}}

    leg("profiling", t0)

    t0 = time.perf_counter()
    # latency_probe: every body at 16 x 1024, batch 256.
    book = os.path.join(workdir, "latency.json")
    out = port_cli("tools.latency_probe", ["--bodies", ",".join(LATENCY_BODIES),
                                           "--record", book], timeout=600)
    lines = [ln for ln in out.splitlines() if ln.split(" ")[0] in LATENCY_BODIES]
    require(len(lines) == len(LATENCY_BODIES), f"latency_probe printed {lines}")
    for ln in lines:
        print(f"tools latency_probe: {ln}")
    with open(book) as fh:
        rec["latency_book"] = json.load(fh)
    require(sorted(rec["latency_book"]) == sorted(f"{b}-{ANTENNAS}ant-fft{FFT}"
                                                  for b in LATENCY_BODIES),
            f"latency book keys {sorted(rec['latency_book'])}")
    print(f"tools latency_probe book: {json.dumps(rec['latency_book'])}")
    rec["latency_lines"] = lines
    launches["latency_probe"] = profiling.summed_launch_lines(out)

    leg("latency_probe", t0)

    t0 = time.perf_counter()
    # waterfall: the 64-QAM record at the main geometry.
    wf_path = os.path.join(workdir, "waterfall.json")
    out = port_cli("tools.waterfall", ["--scheme", "64qam", "--snrs", WATERFALL_SNRS,
                                       "--seeds", "1", "--pipelines", "golden,fused,fast,composed",
                                       "--fail-above-db", "0.5", "--out", wf_path], timeout=600)
    for ln in out.splitlines():
        if ln.startswith("[waterfall]"):
            print(f"tools waterfall: {ln}")
    with open(wf_path) as fh:
        rec["waterfall"] = json.load(fh)
    require(len(rec["waterfall"]["rows"]) == len(WATERFALL_SNRS.split(",")),
            "waterfall: a row is missing")
    print(f"tools waterfall: {json.dumps(last_json(out))}  [{card}]")
    launches["waterfall"] = profiling.summed_launch_lines(out)

    leg("waterfall", t0)

    t0 = time.perf_counter()
    # ring_bench: sc16, the int16 batch read, then the legs apart.
    ring = ["--antennas", str(ANTENNAS), "--fft", str(FFT), "--cp", str(CP), "--dtype", "sc16",
            "--batch", "--i16"]
    rec["ring_bench"] = [last_json(port_cli("tools.ring_bench", ring + extra))
                         for extra in ([], ["--decompose"])]
    for r in rec["ring_bench"]:
        print(f"tools ring_bench: {json.dumps(r)}  [{card}]")

    leg("ring_bench", t0)

    t0 = time.perf_counter()
    # soak: the documented hardware soak, cut to SOAK_SECONDS, three frames.
    r = subprocess.run([sys.executable, "-m", "ofdm_ls_mrc_tpu_torch.tools.soak",
                        "--seconds", str(SOAK_SECONDS), "--antennas", str(ANTENNAS),
                        "--fft-size", str(FFT), "--frame-len", str(SYMBOLS), "--ring-dtype",
                        "sc16", "--sc16-native", "--rate", "4e6", "--num-frames", "3",
                        "--dir", os.path.join(workdir, "soak")],
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    require(r.returncode == 0, f"soak exited {r.returncode}:\n{r.stdout}\n{r.stderr[-4000:]}")
    soak = last_json(r.stdout)
    require(soak["pass"] and soak["rx_rc"] == 0 and soak["demod_rc"] == 0,
            f"soak: {json.dumps(soak)}")
    print(f"tools soak: pass, {soak['clean_frames']} clean / {soak['dirty_frames']} dirty, "
          f"clean_fraction {soak['clean_fraction']:.4f}, rx_rc {soak['rx_rc']}, demod_rc "
          f"{soak['demod_rc']}, EVM clean max {soak['evm_clean_db']['max']:.2f} dB  [{card}]")
    print(f"tools soak record: {json.dumps(soak)}")
    rec["soak"] = soak
    launches["soak"] = soak["launches"]

    leg("soak", t0)

    t0 = time.perf_counter()
    # scaling_bench: NCCL at world size 1 with 64 antennas.
    rec["scaling"], launches["scaling_bench"] = [], {}

    def scaling(antennas, out):
        sc = last_json(out)
        for ln in out.splitlines():
            if ln.startswith(("ant=", "structure@")):
                print(f"tools scaling_bench {antennas} antennas: {ln}  [{card}]")
        st = sc["structure"]
        require(st["all_reduce_count"] == 1
                and st["all_reduce_fp32_words"] == st["expected_fp32_words"]
                and st["payload_constant_across_shards"],
                f"scaling_bench structure: {json.dumps(st)}")
        rec["scaling"].append(sc)
        for row in sc["rows"]:
            for k, v in row["launches"].items():
                launches["scaling_bench"][k] = launches["scaling_bench"].get(k, 0) + v

    for antennas, flags in SCALING_TIMED:
        scaling(antennas, port_cli("tools.scaling_bench", ["--antennas", str(antennas),
                                                           "--pipeline", "fused", *flags],
                                   timeout=900))
    leg("scaling_bench", t0)

    # Then the scaling structure on gloo ranks of the one card and the
    # examples (on the card by default), all at once: their lines are
    # structure and accuracy, not times.
    t0 = time.perf_counter()
    antennas, flags = SCALING_STRUCTURE
    cmds = {f"example {name}": [f"examples.{name}"] for name in EXAMPLES}
    cmds["scaling_bench"] = ["tools.scaling_bench", "--antennas", str(antennas), "--pipeline",
                             "fused", *flags]
    procs = {label: subprocess.Popen([sys.executable, "-m", f"ofdm_ls_mrc_tpu_torch.{cmd[0]}",
                                      *cmd[1:]], cwd=REPO, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
             for label, cmd in cmds.items()}
    try:
        for label, p in procs.items():
            out, err = p.communicate(timeout=600)
            require(p.returncode == 0, f"{label} exited {p.returncode}:\n{out}\n{err}")
            if label == "scaling_bench":
                scaling(antennas, out)
                continue
            require(out.splitlines()[-1] == "OK", f"{label}: {out}")
            for ln in out.splitlines():
                print(f"tools {label}: {ln}")
            launches[label] = profiling.summed_launch_lines(out)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    leg("scaling structure and examples", t0)
    for name in ("profiling", "latency_probe", "waterfall", "soak"):
        require(launches[name].get("fft_mrc", 0) > 0, f"{name}: fft_mrc was not launched")
    print(f"tools launches: {json.dumps(launches)}")
    print(f"phase 16 (tools): {time.perf_counter() - t_phase:.1f} s")
    return rec, launches


def bench_phase(workdir, card, capture_us: float) -> tuple:
    """Phase 17 (see the module docstring): ``capture_us`` is phase 14's
    device time per frame of the exact sc16 capture.  Returns the phase's
    records and each run's kernel launches."""
    from ofdm_ls_mrc_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    rec, launches = {}, {}
    modes_book = os.path.join(workdir, "bench_modes.json")
    samples = SYMBOLS * ANTENNAS * FFT          # --cp-where host: the CP is not counted
    for label, (flags, mode, want, zero) in BENCH_RUNS.items():
        t0 = time.perf_counter()
        record = ["--record", modes_book] if label == "default" else []
        out = port_cli("bench", [*flags, *record], timeout=600)
        r = last_json(out)
        got = profiling.summed_launch_lines(out)
        launches[f"bench {label}"] = got
        require(r["mode"] == mode and r["backend"] == "cuda" and r["value"] > 0,
                f"bench {label}: mode {r['mode']}, backend {r['backend']}, value {r['value']}")
        require(all(got.get(k, 0) > 0 for k in want) and not any(got.get(k, 0) for k in zero),
                f"bench {label}: launches {got}")
        event_us = samples / r.get("total_samples_per_sec", r["value"]) * 1e6
        dev = r["device_time_sec_per_frame"]
        dev_us = None if dev is None else dev * 1e6
        for ln in out.splitlines():
            if ln.startswith(("per frame:", "host-bound:")):
                print(f"bench {label}: {ln}")
        print(f"bench {label}: {r['mode']} {r['value']:.6e} samples/s per card, event "
              f"{event_us:.3f} us/frame, device {us(dev and dev * 1e3)}/frame"
              + ("" if dev_us is None else f", event/device {event_us / dev_us:.3f}")
              + f", golden {r['golden_sec_per_frame'] * 1e3:.2f} ms/frame  [{card}]")
        rec[label] = {"record": r, "event_us_per_frame": event_us, "device_us_per_frame": dev_us,
                      "host_bound": "host-bound:" in out, "seconds": time.perf_counter() - t0}
    dev_us = rec["default"]["device_us_per_frame"]
    require(dev_us is not None and abs(dev_us / capture_us - 1) <= BENCH_DEVICE_TOL,
            f"bench default: device {dev_us} us/frame against phase 14's capture "
            f"{capture_us:.3f} us/frame (within {BENCH_DEVICE_TOL:.0%})")
    print(f"bench default: device {dev_us:.3f} us/frame against phase 14's demod_capture "
          f"{capture_us:.3f} us/frame: {(dev_us / capture_us - 1) * 100:+.2f}%  [{card}]")
    # The gate's ratchets against floors this phase just took on this card.
    lat_book = os.path.join(workdir, "latency.json")
    out = port_cli("tools.latency_probe", ["--bodies", GATE_LATENCY_BODIES, "--record", lat_book],
                   timeout=600)
    launches["bench latency_probe"] = profiling.summed_launch_lines(out)
    with open(lat_book) as fh:
        require(sorted(json.load(fh)) == sorted(f"{b}-{ANTENNAS}ant-fft{FFT}"
                                                for b in GATE_LATENCY_BODIES.split(",")),
                "the latency book lacks a body")
    out = port_cli("tools.gate", ["--skip-accuracy", "--perf", "--latency", "--books", workdir],
                   timeout=600)
    rec["gate"] = [ln for ln in out.splitlines() if ln.startswith("[gate]")]
    for ln in rec["gate"]:
        print(f"bench gate: {ln}  [{card}]")
    require(rec["gate"][-1] == "[gate] ALL PASS", f"the gate's ratchets: {rec['gate']}")
    print(f"phase 17 (bench): {time.perf_counter() - t_phase:.1f} s")
    return rec, launches


def call_ms(fn, n: int) -> float:
    """Per call, CUDA events around n back-to-back calls
    (``profiling.call_time``): the host's launch work is inside when it is
    slower than the device."""
    from ofdm_ls_mrc_tpu_torch.utils import profiling

    return profiling.call_time(fn, n, "cuda") * 1e3


def device_ms(fn, n: int) -> dict:
    """Per call, the device time of each CUDA kernel fn runs, by name:
    ``profiling.device_time`` of fn as one item, n calls a trace ("ms",
    "split", "partial", "missing"; see ``profiling._device_reading``)."""
    from ofdm_ls_mrc_tpu_torch.utils import profiling

    return profiling.device_time(lambda _: fn(), [None], reps=n, device="cuda", detail=True)


def measure(kernel_fn, plain_fn, n: int, library_fn=None):
    """Events in the order plain, kernel, kernel, plain (mean of each
    pair), then the profiler's device time of each (and of the library
    call, where there is one)."""
    p1, k1, k2, p2 = (call_ms(f, n) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn))
    t = {"kernel_call": (k1 + k2) / 2, "plain_call": (p1 + p2) / 2}
    sides = [("kernel", kernel_fn), ("plain", plain_fn)]
    if library_fn is not None:
        t["library_call"] = call_ms(library_fn, n)
        sides.append(("library", library_fn))
    for who, fn in sides:
        d = device_ms(fn, n)
        t[f"{who}_dev"], t[f"{who}_split"] = d["ms"], d["split"]
        t[f"{who}_partial"] = d["partial"]
    return t


def us(ms, partial: bool = False) -> str:
    """A device time in ms as 'x.xx us' (tagged where it was read from a
    partial trace), or 'not measured' where the profiler gave none."""
    if ms is None:
        return "not measured"
    return f"{ms * 1e3:.2f} us" + (" (partial trace)" if partial else "")


def timed(t: dict, who: str = "kernel") -> tuple:
    """(ms, source) of one side of a measure() result: the profiler's
    device time where it gave one, else the CUDA-event time per call."""
    if t[f"{who}_dev"] is None:
        return t[f"{who}_call"], "CUDA events per call (no device events)"
    return t[f"{who}_dev"], "torch.profiler" + (", partial trace" if t[f"{who}_partial"] else "")


def one_frame_work(name: str, a: int, f: int, s: int) -> tuple:
    """(bytes, FLOPs) of one frame's call of a kernel, f32 rows in: each
    input read once, each output written once (s data symbols)."""
    if name == "pilot_ls":
        return a * f * 8 + f * 8 + a * f * 8 + f * 4, fft_flops(a, f) + 15.0 * a * f
    if name == "fft_mrc":
        return (s * a * f * 8 + a * f * 8 + f * 4 + s * (f - 1) * 8,
                fft_flops(s * a, f) + 8.0 * s * a * f + 2.0 * s * f)
    return (s * a * f * 8 + a * f * 8 + f * 4 + s * f * 8,          # mrc_demod
            fft_flops(s * a, f) + 8.0 * s * a * f + 3.0 * s * f)


def baseline_phase(dev, card, golden, sim, reset_counts, counts, measure) -> tuple:
    """Phase 11 (see the module docstring); returns its records by label
    and the 4-antenna frames' records by F."""
    import torch

    from ofdm_ls_mrc_tpu_torch import FrameConfig
    from ofdm_ls_mrc_tpu_torch.models import StreamingDemodulator, UplinkReceiver
    from ofdm_ls_mrc_tpu_torch.ops import pipeline as pipe
    from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray

    t_phase = time.perf_counter()
    rec, by_fft = {}, {}
    s = SMALL_SYMBOLS - 1
    for label, (a, f, taps, snr, seed, evm_max) in {**BASELINE, **FRAME_128}.items():
        # tests/test_baseline_configs.py: a fresh rng(42) for each config.
        rng = np.random.default_rng(42)
        cfg = FrameConfig(num_antennas=a, fft_size=f, cyclic_prefix=SMALL_CP,
                          frame_len=SMALL_SYMBOLS)
        data, _ = sim.random_symbols(rng, (s, f - 1), "qpsk")
        pilot = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
        frame = sim.ChannelModel(a, f, num_taps=taps, snr_db=snr, seed=seed).apply(
            sim.make_tx_frame(data, pilot, SMALL_CP), SMALL_CP)
        gold = golden.demod_frame(frame, pilot, SMALL_CP)
        rx = UplinkReceiver(cfg, pilot, pipeline="fused", device=dev)
        fd = CArray.from_numpy(frame, dev)

        def hold(leg, out, need, want=gold, tol=GOLDEN_TOL):
            evm = sim.evm_db(np.fft.fftshift(out, axes=-1), data)
            rel = max_rel(out, want)
            print(f"baseline {label} {leg}: shape {out.shape}, EVM {evm:.2f} dB, max-rel "
                  f"{rel:.3e} vs {'golden' if want is gold else 'demod_frame'}, launches {need}")
            require(out.shape == (s, f - 1) and np.all(np.isfinite(out)),
                    f"baseline {label} {leg}: bad output, shape {out.shape}")
            require(evm < evm_max, f"baseline {label} {leg}: EVM {evm:.2f} dB >= {evm_max}")
            require(rel < tol, f"baseline {label} {leg}: max-rel {rel:.3e} >= {tol}")
            for name, n in need.items():
                require(n > 0, f"kernel {name} was not launched on the baseline {label} {leg}")
            return {"evm_db": evm, "max_rel": rel, "launches": need}

        torch.cuda.synchronize()
        reset_counts()
        whole = rx.demod_frame(fd).to_numpy()
        r = {"whole frame": hold("whole frame", whole,
                                 {k: counts()[k] for k in ("pilot_ls", "fft_mrc")})}
        if a == 4 and f == 64:
            reset_counts()
            split = rx.demod_data(fd[1:], *rx.estimate_channel(fd[0])).to_numpy()
            r["split-phase"] = hold("split-phase", split, {"mrc_demod": counts()["mrc_demod"]})
            sd = StreamingDemodulator(cfg, pilot, pipeline="fused", device=dev)
            torch.cuda.synchronize()
            reset_counts()
            sd.push_pilot(fd[0])
            rows = np.stack([sd.push_symbol(fd[i], slot=i).to_numpy()
                             for i in range(1, SMALL_SYMBOLS)])
            r["streaming"] = hold("streaming fused", rows,
                                  {k: counts()[k] for k in ("pilot_ls", "fft_mrc")},
                                  want=whole, tol=KERNEL_TOL)
        # Each kernel on this one frame: device time, its plain version and
        # torch.fft.fft over the same rows.
        y = fd[..., SMALL_CP:]
        h, inv = pipe.estimate_pilot_plain(y[0], rx.x_full)
        pilot_c = torch.complex(y[0].re.contiguous(), y[0].im.contiguous())
        data_c = torch.complex(y[1:].re.contiguous(), y[1:].im.contiguous())
        r["times"] = {
            "pilot_ls": measure(lambda: pipe.estimate_pilot_fused(y[0], rx.x_full),
                                lambda: pipe.estimate_pilot_plain(y[0], rx.x_full), 200,
                                lambda: torch.fft.fft(pilot_c, dim=-1)),
            "fft_mrc": measure(lambda: pipe.fused_pipeline(y[1:], h, inv),
                               lambda: pipe.fused_pipeline_plain(y[1:], h, inv), 200,
                               lambda: torch.fft.fft(data_c, dim=-1))}
        for name, t in r["times"].items():
            nbytes, flops = one_frame_work(name, a, f, s)
            b_ms, b_by = bound_ms(nbytes, flops)
            t["bound_ms"], t["bound_by"] = b_ms, b_by
            print(f"time {name} ({a}x{f}x{SMALL_SYMBOLS} f32, cp {SMALL_CP}, one frame): kernel "
                  f"device {us(t['kernel_dev'], t['kernel_partial'])}, per call "
                  f"{t['kernel_call'] * 1e3:.2f} us; plain device "
                  f"{us(t['plain_dev'], t['plain_partial'])}; torch.fft.fft device "
                  f"{us(t['library_dev'], t['library_partial'])}, per call "
                  f"{t['library_call'] * 1e3:.2f} us; bound {b_ms * 1e3:.3f} us ({b_by}, "
                  f"{nbytes / 1e3:.1f} KB, {flops / 1e6:.3f} MFLOP)  [{card}]")
        rec[label] = r
        if a == 4:
            by_fft[f] = r
        if a == 4 and f == 64:
            rec["capture"] = small_capture(dev, card, rx, pipe, measure)
    print(f"phase 11 (BASELINE configs): {time.perf_counter() - t_phase:.1f} s")
    return rec, by_fft


def small_capture(dev, card, rx, pipe, measure) -> dict:
    """demod_capture over SMALL_CAPTURE device-resident 4 x 64 x 9 f32 frames
    with the prefix (cp 8, drawn on the card from a seed): against the plain
    versions, then its device time per frame, each kernel's share, the bound
    and torch.fft.fft over the same rows."""
    import torch

    from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray

    a, f, s = rx.cfg.num_antennas, rx.cfg.fft_size, SMALL_SYMBOLS
    shape = (SMALL_CAPTURE, s, a, f + SMALL_CP)
    gen = torch.Generator(device=dev).manual_seed(0)
    cap = CArray(torch.randn(shape, generator=gen, device=dev),
                 torch.randn(shape, generator=gen, device=dev))
    y = cap[..., SMALL_CP:]

    def plain():
        h, inv = pipe.estimate_pilot_plain(y[:, 0], rx.x_full)
        return pipe.fused_pipeline_plain(y[:, 1:], h, inv)

    rel = max_rel(rx.demod_capture(cap).to_numpy(), plain().to_numpy())
    print(f"demod_capture {SMALL_CAPTURE} frames of {a}x{f}x{s} f32 (cp {SMALL_CP}, "
          f"{2 * cap.re.numel() * 4 / 1e6:.1f} MB): max-rel vs plain {rel:.3e}")
    require(rel < KERNEL_TOL, f"demod_capture {a}x{f}: max-rel vs plain {rel:.3e}")
    rows_c = torch.complex(y.re.contiguous(), y.im.contiguous())
    t = measure(lambda: rx.demod_capture(cap), plain, 10, lambda: torch.fft.fft(rows_c, dim=-1))
    del rows_c
    k = SMALL_CAPTURE
    nbytes = s * a * f * 8 + (s - 1) * (f - 1) * 8          # per frame: rows in, output out
    flops = fft_flops(s * a, f) + 15.0 * a * f + 8.0 * (s - 1) * a * f + 2.0 * (s - 1) * f
    b_ms, b_by = bound_ms(nbytes, flops)
    dev_ms, how = timed(t)
    split = {}      # each kernel's device time per frame; None where the trace had none
    for name in ("pilot_ls", "fft_mrc"):
        hits = [v for key, v in t["kernel_split"].items() if name in key]
        split[name] = sum(hits) / k if hits else None

    def ns(ms) -> str:
        return "not measured" if ms is None else f"{ms * 1e6:.2f} ns/frame"

    samples = k * s * a * f
    print(f"time demod_capture ({k} x {a}x{f}x{s} f32, cp {SMALL_CP}): "
          f"{ns(dev_ms / k)} ({how}; {samples / (dev_ms * 1e-3):.4g} samples/s; pilot_ls "
          f"{ns(split['pilot_ls'])}, fft_mrc {ns(split['fft_mrc'])}), per call "
          f"{t['kernel_call'] * 1e3:.2f} us; plain device {us(t['plain_dev'], t['plain_partial'])}"
          f" a call; torch.fft.fft over the same rows device "
          f"{us(t['library_dev'], t['library_partial'])}, per call "
          f"{t['library_call'] * 1e3:.2f} us  [{card}]")
    print(f"bound demod_capture {a}x{f}x{s}: {nbytes / 1e3:.3f} KB, {flops / 1e3:.1f} kFLOP a "
          f"frame -> {b_ms * 1e6:.2f} ns/frame ({b_by}); kernels {dev_ms * 1e6 / k:.2f} ns/frame "
          f"({b_ms * k / dev_ms:.1%} of the bound's rate; {how})  [{card}]")
    del cap, y
    torch.cuda.empty_cache()
    return {"frames": k, "max_rel_plain": rel, "ms_per_frame": dev_ms / k, "source": how,
            "pilot_ls_ms_per_frame": split["pilot_ls"], "fft_mrc_ms_per_frame": split["fft_mrc"],
            "plain_ms_per_frame": timed(t, "plain")[0] / k, "plain_source": timed(t, "plain")[1],
            "library_ms_per_frame": timed(t, "library")[0] / k,
            "library_source": timed(t, "library")[1],
            "call_ms": t["kernel_call"], "samples_per_s": samples / (dev_ms * 1e-3),
            "bound_ms_per_frame": b_ms, "bound_by": b_by}


def golden_downlink(golden, h, sent, cp):
    """The NumPy chain per symbol, modulate(apply(zf(h), x)): [A, N]."""
    w = golden.zf_precoder(h)
    return np.concatenate([golden.modulate_symbol(golden.apply_precoder(w, sent[:, i]), cp)
                           for i in range(sent.shape[1])], axis=1)


def native_downlink(h, sent, cp):
    """The same chain through the C++ oracle (io/native_dsp): [A, N]."""
    from ofdm_ls_mrc_tpu_torch.io import native_dsp

    w = native_dsp.zf_precoder(h)
    cols = []
    for i in range(sent.shape[1]):
        ant = native_dsp.apply_precoder(w, sent[:, i])
        cols.append(np.stack([native_dsp.modulate_symbol(row, cp) for row in ant]))
    return np.concatenate(cols, axis=1)


def downlink_phase(workdir, dev, card, golden, call_ms, device_ms) -> dict:
    """Phase 12 (see the module docstring); returns its records."""
    import torch

    from ofdm_ls_mrc_tpu_torch import FrameConfig
    from ofdm_ls_mrc_tpu_torch.models import DownlinkTransmitter
    from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray

    t_phase = time.perf_counter()
    rec = {}
    f, sd = DL_FFT, DL_SYMBOLS - 1
    for label, (u, a, fmt) in DL_RUNS.items():
        out, data = os.path.join(workdir, "dl.dat"), os.path.join(workdir, "dl_sent.dat")
        t0 = time.perf_counter()
        stdout = port_cli("apps.dl_app", [
            "--users", str(u), "--antennas", str(a), "--fft-size", str(f), "--cp-size", str(DL_CP),
            "--frame-len", str(DL_SYMBOLS), "--num-frames", str(DL_FRAMES), "--simulate-channel",
            "--verify", "--out", out, "--out-format", fmt, "--data-out", data])
        wall = time.perf_counter() - t0
        for line in stdout.splitlines():
            print(f"dl_app {label}: {line}  [{card}]")
        evm = float(re.search(r"ZF separation EVM \(worst symbol\): (-?[\d.]+) dB", stdout).group(1))
        pre, mod = (float(v) for v in re.search(
            r"precode median ([\d.]+) us, modulate median ([\d.]+) us", stdout).groups())
        fps = float(re.search(r"([\d.]+) frames/s", stdout).group(1))
        fps_steady = float(re.search(r"([\d.]+) frames/s after the first frame", stdout).group(1))
        require(evm < -40.0, f"dl_app {label}: separation EVM {evm} dB >= -40")
        # The oracles on the app's channel (seed 0, drawn first, as the app
        # draws it) and its sent symbols.
        rng = np.random.default_rng(0)
        h = ((rng.standard_normal((f - 1, u, a)) + 1j * rng.standard_normal((f - 1, u, a)))
             / np.sqrt(2)).astype(np.complex64)
        sent = np.fromfile(data, np.complex64).reshape(u, DL_FRAMES * sd, f - 1)
        if fmt == "sc16":
            got = golden.io.sc16_to_complex(np.fromfile(out, np.int16)).reshape(a, -1)
        else:
            got = np.fromfile(out, np.complex64).reshape(a, -1)
        want = golden_downlink(golden, h, sent, DL_CP)
        err_np = max_abs(got, want)
        t0 = time.perf_counter()
        err_native = max_abs(got, native_downlink(h, sent, DL_CP))
        native_s = time.perf_counter() - t0
        print(f"dl_app {label}: exit 0 in {wall:.1f} s with start-up, separation EVM {evm} dB, "
              f"capture {got.shape} max-abs {err_np:.3e} vs the NumPy chain, {err_native:.3e} "
              f"vs the C++ oracle ({native_s:.1f} s on the host); {fps} frames/s ({fps_steady} after "
              f"the first frame), per symbol "
              f"precode {pre} us, modulate {mod} us (the app's line)  [{card}]")
        for who, err in (("NumPy chain", err_np), ("C++ oracle", err_native)):
            require(err <= DL_TOL, f"dl_app {label}: max-abs {err:.3e} vs the {who} > {DL_TOL}")
        # precode and modulate on device-resident inputs, in this process.
        cfg = FrameConfig(num_antennas=a, fft_size=f, cyclic_prefix=DL_CP, frame_len=DL_SYMBOLS)
        tx = DownlinkTransmitter(cfg, device=dev)
        h_dev, x_dev = CArray.from_numpy(h, dev), CArray.from_numpy(sent[:, 0], dev)
        ant = tx.precode(h_dev, x_dev)
        times = {}
        for step, fn in (("precode", lambda: tx.precode(h_dev, x_dev)),
                         ("modulate", lambda: tx.modulate(ant))):
            d = device_ms(fn, 100)
            times[step] = {"device_ms": d["ms"], "device_partial": d["partial"],
                           "call_ms": call_ms(fn, 100)}
            print(f"time downlink {step} ({u} users x {a} antennas x {f}, one symbol): device "
                  f"{us(d['ms'], d['partial'])} in {len(d['split'])} kernels (torch.profiler, "
                  f"100 calls), per call {times[step]['call_ms'] * 1e3:.2f} us (CUDA events, "
                  f"100 calls)  [{card}]")
            for key, v in sorted(d["split"].items(), key=lambda kv: -kv[1])[:4]:
                print(f"    {v * 1e3:9.2f} us/call  {key[:90]}")
        rec[label] = {"evm_db": evm, "max_abs_numpy": err_np, "max_abs_native": err_native,
                      "frames_per_s": fps, "frames_per_s_after_first": fps_steady,
                      "app_precode_us": pre, "app_modulate_us": mod,
                      "seconds": wall, **{f"{k}_{m}": v[m] for k, v in times.items()
                                          for m in ("device_ms", "device_partial", "call_ms")}}
        del h_dev, x_dev, ant, tx
    torch.cuda.empty_cache()
    print(f"phase 12 (downlink): {time.perf_counter() - t_phase:.1f} s")
    return rec


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
    small = list(ptxas_lines(ptxas.getvalue(), SMALL_FFT, ("pilot_ls", "fft_mrc"), 4))
    require(len(small) == 16, f"ptxas report: {len(small)} pilot_ls/fft_mrc kernels at F = 64 "
                              "and 128, want 16")
    print("\n".join(small))
    speed_summary = list(speed_ptxas_lines(ptxas.getvalue()))
    require(len(speed_summary) == 12, f"ptxas report: {len(speed_summary)} speed kernels at F = "
                                      f"256, {FFT} and 4096, want 12")
    print("\n".join(speed_summary))
    side_summary = list(side_ptxas_lines(ptxas.getvalue()))
    require(len(side_summary) == 32, f"ptxas report: {len(side_summary)} side-form kernels at "
                                     "F = 256, 512, 2048 and 4096, want 32")
    print("\n".join(side_summary))
    for ln in side_summary:
        spilled = int(re.search(r"(\d+) B spilled", ln).group(1))
        require(spilled <= (0 if ln.startswith("ptxas mrc_demod_side<2048") else 16),
                f"{ln}: spills past the side form's bound")
    probe_summary = list(probe_ptxas_lines(ptxas.getvalue()))
    print("\n".join(probe_summary))
    require(any(ln.startswith("ptxas burn_tile") for ln in probe_summary),
            "ptxas report: no out-of-line burn_tile")

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

    def check_pilot(label, y, x, quiet=False, name="pilot_ls"):
        """estimate_pilot_fused against estimate_pilot_plain: max-rel on h
        and sum_a|h|^2 (inv, its reciprocal, peaks at the weakest bin);
        max-abs on the kernel's outputs, h and inv."""
        h_k, inv_k = pipe.estimate_pilot_fused(y, x)
        h_p, inv_p = pipe.estimate_pilot_plain(y, x)
        torch.cuda.synchronize()
        h_k, h_p = h_k.to_numpy(), h_p.to_numpy()
        inv_k, inv_p = inv_k.cpu().numpy(), inv_p.cpu().numpy()
        return check(name, label, [(h_k, h_p), (1 / inv_k, 1 / inv_p)],
                     [(h_k, h_p), (inv_k, inv_p)], quiet=quiet)

    errs_abs = {name: 0.0 for name in (*KERNELS, *small_records())}
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
        cp_max = SMALL_CP if f in SMALL_FFT else CP
        for a in (SMALL_ANTENNAS if f in SMALL_FFT else PILOT_ANTENNAS):
            plan = fft_plan.pilot_plan(a, f)
            rels = [check_pilot(f"F={f} A={a} {dtype} cp={cp}",
                                frame_of(rng, (PILOT_FRAMES, 2, a, f + cp), dtype)[:, 0, :, cp:],
                                x_f, quiet=True,
                                name=f"pilot_ls F={f}" if f in SMALL_FFT else "pilot_ls")
                    for dtype in ("f32", "int16") for cp in (0, 1, cp_max)]
            print(f"check pilot_ls F={f} A={a}: cluster of {plan.clusters} blocks x "
                  f"{plan.teams} teams x {plan.rows} rows ({plan.threads} threads a block), "
                  f"{PILOT_FRAMES} frames a call, f32/int16 x cp 0/1/{cp_max}: "
                  f"max-rel {max(rels):.3e}")
    # fft_mrc at the 64-subcarrier sizes: PILOT_FRAMES frames of SMALL_SYMBOLS
    # symbols in one launch, 4 symbols a block.
    for f in SMALL_FFT:
        x_f = ls.pad_pilot(np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64), dev)
        g = fft_plan.plan(f).symbols_per_block
        for a in SMALL_ANTENNAS:
            rels = []
            for dtype in ("f32", "int16"):
                for cp in (0, 1, SMALL_CP):
                    y = frame_of(rng, (PILOT_FRAMES, SMALL_SYMBOLS, a, f + cp), dtype)[..., cp:]
                    h_p, inv_p = pipe.estimate_pilot_plain(y[:, 0], x_f)
                    out_k = pipe.fused_pipeline(y[:, 1:], h_p, inv_p)
                    out_p = pipe.fused_pipeline_plain(y[:, 1:], h_p, inv_p)
                    torch.cuda.synchronize()
                    rels.append(check(f"fft_mrc F={f}", f"A={a} {dtype} cp={cp}",
                                      [(out_k.to_numpy(), out_p.to_numpy())], quiet=True))
            print(f"check fft_mrc F={f} A={a}: {PILOT_FRAMES} frames of {SMALL_SYMBOLS - 1} data "
                  f"symbols a call ({-(-(SMALL_SYMBOLS - 1) // g)} x {PILOT_FRAMES} blocks of {g} "
                  f"symbols), f32/int16 x cp 0/1/{SMALL_CP}: max-rel {max(rels):.3e}")
    for dtype in ("f32", "int16"):  # the 64-bin geometry: 8 symbols a block
        frame = frame_of(rng, (SYMBOLS, 4, 64), dtype)
        small_x = ls.pad_pilot(pilot[:63], dev)
        hconj, hsqrd = composed_estimate(frame[0], small_x)
        eq_k = fused_mrc.fused_demod(frame[1:], hconj, hsqrd)
        eq_p = fused_mrc.fused_demod_plain(frame[1:], hconj, hsqrd)
        torch.cuda.synchronize()
        check("mrc_demod", f"F=64 A=4 {dtype}", [(eq_k.to_numpy(), eq_p.to_numpy())])
    for variant, ts, s, a, f in PROBE_CHECKS:
        pre, pim, bias, wmat = dma_probe.make_frames(1, s, a, f, dev, seed=2)
        bias = bias + 0.5
        name = "io_manual" if variant.startswith("manual") else "io_auto"
        label = f"{variant} ts={ts} S={s} A={a} F={f}"
        for compute in (0, PROBE_COMPUTE):
            got = dma_probe.io_probe(pre[0], pim[0], bias, wmat, variant=variant,
                                     ts=ts, compute=compute)
            want = dma_probe.io_probe_plain(pre[0], pim[0], bias, wmat, compute)
            torch.cuda.synchronize()
            check(name, f"{label} compute={compute}",
                  [(g.cpu().numpy(), w.cpu().numpy()) for g, w in zip(got, want)])
        # The burn at scale 1, where it shows (1e-9 hides it below f32
        # resolution): held to BURN_TOL of the largest burn term.
        err = dma_probe.burn_error(pre[0], pim[0], bias, wmat, PROBE_COMPUTE,
                                   variant=variant, ts=ts)
        print(f"check {name} {label} compute={PROBE_COMPUTE} burn_scale=1: "
              f"{err:.3e} of the largest burn term")
        require(err < dma_probe.BURN_TOL,
                f"{name} {label}: burn at scale 1 off by {err:.3e} >= {dma_probe.BURN_TOL}")
    del pre, pim
    side, side_records = side_legs(dev, card, reset_counts, counts, measure, errs_abs)

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
    # Two rounds over the variants, the best of each kept: a reading taken
    # first in the phase came out up to 5% slower than the same kernel's
    # later in the run.
    first = {}
    for rnd in range(2):
        for compute in (0, PROBE_COMPUTE):
            for variant in PROBE_VARIANTS:
                t = dma_probe.time_per_frame(
                    lambda: dma_probe.io_probe(sre, sim_, bias, wmat, variant=variant,
                                               ts=PROBE_TS, compute=compute),
                    PROBE_FRAMES, passes=10, reps=PROBE_REPS)
                first.setdefault((variant, compute), t)
                probe_s[variant, compute] = min(t, probe_s.get((variant, compute), t))
    for (variant, compute), t in probe_s.items():
        print(f"probe {variant:9s} compute={compute}: {t * 1e6:8.2f} us/frame  "
              f"({b_in / t / 1e9:7.1f} GB/s in, {(b_in + b_out) / t / 1e9:7.1f} GB/s "
              f"in+out; round 1 {first[variant, compute] * 1e6:.2f})  [{card}]")
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
    burn_flops = SYMBOLS * ANTENNAS * (FFT // 128) * PROBE_COMPUTE * 2.0 * 128 * 128
    probe_bound2_ms = max((b_in + FFT * 4 + b_out) / HBM_BYTES_PER_S,
                          burn_flops / BF16_TENSOR_FLOPS) * 1e3
    print(f"bound probes compute={PROBE_COMPUTE}: {(b_in + FFT * 4 + b_out) / 1e6:.3f} MB -> "
          f"{(b_in + FFT * 4 + b_out) / HBM_BYTES_PER_S * 1e6:.2f} us, burn "
          f"{burn_flops / 1e6:.1f} MFLOP -> {burn_flops / BF16_TENSOR_FLOPS * 1e6:.2f} us at "
          f"989 TFLOP/s bf16; auto {probe_s['auto', PROBE_COMPUTE] * 1e6:.2f} us/frame "
          f"({burn_flops / probe_s['auto', PROBE_COMPUTE] / 1e12:.1f} TFLOP/s burn)  [{card}]")

    # -- 8. timing ----------------------------------------------------------
    def report(label: str, t: dict, frames: int = 1, antennas: int = ANTENNAS) -> None:
        samples = frames * SYMBOLS * antennas * FFT
        for who in ("kernel", "plain"):
            call, dev_t = t[f"{who}_call"], t[f"{who}_dev"]
            rate = f" ({samples / (dev_t * 1e-3):.4g} samples/s)" if dev_t is not None else ""
            print(f"time {label} {who}: device "
                  f"{us(None if dev_t is None else dev_t / frames, t[f'{who}_partial'])}/frame"
                  f"{rate}, per call {call * 1e3 / frames:.2f} us/frame "
                  f"({samples / (call * 1e-3):.4g} samples/s)  [{card}]")
            for key, ms in sorted(t[f"{who}_split"].items(), key=lambda kv: -kv[1])[:4]:
                print(f"    {ms / dev_t:6.1%}  {ms * 1e3:9.2f} us/call  {key[:90]}")
        if "library_call" in t:
            dev_t = t["library_dev"]
            print(f"time {label} library: device "
                  f"{us(None if dev_t is None else dev_t / frames, t['library_partial'])}/frame, "
                  f"per call {t['library_call'] * 1e3 / frames:.2f} us/frame  [{card}]")

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
    d = device_ms(lambda: sd.push_symbol(frame_dev[1], slot=1), 100)
    print(f"time streaming fused push_symbol: device {us(d['ms'], d['partial'])}/symbol ("
          + ", ".join(f"{k[:40]} {v * 1e3:.2f} us" for k, v in d["split"].items())
          + f")  [{card}]")
    # Each record's times with their sources: the device time where the
    # profiler gave one, else the event time per call.
    ms = {name: {"ms": timed(t), "plain_ms": timed(t, "plain"), "library_ms": timed(t, "library")}
          for name, t in times.items()}

    # The probes: per frame over the 20-frame batch (one launch a pass).
    y2 = torch.stack([sre, sim_])
    manual_variant = min(PROBE_VARIANTS[1:], key=lambda v: probe_s[v, 0])
    plain_s = dma_probe.time_per_frame(
        lambda: dma_probe.io_probe_plain(sre, sim_, bias, wmat), PROBE_FRAMES, 10, PROBE_REPS)
    library_s = dma_probe.time_per_frame(lambda: torch.sum(y2, dim=2), PROBE_FRAMES, 10, PROBE_REPS)
    per_pass = "CUDA events over one launch a pass of 20 frames"
    for name, variant in (("io_auto", "auto"), ("io_manual", manual_variant)):
        ms[name] = {"ms": (probe_s[variant, 0] * 1e3, per_pass),
                    "plain_ms": (plain_s * 1e3, per_pass),
                    "library_ms": (library_s * 1e3, per_pass)}
    print(f"time io probes (per frame, 20 frames, compute 0): plain {plain_s * 1e6:.2f} us, "
          f"library torch.sum {library_s * 1e6:.2f} us  [{card}]")

    def xyyx(fx, fy):
        """us per frame over the batch, in the order X Y Y X."""
        return [dma_probe.time_per_frame(fn, PROBE_FRAMES, 10, PROBE_REPS) * 1e6
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
    k64_ms, k64_src = timed(t64)
    print(f"bound fft_mrc 64 antennas: {b64 / 1e6:.3f} MB, {f64 / 1e6:.1f} MFLOP -> "
          f"{b64_ms * 1e3:.2f} us ({b64_by}) at the published peaks, "
          f"{b64 / io_floor * 1e6:.2f} us at the measured io floor; kernel "
          f"{k64_ms * 1e3:.2f} us ({k64_src})  [{card}]")
    # pilot_ls on the 64-antenna pilot: a cluster of 8 blocks x 4 teams x 2 rows.
    wide_pc = torch.complex(wide[0].re.contiguous(), wide[0].im.contiguous())
    t64p = measure(lambda: pipe.estimate_pilot_fused(wide[0], x_full),
                   lambda: pipe.estimate_pilot_plain(wide[0], x_full), 200,
                   lambda: torch.fft.fft(wide_pc, dim=-1))
    del wide_pc
    report("pilot_ls (one 64-antenna pilot, 64x1024 f32, cp 72)", t64p, antennas=64)
    p64 = fft_plan.pilot_plan(64, FFT)
    bp64_ms, bp64_by = bound_ms(64 * FFT * 16 + FFT * 12, fft_flops(64, FFT) + 15.0 * 64 * FFT)
    kp64_ms, kp64_src = timed(t64p)
    print(f"bound pilot_ls 64 antennas: {bp64_ms * 1e3:.2f} us ({bp64_by}); kernel "
          f"{kp64_ms * 1e3:.2f} us ({kp64_src}), cluster of {p64.clusters} blocks x "
          f"{p64.teams} teams x {p64.rows} rows  [{card}]")

    # -- 9. the live path: ring -> demod_app on the card -> output file -------
    del wide
    torch.cuda.empty_cache()
    live = {}
    with tempfile.TemporaryDirectory() as workdir:
        pilot_path = os.path.join(workdir, "Pilots.dat")
        golden.write_pilot(pilot_path, np.exp(2j * np.pi * np.random.default_rng(12).random(
            FFT - 1)).astype(np.complex64))
        live_pilot = golden.load_pilot(pilot_path, FFT - 1)
        t0 = time.perf_counter()
        wire, sent, gold = live_frames(golden, sim, live_pilot)
        print(f"live path: {LIVE_FRAMES} frames made in {time.perf_counter() - t0:.1f} s")
        for label, (flags, want_launches) in LIVE_MODES.items():
            out = os.path.join(workdir, f"Output_{len(live)}.dat")
            t0 = time.perf_counter()
            stdout = run_live_app(flags, wire, pilot_path, out)
            print(f"live {label}: app run {time.perf_counter() - t0:.1f} s with start-up")
            live[label] = check_live(label, stdout, out, sent, gold, want_launches, card,
                                     golden, sim)
        live["host split"] = host_split(wire, live_pilot, dev, card, workdir)
    del wire, sent, gold

    # -- 10. three processes: tx_app -> rx_app -> demod_app, compare_app, gate --
    with tempfile.TemporaryDirectory() as workdir:
        live.update(three_processes(workdir, card, golden, sim, dev, call_ms, device_ms))

    # -- 11. the BASELINE configs 1-2 on the card; the 4 x 64 capture ---------
    baseline, baseline_rows = baseline_phase(dev, card, golden, sim, reset_counts, counts,
                                             measure)

    # -- 12. the downlink: dl_app on the card against two oracles -------------
    with tempfile.TemporaryDirectory() as workdir:
        downlink = downlink_phase(workdir, dev, card, golden, call_ms, device_ms)

    # -- 13. the sharded paths: config 4 at world size 1, two ranks, streaming,
    # downlink ---------------------------------------------------------------
    with tempfile.TemporaryDirectory() as workdir:
        sharded, variant = sharded_phase(workdir, dev, card, golden, sim, reset_counts, counts,
                                         measure, call_ms, device_ms)

    # -- 14. the bf16 speed mode: both kernels, every path that selects it ----
    with tempfile.TemporaryDirectory() as workdir:
        speed, speed_records = speed_phase(workdir, dev, card, golden, sim, reset_counts,
                                           counts, measure, device_ms, live["gate"])

    # -- 15. the large-F geometry: F = 8192, 16384 and 32768 -------------------
    with tempfile.TemporaryDirectory() as workdir:
        large, large_records = large_fft_phase(workdir, dev, card, golden, sim, reset_counts,
                                               counts, measure, io_floor, ptxas.getvalue())

    # -- 16. the tools and examples of the port, each through its command line
    with tempfile.TemporaryDirectory() as workdir:
        tools, tool_launch = tools_phase(workdir, card, rx, frame_dev, reset_counts, counts)

    # -- 17. the bench entry and the gate's ratchets, each a process ---------
    exact_capture = speed_records[0]["capture_ms_per_frame_xyyx"]["exact"]
    with tempfile.TemporaryDirectory() as workdir:
        bench, bench_launch = bench_phase(workdir, card, sum(exact_capture) / 2 * 1e3)

    # Work of each kernel at the timed shapes (f32 in, one frame; the probes
    # one frame of 101 symbols): each input read once, each output written once.
    a, f, s = ANTENNAS, FFT, SYMBOLS - 1
    work = {name: one_frame_work(name, a, f, s) for name in ("pilot_ls", "fft_mrc", "mrc_demod")}
    work["io_auto"] = (b_in + f * 4 + b_out, 2.0 * SYMBOLS * a * f)
    work["io_manual"] = work["io_auto"]
    records = []
    for name, (src, replaces) in KERNELS.items():
        nbytes, flops = work[name]
        b_ms, b_by = bound_ms(nbytes, flops)
        rec = {"name": name, "route": "cuda", "source": f"ofdm_ls_mrc_tpu_torch/csrc/{src}",
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": errs_abs[name], **{key: v for key, (v, _) in ms[name].items()},
               "bound_ms": b_ms, "bound_by": b_by, "floor_ms": nbytes / io_floor * 1e3,
               "time_source": {key: how for key, (_, how) in ms[name].items()}}
        if name == "io_manual":
            rec["variant"] = manual_variant
        if name in ("io_auto", "io_manual"):
            rec["ms_compute2"] = probe_s[rec.get("variant", "auto"), PROBE_COMPUTE] * 1e3
            rec["bound_ms_compute2"] = probe_bound2_ms
        if name in ("pilot_ls", "fft_mrc"):
            rec["launches_streaming"] = stream_launches["fused"][name]
            rec["launches_app"] = {label: r["launches"][name] for label, r in live.items()
                                   if "launches" in r}
        if name == "fft_mrc":
            rec["ms_64_antennas"], rec["bound_ms_64_antennas"] = k64_ms, b64_ms
            rec["time_source"]["ms_64_antennas"] = k64_src
        if name == "pilot_ls":
            cap_ms = t_cap_pilot["kernel_dev"]
            rec["ms_capture_per_frame"] = None if cap_ms is None else cap_ms / CAPTURE_FRAMES
            rec["time_source"]["ms_capture_per_frame"] = timed(t_cap_pilot)[1]
            rec["ms_64_antennas"], rec["bound_ms_64_antennas"] = kp64_ms, bp64_ms
            rec["time_source"]["ms_64_antennas"] = kp64_src
        records.append(rec)
        print(f"bound {name}: {nbytes / 1e6:.3f} MB, {flops / 1e6:.1f} MFLOP -> "
              f"{b_ms * 1e3:.2f} us ({b_by}) at the published peaks, "
              f"{nbytes / io_floor * 1e6:.2f} us at the measured io floor; kernel "
              f"{rec['ms'] * 1e3:.2f} us ({rec['time_source']['ms']})  [{card}]")
    # The 64-subcarrier sizes: one 4 x F x 9 frame of phase 11 (launches of
    # its whole-frame leg); at F = 64 also the 4,096-frame capture.
    for name in small_records():
        kernel, f = name.split(" F=")
        row = baseline_rows[int(f)]
        t = row["times"][kernel]
        sides = {"ms": timed(t), "plain_ms": timed(t, "plain"), "library_ms": timed(t, "library")}
        rec = {"name": name, "route": "cuda",
               "source": f"ofdm_ls_mrc_tpu_torch/csrc/{KERNELS[kernel][0]}",
               "replaces": KERNELS[kernel][1], "launches": row["whole frame"]["launches"][kernel],
               "max_abs_err": errs_abs[name], **{key: v for key, (v, _) in sides.items()},
               "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
               "time_source": {key: how for key, (_, how) in sides.items()},
               "shape": f"4x{f}x{SMALL_SYMBOLS} f32, cp {SMALL_CP}, one frame"}
        if f == "64":
            cap = baseline["capture"]
            rec["ms_capture_per_frame"] = cap[f"{kernel}_ms_per_frame"]
            rec["time_source"]["ms_capture_per_frame"] = cap["source"]
            rec["launches_baseline"] = {k: v["whole frame"]["launches"][kernel]
                                        for k, v in baseline.items() if "whole frame" in v}
        records.append(rec)

    # The pilot's sum|h|^2 variant (the sharded paths' pilot): launches of
    # phase 13's sharded frame, times on its 64 x 1024 sc16 pilot.
    records.append({"name": "pilot_ls_sum", "route": "cuda",
                    "source": f"ofdm_ls_mrc_tpu_torch/csrc/{KERNELS['pilot_ls'][0]}",
                    "replaces": KERNELS["pilot_ls"][1], **variant,
                    "launches_streaming": sharded["streaming"]["launches"]["pilot_ls_sum"]})
    records.extend(side_records)
    records.extend(speed_records)
    records.extend(large_records)
    for rec in records:
        if " F=" not in rec["name"]:
            rec["launches_tools"] = {leg: n.get(rec["name"], 0) for leg, n in tool_launch.items()}
            rec["launches_bench"] = {leg: n.get(rec["name"], 0) for leg, n in bench_launch.items()}

    require("jax" not in sys.modules, "jax was imported")
    require(not any(m == "ofdm_ls_mrc_tpu" or m.startswith("ofdm_ls_mrc_tpu.")
                    for m in sys.modules), "the JAX package was imported")
    print(json.dumps({"side": side, "live": live, "baseline": baseline, "downlink": downlink,
                      "sharded": sharded, "speed": speed, "large_fft": large, "tools": tools,
                      "bench": bench, "card": card}))
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
