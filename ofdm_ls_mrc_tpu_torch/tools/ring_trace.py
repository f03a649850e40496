"""Where the time of the data kernels' one-launch split form goes (the
exact ``fft_mrc_ring_kernel`` and the bf16 ``fft_mrc_bf16_ring_kernel``,
``csrc/fft_split.cuh`` ring_loop), read from the %globaltimer stamps each
tile writes when ``csrc/fft_mrc.cu`` (or ``csrc/fft_mrc_bf16.cu`` with
``csrc/fft_split.cu``) is built with ``-DOFDM_RING_TRACE`` (a separate
library; the port's build never defines it).

  python -m ofdm_ls_mrc_tpu_torch.tools.ring_trace [--fft 16384 32768] [--ring-mb M]
      [--antennas 16] [--int16] [--bf16]

For one A x F x 100-symbol frame (f32 rows, or the same rows as int16) it
runs ``fft_mrc`` (``--bf16``: ``fft_mrc_bf16``, F = 8192 to 32768) three
times on the ring of ``fft_plan.split_ring`` (the last run traced), checks
the output against the plain version, and prints for each kind of tile its
count, its mean, median and 90th-percentile duration and the mean of each
phase -- a column tile: its samples loaded, its FFT, its wait for a free
slot, its stores and count; an exact row tile: its estimate slice and gains
in flight, its wait for the symbol's columns, its rows read and folded, its
epilogue; a bf16 row tile: its wait for the columns, its antennas (every
row of the slot copied in), its epilogue, and thread 0's sums over the
antennas (the TMA copies' issue, their wait for a free tile, the wait for a
full tile, the products issued and waited for, the folds with the next
antenna's h loads, the second quarter's product) -- the blocks' busy time
by kind, the mean idle time between a block's tiles, and the tiles running
at once in each tenth of the launch.  All times are microseconds of device
time.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np
import torch

from ofdm_ls_mrc_tpu_torch.kernels import build
from ofdm_ls_mrc_tpu_torch.ops import fft_plan, ls
from ofdm_ls_mrc_tpu_torch.ops import pipeline as pipe
from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray

SYMBOLS = 100
STAMPS = 12  # per ticket: start, four phase ends, block | kind | item, six phase sums (ns)
PHASES = {True: ("load", "fft", "slot wait", "store + count"),
          False: ("slice + gains", "columns wait", "rows", "epilogue")}
BF16_PHASES = {True: PHASES[True],
               False: ("start", "columns wait", "antennas", "epilogue")}
# The bf16 row tile's sums over its antennas (fft_mrc_bf16.cu ring_rows).
BF16_SUMS = ("copies issued", "wait for a free tile", "wait for a full tile", "products",
             "folds and the next h loads", "of the products, the second quarter's")


def traced_library(bf16: bool = False) -> ctypes.CDLL:
    name = "libring_trace_bf16" if bf16 else "libring_trace"
    out = build.BUILD_DIR / "trace" / f"{name}_{build.source_hash()}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        srcs = (["fft_mrc_bf16.cu", "fft_split.cu"] if bf16 else ["fft_mrc.cu"])
        subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-DOFDM_RING_TRACE", "-shared",
                        "-o", str(out), *(str(build.CSRC_DIR / s) for s in srcs)], check=True)
    lib = ctypes.CDLL(str(out))
    entry = "ofdm_fft_mrc_bf16" if bf16 else "ofdm_fft_mrc"
    getattr(lib, entry).argtypes = build.SIGNATURES[entry]
    lib.ofdm_ring_trace_set.argtypes = (ctypes.c_void_p,)
    return lib


def summary(stamps: np.ndarray, bf16: bool = False) -> None:
    """Print the per-kind phases, busy and idle time and concurrency of one
    traced launch ([tickets, STAMPS] int64)."""
    phases = BF16_PHASES if bf16 else PHASES
    t = stamps[:, :5] - stamps[:, 0].min()
    t = t / 1e3
    column = ((stamps[:, 5] >> 31) & 1) == 1
    block = stamps[:, 5] >> 32
    span = t[:, 4].max()
    print(f"  span {span:.1f} us, {len(np.unique(block))} blocks, {len(t)} tiles")
    for kind in (True, False):
        m = column if kind else ~column
        dur = t[m, 4] - t[m, 0]
        means = ", ".join(f"{name} {np.mean(t[m, i + 1] - t[m, i]):.2f}"
                          for i, name in enumerate(phases[kind]))
        print(f"  {'column' if kind else 'row'} tiles: {m.sum()}, mean {dur.mean():.2f}, median "
              f"{np.median(dur):.2f}, p90 {np.percentile(dur, 90):.2f} us ({means}); busy "
              f"{dur.sum():.0f} block-us")
        if bf16 and not kind:
            sums = ", ".join(f"{name} {np.mean(stamps[m, 6 + i]) / 1e3:.2f}"
                             for i, name in enumerate(BF16_SUMS))
            print(f"  bf16 row tiles, thread 0's sums over the antennas (mean us a "
                  f"tile): {sums}")
    idle = []
    for b in np.unique(block):
        mine = np.argsort(t[block == b, 0])
        start, end = t[block == b, 0][mine], t[block == b, 4][mine]
        idle.append(start[0] + (start[1:] - end[:-1]).sum())
    edges = np.linspace(0, span, 11)
    tenths = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        def running(m):
            overlap = np.minimum(t[m, 4], hi) - np.maximum(t[m, 0], lo)
            return np.clip(overlap, 0, None).sum() / (hi - lo)
        tenths.append(f"{running(column):.0f}c/{running(~column):.0f}r")
    print(f"  idle between a block's tiles: mean {np.mean(idle):.1f} us; tiles running by "
          f"tenth (column/row): {' '.join(tenths)}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--fft", type=int, nargs="+", default=list(fft_plan.SPLIT_FFT_SIZES))
    ap.add_argument("--ring-mb", type=int, default=0,
                    help="MiB of the ring (default: fft_plan.SPLIT_RING_BYTES)")
    ap.add_argument("--antennas", type=int, default=16)
    ap.add_argument("--int16", action="store_true", help="int16 rows (sc16 full scale)")
    ap.add_argument("--bf16", action="store_true",
                    help="trace fft_mrc_bf16's ring (F = 8192 to 32768) in place of fft_mrc's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ring_trace: no CUDA device", file=sys.stderr)
        return 1
    if args.ring_mb:
        fft_plan.SPLIT_RING_BYTES = args.ring_mb << 20
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    lib = traced_library(args.bf16)
    a = args.antennas
    sizes = fft_plan.SPEED_SPLIT_SIZES if args.bf16 else fft_plan.SPLIT_FFT_SIZES
    k1 = fft_plan.SPEED_RING_K1 if args.bf16 else fft_plan.SPLIT_K1
    for f in args.fft:
        if f not in sizes:
            raise SystemExit(f"ring_trace: F={f} not in {sizes}")
        g = torch.Generator(device=dev).manual_seed(f)
        y = CArray(*(0.1 * torch.randn((1, SYMBOLS + 1, a, f), generator=g, device=dev)
                     for _ in range(2)))
        x = ls.pad_pilot(np.exp(2j * np.pi * np.random.default_rng(f).random(f - 1))
                         .astype(np.complex64), dev)
        h, inv = pipe.estimate_pilot_plain(y[:, 0], x)
        if args.int16:
            y = CArray(*(torch.round(v * 32767).clamp(-32768, 32767).to(torch.int16)
                         for v in (y.re, y.im)))
        rows = y[:, 1:]
        st = rows.re.stride()
        out = CArray(torch.empty((1, SYMBOLS, f - 1), device=dev),
                     torch.empty((1, SYMBOLS, f - 1), device=dev))
        ring, counters, slots, lag = pipe._split_ring(SYMBOLS, a, f, (h.re, h.im, inv), dev, k1)
        ct, rt = fft_plan.split_ring_tiles(a, f, k1)
        stamps = torch.zeros((SYMBOLS * (ct + rt), STAMPS), dtype=torch.int64, device=dev)
        table = fft_plan.split_tables(f, args.bf16 and args.int16, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for run in range(3):
            counters.zero_()
            if run == 2:
                torch.cuda.synchronize()
                assert lib.ofdm_ring_trace_set(stamps.data_ptr()) == 0
            if args.bf16:
                err = lib.ofdm_fft_mrc_bf16(
                    rows.re.data_ptr(), rows.im.data_ptr(), int(args.int16), st[0], st[1], st[2],
                    1, SYMBOLS, a, f, h.re.data_ptr(), h.im.data_ptr(), inv.data_ptr(),
                    table.data_ptr(), None, fft_plan.speed_w_image(dev).data_ptr(),
                    out.re.data_ptr(), out.im.data_ptr(), ring.data_ptr(), slots, lag,
                    counters.data_ptr(), stream)
            else:
                err = lib.ofdm_fft_mrc(rows.re.data_ptr(), rows.im.data_ptr(), int(args.int16), 1,
                                       st[0], st[1], st[2], pipe._scale(rows), 1, SYMBOLS, a, f,
                                       h.re.data_ptr(), h.im.data_ptr(), inv.data_ptr(),
                                       table.data_ptr(), out.re.data_ptr(), out.im.data_ptr(),
                                       ring.data_ptr(), slots, lag, counters.data_ptr(), stream)
            if err != 0:
                raise SystemExit(f"ring_trace: the ring kernel returned CUDA error {err}")
        torch.cuda.synchronize()
        assert lib.ofdm_ring_trace_set(None) == 0
        plain = pipe.fused_pipeline_speed_plain if args.bf16 else pipe.fused_pipeline_plain
        want = plain(rows, h, inv).to_numpy()
        rel = float(np.abs(out.to_numpy() - want).max() / np.abs(want).max())
        print(f"{'fft_mrc_bf16' if args.bf16 else 'fft_mrc'} ring F={f}, {a} x {f} x {SYMBOLS} "
              f"{'int16' if args.int16 else 'f32'}, slots {slots}, lag {lag}: max-rel vs plain "
              f"{rel:.2e}  [{card}]")
        summary(stamps.cpu().numpy(), args.bf16)
        del y, rows, h, inv, out, ring, counters, stamps
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
