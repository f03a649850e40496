"""Where the time of the exact data kernels at F = 8192 goes
(``fft_mrc_spread_kernel``, ``csrc/fft_spread.cuh`` spread_rows), or at F =
256, 512, 2048 and 4096 (``fft_mrc_side_kernel``, ``csrc/fft_side.cuh``
side_rows), read from the %globaltimer stamps thread 0 of each block writes
when ``csrc/fft_mrc.cu`` is built with ``-DOFDM_SPREAD_TRACE`` (a separate
library; the port's build never defines it).

  python -m ofdm_ls_mrc_tpu_torch.tools.spread_trace [--fft 8192] [--antennas 16]
      [--symbols 100] [--int16]

For one A x F x S frame (f32 rows, or the same rows as int16) it runs
``fft_mrc`` three times on the plan of ``fft_plan.spread_plan`` (at the
side sizes ``fft_plan.side_plan``; the last run traced), checks the output
against the plain version, and prints the mean and median of each phase of
a row -- its wait for its copy and the block's barrier (the side form: its
team's), its FFT (with h's row copied in during the last pass), its
multiply-add with h, and where the row ends a symbol the finish (the
partial handed in and counted, or the partials added and the symbol
stored; the side form: a symbol the team goes on past, stored or handed to
its team slot) -- the blocks' spans (first row's start to last row's end:
mean, largest), the launch's span, and the mean time a block waits before
its first row.  At the side sizes the rows are team 0's of each block, and
it also prints a block's tail: from its start to its first row, from team
0's last row to the block's partials barrier, and from there to its shared
symbols stored or handed in.  All times are microseconds of device time.
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

MAX_ROWS = 64   # rows a block the stamp buffer holds (csrc/fft_spread.cuh stamp)
TAIL = 63       # the side form's block stamps (csrc/fft_side.cuh OFDM_SIDE_STAMP)
SHARED = 62     # ... and those of its first two shared symbols
STAMPS = 8      # per row: start, landed, FFT done, multiply-add done, finish done
PHASES = ("wait", "fft", "multiply-add", "finish")


def traced_library() -> ctypes.CDLL:
    out = build.BUILD_DIR / "trace" / f"libspread_trace_{build.source_hash()}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-DOFDM_SPREAD_TRACE", "-shared",
                        "-o", str(out), str(build.CSRC_DIR / "fft_mrc.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    lib.ofdm_fft_mrc.argtypes = build.SIGNATURES["ofdm_fft_mrc"]
    lib.ofdm_spread_trace_set.argtypes = (ctypes.c_void_p,)
    return lib


def summary(stamps: np.ndarray, side: bool) -> None:
    """Print the phases, spans and start waits of one traced launch
    ([blocks, MAX_ROWS, STAMPS] int64 ns, 0 where no stamp); the side
    form's block stamps too."""
    tail = stamps[:, TAIL].copy() if side else None
    shared = stamps[:, SHARED].copy() if side else None
    if side:
        stamps = stamps[:, :SHARED]
    rows = stamps[stamps[..., 0] != 0]
    parts = []
    for k, name in enumerate(PHASES):
        done = rows[:, k + 1] != 0
        d = (rows[done, k + 1] - rows[done, k]) / 1e3
        parts.append(f"{name} {np.mean(d):.2f}/{np.median(d):.2f}"
                     + (f" ({done.sum()} of {len(rows)} rows)" if k == 3 else ""))
    print(f"  rows {len(rows)}; mean/median us a row: {', '.join(parts)}")
    t0 = rows[:, 0].min()
    starts, spans, ends = [], [], []
    for blk in stamps:
        r = blk[blk[:, 0] != 0]
        if not len(r):   # a side block whose team 0 took no row
            continue
        end = np.maximum(r[:, 3], r[:, 4]).max()
        starts.append(r[:, 0].min() - t0)
        spans.append(end - r[:, 0].min())
        ends.append(end)
    print(f"  block span mean {np.mean(spans) / 1e3:.2f} us, largest {np.max(spans) / 1e3:.2f}; "
          f"launch span {(np.max(ends) - t0) / 1e3:.2f} us; first row's start after the "
          f"launch's first: mean {np.mean(starts) / 1e3:.2f} us, largest "
          f"{np.max(starts) / 1e3:.2f}")
    if side:
        has = np.array([bool((blk[:, 0] != 0).any()) for blk in stamps])
        first = np.array([blk[blk[:, 0] != 0][:, 0].min() for blk in stamps[has]])
        parts = {"start to first row": first - tail[has, 0],
                 "last row to the partials barrier": tail[:, 2] - tail[:, 1],
                 "shared symbols": tail[:, 3] - tail[:, 2],
                 "block": tail[:, 3] - tail[:, 0]}
        print("  block tail mean/largest us: " + ", ".join(
            f"{k} {np.mean(v) / 1e3:.2f}/{np.max(v) / 1e3:.2f}" for k, v in parts.items())
            + f"; launch {(tail[:, 3].max() - tail[:, 0].min()) / 1e3:.2f}")
        begun = shared[:, 0] != 0
        if begun.any():
            d = (shared[begun, 0] - tail[begun, 2]) / 1e3
            print(f"  partials barrier to the first shared symbol's turn mean/largest us: "
                  f"{d.mean():.2f}/{d.max():.2f}")
        for k in range(2):   # the first two shared symbols' phases, where a block has them
            sym = shared[:, 4 * k:4 * k + 4]
            sym = sym[np.all(sym != 0, axis=1)]
            if len(sym):
                d = np.diff(sym, axis=1) / 1e3
                print(f"  shared symbol {k + 1} ({len(sym)} blocks) mean/largest us: teams' "
                      f"partials {d[:, 0].mean():.2f}/{d[:, 0].max():.2f}, blocks' "
                      f"{d[:, 1].mean():.2f}/{d[:, 1].max():.2f}, store "
                      f"{d[:, 2].mean():.2f}/{d[:, 2].max():.2f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--fft", type=int, default=fft_plan.SPREAD_FFT,
                    help="F: 8192 (the spread form) or a side size (256, 512, 2048, 4096)")
    ap.add_argument("--antennas", type=int, default=16)
    ap.add_argument("--symbols", type=int, default=100)
    ap.add_argument("--int16", action="store_true", help="int16 rows (sc16 full scale)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("spread_trace: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    F = args.fft
    side = F in fft_plan.SIDE_FFT_SIZES
    if not side and F != fft_plan.SPREAD_FFT:
        raise SystemExit(f"spread_trace: F = {F} is neither 8192 nor a side size")
    lib = traced_library()
    a, s = args.antennas, args.symbols
    if side:
        plan = fft_plan.side_plan(s, a, F, pipe._sms(dev))
        if -(-s * a // (plan.blocks * fft_plan.side_teams(F))) > SHARED:
            raise SystemExit(f"spread_trace: more than {SHARED} rows a team")
    else:
        plan = fft_plan.spread_plan(s, a, pipe._sms(dev))
        if -(-s * a // plan.blocks) > MAX_ROWS:
            raise SystemExit(f"spread_trace: more than {MAX_ROWS} rows a block")
    table = fft_plan.side_twiddles(F, dev) if side else fft_plan.pass_twiddles(F, dev)
    g = torch.Generator(device=dev).manual_seed(F)
    y = CArray(*(0.1 * torch.randn((1, s + 1, a, F), generator=g, device=dev) for _ in range(2)))
    x = ls.pad_pilot(np.exp(2j * np.pi * np.random.default_rng(F).random(F - 1))
                     .astype(np.complex64), dev)
    h, inv = pipe.estimate_pilot_plain(y[:, 0], x)
    if args.int16:
        y = CArray(*(torch.round(v * 32767).clamp(-32768, 32767).to(torch.int16)
                     for v in (y.re, y.im)))
    rows = y[:, 1:]
    st = rows.re.stride()
    out = CArray(torch.empty((1, s, F - 1), device=dev), torch.empty((1, s, F - 1), device=dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    partials, counts, blocks, smem = pipe._spread_scratch(s, a, F, (h.re, h.im), dev, stream)
    stamps = torch.zeros((blocks, MAX_ROWS, STAMPS), dtype=torch.int64, device=dev)
    for run in range(3):
        if run == 2:
            torch.cuda.synchronize()
            assert lib.ofdm_spread_trace_set(stamps.data_ptr()) == 0
        err = lib.ofdm_fft_mrc(rows.re.data_ptr(), rows.im.data_ptr(), int(args.int16),
                               int(pipe._rows_aligned(rows)), st[0], st[1], st[2],
                               pipe._scale(rows), 1, s, a, F, h.re.data_ptr(), h.im.data_ptr(),
                               inv.data_ptr(), table.data_ptr(),
                               out.re.data_ptr(), out.im.data_ptr(), partials.data_ptr(), blocks,
                               smem, counts.data_ptr(), stream)
        if err != 0:
            raise SystemExit(f"spread_trace: the kernel returned CUDA error {err}")
    torch.cuda.synchronize()
    assert lib.ofdm_spread_trace_set(None) == 0
    want = pipe.fused_pipeline_plain(rows, h, inv).to_numpy()
    rel = float(np.abs(out.to_numpy() - want).max() / np.abs(want).max())
    print(f"fft_mrc {'side' if side else 'spread'} F={F}, {a} x {F} x {s} "
          f"{'int16' if args.int16 else 'f32'}, {blocks} blocks: max-rel vs plain {rel:.2e}  "
          f"[{card}]")
    summary(stamps.cpu().numpy(), side)
    return 0


if __name__ == "__main__":
    sys.exit(main())
