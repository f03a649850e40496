"""Input-delivery probes: the io floor of the card (counterpart of
``tools/dma_probe.py``).

Each probe is the data kernels' input path with a minimal reduce as its
compute: for y [S, A, F] f32 planes, out = sum over the antennas + a bias,
per symbol, for re and im (``csrc/io_probe.cu``):

  auto     -- a plain load-reduce-store kernel (the TPU's BlockSpec
              auto-pipelined input)
  manualN  -- persistent blocks (one per SM) keep an N-deep ring of
              shared-memory slots (N in 2, 3, 4): a producer lane refills a
              slot with one TMA tensor copy a plane once its consumers
              release it, the copies completing on the slot's "full"
              mbarrier; the consumer warps wait on it, reduce, and release
              the slot on its "empty" mbarrier (``ring_schedule`` mirrors the
              order and the phases)
  manualNs -- the same with one full barrier per symbol of the window, each
              symbol reduced as soon as it lands (a copy a plane and symbol)

``--compute N`` adds N chained bf16 [R, 128] x [128, 128] products per
window on the staged rows (CUDA cores, fp32 accumulation), 1e-9 of which
is added to the re output: the overlap experiment (total ~ max(io, compute)
when the copies hide behind the compute, ~ io + compute when they
serialize).

A window is ts symbols x A antennas x 128 columns (whole 128-wide rows, the
burn's width), ts*A/2 KB per plane; the ring of depth N needs N*ts*A KB of
shared memory and its barriers, at most 227 KB with the burn's 36 KB, so
the default window is ts = 2 (16 antennas: 32 KB a slot, every depth fits).

Frames are made on the card and stay there.  One launch covers the whole
batch as [K*S, A, F]: the probe's output is per symbol, so this is the
per-frame function K times over, and a launch moves enough bytes (265 MB
at the defaults, past the 50 MB L2) that the host's launch work hides
behind the device.  Times are CUDA events around ``--r-hi`` passes over
the ``--batch`` frames, best of ``--reps``.

Usage:  python -m ofdm_ls_mrc_tpu_torch.tools.dma_probe [--variants auto,manual2,manual3s]
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..kernels import build
from ..ops.pipeline import _device_route

COLS = 128                # column tile: one burn row
TS_CHOICES = (1, 2, 4, 8)
DEPTHS = (2, 3, 4)
SMEM_LIMIT = 232448       # bytes of shared memory a block may opt in to
MAX_BOX = 256             # elements of a TMA box along one dimension (the antennas)
BURN_SCALE = 1e-9
_VARIANT = re.compile(r"^(auto|manual([234])(s?))$")

launch_counts: Dict[str, int] = {"io_auto": 0, "io_manual": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def parse_variant(variant: str) -> Tuple[int, bool]:
    """'auto' -> (0, False); 'manualN[s]' -> (N, per_symbol)."""
    m = _VARIANT.match(variant)
    if m is None:
        raise ValueError(f"unknown variant {variant!r}: expected auto, manualN or "
                         f"manualNs with N in {DEPTHS}")
    if m.group(1) == "auto":
        return 0, False
    return int(m.group(2)), m.group(3) == "s"


def ring_barrier_bytes(depth: int, ts: int, per_symbol: bool) -> int:
    """The ring's mbarriers, 8 bytes each: per stage one "full" barrier (one
    per symbol in the "s" form) and one "empty", rounded up to 128 bytes
    (the tensor copies' alignment of the ring after them)."""
    return -(-depth * ((ts if per_symbol else 1) + 1) * 8 // 128) * 128


def smem_bytes(variant: str, ts: int, antennas: int, compute: int) -> int:
    """Dynamic shared memory of one block of the variant's kernel."""
    depth, per_symbol = parse_variant(variant)
    rows = depth * 2 * ts * antennas * COLS * 4 if depth else (
        antennas * COLS * 4 if compute else 0)
    burn = COLS * COLS * 2 + 4 * COLS * 4 + (ts if depth else 1) * COLS * 4
    bars = ring_barrier_bytes(depth, ts, per_symbol) if depth else 0
    return bars + rows + (burn if compute else 0)


def ring_schedule(block: int, grid: int, items: int, depth: int) -> List[Tuple[int, int, int]]:
    """(item, stage, parity) of each item that block ``block`` of a
    persistent grid of ``grid`` handles, in order: the it-th is item
    block + it * grid, in ring stage it % depth, whose full barriers the
    consumers wait on with parity (it // depth) % 2 and whose empty barrier
    the producer waits on with the other parity before refilling it (so the
    first depth waits pass at once).  csrc/io_probe.cu io_manual_kernel runs
    this schedule."""
    mine = (items - 1 - block) // grid + 1 if block < items else 0
    return [(block + it * grid, it % depth, (it // depth) & 1) for it in range(mine)]


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def burn_plain(rows: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """n chained [.., 128] x [128, 128] products, operands and each result
    rounded to bf16, fp32 accumulation."""
    acc = rows.to(torch.bfloat16).float()
    wb = w.to(torch.bfloat16).float()
    for _ in range(n):
        acc = torch.matmul(acc, wb).to(torch.bfloat16).float()
    return acc


def io_probe_plain(yre: torch.Tensor, yim: torch.Tensor, bias: torch.Tensor,
                   w: torch.Tensor, compute: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """y [S, A, F] planes -> (sum_a y_re + bias (+ 1e-9 sum_a burn), sum_a y_im + bias)."""
    out_re = torch.sum(yre, dim=1) + bias
    if compute:
        s, a, f = yre.shape
        burned = burn_plain(yre.reshape(s, a, f // COLS, COLS), w, compute)
        out_re = out_re + torch.sum(burned, dim=1).reshape(s, f) * BURN_SCALE
    return out_re, torch.sum(yim, dim=1) + bias


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def _check_input(t: torch.Tensor, name: str, shape, device: torch.device) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected float32 {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned on {device}")


def io_probe(yre: torch.Tensor, yim: torch.Tensor, bias: torch.Tensor, w: torch.Tensor,
             *, variant: str = "auto", ts: int = 2,
             compute: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Data symbols through a probe kernel, ``csrc/io_probe.cu``.

    Args:
      yre, yim: [S, A, F] float32 planes, F a multiple of 128, S < 65536.
      bias:     [F] float32.
      w:        [128, 128] float32, the burn's matrix (rounded to bf16).
      variant:  'auto', 'manualN' or 'manualNs' (N in 2, 3, 4).
      ts:       symbols per window of the manual variants (1, 2, 4 or 8,
                at most S).
      compute:  chained products per window (0: none).

    Returns:
      (out_re, out_im), [S, F] float32 each.
    """
    depth, per_symbol = parse_variant(variant)
    if yre.ndim != 3:
        raise ValueError(f"io_probe: y must be [S, A, F], got shape {tuple(yre.shape)}")
    s, a, f = yre.shape
    if f % COLS or min(s, a, f) == 0 or s >= 65536:
        raise ValueError(f"io_probe: shape {(s, a, f)}: F must be a positive multiple "
                         f"of {COLS} and S below 65536")
    if compute < 0:
        raise ValueError(f"io_probe: compute={compute} < 0")
    if depth and (ts not in TS_CHOICES or ts > s):
        raise ValueError(f"io_probe: ts={ts} must be in {TS_CHOICES} and at most S={s}")
    if depth and a > MAX_BOX:
        raise ValueError(f"io_probe: {variant} copies all {a} antennas in one TMA box, "
                         f"at most {MAX_BOX}")
    smem = smem_bytes(variant, ts, a, compute)
    if smem > SMEM_LIMIT:
        raise ValueError(f"io_probe: {variant} at ts={ts}, {a} antennas, compute="
                         f"{compute} needs {smem} B of shared memory > {SMEM_LIMIT}; "
                         "lower ts or the depth")
    if not _device_route(yre, "io_probe"):
        return io_probe_plain(yre, yim, bias, w, compute)
    dev = yre.device
    _check_input(yre, "yre", (s, a, f), dev)
    _check_input(yim, "yim", (s, a, f), dev)
    _check_input(bias, "bias", (f,), dev)
    _check_input(w, "w", (COLS, COLS), dev)
    out_re = torch.empty((s, f), dtype=torch.float32, device=dev)
    out_im = torch.empty((s, f), dtype=torch.float32, device=dev)
    lib = build.load_library()
    ptrs = (yre.data_ptr(), yim.data_ptr(), s, a, f, bias.data_ptr(), w.data_ptr(), compute)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if depth:
            err = lib.ofdm_io_manual(*ptrs, depth, ts, int(per_symbol), out_re.data_ptr(),
                                     out_im.data_ptr(), stream)
        else:
            err = lib.ofdm_io_auto(*ptrs, out_re.data_ptr(), out_im.data_ptr(), stream)
    name = "io_manual" if depth else "io_auto"
    build.check(lib, err, name)
    launch_counts[name] += 1
    return out_re, out_im


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------

def frame_bytes(symbols: int, antennas: int, fft: int) -> Tuple[int, int]:
    """(bytes in, bytes out) of one frame: each input read once, each output
    written once."""
    return symbols * antennas * fft * 4 * 2, symbols * fft * 4 * 2


def make_frames(batch: int, symbols: int, antennas: int, fft: int, device,
                seed: int = 0):
    """(yre, yim [K, S, A, F], bias [F], w [128, 128]) made on the device."""
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (batch, symbols, antennas, fft)
    yre = torch.randn(shape, generator=g, device=device)
    yim = torch.randn(shape, generator=g, device=device)
    w = 0.1 * torch.randn((COLS, COLS), generator=g, device=device)
    return yre, yim, torch.zeros(fft, device=device), w


def time_per_frame(fn, frames: int, passes: int, reps: int) -> float:
    """Seconds per frame: CUDA events around ``passes`` calls of fn (each
    one pass over ``frames`` frames), best of ``reps``, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(passes):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) * 1e-3 / (passes * frames))
    return best


def as_symbols(y: torch.Tensor) -> torch.Tensor:
    """[K, S, A, F] frames -> [K*S, A, F] symbols (a view)."""
    return y.reshape(-1, *y.shape[2:])


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.max(torch.abs(got - want)) / torch.max(torch.abs(want)))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="auto,manual2,manual3")
    ap.add_argument("--batch", type=int, default=20, help="device-resident frames")
    ap.add_argument("--reps", type=int, default=4, help="timed repetitions (best kept)")
    ap.add_argument("--r-hi", type=int, default=101,
                    help="passes over the batch in one timed repetition")
    ap.add_argument("--antennas", type=int, default=16)
    ap.add_argument("--fft", type=int, default=1024)
    ap.add_argument("--symbols", type=int, default=101)
    ap.add_argument("--ts", type=int, default=2, help="symbols per window (manual variants)")
    ap.add_argument("--compute", type=int, default=0, metavar="N",
                    help="add N chained bf16 products per window "
                         "(overlap experiment: additive vs max)")
    ap.add_argument("--check", action="store_true",
                    help="check each variant against its plain version first")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("dma_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    yre, yim, bias, w = make_frames(args.batch, args.symbols, args.antennas, args.fft, dev)
    b_in, b_out = frame_bytes(args.symbols, args.antennas, args.fft)
    sre, sim = as_symbols(yre), as_symbols(yim)
    for v in args.variants.split(","):
        kw = dict(variant=v, ts=args.ts, compute=args.compute)
        if args.check:
            got = io_probe(yre[0], yim[0], bias, w, **kw)
            want = io_probe_plain(yre[0], yim[0], bias, w, args.compute)
            err = max(max_rel(g, h) for g, h in zip(got, want))
            print(f"  {v}: max rel err vs plain {err:.2e}", flush=True)
        t = time_per_frame(lambda: io_probe(sre, sim, bias, w, **kw),
                           args.batch, args.r_hi, args.reps)
        print(f"{v:10s} {t * 1e6:8.2f} us/frame  ({b_in / 1e6:.1f} MB in -> "
              f"{b_in / t / 1e9:7.1f} GB/s effective, {(b_in + b_out) / t / 1e9:7.1f} "
              f"GB/s in+out)  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
