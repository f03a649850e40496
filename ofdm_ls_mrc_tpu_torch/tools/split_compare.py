"""Device time of the kernels at the large-F geometry, kernel by kernel, for
comparing two trees of the port (or two chunk sizes) on one card.

  python ofdm_ls_mrc_tpu_torch/tools/split_compare.py [--chunk N] [--ring-mb M]
      [--pilots] [--antennas A] [--sizes F,F,...]

On one A x F x 100-symbol frame (A = 16 unless ``--antennas``) (f32 rows, and the same rows as int16) at
F = 8192, 16384 and 32768 (or ``--sizes``): ``fused_pipeline`` exact (at
8192 ``fft_mrc_spread_kernel``, the frame's rows spread over the card; above
it one launch of ``fft_mrc_ring_kernel``, the column and row
tiles of the split form on a ring of L2-resident symbol slots, beside the
zeroing of its counters) and ``exact=False`` (one launch of
``fft_mrc_bf16_ring_kernel``: the same column tiles, storing bf16, and the
bf16 row tiles of 16 bins k1 fed by TMA), ``fused_demod``
(``mrc_demod_ring_kernel`` above 8192) and the pilots (exact: at 8192
``pilot_ls_row_kernel``, a cluster per antenna row, above it the split
form's column pass and ``pilot_ls_rows_kernel``; its sum variant; bf16:
the column pass and ``pilot_rows_kernel``), each time the sum of its
kernels, each kernel's time and, where a separate column pass ran, its and
the row pass's shares (torch.profiler device time, the mean over n calls of
a trace opened with spin kernels that are left out), and ``torch.fft.fft``
over the same rows beside each frame and pilot, and each data kernel's
bound (its bytes, each input read once and each output written once, at
3.35 TB/s).  At F = 8192 and below it also times the exact data kernels on
one streamed symbol (S = 1, ``push_symbol``'s shape) and ``fused_pipeline``
over a capture of 20 sc16 frames (``demod_capture``'s data shape, cp
stripped).  ``--sizes`` picks the F (any of 64-32768); below 8192 the exact
data kernels (at 256, 512, 2048 and 4096 the side form, ``fft_mrc_side_kernel``
and ``mrc_demod_side_kernel``: a launch's antenna rows side by side over the
card), the exact pilot and ``torch.fft.fft`` are timed, the pilot (and its sum
variant) beside its bytes bound too, and the pilots of a 20-frame sc16
capture (at 64 and 128 also of the 4,096-frame 4-antenna capture) beside
``torch.fft.fft`` over their rows.  ``--pilots`` times the pilots alone.  ``--clusters`` times the exact pilot at F = 16384 and 32768
with its clusters capped at 1, 2, 4 and 8 blocks
(``fft_plan.split_pilot_clusters`` in place of the plan's choice) and
nothing else.  ``--chunk N`` caps the chunked split form's symbols (frames)
a chunk at N in place of ``fft_plan.split_chunk``'s choice: it reaches the
split pilots only.  ``--ring-mb M`` sizes the data kernels' rings to M MiB
in place of ``fft_plan.SPLIT_RING_BYTES``.  It imports
``ofdm_ls_mrc_tpu_torch`` by absolute name, so ``PYTHONPATH=<another
checkout>`` times that checkout's package with the same calls: two trees in
one call on the same card compare in the order X Y Y X.  The last line is a
JSON object of every time in microseconds.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import ofdm_ls_mrc_tpu_torch
from ofdm_ls_mrc_tpu_torch.ops import fft_plan, fused_mrc, ls
from ofdm_ls_mrc_tpu_torch.ops import pipeline as pipe
from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray

ANTENNAS, SYMBOLS = 16, 101
SIZES = (8192, 16384, 32768)
CAPTURE = 20      # sc16 frames of the capture leg (F <= 8192)
SMALL_CAPTURE, SMALL_CAPTURE_ANTENNAS = 4096, 4   # the 4 x 64 x 9 capture's pilots (F = 64, 128)
SMALL_CAPTURE_FFT = (64, 128)
PAD = 16          # spin kernels at the head of a trace
CALLS = 5
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (published)


def data_bytes(s: int, a: int, f: int, in_bytes: int, demod: bool, k: int = 1) -> int:
    """Bytes a data kernel must move over k frames of s symbols: the rows
    (two planes of in_bytes), h and the gains in, the output ([.., S, F - 1]
    or mrc_demod's [S, F]) out."""
    return k * (s * a * f * 2 * in_bytes + a * f * 8 + f * 4 + s * (f if demod else f - 1) * 8)


def pilot_bytes(a: int, f: int, in_bytes: int = 4, k: int = 1) -> int:
    """Bytes the exact pilot must move over k frames: the rows (two planes
    of in_bytes) and X in, h (two f32 planes) and inv out."""
    return k * (a * f * 2 * in_bytes + a * f * 8 + f * 4) + f * 8


def device_split(fn, n: int) -> dict:
    """Mean device time per call of each of fn's kernels, by name, over a
    trace of n calls."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PAD):
            torch.cuda._sleep(1000)
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / n for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key}


def shares(split: dict) -> str:
    """The column pass's and the other kernels' (the row pass's) time and
    share of a split-form call; '' where no column pass ran."""
    col = sum(v for k, v in split.items() if "column_pass" in k)
    total = sum(split.values())
    if not col or not total:
        return ""
    return (f"; column pass {col:.1f} us ({100 * col / total:.0f}%), row pass "
            f"{total - col:.1f} us ({100 * (total - col) / total:.0f}%)")


def cluster_bounds(dev: torch.device, card: str) -> int:
    """The exact pilot of 16 f32 rows at F = 16384 and 32768 with its
    clusters capped at 1, 2, 4 and 8 blocks, and at the plan's own bound."""
    plain = fft_plan.split_pilot_clusters
    res = {}
    for f in fft_plan.SPLIT_FFT_SIZES:
        rng = np.random.default_rng(f)
        z = 0.1 * (rng.standard_normal((ANTENNAS, f)) + 1j * rng.standard_normal((ANTENNAS, f)))
        y = CArray.from_numpy(z.astype(np.complex64), dev)
        x = ls.pad_pilot(np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64), dev)
        for most in (1, 2, 4, 8, None):
            fft_plan.split_pilot_clusters = plain if most is None else (
                lambda a, ff, k=1, most=most: min(most, a))
            plan = fft_plan.pilot_plan(ANTENNAS, f)
            split = device_split(lambda: pipe.estimate_pilot_fused(y, x), CALLS)
            label = f"pilot exact F={f} at most {most or 'the plan'} blocks a cluster"
            res[label] = {"us": sum(split.values()), "kernels": split, "plan": list(plan)}
            print(f"{label} (clusters, teams, rows = {tuple(plan[:3])}): "
                  f"{res[label]['us']:.1f} us device{shares(split)}  [{card}]", flush=True)
        fft_plan.split_pilot_clusters = plain
    print(json.dumps({"package": ofdm_ls_mrc_tpu_torch.__file__, "card": card, "us": res}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--chunk", type=int, default=0,
                    help="frames a chunk of the chunked split form, at most: the split "
                         "pilots (default: split_chunk)")
    ap.add_argument("--ring-mb", type=int, default=0,
                    help="MiB of the data kernels' rings of symbol slots "
                         "(default: fft_plan.SPLIT_RING_BYTES)")
    ap.add_argument("--pilots", action="store_true", help="time the pilots alone")
    ap.add_argument("--antennas", type=int, default=ANTENNAS,
                    help=f"antennas of the frame (default {ANTENNAS})")
    ap.add_argument("--clusters", action="store_true",
                    help="time the exact split pilot at each cluster bound")
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)),
                    help="comma-separated F to time (default %(default)s; below 8192 the "
                         "exact data kernels only)")
    args = ap.parse_args()
    sizes = [int(v) for v in args.sizes.split(",")]
    if not torch.cuda.is_available():
        print("split_compare: no CUDA device", file=sys.stderr)
        return 1
    if args.chunk:
        plain_chunk = fft_plan.split_chunk
        fft_plan.split_chunk = lambda items, a, f: min(plain_chunk(items, a, f), args.chunk)
    if args.ring_mb:
        fft_plan.SPLIT_RING_BYTES = args.ring_mb << 20
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"package {ofdm_ls_mrc_tpu_torch.__file__}, {args.antennas} antennas, chunk "
          f"{args.chunk or 'split_chunk'}, ring {args.ring_mb or 'SPLIT_RING_BYTES'}  [{card}]")
    if args.clusters:
        return cluster_bounds(dev, card)
    res = {}
    for f in sizes:
        large = f in SIZES
        rng = np.random.default_rng(f)
        z = 0.1 * (rng.standard_normal((SYMBOLS, args.antennas, f))
                   + 1j * rng.standard_normal((SYMBOLS, args.antennas, f)))
        y = CArray.from_numpy(z.astype(np.complex64), dev)
        del z
        y16 = CArray(*(torch.round(t * 32767).to(torch.int16) for t in (y.re, y.im)))
        x = ls.pad_pilot(np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64), dev)
        h, inv = pipe.estimate_pilot_plain(y[0], x)
        hc, hs = h.conj(), 1 / inv
        pilot_c = torch.complex(y.re[0], y.im[0])
        data_c = None if args.pilots else torch.complex(y.re[1:], y.im[1:])
        s, a = SYMBOLS - 1, args.antennas
        sides, bounds = {}, {}
        if not args.pilots:
            sides.update({
                f"frame exact F={f}": lambda: pipe.fused_pipeline(y[1:], h, inv),
                f"frame exact int16 F={f}": lambda: pipe.fused_pipeline(y16[1:], h, inv),
                f"mrc_demod F={f}": lambda: fused_mrc.fused_demod(y[1:], hc, hs),
                f"mrc_demod int16 F={f}": lambda: fused_mrc.fused_demod(y16[1:], hc, hs),
                f"torch.fft.fft frame rows F={f}": lambda: torch.fft.fft(data_c, dim=-1),
            })
            bounds.update({f"frame exact F={f}": data_bytes(s, a, f, 4, False),
                           f"frame exact int16 F={f}": data_bytes(s, a, f, 2, False),
                           f"mrc_demod F={f}": data_bytes(s, a, f, 4, True),
                           f"mrc_demod int16 F={f}": data_bytes(s, a, f, 2, True)})
            if large:
                sides.update({
                    f"frame bf16 F={f}": lambda: pipe.fused_pipeline(y[1:], h, inv, exact=False),
                    f"frame bf16 int16 F={f}": lambda: pipe.fused_pipeline(y16[1:], h, inv,
                                                                           exact=False),
                })
            if f <= 8192:   # push_symbol's shape and demod_capture's
                g = torch.Generator(device=dev).manual_seed(f)
                cap = CArray(*(torch.randint(-3277, 3277, (CAPTURE, SYMBOLS, a, f), generator=g,
                                             dtype=torch.int16, device=dev) for _ in range(2)))
                hk = CArray(*(t[None].expand(CAPTURE, -1, -1).contiguous() for t in (h.re, h.im)))
                invk = inv[None].expand(CAPTURE, -1).contiguous()
                sides.update({
                    f"frame exact S=1 F={f}": lambda: pipe.fused_pipeline(y[1:2], h, inv),
                    f"mrc_demod S=1 F={f}": lambda: fused_mrc.fused_demod(y[1:2], hc, hs),
                    f"capture exact sc16 {CAPTURE} frames F={f}": lambda: pipe.fused_pipeline(
                        cap[:, 1:], hk, invk),
                })
                bounds.update({f"frame exact S=1 F={f}": data_bytes(1, a, f, 4, False),
                               f"mrc_demod S=1 F={f}": data_bytes(1, a, f, 4, True),
                               f"capture exact sc16 {CAPTURE} frames F={f}":
                               data_bytes(s, a, f, 2, False, CAPTURE)})
        sides.update({
            f"pilot exact F={f}": lambda: pipe.estimate_pilot_fused(y[0], x),
            f"pilot exact sum F={f}": lambda: pipe.estimate_pilot_fused(y[0], x, invert=False),
            f"torch.fft.fft pilot rows F={f}": lambda: torch.fft.fft(pilot_c, dim=-1),
        })
        bounds[f"pilot exact F={f}"] = bounds[f"pilot exact sum F={f}"] = pilot_bytes(
            args.antennas, f)
        if large:
            sides[f"pilot bf16 F={f}"] = lambda: pipe.estimate_pilot_fused(y[0], x, exact=False)
        else:   # demod_capture's pilots: each frame's pilot row read in place
            g = torch.Generator(device=dev).manual_seed(f + 1)
            caps = [(CAPTURE, a)] + ([(SMALL_CAPTURE, SMALL_CAPTURE_ANTENNAS)]
                                     if f in SMALL_CAPTURE_FFT else [])
            for frames, ant in caps:
                pcap = CArray(*(torch.randint(-3277, 3277, (frames, 2, ant, f), generator=g,
                                              dtype=torch.int16, device=dev)[:, 0]
                                for _ in range(2)))
                label = f"pilot exact capture sc16 {frames} frames x {ant} antennas F={f}"
                sides[label] = lambda pcap=pcap: pipe.estimate_pilot_fused(pcap, x)
                bounds[label] = pilot_bytes(ant, f, 2, frames)
                cap_c = torch.complex(pcap.re.float(), pcap.im.float())
                sides[f"torch.fft.fft {label}"] = lambda cap_c=cap_c: torch.fft.fft(cap_c, dim=-1)
        for label, fn in sides.items():
            split = device_split(fn, CALLS)
            res[label] = {"us": sum(split.values()), "kernels": split}
            parts = ", ".join(f"{k.split('(')[0].replace('void ', '')} {v:.1f}"
                              for k, v in sorted(split.items(), key=lambda kv: -kv[1]))
            bound = ""
            if label in bounds:
                res[label]["bound_us"] = bounds[label] / HBM_BYTES_PER_S * 1e6
                bound = (f"; bound {res[label]['bound_us']:.2f} us ({bounds[label] / 1e6:.2f} MB "
                         f"at 3.35 TB/s)")
            print(f"{label}: {res[label]['us']:.1f} us device ({parts}){shares(split)}{bound}  "
                  f"[{card}]", flush=True)
        del y, y16, h, inv, hc, hs, pilot_c, data_c
        torch.cuda.empty_cache()
    print(json.dumps({"package": ofdm_ls_mrc_tpu_torch.__file__, "card": card,
                      "antennas": args.antennas, "chunk": args.chunk or None,
                      "ring_mb": args.ring_mb or None,
                      "pilots_only": args.pilots, "us": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
