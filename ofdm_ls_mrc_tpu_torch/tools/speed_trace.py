"""Per-phase timeline of the speed kernels (``csrc/fft_mrc_bf16.cu``) on the
card, read from the %globaltimer stamps the source writes when it is built
with ``-DOFDM_SPEED_TRACE`` (a separate library; the port's build never
defines it).

  python -m ofdm_ls_mrc_tpu_torch.tools.speed_trace [--fft 1024] [--cluster N]

For one 16 x F x 100-symbol f32 frame (``fft_mrc_bf16``) and one 16 x F
pilot (``pilot_ls_bf16``) it prints, for each stamp, the median and the
largest time over the blocks, in microseconds from the first block's start:
warpgroup 0's start, W in shared memory, and for each of the block's first
four chunks the tile written, the product done and the chunk folded; the
symbol's sums in natural order, the cluster barrier passed, the readout
done and the end; the stage-1 warpgroups' rows in and tiles written.  A
stamp a block did not reach is left out.  ``--cluster N`` sets the data
launch's cluster size (at most the symbol's chunks), to compare a symbol's
chunks split across blocks with whole symbols a block.
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

SLOTS = 32
NAMES = {0: "product warpgroup start", 1: "W in shared memory", 14: "sums in natural order",
         15: "cluster barrier passed", 16: "readout done", 17: "product warpgroup end",
         26: "stage-1 start", 27: "stage-1 end"}
for _i in range(4):
    NAMES.update({2 + 3 * _i: f"chunk {_i} tile written (waited)",
                  3 + 3 * _i: f"chunk {_i} product done", 4 + 3 * _i: f"chunk {_i} folded",
                  18 + 2 * _i: f"stage 1: chunk {_i} rows in",
                  19 + 2 * _i: f"stage 1: chunk {_i} tile written"})


def traced_library(cluster: int) -> ctypes.CDLL:
    out = build.BUILD_DIR / "trace" / f"libspeed_trace_{build.source_hash()}_{cluster}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        flags = ["-DOFDM_SPEED_TRACE"] + ([f"-DOFDM_SPEED_MAX_CLUSTER={cluster}"] if cluster else [])
        subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, *flags, "-shared", "-o", str(out),
                        str(build.CSRC_DIR / "fft_mrc_bf16.cu"),
                        str(build.CSRC_DIR / "fft_split.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ofdm_fft_mrc_bf16.argtypes = build.SIGNATURES["ofdm_fft_mrc_bf16"]
    lib.ofdm_pilot_ls_bf16.argtypes = (p, p, i, ll, ll, i, i, i, p, p, p, p, p, i, p, p, p, p,
                                       i, p)
    lib.ofdm_speed_trace.argtypes = (p,)
    lib.ofdm_speed_trace_clear.argtypes = ()
    return lib


def last_of_three(lib, launch) -> None:
    """Three launches (the first two warm), the stamps of the third."""
    for rep in range(3):
        if rep == 2:
            torch.cuda.synchronize()
            assert lib.ofdm_speed_trace_clear() == 0
        assert launch() == 0


def show(lib, label: str) -> None:
    torch.cuda.synchronize()
    buf = np.zeros((512, SLOTS), np.uint64)
    assert lib.ofdm_speed_trace(buf.ctypes.data) == 0
    b = buf[buf[:, 0] > 0].astype(np.int64)
    t0 = b[:, 0].min()
    print(f"--- {label}: {len(b)} blocks; us from the first block's start (median, largest)")
    for s in sorted(NAMES, key=lambda s: np.median(b[:, s])):
        v = b[:, s]
        if (v == 0).any():
            continue
        print(f"  {NAMES[s]:34s} {np.median(v - t0) / 1e3:9.2f} {(v - t0).max() / 1e3:9.2f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--fft", type=int, default=1024)
    ap.add_argument("--cluster", type=int, default=0, help="the data launch's cluster size")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("speed_trace: no CUDA device", file=sys.stderr)
        return 1
    dev, f = torch.device("cuda"), args.fft
    if f not in fft_plan.SPEED_FFT_SIZES or f in fft_plan.SPEED_SPLIT_SIZES:
        print(f"speed_trace: traces the cluster kernel, F = 256 to 4096, not {f}",
              file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[{card}]")
    lib = traced_library(args.cluster)
    rng = np.random.default_rng(1)
    z = (0.1 * (rng.standard_normal((101, 16, f)) + 1j * rng.standard_normal((101, 16, f))))
    y = CArray.from_numpy(z.astype(np.complex64), dev)
    x = ls.pad_pilot(np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64), dev)
    h, inv = pipe.estimate_pilot_plain(y[0], x)
    tw, w = fft_plan.speed_twiddles(f, False, dev), fft_plan.speed_w(dev)
    d, stream = y[1:], torch.cuda.current_stream().cuda_stream
    out = CArray(torch.empty(1, 100, f - 1, device=dev), torch.empty(1, 100, f - 1, device=dev))
    last_of_three(lib, lambda: lib.ofdm_fft_mrc_bf16(
        d.re.data_ptr(), d.im.data_ptr(), 0, 0, d.re.stride(0), d.re.stride(1), 1, 100, 16, f,
        h.re.data_ptr(), h.im.data_ptr(), inv.data_ptr(), tw.data_ptr(), w.data_ptr(), None,
        out.re.data_ptr(), out.im.data_ptr(), None, 0, 0, None, stream))
    show(lib, f"fft_mrc_bf16, one 16 x {f} x 100 f32 frame")
    ho = CArray(torch.empty(1, 16, f, device=dev), torch.empty(1, 16, f, device=dev))
    io = torch.empty(1, f, device=dev)
    last_of_three(lib, lambda: lib.ofdm_pilot_ls_bf16(
        y[0].re.data_ptr(), y[0].im.data_ptr(), 0, 0, y[0].re.stride(0), 1, 16, f,
        x.re.data_ptr(), x.im.data_ptr(), tw.data_ptr(), w.data_ptr(), None, 0, ho.re.data_ptr(),
        ho.im.data_ptr(), io.data_ptr(), None, 0, stream))
    show(lib, f"pilot_ls_bf16, one 16 x {f} f32 pilot")
    return 0


if __name__ == "__main__":
    sys.exit(main())
