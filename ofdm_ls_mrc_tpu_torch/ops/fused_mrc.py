"""The split-phase data path in one hand-written CUDA kernel (counterpart of
``ofdm_ls_mrc_tpu.ops.pallas_mrc``).

  ``fused_demod`` -> ``csrc/mrc_demod.cu``, plain ``fused_demod_plain``

The contract is the split-phase API's: the estimate comes as
``ls.estimate_channel_full`` returns it (hconj conjugated with the DC bin
zeroed, hsqrd with the DC bin pinned to 1, true frequency order), and the
result is the full-width equalized grid in true order, ready for
``mrc.finalize``.  Estimates are thus interchangeable across frames and
pipelines.  The wrapper runs the plain version for tensors on the CPU, and
only there; for CUDA tensors it launches the kernel or raises.

``launch_counts`` counts kernel launches; only a launch adds to it.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..kernels import build
from . import fft as fft_ops
from . import fft_plan
from . import mrc as mrc_ops
from .cplx import CArray
from .pipeline import (_check_dense, _check_rows, _data_table, _device_route, _ptr,
                       _rows_aligned, _scale, _split_ring, _spread_scratch, widen_sc16)

MRC_DEMOD_FFT_SIZES = (64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768)

launch_counts: Dict[str, int] = {"mrc_demod": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def fused_demod_plain(y: CArray, hconj: CArray, hsqrd: torch.Tensor) -> CArray:
    """Data [S, A, F] (f32 or int16 planes) + estimate (hconj [A, F],
    hsqrd [F]) -> equalized [S, F], true order."""
    return mrc_ops.mrc_combine(fft_ops.fft(widen_sc16(y)), hconj, hsqrd)


def fused_demod(y: CArray, hconj: CArray, hsqrd: torch.Tensor) -> CArray:
    """FFT + MRC + equalize over data symbols, kernel ``csrc/mrc_demod.cu``.

    Args:
      y:     [S, A, F] time-domain data rows, cyclic prefix already dropped
             (a view such as ``data[..., cp:]`` is read in place), f32 or
             int16 (sc16 full scale); any strides with contiguous rows.
             F is a power of two from 64 to 32768 (8192 with the rows
             spread over the card, ``fft_plan.spread_plan``; 16384 and
             32768 in the split form, one launch on a ring of symbol
             slots, ``fft_plan.split_ring``); any antenna count.
      hconj: [A, F] conjugated, DC-zeroed estimate, true order.
      hsqrd: [F] sum_a |h|^2 with the DC bin pinned to 1, true order (at
             F = 16384 and 32768 both start 16-byte aligned).

    Returns:
      [S, F] float32 planes in true frequency order (the DC bin is
      meaningless, as in ``mrc.mrc_combine``): feed to ``mrc.finalize``.
    """
    if y.ndim != 3:
        raise ValueError(f"fused_demod: y must be [S, A, F], got shape {y.shape}")
    s, a, f = y.shape
    if f not in MRC_DEMOD_FFT_SIZES:
        raise ValueError(f"fused_demod: F={f} not in {MRC_DEMOD_FFT_SIZES}")
    if not _device_route(y, "fused_demod"):
        return fused_demod_plain(y, hconj, hsqrd)
    _check_rows(y, "fused_demod: y", 3)
    dev = y.device
    _check_dense(hconj.re, "hconj.re", (a, f), dev)
    _check_dense(hconj.im, "hconj.im", (a, f), dev)
    _check_dense(hsqrd, "hsqrd", (f,), dev)
    out = CArray(torch.empty((s, f), dtype=torch.float32, device=dev),
                 torch.empty((s, f), dtype=torch.float32, device=dev))
    lib = build.load_library()
    st = y.re.stride()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if f == fft_plan.SPREAD_FFT or f in fft_plan.SIDE_FFT_SIZES:
            ring, counters, slots, lag = _spread_scratch(s, a, f, (hconj.re, hconj.im), dev,
                                                         stream)
        else:
            ring, counters, slots, lag = _split_ring(s, a, f, (hconj.re, hconj.im, hsqrd),
                                                     dev, fft_plan.SPLIT_K1)
        err = lib.ofdm_mrc_demod(
            y.re.data_ptr(), y.im.data_ptr(), int(y.dtype == torch.int16),
            int(_rows_aligned(y)), st[0], st[1], _scale(y), s, a, f,
            hconj.re.data_ptr(), hconj.im.data_ptr(), hsqrd.data_ptr(),
            _data_table(f, dev).data_ptr(), out.re.data_ptr(), out.im.data_ptr(),
            _ptr(ring), slots, lag, _ptr(counters), stream)
    build.check(lib, err, "mrc_demod")
    launch_counts["mrc_demod"] += 1
    return out
