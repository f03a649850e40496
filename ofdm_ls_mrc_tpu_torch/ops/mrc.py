"""Maximal Ratio Combining on full-width planar tensors (counterpart of
``ofdm_ls_mrc_tpu.ops.mrc``): Yf[k] = sum_ant FFT(Y)_ant[k] * Hconj_ant[k] /
Hsqrd[k] (matrixMultThenSum + normalize, cpuLS.hpp:187-208,354-367)."""

from __future__ import annotations

import torch

from .cplx import CArray
from .shift import output_shift


def mrc_numerator(data_fft: CArray, hconj_full: CArray) -> CArray:
    """Sum over antennas of Yf * Hconj.

    Args:
      data_fft:   [..., S, A, F] planar FFT'd data symbols.
      hconj_full: [..., A, F] conjugated, DC-masked channel estimate.

    Returns:
      [..., S, F] planar numerator.
    """
    hr, hi = hconj_full.re.unsqueeze(-3), hconj_full.im.unsqueeze(-3)
    re = torch.sum(data_fft.re * hr - data_fft.im * hi, dim=-2)
    im = torch.sum(data_fft.re * hi + data_fft.im * hr, dim=-2)
    return CArray(re, im)


def mrc_combine(data_fft: CArray, hconj_full: CArray, hsqrd_full: torch.Tensor) -> CArray:
    """Numerator over antennas, then normalize: [..., S, F] on the full grid."""
    num = mrc_numerator(data_fft, hconj_full)
    return num.div_real(hsqrd_full.unsqueeze(-2))


def finalize(equalized_full: CArray) -> CArray:
    """Full grid to the reference's (F-1)-wide output: drop the DC bin, then
    the output half-spectrum swap (shiftOneRow, cpuLS.hpp:368)."""
    return output_shift(equalized_full[..., 1:])
