"""Planar unnormalized DFTs through ``torch.fft``.

Forward is the unnormalized DFT (== FFTW_FORWARD == np.fft.fft); inverse is
the unnormalized backward DFT (== FFTW_BACKWARD == np.fft.ifft * N,
cpuLS.hpp:152-162).  These serve the composed pipeline and the plain versions
of the kernels; the fused path computes its FFTs inside its own kernels
(``csrc/fft.cuh``).  The reference's MXU formulations (``matmul``,
``four_step``, ``set_precision``) have no counterpart here.
"""

from __future__ import annotations

import torch

from .cplx import CArray


def _planar(z: torch.Tensor) -> CArray:
    return CArray(z.real.contiguous(), z.imag.contiguous())


def fft(x: CArray) -> CArray:
    """Forward DFT along the last axis of float32 planes."""
    return _planar(torch.fft.fft(torch.complex(x.re, x.im), dim=-1))


def ifft(x: CArray) -> CArray:
    """Unnormalized inverse DFT along the last axis of float32 planes."""
    return _planar(torch.fft.ifft(torch.complex(x.re, x.im), dim=-1, norm="forward"))
