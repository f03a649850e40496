"""Least-Squares channel estimation on the full FFT grid, DC masked
(counterpart of ``ofdm_ls_mrc_tpu.ops.ls``).

H = FFT(pilot) / X per antenna, conjugated, with the DC bin zeroed
(hconj[..., 0] = 0); Hsqrd = sum_ant |H|^2 with the DC bin set to 1
(firstVector, cpuLS.hpp:247-317; findDistSqrd, cpuLS.hpp:211-228).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .cplx import CArray, DeviceLike, cdiv, cwhere


def pad_pilot(pilot_x: np.ndarray, device: DeviceLike) -> CArray:
    """Embed the (F-1)-wide pilot into the full FFT grid with X[0] = 1, in
    natural frequency order.  The DC value only has to be non-zero: every
    path masks or drops that bin."""
    x = np.asarray(pilot_x, dtype=np.complex64)
    full = np.concatenate([np.ones(x.shape[:-1] + (1,), np.complex64), x], axis=-1)
    return CArray.from_numpy(full, device)


def estimate_channel_full(pilot_fft: CArray, x_full: CArray) -> Tuple[CArray, torch.Tensor]:
    """LS estimate from an already-FFT'd pilot symbol.

    Args:
      pilot_fft: [..., A, F] planar FFT of the time-domain pilot rows.
      x_full:    [F] planar padded pilot (``pad_pilot``).

    Returns:
      hconj: [..., A, F] conj(H) with the DC bin zeroed.
      hsqrd: [..., F] sum over antennas of |H|^2 with the DC bin set to 1.
    """
    h = cdiv(pilot_fft, x_full)
    f = h.shape[-1]
    dc_mask = torch.arange(f, device=h.device) != 0
    hconj = cwhere(dc_mask, h.conj(), 0.0)
    hsqrd = torch.sum(h.abs2(), dim=-2)
    hsqrd = torch.where(dc_mask, hsqrd, torch.ones((), dtype=hsqrd.dtype, device=h.device))
    return hconj, hsqrd
