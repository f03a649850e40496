"""Half-spectrum swaps as rolls on the last axis (counterpart of
``ofdm_ls_mrc_tpu.ops.shift``)."""

from __future__ import annotations

from .cplx import CArray


def pilot_shift(x: CArray) -> CArray:
    """fftshift on the last axis (pilot load convention, cpuLS.hpp:105-113)."""
    return x.roll(x.shape[-1] // 2, axis=-1)


def output_shift(x: CArray) -> CArray:
    """ifftshift on the last axis (demod output convention, cpuLS.hpp:135-149)."""
    return x.roll(-(x.shape[-1] // 2), axis=-1)
