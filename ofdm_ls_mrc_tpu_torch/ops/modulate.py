"""Cyclic-prefix handling (counterpart of the CP helpers in
``ofdm_ls_mrc_tpu.ops.modulate``; the downlink modulator is not ported yet)."""

from __future__ import annotations

import torch

from .cplx import CArray


def add_cyclic_prefix(sym: CArray, cp: int) -> CArray:
    """Prepend the last ``cp`` samples (addPrefix, cpuLS.hpp:391-398)."""
    if cp == 0:
        return sym
    return CArray(torch.cat([sym.re[..., -cp:], sym.re], dim=-1),
                  torch.cat([sym.im[..., -cp:], sym.im], dim=-1))


def drop_cyclic_prefix(sym: CArray, cp: int) -> CArray:
    """Strip the cyclic prefix (read path, ShMemSymBuff.hpp:281-294).

    Returns a view: the kernels read the payload in place through the row
    stride, so a frame with a prefix is never copied."""
    if cp == 0:
        return sym
    return sym[..., cp:]
