"""Uplink receiver: the whole-frame LS + MRC pipeline (counterpart of
``ofdm_ls_mrc_tpu.models.uplink``).

``pipeline="fused"`` runs the hand-written CUDA kernels (their plain
versions for CPU tensors): the whole-frame path the two of
``ops/pipeline.py``, the split-phase ``demod_data`` the one of
``ops/fused_mrc.py``.  ``pipeline="composed"`` runs the plain op
composition (``torch.fft`` + LS + MRC), the port's correctness anchor.  The
split-phase ``estimate_channel`` uses torch ops under both pipelines, as the
reference does, so estimates are interchangeable across frames and
pipelines.

All math is planar (re, im): inputs are host complex arrays or ``CArray``s
already on the receiver's device, outputs are ``CArray``s.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch
from torch import nn

from ..config import FrameConfig
from ..ops import fft as fft_ops
from ..ops import fused_mrc
from ..ops import ls as ls_ops
from ..ops import mrc as mrc_ops
from ..ops import pipeline as pipe
from ..ops.cplx import CArray, DeviceLike, resolve_device
from ..ops.modulate import drop_cyclic_prefix

FrameLike = Union[np.ndarray, CArray]


def to_device(x: FrameLike, device: torch.device) -> CArray:
    """A host complex array as planar float32 on ``device``; a CArray passes
    through when it is already there and raises when it is not."""
    if not isinstance(x, CArray):
        return CArray.from_numpy(x, device)
    if x.device != device:
        raise ValueError(f"input is on {x.device}, expected {device}")
    return x


def demod_frame_fn(frame: CArray, x_full: CArray, *, cp: int) -> CArray:
    """Composed whole-frame demod: [.., S, A, F+cp] -> [.., S-1, F-1]."""
    yf = fft_ops.fft(pipe.widen_sc16(drop_cyclic_prefix(frame, cp)))
    hconj, hsqrd = ls_ops.estimate_channel_full(yf[..., 0, :, :], x_full)
    eq = mrc_ops.mrc_combine(yf[..., 1:, :, :], hconj, hsqrd)
    return mrc_ops.finalize(eq)


def estimate_fn(pilot_sym: CArray, x_full: CArray, *, cp: int) -> Tuple[CArray, torch.Tensor]:
    """[.., A, F+cp] pilot -> (hconj [.., A, F], hsqrd [.., F]), DC masked."""
    y = pipe.widen_sc16(drop_cyclic_prefix(pilot_sym, cp))
    return ls_ops.estimate_channel_full(fft_ops.fft(y), x_full)


def demod_data_fn(data: CArray, hconj: CArray, hsqrd: torch.Tensor, *, cp: int) -> CArray:
    """Pre-estimated data symbols: [.., S, A, F+cp] -> [.., S, F-1]."""
    y = pipe.widen_sc16(drop_cyclic_prefix(data, cp))
    return mrc_ops.finalize(mrc_ops.mrc_combine(fft_ops.fft(y), hconj, hsqrd))


class UplinkReceiver(nn.Module):
    """LS + MRC uplink receiver for one antenna-array stream.

    Usage:
      rx = UplinkReceiver(cfg, pilot_x)        # on the card; device="cpu" asks for the CPU
      out = rx.demod_frame(frame)              # CArray [S-1, F-1]
      hconj, hsqrd = rx.estimate_channel(frame[0])
      out = rx.demod_data(frame[1:], hconj, hsqrd)

    The padded pilot (natural order, X[0] = 1) is a registered buffer, so
    ``rx.to(device)`` moves it; inputs must be host arrays or CArrays on the
    receiver's device.
    """

    def __init__(self, cfg: FrameConfig, pilot_x: np.ndarray, *,
                 pipeline: str = "fused", exact: bool = True,
                 device: DeviceLike = "cuda"):
        """pipeline: 'fused' (the CUDA kernels) or 'composed' (plain ops).
        'fast' is the reference's MXU Karatsuba path, not ported.
        exact: only True; the bf16 speed mode is not ported yet.
        device: where the receiver computes, the card unless 'cpu' is asked
        for; without a CUDA device the default raises."""
        super().__init__()
        cfg.validate()
        if pipeline == "fast":
            raise NotImplementedError(
                "pipeline='fast' is the TPU's Karatsuba MXU path and is not "
                "ported (ROADMAP.md queue 1 #5); use 'fused' or 'composed'")
        if pipeline not in ("fused", "composed"):
            raise ValueError(f"unknown pipeline {pipeline!r}: expected 'fused' "
                             "or 'composed'")
        if not exact:
            raise NotImplementedError(
                "exact=False (the bf16 speed mode) is not ported yet "
                "(ROADMAP.md queue 1 #11)")
        if pipeline == "fused" and not pipe.supports_fused(cfg.fft_size):
            raise ValueError(f"pipeline='fused' needs fft_size in "
                             f"{pipe.FUSED_FFT_SIZES}, got {cfg.fft_size}; "
                             "use pipeline='composed'")
        if pilot_x.shape[-1] != cfg.num_subcarriers:
            raise ValueError(f"pilot has {pilot_x.shape[-1]} bins, config wants "
                             f"{cfg.num_subcarriers}")
        device = resolve_device(device, "UplinkReceiver")
        self.cfg = cfg
        self.pipeline = pipeline
        self.exact = exact
        x = ls_ops.pad_pilot(pilot_x, device)
        self.register_buffer("x_full_re", x.re)
        self.register_buffer("x_full_im", x.im)

    @property
    def device(self) -> torch.device:
        return self.x_full_re.device

    @property
    def x_full(self) -> CArray:
        return CArray(self.x_full_re, self.x_full_im)

    def _as_carray(self, x: FrameLike) -> CArray:
        return to_device(x, self.device)

    # -- whole-frame path ----------------------------------------------------
    def demod_frame(self, frame: FrameLike) -> CArray:
        """[S, A, F+cp] -> [S-1, F-1] demodulated data symbols."""
        frame = self._as_carray(frame)
        cp = self.cfg.cyclic_prefix
        if self.pipeline == "fused":
            return pipe.demod_frame_fused(frame, self.x_full, cp=cp)
        return demod_frame_fn(frame, self.x_full, cp=cp)

    forward = demod_frame

    def demod_parts(self, pilot: FrameLike, data: FrameLike) -> CArray:
        """Pre-split fused path: pilot [A, F] + CP-free data rows
        [S-1, A, F] -> [S-1, F-1].  Fused pipeline with cyclic_prefix=0."""
        if self.pipeline != "fused" or self.cfg.cyclic_prefix != 0:
            raise ValueError("demod_parts needs pipeline='fused' and cyclic_prefix=0")
        return pipe.demod_parts_fused(self._as_carray(pilot),
                                      self._as_carray(data), self.x_full)

    # -- split-phase path ----------------------------------------------------
    def estimate_channel(self, pilot_sym: FrameLike) -> Tuple[CArray, torch.Tensor]:
        """[A, F+cp] pilot -> (hconj [A, F], hsqrd [F]) on the full grid."""
        return estimate_fn(self._as_carray(pilot_sym), self.x_full,
                           cp=self.cfg.cyclic_prefix)

    def demod_data(self, data: FrameLike, hconj: CArray, hsqrd: torch.Tensor) -> CArray:
        """[S, A, F+cp] data + estimates -> [S, F-1].  Under 'fused' one
        launch of ``csrc/mrc_demod.cu`` reads the rows in place, then
        ``mrc.finalize``."""
        data = self._as_carray(data)
        cp = self.cfg.cyclic_prefix
        if self.pipeline == "fused":
            eq = fused_mrc.fused_demod(drop_cyclic_prefix(data, cp), hconj, hsqrd)
            return mrc_ops.finalize(eq)
        return demod_data_fn(data, hconj, hsqrd, cp=cp)

    # -- long-capture path ---------------------------------------------------
    def demod_capture(self, frames: FrameLike) -> CArray:
        """[K, S, A, F+cp] capture (K whole frames) -> [K, S-1, F-1].

        The fused pipeline sends all K frames through one launch of each
        kernel; the composed one batches them in its tensor ops."""
        frames = self._as_carray(frames)
        if frames.ndim != 4:
            raise ValueError(f"capture must be [K, S, A, F+cp], got {frames.shape}")
        return self.demod_frame(frames)

    # -- build ahead of time -------------------------------------------------
    def warmup(self) -> None:
        """Run both paths once on ones (the reference's warm-up FFT,
        gpuLS_main.cu:94-97): on CUDA this builds and loads the kernels."""
        s, a, n = self.cfg.frame_len, self.cfg.num_antennas, self.cfg.symbol_len
        self.demod_frame(np.ones((s, a, n), np.complex64))
        h = self.estimate_channel(np.ones((a, n), np.complex64))
        self.demod_data(np.ones((s - 1, a, n), np.complex64), *h)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

