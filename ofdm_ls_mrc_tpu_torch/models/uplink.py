"""Uplink receiver: the whole-frame LS + MRC pipeline (counterpart of
``ofdm_ls_mrc_tpu.models.uplink``).

``pipeline="fused"`` runs the hand-written CUDA kernels (their plain
versions for CPU tensors): the whole-frame path the two of
``ops/pipeline.py``, the split-phase ``demod_data`` the one of
``ops/fused_mrc.py``.  ``pipeline="fast"`` runs ``ops/fastpath.py``, the
permuted-order four-step pipeline on float32 GEMMs (plain torch ops: the
JAX package leaves it to XLA).  ``pipeline="composed"`` runs the plain op
composition (LS + MRC on ``fft_ops.get_fft(fft_impl)``), the port's
correctness anchor.  The split-phase ``estimate_channel`` uses the composed
ops under every pipeline, as the reference does, so estimates are
interchangeable across frames and pipelines.

Routing, as the JAX receiver's (``ofdm_ls_mrc_tpu/models/uplink.py:110-168``),
each downgrade a ``RuntimeWarning``:
  - 'fused' at an F its kernels do not take (``pipeline.supports_fused``:
    the powers of two 64-32768) becomes 'fast';
  - 'fast' with ``fft_impl="xla"`` (the default, ``fft.default_impl``)
    becomes 'composed';
  - 'fast' with 'four_step' or 'matmul' runs ``fastpath.demod_frame_fast``;
  - 'composed' takes ``get_fft(fft_impl)``.
One deliberate difference: 'fused', at an F the kernels take, runs the CUDA
kernels whatever ``fft_impl`` says.  The JAX receiver downgrades 'fused' to
'composed' under 'xla' (``:152-163``) because XLA on a CPU or GPU has no
Pallas kernel; the port has its kernels.

``exact=False`` selects the bf16 speed mode of the fused whole-frame path
(``demod_frame``, ``demod_parts``, ``demod_capture``): the two tensor-core
kernels of ``csrc/fft_mrc_bf16.cu``, about 1e-2 relative error by design,
at F = 256 to 32768.  As in the JAX package, what has no speed branch there
stays exact: F = 64 and 128 (the JAX receiver falls back to its 'fast'
path, which ignores ``exact``), 'fast', 'composed' and the split phase;
``rx.exact`` keeps the value given.

All math is planar (re, im): inputs are host complex arrays or ``CArray``s
already on the receiver's device, outputs are ``CArray``s.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import warnings

import numpy as np
import torch
from torch import nn

from ..config import FrameConfig
from ..ops import fastpath
from ..ops import fft as fft_ops
from ..ops import fused_mrc
from ..ops import ls as ls_ops
from ..ops import mrc as mrc_ops
from ..ops import pipeline as pipe
from ..ops.cplx import CArray, DeviceLike, resolve_device
from ..ops.modulate import drop_cyclic_prefix
from ..utils import profiling

FrameLike = Union[np.ndarray, CArray]


def to_device(x: FrameLike, device: torch.device) -> CArray:
    """A host complex array as planar float32 on ``device``; a CArray passes
    through when it is already there and raises when it is not."""
    if not isinstance(x, CArray):
        return CArray.from_numpy(x, device)
    if x.device != device:
        raise ValueError(f"input is on {x.device}, expected {device}")
    return x


PIPELINES = ("fused", "fast", "composed")


def check_pipeline(cfg: FrameConfig, pipeline: str, who: str) -> str:
    """The pipeline a whole-frame receiver runs: 'fused', 'fast' or
    'composed' as asked, except that 'fused' at an F the kernels do not
    take becomes 'fast' with a RuntimeWarning (the JAX receivers' rule)."""
    if pipeline not in PIPELINES:
        raise ValueError(f"unknown pipeline {pipeline!r}: expected 'fused', 'fast' "
                         "or 'composed'")
    if pipeline == "fused" and not pipe.supports_fused(cfg.fft_size):
        pipe.warn_fused_fallback(cfg.fft_size, who, to="fast")
        return "fast"
    return pipeline


def check_fft_impl(fft_impl) -> str:
    """``fft_impl`` or the default (``fft.default_impl``), checked."""
    impl = fft_impl or fft_ops.default_impl()
    if impl not in fft_ops.FFT_IMPLS:
        raise ValueError(f"unknown fft_impl {impl!r}: expected one of "
                         f"{sorted(fft_ops.FFT_IMPLS)}")
    return impl


def fast_or_composed(pipeline: str, fft_impl: str, who: str) -> str:
    """'fast' has no program on the library FFT: with fft_impl='xla' it
    becomes 'composed' with a RuntimeWarning, as in the JAX receiver."""
    if pipeline == "fast" and fft_impl == "xla":
        warnings.warn(f"{who}: 'fast' pipeline unavailable on the library ('xla') FFT; "
                      "using 'composed' (pass fft_impl='four_step' or 'matmul')",
                      RuntimeWarning, stacklevel=3)
        return "composed"
    return pipeline


def speed_mode(cfg: FrameConfig, pipeline: str, exact: bool) -> bool:
    """True when exact=False runs the bf16 speed kernels: under 'fused' at
    an F they cover (256-32768).  Elsewhere the JAX receivers ignore
    ``exact``, and so do these."""
    return not exact and pipeline == "fused" and pipe.supports_speed(cfg.fft_size)


def demod_frame_fn(frame: CArray, x_full: CArray, *, cp: int,
                   fft_impl: str = "xla") -> CArray:
    """Composed whole-frame demod: [.., S, A, F+cp] -> [.., S-1, F-1]."""
    yf = fft_ops.get_fft(fft_impl)(pipe.widen_sc16(drop_cyclic_prefix(frame, cp)))
    hconj, hsqrd = ls_ops.estimate_channel_full(yf[..., 0, :, :], x_full)
    eq = mrc_ops.mrc_combine(yf[..., 1:, :, :], hconj, hsqrd)
    return mrc_ops.finalize(eq)


def estimate_fn(pilot_sym: CArray, x_full: CArray, *, cp: int,
                fft_impl: str = "xla") -> Tuple[CArray, torch.Tensor]:
    """[.., A, F+cp] pilot -> (hconj [.., A, F], hsqrd [.., F]), DC masked."""
    y = pipe.widen_sc16(drop_cyclic_prefix(pilot_sym, cp))
    return ls_ops.estimate_channel_full(fft_ops.get_fft(fft_impl)(y), x_full)


def demod_data_fn(data: CArray, hconj: CArray, hsqrd: torch.Tensor, *, cp: int,
                  fft_impl: str = "xla") -> CArray:
    """Pre-estimated data symbols: [.., S, A, F+cp] -> [.., S, F-1]."""
    y = pipe.widen_sc16(drop_cyclic_prefix(data, cp))
    return mrc_ops.finalize(mrc_ops.mrc_combine(fft_ops.get_fft(fft_impl)(y), hconj, hsqrd))


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
                 pipeline: str = "fused", fft_impl: Optional[str] = None,
                 exact: bool = True, device: DeviceLike = "cuda"):
        """pipeline: 'fused' (the CUDA kernels), 'fast' (the permuted-order
        four-step pipeline) or 'composed' (plain ops); the module docstring
        gives the downgrades, each a RuntimeWarning, and ``rx.pipeline``
        the pipeline that runs.
        fft_impl: 'xla' (``torch.fft``; the default), 'four_step' or
        'matmul', for 'fast', 'composed' and the split-phase estimate.
        exact: True (fp32-grade) or False, the bf16 speed mode of the
        fused whole-frame path (see the module docstring for what it
        leaves exact).
        device: where the receiver computes, the card unless 'cpu' is asked
        for; without a CUDA device the default raises."""
        super().__init__()
        cfg.validate()
        self.fft_impl = check_fft_impl(fft_impl)
        pipeline = check_pipeline(cfg, pipeline, "UplinkReceiver")
        pipeline = fast_or_composed(pipeline, self.fft_impl, "UplinkReceiver")
        if pilot_x.shape[-1] != cfg.num_subcarriers:
            raise ValueError(f"pilot has {pilot_x.shape[-1]} bins, config wants "
                             f"{cfg.num_subcarriers}")
        device = resolve_device(device, "UplinkReceiver")
        self.cfg = cfg
        self.pipeline = pipeline
        self.exact = exact
        self._fused_exact = not speed_mode(cfg, pipeline, exact)
        x = ls_ops.pad_pilot(pilot_x, device)
        self.register_buffer("x_full_re", x.re)
        self.register_buffer("x_full_im", x.im)
        if pipeline == "fast":
            xp = fastpath.prepare_pilot_fast(pilot_x, cfg.fft_size, device)
            self.register_buffer("x_perm_re", xp.re)
            self.register_buffer("x_perm_im", xp.im)

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
            return pipe.demod_frame_fused(frame, self.x_full, cp=cp, exact=self._fused_exact)
        if self.pipeline == "fast":
            return fastpath.demod_frame_fast(frame, CArray(self.x_perm_re, self.x_perm_im), cp=cp)
        return demod_frame_fn(frame, self.x_full, cp=cp, fft_impl=self.fft_impl)

    forward = demod_frame

    def demod_parts(self, pilot: FrameLike, data: FrameLike) -> CArray:
        """Pre-split fused path: pilot [A, F] + CP-free data rows
        [S-1, A, F] -> [S-1, F-1].  Fused pipeline with cyclic_prefix=0."""
        if self.pipeline != "fused" or self.cfg.cyclic_prefix != 0:
            raise ValueError("demod_parts needs pipeline='fused' and cyclic_prefix=0")
        return pipe.demod_parts_fused(self._as_carray(pilot), self._as_carray(data),
                                      self.x_full, exact=self._fused_exact)

    # -- split-phase path ----------------------------------------------------
    def estimate_channel(self, pilot_sym: FrameLike) -> Tuple[CArray, torch.Tensor]:
        """[A, F+cp] pilot -> (hconj [A, F], hsqrd [F]) on the full grid."""
        return estimate_fn(self._as_carray(pilot_sym), self.x_full,
                           cp=self.cfg.cyclic_prefix, fft_impl=self.fft_impl)

    def demod_data(self, data: FrameLike, hconj: CArray, hsqrd: torch.Tensor) -> CArray:
        """[S, A, F+cp] data + estimates -> [S, F-1].  Under 'fused' one
        launch of ``csrc/mrc_demod.cu`` reads the rows in place, then
        ``mrc.finalize``."""
        data = self._as_carray(data)
        cp = self.cfg.cyclic_prefix
        if self.pipeline == "fused":
            eq = fused_mrc.fused_demod(drop_cyclic_prefix(data, cp), hconj, hsqrd)
            return mrc_ops.finalize(eq)
        return demod_data_fn(data, hconj, hsqrd, cp=cp, fft_impl=self.fft_impl)

    # -- long-capture path ---------------------------------------------------
    def demod_capture(self, frames: FrameLike) -> CArray:
        """[K, S, A, F+cp] capture (K whole frames) -> [K, S-1, F-1].

        The fused pipeline sends all K frames through one launch of each
        kernel; 'fast' and 'composed' batch them in their tensor ops.  While
        a profiler runs, the call is the span ``rx.demod_capture``, the
        root of the wrappers' spans (``utils/profiling.annotate``)."""
        with profiling.annotate("rx.demod_capture"):
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

