"""Per-symbol streaming demodulator: the low-latency path (counterpart of
``ofdm_ls_mrc_tpu.models.streaming``).

Mirrors the reference's per-symbol pipeline (firstVector + demodOneSymbol,
gpuLS.cu:351-473; cpuLS_main.cpp:80-93): symbols stream through as
[A, F+cp] planar blocks, the pilot (slot 0 of each frame) refreshes the
channel estimate, and phase timings feed the reference-compatible
PhaseTimer.

Two bodies:
  'composed' -- torch ops (torch.fft + LS + MRC), any geometry; the
                estimate is (hconj, sum_a |h|^2), true order, DC masked.
  'fused'    -- the whole-frame path's two CUDA kernels at S = 1:
                ``push_pilot`` runs ``pipeline.estimate_pilot_fused`` and
                keeps (h, 1/sum_a |h|^2) in natural order, ``push_symbol``
                one launch of ``pipeline.fused_pipeline`` on sym[None, :, cp:].
                An F the kernels do not cover raises.

One data symbol is one block of the card per launch: this path buys
latency, not throughput.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..config import FrameConfig
from ..io.state import load_estimate, save_estimate
from ..ops import ls as ls_ops
from ..ops import pipeline as pipe
from ..ops.cplx import CArray, DeviceLike, resolve_device
from ..ops.modulate import drop_cyclic_prefix
from ..utils.timing import PhaseTimer
from .uplink import demod_data_fn, estimate_fn, to_device

SymbolLike = Union[np.ndarray, CArray]


class StreamingDemodulator:
    """Symbol-at-a-time LS+MRC demodulator with a persistent channel estimate.

    Usage:
      sd = StreamingDemodulator(cfg, pilot_x)      # on the card
      sd.push_pilot(pilot_sym)                     # frame start (slot 0)
      out = sd.push_symbol(data_sym)               # [F-1] per data symbol
    """

    def __init__(self, cfg: FrameConfig, pilot_x: np.ndarray, *,
                 timer: Optional[PhaseTimer] = None, pipeline: str = "composed",
                 device: DeviceLike = "cuda"):
        """pipeline: 'composed' (default; torch ops, any geometry) or
        'fused' (the CUDA kernels, one launch per symbol; an F they do not
        cover raises).  device: the card unless 'cpu' is asked for; without
        a CUDA device the default raises."""
        cfg.validate()
        if pipeline not in ("composed", "fused"):
            raise ValueError(f"unknown pipeline {pipeline!r}: expected 'composed' "
                             "or 'fused'")
        if pipeline == "fused" and not pipe.supports_fused(cfg.fft_size):
            raise ValueError(f"pipeline='fused' needs fft_size in "
                             f"{pipe.FUSED_FFT_SIZES}, got {cfg.fft_size}; "
                             "use pipeline='composed'")
        if pilot_x.shape[-1] != cfg.num_subcarriers:
            raise ValueError(f"pilot has {pilot_x.shape[-1]} bins, config wants "
                             f"{cfg.num_subcarriers}")
        self.cfg = cfg
        self.pipeline = pipeline
        self.device = resolve_device(device, "StreamingDemodulator")
        self.x_full = ls_ops.pad_pilot(pilot_x, self.device)
        self.timer = timer
        # 'composed': (hconj, sum_a|h|^2); 'fused': (h, 1/sum_a|h|^2).
        self._h: Optional[CArray] = None
        self._g: Optional[torch.Tensor] = None

    @property
    def has_estimate(self) -> bool:
        return self._h is not None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _estimate(self, pilot: CArray):
        cp = self.cfg.cyclic_prefix
        if self.pipeline == "fused":
            return pipe.estimate_pilot_fused(drop_cyclic_prefix(pilot, cp), self.x_full)
        return estimate_fn(pilot, self.x_full, cp=cp)

    def _demod(self, sym: CArray) -> CArray:
        cp = self.cfg.cyclic_prefix
        if self.pipeline == "fused":
            return pipe.fused_pipeline(drop_cyclic_prefix(sym, cp)[None], self._h, self._g)[0]
        return demod_data_fn(sym[None], self._h, self._g, cp=cp)[0]

    def push_pilot(self, pilot_sym: SymbolLike, slot: int = 0) -> None:
        """Refresh the channel estimate from a frame's pilot symbol [A, F+cp].
        With a timer, the 'chanest' phase ends when the device has finished."""
        c = to_device(pilot_sym, self.device)
        if self.timer:
            with self.timer.phase("chanest", slot):
                self._h, self._g = self._estimate(c)
                self._sync()
        else:
            self._h, self._g = self._estimate(c)

    def push_symbol(self, data_sym: SymbolLike, slot: int = 1) -> CArray:
        """Demod one data symbol [A, F+cp] -> [F-1] with the current estimate.

        ``slot`` is the symbol's frame position (data symbols occupy slots
        1..frame_len-1; slot 0 is the pilot).  PhaseTimer.summary() excludes
        slot 0 from decode stats -- mirroring the reference's &decode[1]
        averaging -- so timed data symbols must not default into it.  With a
        timer, the 'decode' phase ends when the device has finished."""
        if self._h is None:
            raise RuntimeError("no channel estimate: push_pilot first "
                               "(frame slot 0 is the pilot)")
        c = to_device(data_sym, self.device)
        if self.timer:
            with self.timer.phase("decode", slot):
                out = self._demod(c)
                self._sync()
            return out
        return self._demod(c)

    def push_symbol_async(self, data_sym: SymbolLike, slot: int = 1) -> CArray:
        """Enqueue-only variant of push_symbol: launches the demod on the
        current stream and returns without waiting for the device.  The
        caller owns the wait (``torch.cuda.synchronize`` or an event); time
        THAT wait, not the enqueue, to keep the decode column honest."""
        if self._h is None:
            raise RuntimeError("no channel estimate: push_pilot first "
                               "(frame slot 0 is the pilot)")
        return self._demod(to_device(data_sym, self.device))

    # -- state persistence (checkpoint/resume; io/state.py) ------------------
    def save_state(self, path: str, frame_index: int = 0) -> None:
        """Persist the current channel estimate for restart-resume, always
        in the portable true-frequency (hconj, sum|h|^2) layout of the JAX
        package's files, whatever the pipeline."""
        if self._h is None:
            raise RuntimeError("no channel estimate to save")
        if self.pipeline == "fused":
            save_estimate(path, self.cfg, self._h.conj(), 1.0 / self._g, frame_index)
        else:
            save_estimate(path, self.cfg, self._h, self._g, frame_index)

    def resume(self, path: str) -> int:
        """Restore a saved estimate (written by either package); returns the
        stored frame index."""
        hconj, hsqrd, idx = load_estimate(path, self.cfg)
        hconj, hsqrd = hconj.to(self.device), hsqrd.to(self.device)
        if self.pipeline == "fused":
            self._h, self._g = hconj.conj(), 1.0 / hsqrd
        else:
            self._h, self._g = hconj, hsqrd
        return idx

    def warmup(self, int16: bool = False) -> None:
        """Run the estimate and demod entries once before the stream goes
        live (on the card this builds and loads the kernels).  ``int16=True``
        feeds planar int16 symbols, the sc16-native input."""
        a, n = self.cfg.num_antennas, self.cfg.symbol_len
        if int16:
            sym = CArray(torch.ones((a, n), dtype=torch.int16, device=self.device),
                         torch.zeros((a, n), dtype=torch.int16, device=self.device))
        else:
            sym = np.ones((a, n), np.complex64)
        self.push_pilot(sym)
        self.push_symbol(sym)
        self._sync()
        self._h = None
        self._g = None
