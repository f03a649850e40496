"""Typed frame geometry for the OFDM LS+MRC receiver.

The port's own copy of ``ofdm_ls_mrc_tpu.config.FrameConfig``; tests hold
the two equal.  The reference scatters configuration across compile-time
``#define`` macros (``numOfRows``/``dimension``/``prefix``/``lenOfBuffer``/
``numUsers``, ``ShMemSymBuff.hpp:41-75``); here they are one frozen
dataclass that every layer consumes.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FrameConfig:
    """Geometry of one OFDM frame as it flows through the pipeline.

    Mirrors the reference defaults (``ShMemSymBuff.hpp:42-67``):
    ``numOfRows=16`` antennas x ``dimension=1024``-point FFT, cyclic prefix
    ``prefix=0`` (the live RX uses 72, ``rx_and_corr.cpp:120``), frame =
    ``lenOfBuffer`` symbols of which symbol 0 is the pilot.
    """

    num_antennas: int = 16          # numOfRows
    fft_size: int = 1024            # dimension
    cyclic_prefix: int = 0          # prefix
    frame_len: int = 101            # lenOfBuffer (ShMemSymBuff_gpu.hpp:73-75)
    num_users: int = 4              # numUsers (ShMemSymBuff_cucomplex.hpp:53-55)

    @property
    def num_subcarriers(self) -> int:
        """Data subcarriers: the DC bin is dropped (gpuLS.cuh:67-70)."""
        return self.fft_size - 1

    @property
    def num_data_symbols(self) -> int:
        """Symbols 1..frame_len-1 carry data; symbol 0 is the pilot."""
        return self.frame_len - 1

    @property
    def symbol_len(self) -> int:
        """Time-domain samples per OFDM symbol including cyclic prefix."""
        return self.fft_size + self.cyclic_prefix

    @property
    def samples_per_frame(self) -> int:
        """Complex samples per frame per antenna (incl. pilot and CP)."""
        return self.frame_len * self.symbol_len

    def validate(self) -> "FrameConfig":
        """Checks the constraints every pipeline shares: the composed path
        takes any even fft_size >= 2; the CUDA kernels further need a power
        of two in their range (``ops/pipeline.supports_fused``), and a
        receiver asked for them on another size raises."""
        if self.num_antennas < 1:
            raise ValueError("num_antennas must be >= 1")
        if self.fft_size < 2 or self.fft_size & 1:
            raise ValueError(f"fft_size must be an even size >= 2 (got {self.fft_size})")
        if self.cyclic_prefix < 0:
            raise ValueError("cyclic_prefix must be >= 0")
        if self.frame_len < 2:
            raise ValueError("frame_len must hold a pilot plus >=1 data symbol")
        return self
