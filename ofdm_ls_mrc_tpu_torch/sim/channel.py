"""Synthetic channel + constellation toolkit (the port's own copy of
``ofdm_ls_mrc_tpu.sim.channel``; tests hold the two equal).

The reference is verified only against live ORBIT radio captures (README.md:2-5);
this module supplies what the reference lacks: a reproducible synthetic
multipath/AWGN channel and QPSK/QAM mappers, so the full TX -> channel -> RX
chain is testable without hardware.  Used by the end-to-end EVM tests and the
file-player front-end.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..golden import dsp


# ---------------------------------------------------------------------------
# Constellations
# ---------------------------------------------------------------------------

_QPSK = np.array([1 + 1j, -1 + 1j, 1 - 1j, -1 - 1j], dtype=np.complex64) / np.sqrt(2)


def _square_qam_points(m_side: int) -> np.ndarray:
    """Unit-average-power square QAM (m_side points per rail)."""
    levels = np.arange(-(m_side - 1), m_side, 2, dtype=np.float32)
    pts = (levels[:, None] + 1j * levels[None, :]).reshape(-1)
    return (pts / np.sqrt(np.mean(np.abs(pts) ** 2))).astype(np.complex64)


_QAM16 = _square_qam_points(4)
_QAM64 = _square_qam_points(8)

CONSTELLATIONS = {"qpsk": _QPSK, "16qam": _QAM16, "64qam": _QAM64}


def map_symbols(bits_or_idx: np.ndarray, scheme: str = "qpsk") -> np.ndarray:
    """Map integer constellation indices to complex symbols."""
    const = CONSTELLATIONS[scheme]
    return const[np.asarray(bits_or_idx) % const.size]


def demap_symbols(syms: np.ndarray, scheme: str = "qpsk") -> np.ndarray:
    """Hard-decision nearest-neighbor demap back to indices.

    Chunked over a flat view so the [n, M] distance matrix stays bounded
    (~8 MB) regardless of input size -- compare_app demaps entire capture
    files, where a one-shot [n, subcarriers, M] broadcast would allocate
    tens of GB."""
    const = CONSTELLATIONS[scheme]
    syms = np.asarray(syms)
    flat = syms.reshape(-1)
    out = np.empty(flat.shape, dtype=np.int64)
    step = max(1, (1 << 20) // const.size)
    for lo in range(0, flat.size, step):
        hi = min(lo + step, flat.size)
        d = np.abs(flat[lo:hi, None] - const[None, :])
        out[lo:hi] = np.argmin(d, axis=-1)
    return out.reshape(syms.shape)


def random_symbols(rng: np.random.Generator, shape,
                   scheme: str = "qpsk") -> "tuple[np.ndarray, np.ndarray]":
    """Random constellation points: returns (symbols, indices)."""

    idx = rng.integers(0, CONSTELLATIONS[scheme].size, size=shape)
    return map_symbols(idx, scheme), idx


# ---------------------------------------------------------------------------
# Channel models
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ChannelModel:
    """Per-antenna frequency-selective Rayleigh channel with AWGN.

    The channel is realized as ``num_taps`` i.i.d. complex-Gaussian time-domain
    taps per antenna (so the frequency response is smooth, as a real multipath
    channel's is), applied by circular convolution -- exact for OFDM symbols
    whose cyclic prefix covers the delay spread.
    """

    num_antennas: int
    fft_size: int
    num_taps: int = 8
    snr_db: float = 30.0
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        taps = (rng.standard_normal((self.num_antennas, self.num_taps))
                + 1j * rng.standard_normal((self.num_antennas, self.num_taps)))
        taps = taps.astype(np.complex64) / np.sqrt(2 * self.num_taps)
        self.taps = taps
        # Frequency response on the full FFT grid.
        h = np.zeros((self.num_antennas, self.fft_size), dtype=np.complex64)
        h[:, : self.num_taps] = taps
        self.freq_response = np.fft.fft(h, axis=-1).astype(np.complex64)
        self._noise_rng = np.random.default_rng(self.seed + 1)

    def apply(self, tx_frame: np.ndarray, cp: int = 0) -> np.ndarray:
        """Run a TX frame through the channel.

        The channel is applied as the exact CP-covered (circular) response:
        the F-sample payload is filtered in the frequency domain and the
        cyclic prefix of the *received* symbol is re-derived from its tail,
        which is what a physical channel with delay spread <= cp produces.

        Args:
          tx_frame: [S, F+cp] complex64 single-stream time-domain symbols.
          cp: cyclic prefix length.

        Returns:
          [S, A, F+cp] complex64 received frame across antennas.
        """
        payload = tx_frame[:, cp:] if cp else tx_frame
        txf = np.fft.fft(payload, axis=-1)                     # [S, F]
        rxf = txf[:, None, :] * self.freq_response[None, :, :]  # [S, A, F]
        rx = np.fft.ifft(rxf, axis=-1).astype(np.complex64)
        if cp:
            rx = np.concatenate([rx[..., -cp:], rx], axis=-1)
        sig_pow = np.mean(np.abs(rx) ** 2)
        noise_pow = sig_pow / (10 ** (self.snr_db / 10))
        noise = (self._noise_rng.standard_normal(rx.shape)
                 + 1j * self._noise_rng.standard_normal(rx.shape))
        rx = rx + np.sqrt(noise_pow / 2).astype(np.float32) * noise.astype(np.complex64)
        return rx.astype(np.complex64)


def evm_db(rx: np.ndarray, tx: np.ndarray) -> float:
    """Error-vector magnitude in dB between demodulated and sent symbols."""
    err = np.mean(np.abs(rx - tx) ** 2)
    ref = np.mean(np.abs(tx) ** 2)
    return float(10 * np.log10(err / ref + 1e-30))


def make_tx_frame(data_syms: np.ndarray, pilot_x: np.ndarray, cp: int = 0) -> np.ndarray:
    """Build a receiver-matched transmit frame: pilot symbol then data symbols.

    Bin mapping note: the receiver FFTs each symbol and takes bins 1..F-1
    in natural FFT order (cpuLS.hpp:292,355), so this helper places the pilot
    and data directly on those bins with NO pre-IFFT half-spectrum rotation.
    The reference's own modulator (modOneSymbol, cpuLS.hpp:492-529) applies an
    extra ifftshift that its receiver only cancels for constant-modulus pilots;
    the faithful modulator lives in golden.dsp.modulate_symbol, while this
    helper exists to close the TX->channel->RX loop exactly for EVM tests.

    Scale note: the reference max-abs normalizes each time-domain symbol
    independently (cpuLS.hpp:521-523), which would give every data symbol its
    own unknown gain; here the whole frame shares one scale so the pilot's
    LS estimate absorbs it.

    Args:
      data_syms: [S-1, F-1] subcarrier data.
      pilot_x:   [F-1] pilot (post pilot_shift, as load_pilot returns).
      cp:        cyclic prefix length.

    Returns:
      [S, F+cp] complex64 time-domain frame.
    """
    f = pilot_x.shape[-1] + 1
    grid = np.zeros((data_syms.shape[0] + 1, f), dtype=np.complex64)
    grid[0, 1:] = pilot_x
    grid[1:, 1:] = data_syms
    td = np.fft.ifft(grid, axis=-1) * f
    td = td / np.max(np.abs(td))
    return dsp.add_cyclic_prefix(td.astype(np.complex64), cp)
