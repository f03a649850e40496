"""File-format compatibility layer (the port's copy of
``ofdm_ls_mrc_tpu.golden.io``; the PN-sequence loader comes with the
correlation slice).

Preserves the reference's on-disk contracts so a user of the reference can
point this framework at the same data files:

* ``Pilots.dat``              -- 1023 raw complex64, fftshift-ed on load
                                 (cpuLS.hpp:80-117)
* ``Output_cpu.dat``          -- demodulated symbols appended as raw complex64
                                 (cpuLS.hpp:374-380)
* ``time_{cpu,gpu}.dat``      -- 5 float32 phase-timing words
                                 (storeTimes, ShMemSymBuff.hpp:166-189)
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .dsp import PILOT_FILL, pilot_shift


def load_pilot(path: Optional[str], n: int = 1023) -> np.ndarray:
    """Load the known pilot sequence, applying the reference's load-time shift.

    Mirrors ``matrix_readX`` (cpuLS.hpp:80-117): raw complex64 read, then
    fftshift; if the file is missing, fill with 0.707+0.707i (the CPU
    fallback, cpuLS.hpp:84-90) -- note the fallback is NOT shifted in the
    reference either (it returns before the memmove swap), and a constant is
    shift-invariant anyway.
    """
    if path is None or not os.path.exists(path):
        return np.full(n, PILOT_FILL, dtype=np.complex64)
    raw = np.fromfile(path, dtype=np.complex64, count=n)
    if raw.size < n:
        raise ValueError(f"pilot file {path!r} holds {raw.size} < {n} samples")
    return pilot_shift(raw).astype(np.complex64)


def write_pilot(path: str, pilot_unshifted: np.ndarray) -> None:
    """Write a pilot file in the reference layout (pre-shift order)."""
    np.asarray(pilot_unshifted, dtype=np.complex64).tofile(path)


def append_output(path: str, symbols: np.ndarray, truncate: bool = False) -> None:
    """Append demodulated symbols as raw complex64 (cpuLS.hpp:374-380).

    The reference truncates on the first data symbol (``it <= 1``) and
    appends afterwards; callers pass ``truncate=True`` for the first write.
    """
    mode = "wb" if truncate else "ab"
    with open(path, mode) as f:
        np.asarray(symbols, dtype=np.complex64).tofile(f)


def read_output(path: str, subcarriers: int = 1023) -> np.ndarray:
    """Read an Output_*.dat file back as [num_symbols, subcarriers]."""
    raw = np.fromfile(path, dtype=np.complex64)
    if raw.size % subcarriers:
        raise ValueError(f"{path!r}: {raw.size} samples not a multiple of {subcarriers}")
    return raw.reshape(-1, subcarriers)


def num_symbols(path: str, dimension: int, prefix: int = 0) -> int:
    """Symbols stored in a raw complex64 capture: file bytes / (8 * symbol
    length) -- the reference's numSyms helper (cpuLS.hpp:176-184), which
    sizes the TX modulation loop from the input file."""
    return os.path.getsize(path) // (8 * (dimension + prefix))


def store_times(path: str, read_avg: float, chanest: float, decode_avg: float,
                fft_avg: float, drop_avg: float) -> None:
    """Binary 5-word timing dump, layout-compatible with storeTimes
    (ShMemSymBuff.hpp:166-189): [read, chanest, decode, fft, drop] float32."""
    np.array([read_avg, chanest, decode_avg, fft_avg, drop_avg],
             dtype=np.float32).tofile(path)


def load_times(path: str) -> np.ndarray:
    return np.fromfile(path, dtype=np.float32, count=5)


# ---------------------------------------------------------------------------
# sc16 <-> complex64 conversion (UHD wire / capture format, single source of
# truth for the full-scale convention used by the ring, tx_app and rx_app)
# ---------------------------------------------------------------------------

SC16_FULL_SCALE = 32767.0

# Cumulative count of component samples clipped by complex_to_sc16 (an
# over-full-scale capture written to an sc16 ring is otherwise distorted with
# no trace).  Read it via sc16_clipped_samples(); a one-time warning fires on
# the first clipping call.  The counters are guarded by a lock:
# complex_to_sc16 runs on rx_app's continuous-sync writer thread
# concurrently with main-thread callers.
import threading as _threading

_sc16_clipped = 0
_sc16_warned = False
_sc16_lock = _threading.Lock()


def sc16_clipped_samples() -> int:
    """Total (re/im component) samples clipped by complex_to_sc16 so far."""
    return _sc16_clipped


def complex_to_sc16(c: np.ndarray) -> np.ndarray:
    """complex64 -> interleaved int16 IQ, clipped to full scale.

    The trailing axis doubles (re, im interleaved); shape otherwise kept.
    Samples beyond +/-1.0 full scale are clipped; clipping is counted
    (sc16_clipped_samples) and warned about once so scale mismatches are
    visible instead of silently distorting the stream.
    """
    global _sc16_clipped, _sc16_warned
    c = np.ascontiguousarray(c, dtype=np.complex64)
    comp = c.view(np.float32)
    scaled = comp * SC16_FULL_SCALE
    # Cheap scalar guard on the live ingest path (SymbolRing.write calls
    # this per symbol): the full clip count runs only when something clips.
    if np.max(np.abs(scaled), initial=0.0) > SC16_FULL_SCALE:
        n_clip = int(np.count_nonzero(np.abs(scaled) > SC16_FULL_SCALE))
        with _sc16_lock:
            _sc16_clipped += n_clip
            warn_now = not _sc16_warned
            _sc16_warned = True
        if warn_now:
            import warnings
            warnings.warn(
                f"complex_to_sc16: {n_clip} sample component(s) beyond "
                f"+/-1.0 full scale clipped (further clipping counted in "
                f"sc16_clipped_samples(), not re-warned)", stacklevel=2)
    iq = np.round(np.clip(scaled, -SC16_FULL_SCALE, SC16_FULL_SCALE))
    return iq.astype(np.int16)


def plane_to_sc16(v: np.ndarray) -> np.ndarray:
    """One planar float component (re OR im) -> full-scale int16.

    The quantization used by the bench/probe tools to build sc16-native
    kernel inputs; kept HERE beside complex_to_sc16 so the rounding/clip
    semantics cannot drift from the live ingest path (no clip counters:
    tool inputs are generated in-range by construction)."""
    return np.clip(np.round(np.asarray(v) * SC16_FULL_SCALE),
                   -SC16_FULL_SCALE, SC16_FULL_SCALE).astype(np.int16)


def sc16_to_complex(iq: np.ndarray) -> np.ndarray:
    """Interleaved int16 IQ -> complex64 (full scale -> 1.0).

    A trailing odd sample (truncated capture) is dropped.
    """
    iq = np.asarray(iq, dtype=np.int16).reshape(-1)
    if iq.size % 2:
        iq = iq[:-1]
    f = iq.astype(np.float32) / SC16_FULL_SCALE
    return (f[0::2] + 1j * f[1::2]).astype(np.complex64)
