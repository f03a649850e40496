"""Golden NumPy oracle: bit-faithful re-derivation of the reference CPU DSP.

The port's own copy of ``ofdm_ls_mrc_tpu.golden.dsp`` (tests hold the two
equal), so the port needs nothing of the JAX package.  It is the semantic
contract: every op and kernel of the port is tested against these functions,
which re-derive (NOT translate) the math of the reference CPU chain:

* pilot load + fftshift            -- ``cpuLS.hpp:80-117``  (matrix_readX)
* LS channel estimation            -- ``cpuLS.hpp:247-317`` (firstVector)
* MRC demodulation                 -- ``cpuLS.hpp:319-389`` (doOneSymbol)
* output half-spectrum swap        -- ``cpuLS.hpp:135-149`` (shiftOneRow)
* OFDM modulator + cyclic prefix   -- ``cpuLS.hpp:391-398,466-529``
* zero-forcing precoder            -- ``cpuLS.hpp:415-463``

Key conventions the reference commits to (verified against the memmove
arithmetic in the reference source):

* ``matrix_readX`` applies ``np.fft.fftshift`` to the odd-length (1023) pilot:
  the three-memmove swap at ``cpuLS.hpp:105-113`` moves ``X[512:]`` to the
  front, which for odd N equals ``fftshift`` (roll by +N//2).
* ``shiftOneRow`` applied to the demod output (``cpuLS.hpp:368``) moves
  ``Yf[511:]`` to the front, which for odd N equals ``np.fft.ifftshift``
  (roll by -(N//2)).  For odd lengths fftshift != ifftshift; the reference
  uses one on the pilot and the *other* on the output.
* FFTW forward (``cpuLS.hpp:165-174``) is the unnormalized DFT == np.fft.fft;
  FFTW backward (``cpuLS.hpp:152-162``) is the unnormalized inverse ==
  ``np.fft.ifft * N``.
* The DC bin (index 0) of every FFT is dropped: Y = A x 1024, X = 1 x 1023,
  H = A x 1023 (``gpuLS.cuh:67-70``; memcpy from ``&Y[row*cols+1]``,
  ``cpuLS.hpp:292,355``).
"""

from __future__ import annotations

import numpy as np

PILOT_FILL = 0.707 + 0.707j  # fallback fill when Pilots.dat missing (cpuLS.hpp:84-90)


# ---------------------------------------------------------------------------
# Spectrum shifts
# ---------------------------------------------------------------------------

def pilot_shift(x: np.ndarray) -> np.ndarray:
    """Half-spectrum swap applied to the pilot on load (cpuLS.hpp:105-113).

    For length N the reference moves ``x[(N+1)//2:]`` in front of
    ``x[:(N+1)//2]`` == ``np.fft.fftshift`` for both parities.
    """
    return np.fft.fftshift(x, axes=-1)


def output_shift(x: np.ndarray) -> np.ndarray:
    """Half-spectrum swap applied to demod output (shiftOneRow, cpuLS.hpp:135-149).

    Moves ``x[(N-1)//2:]`` in front of ``x[:(N-1)//2]`` == ``np.fft.ifftshift``.
    """
    return np.fft.ifftshift(x, axes=-1)


def tx_shift(x: np.ndarray) -> np.ndarray:
    """Pre-IFFT swap in the modulator (ifftShiftOneRow, cpuLS.hpp:119-132).

    Operates on the even-length (1024) grid where fftshift == ifftshift.
    """
    return np.fft.ifftshift(x, axes=-1)


# ---------------------------------------------------------------------------
# Channel estimation + MRC demod (uplink)
# ---------------------------------------------------------------------------

def estimate_channel(pilot_sym: np.ndarray, pilot_x: np.ndarray):
    """LS channel estimate from the frame's pilot symbol.

    Re-derives ``firstVector`` (cpuLS.hpp:247-317): per antenna row, FFT the
    time-domain pilot, drop the DC bin, divide elementwise by the known
    (already pilot_shift-ed) pilot ``X``, conjugate; then accumulate
    ``Hsqrd[k] = sum_ant |H_ant[k]|^2`` (findDistSqrd, cpuLS.hpp:211-228).

    Args:
      pilot_sym: [A, F] complex64 time-domain pilot symbol (CP already dropped).
      pilot_x:   [F-1] complex64 known pilot, as loaded by ``load_pilot``.

    Returns:
      (hconj [A, F-1] complex64, hsqrd [F-1] float32)
    """
    yf = np.fft.fft(pilot_sym.astype(np.complex64), axis=-1)
    h = yf[..., 1:] / pilot_x  # divideOneRow, cpuLS.hpp:233-244
    hconj = np.conj(h)         # cpuLS.hpp:303-307
    hsqrd = np.sum((h.real * h.real + h.imag * h.imag), axis=0)
    return hconj.astype(np.complex64), hsqrd.astype(np.float32)


def demod_symbol(data_sym: np.ndarray, hconj: np.ndarray, hsqrd: np.ndarray) -> np.ndarray:
    """MRC-demodulate one data symbol (doOneSymbol, cpuLS.hpp:319-389).

    FFT rows -> drop DC -> multiply-accumulate with Hconj over antennas
    (matrixMultThenSum, cpuLS.hpp:187-208) -> divide by |H|^2
    (cpuLS.hpp:364-367) -> ifftshift (cpuLS.hpp:368).

    Args:
      data_sym: [A, F] complex64 time-domain symbol (CP already dropped).
      hconj:    [A, F-1] conjugated channel estimate.
      hsqrd:    [F-1] real MRC normalizer.

    Returns:
      [F-1] complex64 demodulated subcarrier symbols.
    """
    yf = np.fft.fft(data_sym.astype(np.complex64), axis=-1)[..., 1:]
    num = np.sum(yf * hconj, axis=0)
    out = (num / hsqrd).astype(np.complex64)
    return output_shift(out)


def drop_cyclic_prefix(sym: np.ndarray, cp: int) -> np.ndarray:
    """Strip the cyclic prefix from the last axis (ShMemSymBuff.hpp:281-294)."""
    if cp == 0:
        return sym
    return sym[..., cp:]


def demod_frame(frame: np.ndarray, pilot_x: np.ndarray, cp: int = 0) -> np.ndarray:
    """Demodulate one whole frame: symbol 0 is the pilot, the rest are data.

    Mirrors the main loop ``cpuLS_main.cpp:80-93``: firstVector on symbol 0,
    doOneSymbol on symbols 1..S-1.

    Args:
      frame:   [S, A, F+cp] complex64 time-domain frame.
      pilot_x: [F-1] known pilot (post pilot_shift).
      cp:      cyclic prefix length.

    Returns:
      [S-1, F-1] complex64 demodulated data symbols.
    """
    frame = drop_cyclic_prefix(frame, cp)
    hconj, hsqrd = estimate_channel(frame[0], pilot_x)
    out = np.stack([demod_symbol(frame[i], hconj, hsqrd) for i in range(1, frame.shape[0])])
    return out.astype(np.complex64)


# ---------------------------------------------------------------------------
# TX / modulator (downlink)
# ---------------------------------------------------------------------------

def add_cyclic_prefix(sym: np.ndarray, cp: int) -> np.ndarray:
    """Prepend the symbol tail as cyclic prefix (addPrefix, cpuLS.hpp:391-398)."""
    if cp == 0:
        return sym
    return np.concatenate([sym[..., -cp:], sym], axis=-1)


def modulate_symbol(data: np.ndarray, cp: int = 0) -> np.ndarray:
    """OFDM-modulate subcarrier data to a time-domain symbol.

    Re-derives ``modOneSymbol`` (cpuLS.hpp:492-529): place the F-1 data bins
    into an F grid at offset 1 (DC stays 0), ifftshift, unnormalized IFFT
    (FFTW_BACKWARD == np.fft.ifft * F), scale by 1/max|.| (LAPACK clange 'M'
    + cblas_csscal, cpuLS.hpp:521-523), prepend cyclic prefix.

    Args:
      data: [..., F-1] complex64 subcarrier values.
      cp:   cyclic prefix length.

    Returns:
      [..., F+cp] complex64 time-domain symbol, max-abs normalized to 1.
    """
    data = np.asarray(data, dtype=np.complex64)
    f = data.shape[-1] + 1
    grid = np.zeros(data.shape[:-1] + (f,), dtype=np.complex64)
    grid[..., 1:] = data
    td = np.fft.ifft(tx_shift(grid), axis=-1) * f  # unnormalized FFTW backward
    maxabs = np.max(np.abs(td), axis=-1, keepdims=True)
    td = (td / maxabs).astype(np.complex64)
    return add_cyclic_prefix(td, cp)


def modulate_pilot_symbol(pilot_x: np.ndarray, cp: int = 0) -> np.ndarray:
    """Modulate the reference/pilot symbol (modRefSymbol, cpuLS.hpp:466-489).

    Identical math to ``modulate_symbol`` applied to the (already shifted)
    pilot sequence.
    """
    return modulate_symbol(pilot_x, cp)


# ---------------------------------------------------------------------------
# Multi-user zero-forcing precoder (downlink)
# ---------------------------------------------------------------------------

def zf_precoder(h: np.ndarray) -> np.ndarray:
    """Per-subcarrier zero-forcing (pseudo-inverse) precoding matrix.

    Re-derives ``createZeroForcingMatrix`` (cpuLS.hpp:415-447): for each
    subcarrier the reference builds ``W = X^H (X X^H)^{-1}`` with
    cgemm/cgetrf/cgetri, where ``X`` is the users x antennas channel at that
    subcarrier -- i.e. the Moore-Penrose right-inverse, so ``X @ W = I_users``.

    Args:
      h: [..., U, A] complex64 channel matrix per subcarrier (U users, A >= U
         antennas).

    Returns:
      [..., A, U] complex64 precoder with ``h @ w == I``.
    """
    h = np.asarray(h, dtype=np.complex64)
    hh = h @ np.conj(np.swapaxes(h, -1, -2))          # [.., U, U]
    w = np.conj(np.swapaxes(h, -1, -2)) @ np.linalg.inv(hh)
    return w.astype(np.complex64)


def apply_precoder(w: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Apply the per-subcarrier precoder to user symbols.

    Re-derives ``multiplyWithChannelInv`` (cpuLS.hpp:449-463): per subcarrier
    ``y_ant = W @ x_users`` via cgemv.

    Args:
      w: [S, A, U] per-subcarrier precoding matrices.
      x: [U, S] user symbols per subcarrier.

    Returns:
      [A, S] precoded antenna streams.
    """
    y = np.einsum("sau,us->as", w, x)
    return y.astype(np.complex64)


# ---------------------------------------------------------------------------
# Cube reorder helper
# ---------------------------------------------------------------------------

def rot_cube(x: np.ndarray) -> np.ndarray:
    """(user, antenna, subcarrier) -> (subcarrier, antenna, user) reorder.

    Re-derives ``rotCube`` (cpuLS.hpp:400-413): the reference stores
    ``temp[col][row][user] = X[user][row][col]`` (flattened C-order); here the
    cube is a real 3-D array so this is a plain transpose.
    """
    return np.ascontiguousarray(np.transpose(x, (2, 1, 0)))
