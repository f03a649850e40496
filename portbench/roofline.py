"""Bytes and operations of the two stages of a capture, and the card's peaks.

The arithmetic of ``ofdm_ls_mrc_tpu_torch/tools/split_compare.py``
(``data_bytes``, ``pilot_bytes``) and of ``PERF.md``'s kernel table: each
input read once and each output written once; 5 F log2 F FLOPs a row FFT,
8 a complex multiply-add of MRC, 15 a pilot bin (the LS divide and its
share of the sum of |h|^2).  A stage's bound is the larger of its bytes
over the memory's rate and its FLOPs over the float32 rate.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM, dense, at its 700 W limit (the data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

COMPONENT_BYTES = {"sc16": 2, "f32": 4}


def capture_samples(k: int, s: int, a: int, f: int) -> int:
    """Complex samples of k frames of s symbols over a antennas, F each
    (the cyclic prefix stripped before the card)."""
    return k * s * a * f


def frame_bytes_in(s: int, a: int, f: int, fmt: str = "sc16") -> int:
    """Bytes of one frame as the card receives it: two planes."""
    return s * a * f * 2 * COMPONENT_BYTES[fmt]


def frame_bytes_out(s: int, f: int) -> int:
    """Bytes of one frame's output: s - 1 data symbols of F - 1 complex64 bins."""
    return (s - 1) * (f - 1) * 8


def data_bytes(s: int, a: int, f: int, in_bytes: int, k: int = 1) -> int:
    """The data stage over k frames of s data symbols: the rows (two planes
    of in_bytes), h and the gains in, the [S, F - 1] output out."""
    return k * (s * a * f * 2 * in_bytes + a * f * 8 + f * 4 + s * (f - 1) * 8)


def pilot_bytes(a: int, f: int, in_bytes: int, k: int = 1) -> int:
    """The pilot stage over k frames: the rows (two planes of in_bytes) and
    X in, h (two f32 planes) and the gains out."""
    return k * (a * f * 2 * in_bytes + a * f * 8 + f * 4) + f * 8


def fft_flops(rows: int, f: int) -> float:
    return rows * 5.0 * f * math.log2(f)


def data_flops(s: int, a: int, f: int, k: int = 1) -> float:
    rows = k * s * a
    return fft_flops(rows, f) + rows * 8.0 * f


def pilot_flops(a: int, f: int, k: int = 1) -> float:
    rows = k * a
    return fft_flops(rows, f) + rows * 15.0 * f


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def data_bound_s(config: dict, k: int) -> float:
    """The data stage's bound for one call of k frames of ``config``."""
    s, a, f = config["frame_len"] - 1, config["num_antennas"], config["fft_size"]
    in_b = COMPONENT_BYTES[config["sample_format"]]
    return bound_s(data_bytes(s, a, f, in_b, k), data_flops(s, a, f, k))


def pilot_bound_s(config: dict, k: int) -> float:
    """The pilot stage's bound for one call of k frames of ``config``."""
    a, f = config["num_antennas"], config["fft_size"]
    in_b = COMPONENT_BYTES[config["sample_format"]]
    return bound_s(pilot_bytes(a, f, in_b, k), pilot_flops(a, f, k))
