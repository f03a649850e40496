"""The fused whole-frame path: pilot LS estimate + per-symbol FFT and MRC in
two hand-written CUDA kernels (counterpart of
``ofdm_ls_mrc_tpu.ops.pallas_pipeline``).

Each kernel has a wrapper and a plain PyTorch version beside it:

  ``estimate_pilot_fused`` -> ``csrc/pilot_ls.cu``, plain ``estimate_pilot_plain``
  ``fused_pipeline``       -> ``csrc/fft_mrc.cu``,  plain ``fused_pipeline_plain``

A wrapper runs the plain version for tensors on the CPU, and only there; for
CUDA tensors it launches its kernel or raises.  Both work in natural
frequency order with the padded pilot X (``ls.pad_pilot``, X[0] = 1) and
leave the DC bin unmasked, as the TPU fused path does: the data path drops
it at the output.  The data path returns rows in the reference order
[..., S, F-1] (DC dropped, ifftshift applied), so the TPU epilogue
``to_reference_order`` lives in the data kernel's store.

Shapes take an optional leading frame axis K: pilot [K, A, F], data
[K, S, A, F], estimate [K, A, F] and [K, F].  One launch of each kernel
covers all K frames (``UplinkReceiver.demod_capture``).

``launch_counts`` counts kernel launches per wrapper; only a launch adds to
it, so a run on the card can show that the path went through the kernels.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from ..golden.io import SC16_FULL_SCALE
from ..kernels import build
from . import fft as fft_ops
from . import fft_plan
from .cplx import CArray, cdiv
from .modulate import drop_cyclic_prefix
from .mrc import mrc_numerator

FUSED_FFT_SIZES = fft_plan.PILOT_FFT_SIZES
MAX_FRAMES = 65535   # frames of one launch: the grid's second dimension

launch_counts: Dict[str, int] = {"pilot_ls": 0, "fft_mrc": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def supports_fused(fft_size: int) -> bool:
    """True when the fused kernels cover this FFT size: a power of two from
    256 to 4096 (csrc/pilot_ls.cu and csrc/fft_mrc.cu instantiate exactly
    these).  The TPU kernel's rule (a (2^k, 128) split) admits the same
    sizes up to 4096."""
    return fft_size in FUSED_FFT_SIZES


@functools.lru_cache(maxsize=None)
def reference_order_index(f: int) -> np.ndarray:
    """out[..., j] = eq[..., idx[j]] for j < F-1: the DC drop plus the output
    ifftshift (shiftOneRow, cpuLS.hpp:368) from natural order,
    idx[j] = 1 + (j + (F-1)//2) mod (F-1)."""
    m = f - 1
    j = np.arange(m)
    return (1 + (j + m // 2) % m).astype(np.int64)


def widen_sc16(x: CArray) -> CArray:
    """Planar int16 -> full-scale float32; float planes pass through."""
    if x.dtype == torch.int16:
        return CArray(x.re.float() / SC16_FULL_SCALE, x.im.float() / SC16_FULL_SCALE)
    return x


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def estimate_pilot_plain(pilot: CArray, x_full: CArray) -> Tuple[CArray, torch.Tensor]:
    """Pilot [..., A, F] (f32 or int16 planes) -> (h [..., A, F],
    inv [..., F]): h = FFT(pilot) * conj(X) / |X|^2, inv = 1/sum_a |h|^2."""
    h = cdiv(fft_ops.fft(widen_sc16(pilot)), x_full)
    return h, 1.0 / torch.sum(h.abs2(), dim=-2)


def fused_pipeline_plain(y: CArray, h: CArray, inv: torch.Tensor) -> CArray:
    """Data [..., S, A, F] + estimate ([..., A, F], [..., F]) ->
    [..., S, F-1] in reference order."""
    num = mrc_numerator(fft_ops.fft(widen_sc16(y)), h.conj())
    eq = num * inv.unsqueeze(-2)
    idx = torch.from_numpy(reference_order_index(y.shape[-1])).to(y.device)
    return eq[..., idx]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_rows(x: CArray, name: str, ndim: int) -> None:
    """Input rows for a kernel: f32 or int16, unit stride along F."""
    if x.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {x.shape}")
    if x.dtype not in (torch.float32, torch.int16):
        raise TypeError(f"{name}: dtype {x.dtype}, expected float32 or int16")
    if x.re.stride() != x.im.stride() or x.re.stride(-1) != 1:
        raise ValueError(f"{name}: planes need equal strides and contiguous rows "
                         f"(strides {x.re.stride()} / {x.im.stride()})")
    if min(x.shape) == 0:
        raise ValueError(f"{name}: empty shape {x.shape}")


def _check_dense(t: torch.Tensor, name: str, shape, device: torch.device) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected float32 {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous on {device}, got {t.device}")


def _device_route(x: CArray, name: str) -> bool:
    """True to launch the kernel (CUDA tensor), False for the plain version
    (CPU tensor); anything else raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for device {x.device}")


def _scale(x: CArray) -> float:
    return 1.0 / SC16_FULL_SCALE if x.dtype == torch.int16 else 1.0


def _rows_aligned(x: CArray) -> bool:
    """True when every row of x starts 16-byte aligned (both bases and every
    stride in bytes multiples of 16): the data kernels then stage rows with
    16-byte cp.async copies, else element by element."""
    size = x.re.element_size()
    return all(t.data_ptr() % 16 == 0 for t in (x.re, x.im)) and all(
        st * size % 16 == 0 for st in x.re.stride()[:-1])


def estimate_pilot_fused(pilot: CArray, x_full: CArray) -> Tuple[CArray, torch.Tensor]:
    """Pilot LS estimate, kernel ``csrc/pilot_ls.cu``: one launch, one
    thread block cluster per frame.

    Args:
      pilot:  [A, F] or [K, A, F] planes, f32 or int16 (sc16 full scale);
              any strides with contiguous rows (a view of a frame is read in
              place).
      x_full: [F] padded pilot, natural order (``ls.pad_pilot``).

    Returns:
      (h [.., A, F], inv [.., F]) in natural order: h unconjugated, inv =
      1/sum_a |h|^2, DC unmasked.
    """
    if not _device_route(pilot, "estimate_pilot_fused"):
        return estimate_pilot_plain(pilot, x_full)
    single = pilot.ndim == 2
    p = pilot[None] if single else pilot
    _check_rows(p, "estimate_pilot_fused: pilot", 3)
    k, a, f = p.shape
    if not supports_fused(f):
        raise ValueError(f"estimate_pilot_fused: F={f} not in {FUSED_FFT_SIZES}")
    if k > MAX_FRAMES:
        raise ValueError(f"estimate_pilot_fused: {k} frames in one call > {MAX_FRAMES}")
    plan = fft_plan.pilot_plan(a, f)
    dev = p.device
    _check_dense(x_full.re, "x_full.re", (f,), dev)
    _check_dense(x_full.im, "x_full.im", (f,), dev)
    if any(t.data_ptr() % 16 for t in (x_full.re, x_full.im)):
        raise ValueError("estimate_pilot_fused: x_full planes must start 16-byte aligned "
                         "(the kernel copies X in 16-byte chunks)")
    h = CArray(torch.empty((k, a, f), dtype=torch.float32, device=dev),
               torch.empty((k, a, f), dtype=torch.float32, device=dev))
    inv = torch.empty((k, f), dtype=torch.float32, device=dev)
    lib = build.load_library()
    with torch.cuda.device(dev):
        err = lib.ofdm_pilot_ls(
            p.re.data_ptr(), p.im.data_ptr(), int(p.dtype == torch.int16),
            int(_rows_aligned(p)), p.re.stride(0), p.re.stride(1), _scale(p), k, a, f,
            plan.clusters, plan.teams, plan.rows, plan.smem_bytes,
            x_full.re.data_ptr(), x_full.im.data_ptr(),
            fft_plan.pass_twiddles(f, dev).data_ptr(),
            h.re.data_ptr(), h.im.data_ptr(), inv.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "pilot_ls")
    launch_counts["pilot_ls"] += 1
    return (h[0], inv[0]) if single else (h, inv)


def fused_pipeline(y: CArray, h: CArray, inv: torch.Tensor) -> CArray:
    """FFT + MRC + equalize over data symbols, kernel ``csrc/fft_mrc.cu``.

    Args:
      y:   [S, A, F] or [K, S, A, F] time-domain data rows, f32 or int16;
           any strides with contiguous rows (frame[1:, ..., cp:] is read in
           place).
      h:   [.., A, F] unconjugated estimate; inv: [.., F] = 1/sum_a |h|^2.

    Returns:
      [.., S, F-1] float32 planes in reference order.
    """
    if not _device_route(y, "fused_pipeline"):
        return fused_pipeline_plain(y, h, inv)
    single = y.ndim == 3
    if single:
        y, h, inv = y[None], h[None], inv[None]
    _check_rows(y, "fused_pipeline: y", 4)
    k, s, a, f = y.shape
    if not supports_fused(f):
        raise ValueError(f"fused_pipeline: F={f} not in {FUSED_FFT_SIZES}")
    dev = y.device
    _check_dense(h.re, "h.re", (k, a, f), dev)
    _check_dense(h.im, "h.im", (k, a, f), dev)
    _check_dense(inv, "inv", (k, f), dev)
    out = CArray(torch.empty((k, s, f - 1), dtype=torch.float32, device=dev),
                 torch.empty((k, s, f - 1), dtype=torch.float32, device=dev))
    lib = build.load_library()
    st = y.re.stride()
    with torch.cuda.device(dev):
        err = lib.ofdm_fft_mrc(
            y.re.data_ptr(), y.im.data_ptr(), int(y.dtype == torch.int16),
            int(_rows_aligned(y)), st[0], st[1], st[2], _scale(y), k, s, a, f,
            h.re.data_ptr(), h.im.data_ptr(), inv.data_ptr(),
            fft_plan.pass_twiddles(f, dev).data_ptr(), out.re.data_ptr(), out.im.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "fft_mrc")
    launch_counts["fft_mrc"] += 1
    return out[0] if single else out


# ---------------------------------------------------------------------------
# Whole-frame entry points
# ---------------------------------------------------------------------------

def demod_parts_fused(pilot: CArray, data: CArray, x_full: CArray) -> CArray:
    """Pre-split form: pilot [.., A, F] + CP-free data rows [.., S-1, A, F]
    -> [.., S-1, F-1] in reference order."""
    h, inv = estimate_pilot_fused(pilot, x_full)
    return fused_pipeline(data, h, inv)


def demod_frame_fused(frame: CArray, x_full: CArray, *, cp: int) -> CArray:
    """Whole frame(s) [.., S, A, F+cp], pilot first -> [.., S-1, F-1].

    The cyclic prefix, the pilot row and the data rows are all views of
    ``frame``: each kernel reads its rows in place through the strides."""
    if frame.ndim not in (3, 4):
        raise ValueError(f"frame must be [S, A, F+cp] or [K, S, A, F+cp], "
                         f"got {frame.shape}")
    y = drop_cyclic_prefix(frame, cp)
    return demod_parts_fused(y[..., 0, :, :], y[..., 1:, :, :], x_full)
