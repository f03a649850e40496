"""The fused whole-frame path: pilot LS estimate + per-symbol FFT and MRC in
two hand-written CUDA kernels (counterpart of
``ofdm_ls_mrc_tpu.ops.pallas_pipeline``).

Each kernel has a wrapper and a plain PyTorch version beside it:

  ``estimate_pilot_fused`` -> ``csrc/pilot_ls.cu``, plain ``estimate_pilot_plain``
  ``fused_pipeline``       -> ``csrc/fft_mrc.cu``,  plain ``fused_pipeline_plain``

and, with ``exact=False`` (the bf16 speed mode, the TPU kernels'
``exact=False`` branch), two tensor-core kernels of ``csrc/fft_mrc_bf16.cu``:

  ``estimate_pilot_fused(exact=False)`` -> ``pilot_ls_bf16``,
                                          plain ``estimate_pilot_speed_plain``
  ``fused_pipeline(exact=False)``       -> ``fft_mrc_bf16``,
                                          plain ``fused_pipeline_speed_plain``

The speed mode's DFT (``speed_dft``, ``fft_plan``'s speed plan) rounds the
four-step transform's stage-1 output to bf16 and runs stage 2 as a bf16
product with float32 accumulation, about 1e-2 relative error by design;
the rest (LS divide, sum|h|^2, MRC, reference order) is float32 as in the
exact kernels.  It covers F = 256 to 32768 (n1 = F / 128 from 2 to 256);
the speed wrappers raise for any other F.  The JAX package's kernel has
no upper F (any (2^k, 128) split); the port's kernels stop at 32768, past
the largest FFT of a public OFDM standard (DVB-T2's 32K mode).

F = 8192 in the exact data kernels spreads a launch's antenna rows over one
block an SM (``fft_plan.spread_plan``, ``csrc/fft_spread.cuh``): a block's
rows in sequence, the sums over a symbol's antennas in registers and, where
its rows span blocks, through partials in a scratch and a count per symbol.
F = 16384 and 32768 (the exact kernels) and F = 8192 to 32768 (the speed
kernels) run in the split form of ``fft_plan`` (``csrc/fft_split.cuh``): a
column pass and each kernel's own row pass.  The pilots run them as
launches over chunks of a scratch in device memory; the data kernels
(exact and bf16) as one persistent launch whose column and row tiles meet
in a ring of symbol slots that L2 holds (``fft_plan.split_ring``).  The
exact pilot at F = 8192 is one launch of a thread block cluster per antenna
row, the F = 64 x 128 split across the cluster (``fft_plan.pilot_plan``).
One wrapper call, one count.

The pilot takes ``invert=False`` for the sharded receivers
(``parallel/``): it then returns the antenna shard's sum_a |h|^2 itself,
the term the shards add in their all-reduce; with ``inv`` = ones the data
path returns the MRC numerator, which they add too.

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

``launch_counts`` counts kernel launches per wrapper (the pilot's
un-inverted variant under ``pilot_ls_sum``, the speed kernels under
``pilot_ls_bf16`` and ``fft_mrc_bf16``); only a launch adds to it, so a
run on the card can show that the path went through the kernels.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

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

SPEED_FFT_SIZES = fft_plan.SPEED_FFT_SIZES
SPLIT_FFT_SIZES = fft_plan.SPLIT_FFT_SIZES           # the exact kernels' split form
SPEED_SPLIT_SIZES = fft_plan.SPEED_SPLIT_SIZES       # the speed kernels'

launch_counts: Dict[str, int] = {"pilot_ls": 0, "fft_mrc": 0, "pilot_ls_sum": 0,
                                 "pilot_ls_bf16": 0, "fft_mrc_bf16": 0}
# The F = 8192 pilot's per-frame counts and the spread data kernels'
# per-symbol counts, each by (device, stream): zero between launches (the
# kernels set each count they use back to 0), so the launches of a stream,
# each after the last, share one buffer.
_pilot_counts: Dict[Tuple[Optional[int], int], torch.Tensor] = {}
_spread_counts: Dict[Tuple[Optional[int], int], torch.Tensor] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def supports_fused(fft_size: int) -> bool:
    """True when the fused kernels cover this FFT size: a power of two from
    64 to 32768 (csrc/pilot_ls.cu and csrc/fft_mrc.cu instantiate exactly
    these, 16384 and 32768 in the split form).  Below, this is wider than
    the TPU kernel's rule, a (2^k, 128) split, which starts at 256 and sends
    64 and 128 to its 'fast' path; here the 64-subcarrier configurations run
    through the same two kernels.  Above, the TPU rule has no bound and this
    one stops at 32768.  The receivers send any other size to 'fast' or
    'composed' with a RuntimeWarning (``warn_fused_fallback``); the wrappers
    raise."""
    return fft_size in FUSED_FFT_SIZES


def warn_fused_fallback(fft_size: int, who: str, to: str = "fast") -> None:
    """The loud downgrade of a receiver asked for 'fused' at an F the
    kernels do not take (the JAX package's ``warn_fused_fallback``): a
    RuntimeWarning, so tests can assert it and CLIs show it on stderr."""
    import warnings
    warnings.warn(
        f"{who}: fused pipeline unavailable for fft_size={fft_size} (the CUDA kernels "
        f"take F in {FUSED_FFT_SIZES}); falling back to the slower {to!r} pipeline",
        RuntimeWarning, stacklevel=3)


def supports_speed(fft_size: int) -> bool:
    """True when the bf16 speed kernels cover this FFT size: the TPU
    kernel's (2^k, 128) split with n1 >= 2, F = 256 to 32768.  Below it the
    receivers run the exact kernels, as the JAX receiver falls back to a
    path that ignores ``exact``; above it the fused kernels stop (and the
    receivers fall back to 'fast')."""
    return fft_size in SPEED_FFT_SIZES


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

def estimate_pilot_plain(pilot: CArray, x_full: CArray, *,
                         invert: bool = True) -> Tuple[CArray, torch.Tensor]:
    """Pilot [..., A, F] (f32 or int16 planes) -> (h [..., A, F],
    inv [..., F]): h = FFT(pilot) * conj(X) / |X|^2, inv = 1/sum_a |h|^2,
    or sum_a |h|^2 itself when ``invert`` is False."""
    h = cdiv(fft_ops.fft(widen_sc16(pilot)), x_full)
    s = torch.sum(h.abs2(), dim=-2)
    return h, (1.0 / s if invert else s)


def fused_pipeline_plain(y: CArray, h: CArray, inv: torch.Tensor) -> CArray:
    """Data [..., S, A, F] + estimate ([..., A, F], [..., F]) ->
    [..., S, F-1] in reference order."""
    num = mrc_numerator(fft_ops.fft(widen_sc16(y)), h.conj())
    eq = num * inv.unsqueeze(-2)
    idx = torch.from_numpy(reference_order_index(y.shape[-1])).to(y.device)
    return eq[..., idx]


def speed_dft(x: CArray) -> CArray:
    """The speed mode's DFT of rows [..., F] (f32, or int16 at sc16 full
    scale) -> [..., F] float32 planes in natural order: the n1-point DFT over
    i1 in float32 (``torch.fft.fft``), the twiddle in float32 (the sc16
    scale folded in), B rounded to bf16 (nearest even), then C = B W as a
    float32 ``torch.matmul`` of bf16-valued operands (each product exact:
    8 + 8 mantissa bits fit in float32); bin n1 k2 + k1 = C[k1, k2]."""
    f = x.shape[-1]
    n1, n2 = fft_plan.speed_split(f)
    lead = x.shape[:-1]
    z = torch.complex(x.re.float(), x.im.float()).reshape(*lead, n1, n2)
    tw = torch.view_as_complex(fft_plan.speed_twiddles(f, x.dtype == torch.int16, x.device))
    b = torch.fft.fft(z, dim=-2) * tw
    br = b.real.to(torch.bfloat16).float()
    bi = b.imag.to(torch.bfloat16).float()
    w = fft_plan.speed_w(x.device).float()
    wr, wi = w[:, :n2], w[:, n2:]
    c_re = br @ wr - bi @ wi
    c_im = br @ wi + bi @ wr
    return CArray(c_re.transpose(-1, -2).reshape(*lead, f),
                  c_im.transpose(-1, -2).reshape(*lead, f))


def estimate_pilot_speed_plain(pilot: CArray, x_full: CArray) -> Tuple[CArray, torch.Tensor]:
    """``estimate_pilot_plain`` on the speed mode's DFT: (h, 1/sum_a |h|^2)."""
    h = cdiv(speed_dft(pilot), x_full)
    return h, 1.0 / torch.sum(h.abs2(), dim=-2)


def fused_pipeline_speed_plain(y: CArray, h: CArray, inv: torch.Tensor) -> CArray:
    """``fused_pipeline_plain`` on the speed mode's DFT."""
    num = mrc_numerator(speed_dft(y), h.conj())
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


def estimate_pilot_fused(pilot: CArray, x_full: CArray, *, invert: bool = True,
                         exact: bool = True) -> Tuple[CArray, torch.Tensor]:
    """Pilot LS estimate, kernel ``csrc/pilot_ls.cu``: one launch, one
    thread block cluster per frame (at F = 8192 four blocks per antenna row,
    a cluster of up to four rows, the sum over the antennas through
    distributed shared memory and per-frame counts; at F = 16384 and 32768 the
    column pass, then a cluster per 8 bins k1 of a frame,
    ``fft_plan.pilot_plan``); with
    ``exact=False`` the speed kernel ``pilot_ls_bf16``
    (``csrc/fft_mrc_bf16.cu``), a cluster per frame too (from F = 8192 the
    column pass, then a cluster per 32 bins k1, ``fft_plan.speed_cluster``).

    Args:
      pilot:  [A, F] or [K, A, F] planes, f32 or int16 (sc16 full scale);
              any strides with contiguous rows (a view of a frame is read in
              place).
      x_full: [F] padded pilot, natural order (``ls.pad_pilot``).
      invert: False returns sum_a |h|^2 in place of its reciprocal (the
              sharded receivers' partial sum; counted as ``pilot_ls_sum``).
              The speed kernel returns the reciprocal only.
      exact:  False for the bf16 speed mode (F in ``SPEED_FFT_SIZES``).

    Returns:
      (h [.., A, F], inv [.., F]) in natural order: h unconjugated, inv =
      1/sum_a |h|^2 (or the sum), DC unmasked.
    """
    if not exact and not invert:
        raise ValueError("estimate_pilot_fused: the speed mode returns 1/sum|h|^2 only "
                         "(the sharded receivers keep the exact pilot)")
    if not _device_route(pilot, "estimate_pilot_fused"):
        if not exact:
            return estimate_pilot_speed_plain(pilot, x_full)
        return estimate_pilot_plain(pilot, x_full, invert=invert)
    single = pilot.ndim == 2
    p = pilot[None] if single else pilot
    _check_rows(p, "estimate_pilot_fused: pilot", 3)
    k, a, f = p.shape
    _check_size(f, exact, "estimate_pilot_fused")
    if k > MAX_FRAMES:
        raise ValueError(f"estimate_pilot_fused: {k} frames in one call > {MAX_FRAMES}")
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
    int16 = p.dtype == torch.int16
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch, chunk = _split_scratch(k, a, f, SPLIT_FFT_SIZES if exact else SPEED_SPLIT_SIZES,
                                    dev)
    with torch.cuda.device(dev):
        if exact:
            name = "pilot_ls" if invert else "pilot_ls_sum"
            plan = fft_plan.pilot_plan(a, f, k)
            rows = f == fft_plan.PILOT_ROW_FFT   # a cluster per row: the split table, counts
            counts = None
            if rows:
                counts = _zero_counts(_pilot_counts, fft_plan.pilot_row_counts(k), dev,
                                      stream)
                clusters = a // fft_plan.pilot_row_rows(a)
                if clusters > 1:   # the sum's partials, one a cluster of rows
                    scratch = torch.empty((k, clusters, f), dtype=torch.float32, device=dev)
            tw = fft_plan.split_tables(f, False, dev) if rows else _exact_table(f, dev)
            err = lib.ofdm_pilot_ls(
                p.re.data_ptr(), p.im.data_ptr(), int(int16),
                int(_rows_aligned(p)), p.re.stride(0), p.re.stride(1), _scale(p), k, a, f,
                plan.clusters, plan.teams, plan.rows, plan.smem_bytes,
                x_full.re.data_ptr(), x_full.im.data_ptr(), tw.data_ptr(),
                h.re.data_ptr(), h.im.data_ptr(), inv.data_ptr(), int(invert),
                _ptr(scratch), chunk, _ptr(counts), stream)
        else:
            name = "pilot_ls_bf16"
            tw, w = _speed_tables(f, int16, dev)
            split = f in SPEED_SPLIT_SIZES   # the row pass: W's image, a cluster per 32 bins k1
            img = fft_plan.speed_w_image(dev) if split else None
            err = lib.ofdm_pilot_ls_bf16(
                p.re.data_ptr(), p.im.data_ptr(), int(int16), p.re.stride(0),
                p.re.stride(1), k, a, f, x_full.re.data_ptr(), x_full.im.data_ptr(),
                tw.data_ptr(), None if split else w.data_ptr(), _ptr(img),
                fft_plan.speed_cluster(a, f, True, k) if split else 0, h.re.data_ptr(),
                h.im.data_ptr(), inv.data_ptr(), _ptr(scratch), chunk, stream)
    build.check(lib, err, name)
    launch_counts[name] += 1
    return (h[0], inv[0]) if single else (h, inv)


def fused_pipeline(y: CArray, h: CArray, inv: torch.Tensor, *,
                   exact: bool = True) -> CArray:
    """FFT + MRC + equalize over data symbols, kernel ``csrc/fft_mrc.cu`` (at
    F = 8192 its rows spread over the card, ``fft_plan.spread_plan``);
    with ``exact=False`` the speed kernel ``fft_mrc_bf16``
    (``csrc/fft_mrc_bf16.cu``: stage 2 on the tensor cores in bf16; from
    F = 8192 one launch on the ring, its row tiles 32 bins k1).

    Args:
      y:   [S, A, F] or [K, S, A, F] time-domain data rows, f32 or int16;
           any strides with contiguous rows (frame[1:, ..., cp:] is read in
           place).
      h:   [.., A, F] unconjugated estimate; inv: [.., F] = 1/sum_a |h|^2.

    Returns:
      [.., S, F-1] float32 planes in reference order.
    """
    if not _device_route(y, "fused_pipeline"):
        return (fused_pipeline_plain if exact else fused_pipeline_speed_plain)(y, h, inv)
    single = y.ndim == 3
    if single:
        y, h, inv = y[None], h[None], inv[None]
    _check_rows(y, "fused_pipeline: y", 4)
    k, s, a, f = y.shape
    _check_size(f, exact, "fused_pipeline")
    dev = y.device
    _check_dense(h.re, "h.re", (k, a, f), dev)
    _check_dense(h.im, "h.im", (k, a, f), dev)
    _check_dense(inv, "inv", (k, f), dev)
    out = CArray(torch.empty((k, s, f - 1), dtype=torch.float32, device=dev),
                 torch.empty((k, s, f - 1), dtype=torch.float32, device=dev))
    lib = build.load_library()
    st = y.re.stride()
    int16 = y.dtype == torch.int16
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if exact:
            name = "fft_mrc"
            if f == fft_plan.SPREAD_FFT or f in fft_plan.SIDE_FFT_SIZES:
                ring, counters, slots, lag = _spread_scratch(k * s, a, f, (h.re, h.im), dev,
                                                             stream)
            else:
                ring, counters, slots, lag = _split_ring(k * s, a, f, (h.re, h.im, inv), dev,
                                                         fft_plan.SPLIT_K1)
            err = lib.ofdm_fft_mrc(
                y.re.data_ptr(), y.im.data_ptr(), int(int16),
                int(_rows_aligned(y)), st[0], st[1], st[2], _scale(y), k, s, a, f,
                h.re.data_ptr(), h.im.data_ptr(), inv.data_ptr(),
                _data_table(f, dev).data_ptr(), out.re.data_ptr(),
                out.im.data_ptr(), _ptr(ring), slots, lag, _ptr(counters), stream)
        else:
            name = "fft_mrc_bf16"
            if any(t.data_ptr() % 16 for t in (h.re, h.im)):
                raise ValueError("fused_pipeline(exact=False): h planes must start 16-byte "
                                 "aligned (the kernel copies h rows in bulk)")
            ring, counters, slots, lag = _split_ring(k * s, a, f, (h.re, h.im), dev,
                                                     fft_plan.SPEED_RING_K1)
            tw, w = _speed_tables(f, int16, dev)
            split = f in SPEED_SPLIT_SIZES   # the ring's row tiles take W's image
            img = fft_plan.speed_w_image(dev) if split else None
            err = lib.ofdm_fft_mrc_bf16(
                y.re.data_ptr(), y.im.data_ptr(), int(int16), st[0], st[1], st[2], k, s, a,
                f, h.re.data_ptr(), h.im.data_ptr(), inv.data_ptr(), tw.data_ptr(),
                None if split else w.data_ptr(), _ptr(img), out.re.data_ptr(),
                out.im.data_ptr(), _ptr(ring), slots, lag, _ptr(counters), stream)
    build.check(lib, err, name)
    launch_counts[name] += 1
    return out[0] if single else out


def _check_size(f: int, exact: bool, who: str) -> None:
    """Raise for an F the chosen kernel does not instantiate."""
    if exact and not supports_fused(f):
        raise ValueError(f"{who}: F={f} not in {FUSED_FFT_SIZES}")
    if not exact and not supports_speed(f):
        raise ValueError(f"{who}: the speed mode needs F in {SPEED_FFT_SIZES}, got {f}")


def _speed_tables(f: int, int16: bool,
                  dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The speed kernels' stage-1 twiddles (from F = 8192 the split form's
    table) and bf16 W on ``dev``; W is read in 16-byte pieces."""
    if f in SPEED_SPLIT_SIZES:
        tw = fft_plan.split_tables(f, int16, dev)
    else:
        tw = fft_plan.speed_twiddles(f, int16, dev)
    w = fft_plan.speed_w(dev)
    if w.data_ptr() % 16 or tw.data_ptr() % 8:
        raise ValueError("speed kernels: W must start 16-byte aligned, the twiddles 8-byte")
    return tw, w


def _exact_table(f: int, dev: torch.device) -> torch.Tensor:
    """The exact kernels' twiddles: the register FFT's pass twiddles, or at
    the split sizes the split form's table."""
    if f in SPLIT_FFT_SIZES:
        return fft_plan.split_tables(f, False, dev)
    return fft_plan.pass_twiddles(f, dev)


def _data_table(f: int, dev: torch.device) -> torch.Tensor:
    """The exact data kernels' twiddles: at the side sizes the side form's
    pass twiddles (its own radices), else ``_exact_table``."""
    if f in fft_plan.SIDE_FFT_SIZES:
        return fft_plan.side_twiddles(f, dev)
    return _exact_table(f, dev)


def _split_scratch(items: int, a: int, f: int, sizes,
                   dev: torch.device) -> Tuple[Optional[torch.Tensor], int]:
    """(scratch [2, chunk, A, F] float32, chunk) of the chunked split form's
    two passes over ``items`` frames of A rows where the pilot runs that
    form at F (``sizes``: SPLIT_FFT_SIZES for the exact pilot,
    SPEED_SPLIT_SIZES for the speed pilot), else (None, 0).  The scratch
    lives until the caller's last reference goes; the allocator gives it to
    no later work of the stream before the kernels are done."""
    if f not in sizes:
        return None, 0
    chunk = fft_plan.split_chunk(items, a, f)
    return torch.empty((2, chunk, a, f), dtype=torch.float32, device=dev), chunk


def _split_ring(items: int, a: int, f: int, estimate, dev: torch.device, k1: int
                ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], int, int]:
    """(ring [2, slots, A, F] (float32; the bf16 kernel's bf16), counters
    [1 + 2 items] int32 zeroed, slots, lag) of a data kernel's one-launch
    split form over ``items``
    symbols of A rows (``fft_plan.split_ring`` with row tiles of ``k1`` bins
    k1: a ring of at most SPLIT_RING_BYTES, which L2 holds; the counters are
    the launch's ticket and each symbol's column tiles and row tiles done),
    where the kernel runs it at F (the exact kernels, k1 = SPLIT_K1: 16384
    and 32768; the bf16 kernel, SPEED_RING_K1: 8192 to 32768), else (None,
    None, 0, 0).  The row tiles copy the ``estimate`` tensors (h's planes and
    the exact kernels' gains, inv or hsqrd) in 16-byte pieces: each must
    start 16-byte aligned.  As ``_split_scratch``, the tensors live until the
    caller's last reference goes, and the stream orders later work after the
    kernel."""
    if f not in (SPLIT_FFT_SIZES if k1 == fft_plan.SPLIT_K1 else SPEED_SPLIT_SIZES):
        return None, None, 0, 0
    if any(t.data_ptr() % 16 for t in estimate):
        raise ValueError(f"the data kernels at F = {f} copy the estimate in 16-byte pieces: "
                         "its planes and gains must start 16-byte aligned")
    slots, lag = fft_plan.split_ring(items, a, f, _sms(dev), k1)
    dtype = torch.float32 if fft_plan.split_ring_bytes_per_value(k1) == 4 else torch.bfloat16
    ring = torch.empty((2, slots, a, f), dtype=dtype, device=dev)
    counters = torch.zeros(1 + 2 * items, dtype=torch.int32, device=dev)
    return ring, counters, slots, lag


def _sms(dev: torch.device) -> int:
    """SMs of the card (the plans' budget); an H100's off the card."""
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).multi_processor_count
    return fft_plan.H100_SMS


def _spread_scratch(items: int, a: int, f: int, estimate, dev: torch.device, stream: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """(partials [B, slots, F, 2] float32: the slots of a block of (re, im)
    pairs, two at F = 8192, ``fft_plan.side_slots`` at the side sizes; the
    per-symbol counts; B; the block's dynamic shared memory) of a spread
    (F = 8192, ``fft_plan.spread_plan``) or side (``fft_plan.side_plan``)
    data kernel's launch over ``items`` symbols of A rows, in the order of
    the C entries' (scratch, counters, slots, lag).  As ``_split_ring``, the
    scratch lives until the caller's last reference goes.  The kernel copies
    the ``estimate`` planes' rows in 16-byte pieces: each must start 16-byte
    aligned."""
    if any(t.data_ptr() % 16 for t in estimate):
        raise ValueError(f"the data kernels at F = {f} copy the estimate in 16-byte pieces: "
                         "its planes must start 16-byte aligned")
    if f == fft_plan.SPREAD_FFT:
        plan, slots = fft_plan.spread_plan(items, a, _sms(dev)), 2
    else:
        plan, slots = fft_plan.side_plan(items, a, f, _sms(dev)), fft_plan.side_slots(f)
    partials = torch.empty((plan.blocks, slots, f, 2), dtype=torch.float32, device=dev)
    counts = _zero_counts(_spread_counts, items, dev, stream)
    return partials, counts, plan.blocks, plan.smem_bytes


def _zero_counts(pool: Dict, n: int, dev: torch.device, stream: int) -> torch.Tensor:
    """At least ``n`` int32 zeros of ``pool`` (``_pilot_counts``: the F =
    8192 pilot's counts, ``fft_plan.pilot_row_counts``; ``_spread_counts``:
    the spread data kernels' per symbol) on ``stream``: a larger buffer
    where a launch needs more."""
    key = (dev.index, stream)
    buf = pool.get(key)
    if buf is None or buf.numel() < n or buf.device != dev:
        buf = torch.zeros(n, dtype=torch.int32, device=dev)
        pool[key] = buf
    return buf


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# Whole-frame entry points
# ---------------------------------------------------------------------------

def demod_parts_fused(pilot: CArray, data: CArray, x_full: CArray, *,
                      exact: bool = True) -> CArray:
    """Pre-split form: pilot [.., A, F] + CP-free data rows [.., S-1, A, F]
    -> [.., S-1, F-1] in reference order; ``exact=False`` runs both speed
    kernels."""
    h, inv = estimate_pilot_fused(pilot, x_full, exact=exact)
    return fused_pipeline(data, h, inv, exact=exact)


def demod_frame_fused(frame: CArray, x_full: CArray, *, cp: int,
                      exact: bool = True) -> CArray:
    """Whole frame(s) [.., S, A, F+cp], pilot first -> [.., S-1, F-1].

    The cyclic prefix, the pilot row and the data rows are all views of
    ``frame``: each kernel reads its rows in place through the strides."""
    if frame.ndim not in (3, 4):
        raise ValueError(f"frame must be [S, A, F+cp] or [K, S, A, F+cp], "
                         f"got {frame.shape}")
    y = drop_cyclic_prefix(frame, cp)
    return demod_parts_fused(y[..., 0, :, :], y[..., 1:, :, :], x_full, exact=exact)
