"""Reference state -> port state.

The JAX fused path keeps its pilot and channel estimate in TPU layouts; the
port works in natural frequency order.  These functions take the reference's
arrays as numpy and return port tensors, so both packages can compute on the
same parameters and each kernel can be compared on its own.

Layouts, with F = n1 * n2, n2 = 128, n1 = F / 128 (the reference's fast split
for every size the fused path supports):

* fastpath permuted order (``prepare_pilot_fast``): position k1*n2 + k2
  holds true frequency n1*k2 + k1;
* pilot-kernel layout (``estimate_pilot_fused`` output, [.., n1, n2]):
  position (p1, k2) holds true frequency n1*k2 + bitrev(p1).

The functions put their tensors on the card unless asked for the CPU.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .ops.cplx import CArray, DeviceLike, resolve_device


def _split(f: int) -> Tuple[int, int]:
    if f % 128 or f // 128 < 2 or (f // 128) & (f // 128 - 1):
        raise ValueError(f"F={f} has no (2^k, 128) split")
    return f // 128, 128


def _bitrev(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    out = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


def perm_true_frequency(f: int) -> np.ndarray:
    """true[p]: the frequency held at fastpath permuted position p."""
    n1, n2 = _split(f)
    k1 = np.arange(n1)[:, None]
    k2 = np.arange(n2)[None, :]
    return (n1 * k2 + k1).reshape(-1)


def kernel_true_frequency(f: int) -> np.ndarray:
    """true[p]: the frequency held at pilot-kernel layout position p."""
    n1, n2 = _split(f)
    p1 = np.arange(n1)[:, None]
    k2 = np.arange(n2)[None, :]
    return (n1 * k2 + _bitrev(n1)[p1]).reshape(-1)


def _to_natural(x: np.ndarray, true: np.ndarray) -> np.ndarray:
    out = np.empty_like(x)
    out[..., true] = x
    return out


def pilot_from_reference(x_full_perm: np.ndarray, device: DeviceLike = "cuda") -> CArray:
    """[F] complex padded pilot in fastpath permuted order -> [F] natural
    order (the ``ls.pad_pilot`` layout)."""
    device = resolve_device(device, "pilot_from_reference")
    x = np.asarray(x_full_perm)
    return CArray.from_numpy(_to_natural(x, perm_true_frequency(x.shape[-1])), device)


def estimate_from_reference(h_re: np.ndarray, h_im: np.ndarray, inv: np.ndarray,
                            device: DeviceLike = "cuda") -> Tuple[CArray, torch.Tensor]:
    """Pilot-kernel outputs (h [A, n1, n2] planes, inv [n1, n2]) ->
    (h [A, F], inv [F]) in natural order."""
    device = resolve_device(device, "estimate_from_reference")
    h_re, h_im, inv = (np.asarray(v, dtype=np.float32) for v in (h_re, h_im, inv))
    a = h_re.shape[0]
    f = inv.size
    true = kernel_true_frequency(f)
    h = _to_natural(h_re.reshape(a, f), true) + 1j * _to_natural(h_im.reshape(a, f), true)
    inv_nat = _to_natural(inv.reshape(f), true)
    return CArray.from_numpy(h, device), torch.from_numpy(inv_nat).to(device)


def streaming_state_from_reference(h_re: np.ndarray, h_im: np.ndarray,
                                   hsqinv: np.ndarray, device: DeviceLike = "cuda"
                                   ) -> Tuple[CArray, torch.Tensor]:
    """The JAX fused ``StreamingDemodulator``'s estimate (h [A, F] planes,
    unconjugated, and 1/sum_a |h|^2 [F], both in fastpath permuted order) ->
    the port's fused streaming state (h [A, F], inv [F]) in natural order."""
    device = resolve_device(device, "streaming_state_from_reference")
    h_re, h_im, hsqinv = (np.asarray(v, dtype=np.float32) for v in (h_re, h_im, hsqinv))
    true = perm_true_frequency(hsqinv.shape[-1])
    h = _to_natural(h_re, true) + 1j * _to_natural(h_im, true)
    return (CArray.from_numpy(h, device),
            torch.from_numpy(_to_natural(hsqinv, true)).to(device))
