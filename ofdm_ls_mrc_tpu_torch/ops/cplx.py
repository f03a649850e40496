"""Planar complex tensors: a (re, im) pair of same-shape torch tensors.

The counterpart of ``ofdm_ls_mrc_tpu.ops.cplx.CArray``.  The hand-written
kernels read planar inputs (float32, or int16 sc16 planes straight from the
radio wire format), so the port keeps the reference's planar layout at every
public function; ``torch.complex`` appears only inside the plain FFT
(``ops/fft.py``).
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike, who: str) -> torch.device:
    """``device`` as a torch.device; a CUDA device where none is available
    raises (the port's entry points default to the card)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}(device='cuda'): no CUDA device is available; "
                           "pass device='cpu' to compute on the CPU")
    return device


class CArray:
    """A complex tensor as planar (re, im) components.

    ``re`` and ``im`` have the same shape, dtype and device.  Arithmetic
    implements the textbook complex formulas on the planes; int16 planes are
    carried as-is (the kernels widen them on load, see ``ops/pipeline.py``).
    """

    __slots__ = ("re", "im")

    def __init__(self, re: torch.Tensor, im: torch.Tensor):
        if re.shape != im.shape or re.dtype != im.dtype or re.device != im.device:
            raise ValueError(
                f"planes differ: re {tuple(re.shape)} {re.dtype} {re.device}, "
                f"im {tuple(im.shape)} {im.dtype} {im.device}")
        self.re = re
        self.im = im

    # -- host boundary -------------------------------------------------------
    @classmethod
    def from_numpy(cls, x: np.ndarray, device: DeviceLike) -> "CArray":
        """Split a host complex array into planar float32 tensors on ``device``.
        A real array becomes the real plane with a zero imaginary plane."""
        x = np.asarray(x)
        if np.iscomplexobj(x):
            re = np.ascontiguousarray(x.real, dtype=np.float32)
            im = np.ascontiguousarray(x.imag, dtype=np.float32)
        else:
            re = np.ascontiguousarray(x, dtype=np.float32)
            im = np.zeros_like(re)
        return cls(torch.from_numpy(re).to(device), torch.from_numpy(im).to(device))

    def to_numpy(self) -> np.ndarray:
        """Copy to the host and re-interleave as complex64."""
        re = self.re.detach().cpu().numpy()
        im = self.im.detach().cpu().numpy()
        return (re + 1j * im).astype(np.complex64)

    def to(self, device: DeviceLike) -> "CArray":
        return CArray(self.re.to(device), self.im.to(device))

    # -- shape utilities ------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.re.shape)

    @property
    def ndim(self) -> int:
        return self.re.ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.re.dtype

    @property
    def device(self) -> torch.device:
        return self.re.device

    def reshape(self, *shape) -> "CArray":
        return CArray(self.re.reshape(*shape), self.im.reshape(*shape))

    def __getitem__(self, idx) -> "CArray":
        return CArray(self.re[idx], self.im[idx])

    def roll(self, shift: int, axis: int = -1) -> "CArray":
        return CArray(torch.roll(self.re, shift, axis), torch.roll(self.im, shift, axis))

    # -- arithmetic -----------------------------------------------------------
    def __add__(self, o: "CArray") -> "CArray":
        return CArray(self.re + o.re, self.im + o.im)

    def __sub__(self, o: "CArray") -> "CArray":
        return CArray(self.re - o.re, self.im - o.im)

    def __mul__(self, o) -> "CArray":
        if isinstance(o, CArray):
            return CArray(self.re * o.re - self.im * o.im,
                          self.re * o.im + self.im * o.re)
        if isinstance(o, complex) or (isinstance(o, torch.Tensor) and o.is_complex()):
            raise TypeError("a complex operand would break the planar "
                            "invariant; wrap it in a CArray")
        return CArray(self.re * o, self.im * o)  # real scalar or tensor

    def __rmul__(self, o) -> "CArray":
        return self.__mul__(o)

    def conj(self) -> "CArray":
        return CArray(self.re, -self.im)

    def mul_conj(self, o: "CArray") -> "CArray":
        """self * conj(o), the MRC inner step."""
        return CArray(self.re * o.re + self.im * o.im,
                      self.im * o.re - self.re * o.im)

    def abs2(self) -> torch.Tensor:
        """|z|^2 as a real tensor."""
        return self.re * self.re + self.im * self.im

    def div_real(self, d: torch.Tensor) -> "CArray":
        inv = 1.0 / d
        return CArray(self.re * inv, self.im * inv)


def cdiv(a: CArray, b: CArray) -> CArray:
    """a / b == a * conj(b) / |b|^2, the reference's divideOneRow form."""
    inv = 1.0 / b.abs2()
    return CArray((a.re * b.re + a.im * b.im) * inv,
                  (a.im * b.re - a.re * b.im) * inv)


def cwhere(mask: torch.Tensor, a: CArray, fill: float) -> CArray:
    """a where ``mask`` holds, the real constant ``fill`` elsewhere."""
    f = torch.full((), fill, dtype=a.re.dtype, device=a.device)
    return CArray(torch.where(mask, a.re, f), torch.where(mask, a.im, f))
