"""Plain reference of the uplink's LS + MRC receiver, in float64 torch.

For each frame of a capture (symbol 0 the pilot, the rest data, every row
of F samples with its cyclic prefix already stripped):

  Y[s, a]  = FFT(y[s, a])                       every row, every antenna
  H[a]     = Y[0, a] / X                        LS, X the pilot with X[0] = 1
  G        = sum_a |H[a]|^2
  eq[s]    = sum_a conj(H[a]) Y[s, a] / G       MRC, s = 1 .. S-1
  out[s,j] = eq[s, 1 + (j + (F-1)//2) mod (F-1)]   DC dropped, reference order

The reference order is the source receiver's (``shiftOneRow``,
cpuLS.hpp:368): the data bins 1 .. F-1 rotated by half their count.  Each
part is written out from the formulas; nothing here imports the port.
"""

from __future__ import annotations

import torch

FULL_SCALE = 32767.0


def reference_order(f: int, device) -> torch.Tensor:
    m = f - 1
    j = torch.arange(m, device=device)
    return 1 + (j + m // 2) % m


def demod(re: torch.Tensor, im: torch.Tensor, pilot: torch.Tensor) -> torch.Tensor:
    """Frames [K, S, A, F] as int16 or float planes, the pilot [F - 1]
    complex -> [K, S - 1, F - 1] complex128."""
    scale = FULL_SCALE if re.dtype == torch.int16 else 1.0
    y = torch.complex(re.double(), im.double()) / scale
    f = y.shape[-1]
    x = torch.cat([torch.ones(1, dtype=torch.complex128, device=y.device),
                   pilot.to(device=y.device, dtype=torch.complex128)])
    big_y = torch.fft.fft(y, dim=-1)
    h = big_y[:, 0] / x                                   # [K, A, F]
    g = (h.real ** 2 + h.imag ** 2).sum(dim=-2)           # [K, F]
    eq = (h.conj()[:, None] * big_y[:, 1:]).sum(dim=-2) / g[:, None]
    return eq[..., reference_order(f, y.device)]
