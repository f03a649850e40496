"""Inputs of a run, made on the device from the seed.

The pilot X is F - 1 unit-modulus bins of random phase.  The samples are
complex Gaussian, their power ``backoff_db`` under sc16 full scale, so that
an ADC clips rarely, rounded to planar int16.  One generator on the device,
seeded once, draws the pilot and then every buffer in a few large calls:
the same seed gives the same inputs.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

FULL_SCALE = 32767.0


def generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def pilot(gen: torch.Generator, f: int, device: torch.device) -> torch.Tensor:
    """[F - 1] complex128 on the device, |X| = 1."""
    phase = torch.rand(f - 1, generator=gen, device=device, dtype=torch.float64)
    return torch.polar(torch.ones_like(phase), 2 * math.pi * phase)


def _plane(gen, shape, sigma: float, device) -> Tuple[torch.Tensor, int]:
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    x.mul_(sigma * FULL_SCALE).round_()
    clipped = int(torch.count_nonzero(x.abs() > FULL_SCALE))
    plane = x.clamp_(-FULL_SCALE, FULL_SCALE).to(torch.int16)
    return plane, clipped


def buffers(gen: torch.Generator, count: int, shape, backoff_db: float,
            device: torch.device) -> Tuple[List[Tuple[torch.Tensor, torch.Tensor]], int]:
    """``count`` buffers of int16 planes (re, im), each of ``shape``, and
    the number of components clipped to full scale."""
    sigma = 10.0 ** (-backoff_db / 20.0) / math.sqrt(2.0)   # each component
    re, c_re = _plane(gen, (count, *shape), sigma, device)
    im, c_im = _plane(gen, (count, *shape), sigma, device)
    return [(re[i], im[i]) for i in range(count)], c_re + c_im
