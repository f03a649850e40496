"""The factorization that the kernels' register FFT runs
(``csrc/fft_warp.cuh``, used by ``csrc/fft_mrc.cu``, ``csrc/mrc_demod.cu`` and
``csrc/pilot_ls.cu``), the host tables it reads, and the pilot kernel's launch
geometry (``pilot_plan``).

A row of F samples is transformed by a team of T = F / M threads, each
holding M complex values in registers.  The transform is a mixed-radix
Stockham FFT in len(radices) passes (radices[0] = M, product F):

  pass p, radix R, Ns = product of the radices before p;
  butterfly b in [0, F/R) takes x[b + (F/R) r], r < R, multiplies input r by
  exp(-2 pi i (b mod Ns) r / (Ns R)), runs an R-point DFT, and writes output
  r to position (b // Ns) Ns R + (b mod Ns) + Ns r.

Thread j runs the butterflies b = j + T q, q < M/R, so it always reads the
positions j + T m, m = q + (M/R) r, into register m.  The first pass reads
the staged row; each later pass reads the previous pass's output from a
shared-memory exchange buffer.  After the last pass register m of thread j
holds bin j + T m (``lane_bins``): the kernels' h read and store use that
map.  The twiddles of passes 1.. come from one float32 table computed in
float64 (``pass_twiddles``), entry r Ns + c = exp(-2 pi i c r / (Ns R)), so
a team's lanes read consecutive entries.  The R-point DFTs inside a thread
use the constants of ``fft_warp.cuh``.

The exchange buffer holds each plane (re, im) as floats, position e stored at
``exchange_slot(F, e)`` = e + e // M, so a transpose between passes is free
of bank conflicts; a plane takes ``plane_floats(F)`` floats and a team's two
buffers ``team_floats(F)``.  Nothing here runs
a kernel; the wrappers pass ``pass_twiddles`` to the kernels, and the CPU tests
emulate the kernels' arithmetic on these tables.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

# F -> (radices of the passes, the first being M, the values a thread
# holds; teams per symbol P; threads per block; blocks an SM should hold).
# csrc/fft_warp.cuh's OFDM_WARP_PLAN lines hold the same table.
PLANS = {
    64: ((8, 8), 4, 128, 4),
    128: ((16, 8), 4, 128, 4),
    256: ((16, 16), 4, 128, 4),
    512: ((32, 16), 4, 128, 2),
    1024: ((32, 32), 4, 128, 2),
    2048: ((32, 8, 8), 2, 128, 1),
    4096: ((32, 16, 8), 2, 256, 1),
}


class Plan(NamedTuple):
    fft_size: int
    radices: Tuple[int, ...]
    values: int            # M, complex values a thread holds
    threads: int           # T = F / M, threads of a row's team
    teams_per_symbol: int  # P: team p takes antennas p, p + P, ...
    block: int             # threads per block
    min_blocks: int        # blocks an SM should hold (__launch_bounds__)

    @property
    def symbols_per_block(self) -> int:
        return self.block // (self.threads * self.teams_per_symbol)


def plan(f: int) -> Plan:
    if f not in PLANS:
        raise ValueError(f"no register-FFT plan for F={f}; sizes {tuple(PLANS)}")
    radices, teams, block, min_blocks = PLANS[f]
    assert math.prod(radices) == f and max(radices) == radices[0]
    return Plan(f, radices, radices[0], f // radices[0], teams, block, min_blocks)


def strides(f: int) -> Tuple[int, ...]:
    """Ns of each pass: the product of the radices before it."""
    out, ns = [], 1
    for r in plan(f).radices:
        out.append(ns)
        ns *= r
    return tuple(out)


def pass_twiddles_np(f: int) -> np.ndarray:
    """[n, 2] float32 (cos, sin) for passes 1..: pass p's block starts after
    the blocks of the passes before it and holds R Ns entries, entry
    r Ns + c = exp(-2 pi i c r / (Ns R)), computed in float64."""
    blocks = []
    for radix, ns in zip(plan(f).radices[1:], strides(f)[1:]):
        r, c = np.meshgrid(np.arange(radix), np.arange(ns), indexing="ij")
        ang = -2.0 * np.pi * (c * r).astype(np.float64) / (ns * radix)
        blocks.append(np.stack([np.cos(ang), np.sin(ang)], axis=-1).reshape(-1, 2))
    return np.concatenate(blocks).astype(np.float32)


@functools.lru_cache(maxsize=None)
def pass_twiddles(f: int, device: torch.device) -> torch.Tensor:
    """``pass_twiddles_np`` on the device: the table the kernels read."""
    return torch.from_numpy(pass_twiddles_np(f)).to(device)


def lane_bins(f: int) -> np.ndarray:
    """[T, M]: the frequency bin that register m of thread j holds after the
    last pass, j + T m."""
    p = plan(f)
    return np.arange(p.threads)[:, None] + p.threads * np.arange(p.values)[None, :]


def exchange_slot(f: int, e):
    """Float offset in an exchange plane of position e: one float of padding
    after every M, which makes every pass's transpose free of bank
    conflicts for the radices above."""
    return e + e // plan(f).values


def plane_floats(f: int) -> int:
    """Floats of one exchange plane: every slot, rounded up to 16 bytes so the
    im plane of a staged row starts 16-byte aligned."""
    return -(-exchange_slot(f, f) // 4) * 4


def smem_bytes(f: int) -> int:
    """Dynamic shared memory of one block: the pass twiddles, then each
    team's buffers."""
    p = plan(f)
    return 4 * (2 * len(pass_twiddles_np(f)) + p.block // p.threads * team_floats(f))


def team_floats(f: int) -> int:
    """Floats of a team's shared memory: two buffers of two planes, padded so
    that the teams that share a warp (T < 32) start T banks apart."""
    t = plan(f).threads
    need = 4 * plane_floats(f)
    return need + ((t - need) % 32 if t < 32 else 0)


# ---------------------------------------------------------------------------
# The pilot kernel's launch geometry (csrc/pilot_ls.cu)
# ---------------------------------------------------------------------------

PILOT_FFT_SIZES = (256, 512, 1024, 2048, 4096)
MAX_CLUSTER = 8             # the portable thread block cluster size


class PilotPlan(NamedTuple):
    clusters: int    # C: blocks of one frame's cluster (grid (C, K))
    teams: int       # teams of one block
    rows: int        # antenna rows of one team, at most
    threads: int     # threads of one block: teams x T
    smem_bytes: int  # dynamic shared memory of one block


def pilot_max_threads(f: int) -> int:
    """Most threads a pilot block holds: 128, or two teams where a team is
    more than 64 threads (F = 4096).  csrc/pilot_ls.cu pilot_max_threads
    holds the same rule (its __launch_bounds__)."""
    return max(128, 2 * plan(f).threads)


def pilot_smem_bytes(f: int, teams: int) -> int:
    """Each team's two buffers, X (two planes of F floats), then the block's
    sum over its teams (F floats); the pilot reads the pass twiddles
    through L1, not from shared memory."""
    return 4 * (teams * team_floats(f) + 3 * f)


@functools.lru_cache(maxsize=None)
def pilot_plan(antennas: int, f: int) -> PilotPlan:
    """Launch geometry of the pilot kernel for A antenna rows of F bins.

    A cluster of C blocks per frame, each block as many one-row teams as its
    thread cap allows, the cluster as large as the rows need up to the
    portable 8; past 8 x teams rows a team takes several (A = 64 at F = 1024:
    8 blocks x 4 teams x 2 rows).  Raises for a shape the kernel cannot
    launch."""
    if f not in PILOT_FFT_SIZES:
        raise ValueError(f"pilot_plan: F={f} not in {PILOT_FFT_SIZES}")
    if antennas < 1:
        raise ValueError(f"pilot_plan: {antennas} antennas")
    t = plan(f).threads
    cap = pilot_max_threads(f) // t
    clusters = min(MAX_CLUSTER, -(-antennas // cap))
    teams = min(cap, -(-antennas // clusters))
    rows = -(-antennas // (clusters * teams))
    teams = -(-antennas // (clusters * rows))  # no team slot left idle per row
    return PilotPlan(clusters, teams, rows, teams * t, pilot_smem_bytes(f, teams))


def pilot_team_rows(antennas: int, p: PilotPlan, rank: int, team: int) -> range:
    """Antenna rows of team ``team`` of block ``rank``: g, g + C teams, ...
    below A, g = rank * teams + team (the kernel's row loop)."""
    return range(rank * p.teams + team, antennas, p.clusters * p.teams)


def pilot_rank_bins(f: int, clusters: int, rank: int) -> range:
    """Bins whose sum over the cluster's blocks rank ``rank`` adds up (from
    the blocks' shared memory) and whose inv it writes: [rank F / C,
    (rank + 1) F / C)."""
    return range(rank * f // clusters, (rank + 1) * f // clusters)
