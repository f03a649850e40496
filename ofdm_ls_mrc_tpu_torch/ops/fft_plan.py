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

At F = 8192 the exact data kernels run the register FFT's team of 256
threads (32 values a thread, radices 32, 16, 16), one a block, the
launch's antenna rows spread over the card (``spread_plan``,
``csrc/fft_spread.cuh``); the last pass's twiddles are products of four of
its table rows (SPREAD_POWERS).  At F = 256, 512, 2048 and 4096 they run
the side form (``side_plan``, ``csrc/fft_side.cuh``): the same passes with
16 values a thread (``SIDE_PLANS``, ``side_geometry``; the helpers here take
its ``Plan`` as ``p``), a launch's rows over teams side by side on the
card; ``PLANS`` there serves the pilot.  Past 8192 one SM cannot hold a
row with its sums (16384 complex float32 values are 128 KB, the register
file 256 KB for every thread of the SM), so the exact kernels run F = 16384
and 32768 in the four-step split of the section "the split form" below
(``csrc/fft_split.cuh``), and the bf16 speed kernels run F = 8192 to 32768
on its first step.

Each function that computes a host table (``pass_twiddles_np``,
``split_tables_np``, ``speed_twiddles_np``, ``speed_w_np``,
``speed_w_image_np``) counts it while a profiler runs
(``utils/profiling.TABLE``), a table built from others once; a cached
device table counts only when it is first built.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils import profiling

# F -> (radices of the passes, the first being M, the values a thread
# holds; teams per symbol P; threads per block; blocks an SM should hold).
# csrc/fft_warp.cuh's OFDM_WARP_PLAN lines hold the same table.  At 8192 the
# kernels take the radices and the team only (``spread_plan``); at 256, 512,
# 2048 and 4096 the pilot runs these and the data kernels ``SIDE_PLANS``.
PLANS = {
    64: ((8, 8), 4, 128, 4),
    128: ((16, 8), 4, 128, 4),
    256: ((16, 16), 4, 128, 4),
    512: ((32, 16), 4, 128, 2),
    1024: ((32, 32), 4, 128, 2),
    2048: ((32, 8, 8), 2, 128, 1),
    4096: ((32, 16, 8), 2, 256, 1),
    8192: ((32, 16, 16), 1, 256, 1),
}


class Plan(NamedTuple):
    fft_size: int
    radices: Tuple[int, ...]
    values: int            # M, complex values a thread holds
    threads: int           # T = F / M, threads of a row's team
    teams_per_symbol: int  # P: team p takes antennas p, p + P, ...
    block: int             # threads per block
    min_blocks: int        # blocks an SM should hold (__launch_bounds__)
    pad: int = 0           # exchange padding stride: one float after every ``pad`` (0: M)

    @property
    def symbols_per_block(self) -> int:
        return self.block // (self.threads * self.teams_per_symbol)


def plan(f: int) -> Plan:
    if f not in PLANS:
        raise ValueError(f"no register-FFT plan for F={f}; sizes {tuple(PLANS)}")
    radices, teams, block, min_blocks = PLANS[f]
    assert math.prod(radices) == f and max(radices) == radices[0]
    return Plan(f, radices, radices[0], f // radices[0], teams, block, min_blocks)


def strides(f: int, p: Optional[Plan] = None) -> Tuple[int, ...]:
    """Ns of each pass: the product of the radices before it (of ``p``, by
    default ``plan(f)``; so for the helpers below)."""
    out, ns = [], 1
    for r in (p or plan(f)).radices:
        out.append(ns)
        ns *= r
    return tuple(out)


@profiling.counts(profiling.TABLE)
def pass_twiddles_np(f: int, p: Optional[Plan] = None) -> np.ndarray:
    """[n, 2] float32 (cos, sin) for passes 1..: pass p's block starts after
    the blocks of the passes before it and holds R Ns entries, entry
    r Ns + c = exp(-2 pi i c r / (Ns R)), computed in float64."""
    blocks = []
    p = p or plan(f)
    for radix, ns in zip(p.radices[1:], strides(f, p)[1:]):
        r, c = np.meshgrid(np.arange(radix), np.arange(ns), indexing="ij")
        ang = -2.0 * np.pi * (c * r).astype(np.float64) / (ns * radix)
        blocks.append(np.stack([np.cos(ang), np.sin(ang)], axis=-1).reshape(-1, 2))
    return np.concatenate(blocks).astype(np.float32)


@functools.lru_cache(maxsize=None)
def pass_twiddles(f: int, device: torch.device) -> torch.Tensor:
    """``pass_twiddles_np`` on the device: the table the kernels read."""
    return torch.from_numpy(pass_twiddles_np(f)).to(device)


def lane_bins(f: int, p: Optional[Plan] = None) -> np.ndarray:
    """[T, M]: the frequency bin that register m of thread j holds after the
    last pass, j + T m."""
    p = p or plan(f)
    return np.arange(p.threads)[:, None] + p.threads * np.arange(p.values)[None, :]


def exchange_slot(f: int, e, p: Optional[Plan] = None):
    """Float offset in an exchange plane of position e: one float of padding
    after every M (every ``p.pad`` where the plan sets it), which spreads
    every pass's transpose over the banks for the radices above."""
    p = p or plan(f)
    return e + e // (p.pad or p.values)


def plane_floats(f: int, p: Optional[Plan] = None) -> int:
    """Floats of one exchange plane: every slot, rounded up to 16 bytes so the
    im plane of a staged row starts 16-byte aligned."""
    return -(-exchange_slot(f, f, p) // 4) * 4


def smem_bytes(f: int) -> int:
    """Dynamic shared memory of one block: the pass twiddles, then each
    team's buffers."""
    p = plan(f)
    return 4 * (2 * len(pass_twiddles_np(f)) + p.block // p.threads * team_floats(f))


def team_floats(f: int, p: Optional[Plan] = None, buffers: int = 2) -> int:
    """Floats of a team's shared memory: two buffers (the push form's pilot:
    one) of two planes, padded so that the teams that share a warp (T < 32)
    start T banks apart."""
    t = (p or plan(f)).threads
    need = 2 * buffers * plane_floats(f, p)
    return need + ((t - need) % 32 if t < 32 else 0)


# ---------------------------------------------------------------------------
# The pilot kernel's launch geometry (csrc/pilot_ls.cu)
# ---------------------------------------------------------------------------

PILOT_FFT_SIZES = (64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768)
MAX_CLUSTER = 8             # the portable thread block cluster size
PILOT_PUSH_SIZES = (64, 128, 256, 512, 2048, 4096)   # the push form (pilot_ls_push_kernel)
PILOT_PUSH_THREADS = 512    # ... threads of a block, at most (its __launch_bounds__)
PILOT_PUSH_BLOCK = 128      # ... threads of a block while 16 blocks of them hold every row
PILOT_PUSH_MAX_CLUSTER = 16  # ... blocks of a frame's cluster, at most (the non-portable size)
PILOT_PUSH_REGS = 128       # ... registers of a thread, at most (__launch_bounds__(512, 1))
SMEM_PER_SM = 233472        # shared memory of an H100 SM, bytes (1 KB of it reserved a block)
PILOT_ROW_FFT = 8192        # the pilot's size run as blocks per antenna row
PILOT_ROW_BLOCKS = 4        # ... a row's blocks: columns 32 r .. 32 r + 31 and rows k1 16 r .. + 15
PILOT_ROW_K1 = 16           # ... rows k1 of a block's 128-point FFTs
PILOT_ROW_MAX_ROWS = 4      # ... rows a cluster holds, at most (16 blocks, past the portable 8)
SMS = 132                   # streaming multiprocessors of an H100 SXM: the plans' budget
SPLIT_PILOT_THREADS_PER_SM = 128   # the split pilot's row-pass threads an SM, at most


class PilotPlan(NamedTuple):
    clusters: int    # C: blocks of one frame's cluster (grid (C, K); split sizes (n1 / 8 C, K))
    teams: int       # teams of one block
    rows: int        # antenna rows of one team, at most
    threads: int     # threads of one block: teams x T
    smem_bytes: int  # dynamic shared memory of one block


def pilot_geometry(f: int) -> Plan:
    """The row FFT of the push form (``PILOT_PUSH_SIZES``): the register
    plan at 64 and 128, the side form's (16 values a thread) from 256
    (csrc/pilot_ls.cu PushPlanOf); elsewhere the register plan."""
    return side_geometry(f) if f in SIDE_PLANS else plan(f)


def pilot_twiddles_np(f: int) -> np.ndarray:
    """``pass_twiddles_np`` of the pilot's radices (``pilot_geometry``)."""
    return pass_twiddles_np(f, pilot_geometry(f))


@functools.lru_cache(maxsize=None)
def pilot_twiddles(f: int, device: torch.device) -> torch.Tensor:
    """``pilot_twiddles_np`` on the device: the table the push form copies
    into shared memory."""
    return torch.from_numpy(pilot_twiddles_np(f)).to(device)


def pilot_team_threads(f: int) -> int:
    """Threads of a pilot team, the unit that takes one antenna row: the
    row FFT's T (``pilot_geometry``), at the split sizes the 8 lanes of each
    of the row pass block's SPLIT_K1 rows (``split_teams``), at
    PILOT_ROW_FFT the whole block (a block takes its share of one row)."""
    if f == PILOT_ROW_FFT:
        return SPLIT_COLUMN_THREADS
    return SPLIT_K1 * plan(SPLIT_N2).threads if f in SPLIT_FFT_SIZES else pilot_geometry(f).threads


def pilot_max_threads(f: int) -> int:
    """Most threads a pilot block holds: in the push form
    PILOT_PUSH_THREADS; at F = 1024 four one-warp teams; at PILOT_ROW_FFT a block of a
    row's four (256); at the split sizes the row pass's SPLIT_TEAMS teams.
    csrc/pilot_ls.cu kPushMaxThreads and pilot_max_threads hold the same
    rule (their __launch_bounds__)."""
    if f in PILOT_PUSH_SIZES:
        return PILOT_PUSH_THREADS
    if f in SPLIT_FFT_SIZES:
        return SPLIT_TEAMS * pilot_team_threads(f)
    if f == PILOT_ROW_FFT:
        return SPLIT_COLUMN_THREADS
    return max(128, 2 * plan(f).threads)


def pilot_sums_width(f: int, clusters: int) -> int:
    """In the push form, floats of a block's slot of the sums at a rank:
    the most bins a rank owns, T times ceil(M / C) (``pilot_rank_bins``)."""
    p = pilot_geometry(f)
    return p.threads * -(-p.values // clusters)


def pilot_smem_bytes(f: int, teams: int, clusters: int = 1) -> int:
    """In the push form the pass twiddles (``pilot_twiddles_np``), X (two
    planes of F floats), each team's one row buffer, then, where a frame's
    cluster is more than one block, a slot of the sums for each of its C
    blocks (``pilot_sums_width``).  At F =
    1024 each team's two buffers, X, then the block's sum over its teams (F
    floats; a block of one team sums into its first buffer); that form reads
    the pass twiddles through L1.  At the split sizes the row pass's buffers
    (``split_smem_bytes``), then X of the block's SPLIT_K1 x 128 bins (two
    planes).  At PILOT_ROW_FFT the column buffers of the block's 32 columns
    (its row's blocks read them), one 8-lane team buffer for each of its
    PILOT_ROW_K1 rows k1, then |h|^2 of its PILOT_ROW_K1 x 128 bins (the
    cluster reads them)."""
    if f in PILOT_PUSH_SIZES:
        return 4 * (2 * len(pilot_twiddles_np(f)) + 2 * f
                    + teams * team_floats(f, pilot_geometry(f), buffers=1)
                    + (clusters * pilot_sums_width(f, clusters) if clusters > 1 else 0))
    if f in SPLIT_FFT_SIZES:
        return split_smem_bytes(teams) + 4 * 2 * SPLIT_K1 * SPLIT_N2
    if f == PILOT_ROW_FFT:
        return (split_column_smem_bytes(f // SPLIT_N2) + 4 * PILOT_ROW_K1 * team_floats(SPLIT_N2)
                + 4 * PILOT_ROW_K1 * SPLIT_N2)
    return 4 * (teams * team_floats(f) + 2 * f + (f if teams > 1 else 0))


def pilot_plan(antennas: int, f: int, frames: int = 1) -> PilotPlan:
    """Launch geometry of the pilot kernel for ``frames`` frames of A
    antenna rows of F bins.

    A cluster of C blocks per frame (at the split sizes per SPLIT_K1 bins k1
    of a frame), each block as many one-row teams as its thread cap allows;
    team g = rank * teams + team of the cluster takes rows g, g + C teams,
    ... (``pilot_team_rows``).  The push form (``PILOT_PUSH_SIZES``) takes
    as many blocks of up to PILOT_PUSH_BLOCK threads (one team where a team
    is more) as its rows need, up to PILOT_PUSH_MAX_CLUSTER (past the
    portable 8: the kernel sets the non-portable size and checks that the
    card can co-schedule it), and larger blocks, up to PILOT_PUSH_THREADS,
    only where 16 do not hold every row and the card still holds the
    launch's blocks at once (``_push_plan``): a block holds at most 4 warps
    where it can, as 16 warps on one SM measured slower than the parent
    form (PERF.md, PR 20).  4 x 64 and 16 x
    64: one block, no cluster; 16 x 256: 2 blocks of 8 teams; 16 x 512: 4
    of 4; 16 x 2048 and 16 x 4096: 16 of one team; 64 x 2048: 16 of 4
    teams; 64 x 4096: 16 of 2 teams of 2 rows.  F = 1024 takes the cluster as large
    as the rows need, up to the portable 8 (A = 64: 8 blocks x 4 teams x 2
    rows).  The split sizes spread the antennas over as many
    blocks as they have, up to 8, as long as the card holds every block of
    every frame's clusters at once (``split_pilot_clusters``: 16 x 16384 is
    16 clusters of 8 blocks x 2 teams, 16 x 32768 32 of 2 x 4 teams of 2
    rows).  In
    both, every block gets a row, and no team slot is idle for a whole row.
    F = PILOT_ROW_FFT (8192) takes PILOT_ROW_BLOCKS blocks for each antenna
    row and a cluster of ``pilot_row_rows`` rows (grid (4 A, K)):
    (clusters, teams, rows) = (4 G, 1, 1), the sum over the antennas a tree
    through the cluster and across the clusters (``pilot_rank_bins``).
    Raises for a shape the kernel cannot launch."""
    if f not in PILOT_FFT_SIZES:
        raise ValueError(f"pilot_plan: F={f} not in {PILOT_FFT_SIZES}")
    if antennas < 1:
        raise ValueError(f"pilot_plan: {antennas} antennas")
    if frames < 1:
        raise ValueError(f"pilot_plan: {frames} frames")
    if f in SPLIT_FFT_SIZES:
        return _pilot_plan(antennas, f, split_pilot_clusters(antennas, f, frames))
    if f == PILOT_ROW_FFT:
        return PilotPlan(PILOT_ROW_BLOCKS * pilot_row_rows(antennas), 1, 1, SPLIT_COLUMN_THREADS,
                         pilot_smem_bytes(f, 1))
    t = pilot_team_threads(f)
    cap = pilot_max_threads(f) // t
    if f in PILOT_PUSH_SIZES:
        return _push_plan(antennas, f, frames)
    return _pilot_plan(antennas, f, min(MAX_CLUSTER, -(-antennas // cap)))


def pilot_blocks_per_sm(p: PilotPlan) -> int:
    """Push blocks of plan p an H100 SM holds at once: by threads (2048),
    registers (PILOT_PUSH_REGS a thread of the 64 K), shared memory
    (SMEM_PER_SM, 1 KB reserved a block) and the 32-block limit."""
    return min(32, 2048 // p.threads, 65536 // (PILOT_PUSH_REGS * p.threads),
               SMEM_PER_SM // (p.smem_bytes + 1024))


@functools.lru_cache(maxsize=None)
def _push_plan(antennas: int, f: int, frames: int) -> PilotPlan:
    """The push form's plan (``pilot_plan``): blocks of PILOT_PUSH_BLOCK
    threads (one team where a team is more), as many as the rows need up to
    PILOT_PUSH_MAX_CLUSTER; where 16 such blocks do not hold every row, the
    largest blocks (up to PILOT_PUSH_THREADS) whose launch of ``frames``
    frames the card still holds at once (``pilot_blocks_per_sm``), else the
    largest: one 64 x 2048 pilot is 16 blocks of 4 one-row teams, a capture
    of 20 is 16 blocks of one team of 4 rows a frame (320 blocks, 3 an SM)
    where 16 of 4 teams (one an SM) ran 1.3x the parent form (PERF.md, PR
    20)."""
    t = pilot_team_threads(f)
    base = max(1, PILOT_PUSH_BLOCK // t)
    most = min(PILOT_PUSH_MAX_CLUSTER, -(-antennas // base))
    widest = min(PILOT_PUSH_THREADS // t, max(base, -(-antennas // most)))
    plans = [_pilot_plan(antennas, f, most, teams) for teams in range(widest, base - 1, -1)]
    for p in plans:
        if frames * p.clusters <= H100_SMS * pilot_blocks_per_sm(p):
            return p
    return plans[0]


@functools.lru_cache(maxsize=None)
def _pilot_plan(antennas: int, f: int, most: int, cap: int = 0) -> PilotPlan:
    """``pilot_plan`` with at most ``most`` blocks a cluster and ``cap``
    teams a block (0: the kernel's thread cap): csrc/pilot_ls.cu checks a
    plan by the same rules."""
    t = pilot_team_threads(f)
    cap = cap or pilot_max_threads(f) // t
    clusters = most
    teams = min(cap, -(-antennas // clusters))
    clusters = min(clusters, -(-antennas // teams))   # every block a row
    rows = -(-antennas // (clusters * teams))
    teams = -(-antennas // (clusters * rows))          # no team slot left idle per row
    return PilotPlan(clusters, teams, rows, teams * t, pilot_smem_bytes(f, teams, clusters))


def split_pilot_clusters(antennas: int, f: int, frames: int = 1) -> int:
    """Most blocks of the split pilot's clusters (F = 16384, 32768): one per
    antenna up to the portable 8, fewer while the launch's frames x n1 / 8
    clusters would hold more than SPLIT_PILOT_THREADS_PER_SM threads on
    each of the card's SMS SMs.  Past that the card places the clusters in waves (a block
    of 4 teams and its 179 registers a thread fills an SM's register file
    to 70%), and every block's chain is the pilot's time
    (``tools/split_compare.py --clusters`` times each bound; PERF.md)."""
    groups = split_factors(f)[0] // SPLIT_K1
    c = min(MAX_CLUSTER, antennas)
    while c > 1:
        p = _pilot_plan(antennas, f, c)
        if frames * groups * p.clusters * p.threads <= SPLIT_PILOT_THREADS_PER_SM * SMS:
            break
        c -= 1
    return c


def pilot_row_rows(antennas: int) -> int:
    """Antenna rows of one PILOT_ROW_FFT cluster: 4, 2 or 1, the largest
    dividing A (the grid's clusters take every row once).  Its blocks of one
    rank add their rows' |h|^2 in distributed shared memory; A / G clusters'
    partials ([K, A / G, F] float32 in the pilot's scratch, where A > G)
    are added by the last of them to count in."""
    return 4 if antennas % 4 == 0 else 2 if antennas % 2 == 0 else 1


def pilot_row_counts(frames: int) -> int:
    """Counts of the PILOT_ROW_FFT pilot's sum, [K, PILOT_ROW_BLOCKS
    PILOT_ROW_MAX_ROWS]: one for each block slot of a cluster."""
    return frames * PILOT_ROW_BLOCKS * PILOT_ROW_MAX_ROWS


def pilot_team_rows(antennas: int, p: PilotPlan, rank: int, team: int) -> range:
    """Antenna rows of team ``team`` of block ``rank``: g, g + C teams, ...
    below A, g = rank * teams + team (the kernel's row loop)."""
    return range(rank * p.teams + team, antennas, p.clusters * p.teams)


def pilot_rank_bins(f: int, clusters: int, rank: int):
    """Bins whose sum over the cluster's blocks rank ``rank`` adds up (from
    the blocks' shared memory) and whose inv it writes: [rank F / C,
    (rank + 1) F / C).  At the split sizes the cluster holds SPLIT_K1 x 128
    bins (``split_pilot_rank_bins``).  At PILOT_ROW_FFT ``rank`` is a
    cluster's block slot 4 i + r (row i, block r): the i-th of the cluster's
    G rows' share of block r's bins (k1 + 64 k2 for k1 in [16 r, 16 r +
    16)), entries e of [i E, (i + 1) E), E = 2048 / G, bin 64 (e // 16) +
    16 r + e % 16, whose sum over the cluster's rows it adds in distributed
    shared memory and, the last of its slot across the clusters, over them
    (``pilot_row_rows``).  In the push form rank r owns the registers [r M
    / C, (r + 1) M / C) of every lane: bins [T (r M / C), T ((r + 1) M /
    C)), which the blocks' slots of the sums hold and whose inv it writes."""
    if f in PILOT_PUSH_SIZES:
        p = pilot_geometry(f)
        return range(p.threads * (rank * p.values // clusters),
                     p.threads * ((rank + 1) * p.values // clusters))
    if f == PILOT_ROW_FFT:   # slot = 4 i + r of the cluster: row i's block r
        n1 = f // SPLIT_N2
        r, i = rank % PILOT_ROW_BLOCKS, rank // PILOT_ROW_BLOCKS
        per = PILOT_ROW_K1 * SPLIT_N2 * PILOT_ROW_BLOCKS // clusters
        e = np.arange(per * i, per * (i + 1))
        return n1 * (e // PILOT_ROW_K1) + PILOT_ROW_K1 * r + e % PILOT_ROW_K1
    return range(rank * f // clusters, (rank + 1) * f // clusters)


def split_pilot_rank_bins(f: int, clusters: int, rank: int, group: int) -> np.ndarray:
    """The bins whose sum rank ``rank`` of the split pilot's cluster for
    bins k1 = SPLIT_K1 group .. SPLIT_K1 group + SPLIT_K1 - 1 adds up and
    writes: entries [rank B / C, (rank + 1) B / C) of the cluster's B =
    SPLIT_K1 x 128 bins, entry i = (k2 = i // SPLIT_K1, k1 = SPLIT_K1 group +
    i % SPLIT_K1), bin k1 + n1 k2 (csrc/pilot_ls.cu pilot_ls_rows_kernel)."""
    n1, n2 = split_factors(f)
    i = np.arange(rank * SPLIT_K1 * n2 // clusters, (rank + 1) * SPLIT_K1 * n2 // clusters)
    return SPLIT_K1 * group + i % SPLIT_K1 + n1 * (i // SPLIT_K1)


# ---------------------------------------------------------------------------
# The split form (csrc/fft_split.cuh, csrc/fft_split.cu)
# ---------------------------------------------------------------------------
#
# F = n1 x 128, x[i1, i2] = x[128 i1 + i2], in two passes through a scratch:
#   1. the column pass: the n1-point DFT over i1 of each column i2 (the
#      register FFT at F = n1, one team a column, ``split_columns`` columns a
#      block of SPLIT_COLUMN_THREADS), times the four-step twiddle
#      exp(-2 pi i k1 i2 / F) (``speed_twiddles``), into the scratch row
#      B[k1][i2] of its antenna;
#   2. the row pass: the 128-point DFT of each B[k1][:] (the register FFT at
#      F = 128, one 8-lane team a row): bin k1 + n1 k2 in register k2 // 8
#      of lane k2 % 8.  A data block takes SPLIT_K1 bins k1 of one symbol
#      and every antenna, over up to SPLIT_TEAMS teams, so its sums over the
#      antennas need no other block; the pilot spreads the antennas of its
#      SPLIT_K1 bins k1 over a cluster (``pilot_plan``,
#      ``split_pilot_rank_bins``).
# The exact kernels run both passes at F = 16384 and 32768 (the exact pilot
# at 8192 too, across a cluster per antenna row: ``pilot_plan``); the speed
# kernels run the column pass at F = 8192 to 32768 and their bf16 stage 2
# in place of the row pass.  The split pilots take the frames in chunks
# (``split_chunk``), each the column pass then the row pass on one scratch
# [2, chunk, A, F].  The data kernels (fft_mrc, mrc_demod; the bf16
# fft_mrc_bf16) run both passes in one persistent launch whose tiles (a
# column tile: one column-pass block's columns of one antenna row; a row
# tile: SPLIT_K1 bins k1 of one symbol, the bf16 kernel's SPEED_RING_K1)
# are taken by ticket in the order of ``ring_ticket`` and meet in a ring of
# ``split_ring`` symbol slots, [2, slots, A, F], that L2 holds.

SPLIT_FFT_SIZES = (16384, 32768)           # the exact kernels' two-pass sizes
SPEED_SPLIT_SIZES = (8192, 16384, 32768)   # the speed kernels' (n1 = 64 to 256)
SPLIT_N2 = 128
SPLIT_K1 = 8                 # bins k1 of an exact row-pass block
SPLIT_TEAMS = 4              # antenna teams of an exact row-pass block, at most
SPLIT_COLUMN_THREADS = 256   # threads of a column-pass block
SPLIT_SCRATCH_BYTES = 512 << 20  # a chunk's scratch: at most this much, one symbol at least
SPLIT_RING_BYTES = 40 << 20      # the data kernels' ring: its share of the H100's 50 MB L2
SPLIT_RING_MIN_SLOTS = 8         # slots the share must hold for the ring to stay in L2
SPEED_RING_L2_ANTENNAS = 16      # the bf16 ring stays in L2 up to this many antennas
SPLIT_RING_BLOCKS = 2            # ring-kernel blocks an SM (__launch_bounds__)
SPLIT_RING_LAG_BLOCKS = 2.0      # the lag's ticket distance, in blocks of the grid
H100_SMS = 132


def split_factors(f: int) -> Tuple[int, int]:
    """(n1, n2) = (F / 128, 128) of the split form; raises for an F that
    neither the exact nor the speed kernels split."""
    if f not in SPLIT_FFT_SIZES + SPEED_SPLIT_SIZES:
        raise ValueError(f"no split form for F={f}; sizes {SPEED_SPLIT_SIZES}")
    return f // SPLIT_N2, SPLIT_N2


def split_columns(n1: int) -> int:
    """Columns i2 of one column-pass block: a team of the n1-point register
    FFT each (32 at n1 = 64 and 128, 16 at 256)."""
    return SPLIT_COLUMN_THREADS // plan(n1).threads


def split_column_stride(n1: int) -> int:
    """Floats of a column's buffer in the column pass: the register FFT's two
    planes and one more (a warp's 32 samples in one run of 32 columns: an
    odd stride) or two (two runs of 16: twice an odd number), so that the
    transposes into and out of the columns spread over the 32 banks."""
    return 2 * plane_floats(n1) + (1 if split_columns(n1) >= 32 else 2)


def split_column_smem_bytes(n1: int) -> int:
    return 4 * split_columns(n1) * split_column_stride(n1)


def split_teams(antennas: int) -> int:
    """Antenna teams of an exact row-pass block of the data kernels."""
    return min(SPLIT_TEAMS, antennas)


def split_smem_bytes(teams: int) -> int:
    """Dynamic shared memory of an exact row-pass block: each team's
    SPLIT_K1 8-lane row teams, two row buffers each (``team_floats(128)``);
    the sums over the antennas reuse the first buffers."""
    return 4 * teams * SPLIT_K1 * team_floats(SPLIT_N2)


@profiling.counts(profiling.TABLE)
def split_tables_np(f: int, int16: bool = False) -> np.ndarray:
    """[n, 2] float32 (cos, sin): the pass twiddles of the n1-point column
    FFT, those of the 128-point row FFT, then the [n1, 128] four-step
    twiddles (``speed_twiddles_np``, the sc16 scale folded in for the speed
    kernels' int16 rows).  csrc/fft_split.cuh splits the table by the
    sizes of the first two."""
    n1, n2 = split_factors(f)
    tw = speed_twiddles_np(f, int16).reshape(-1)
    four = np.stack([tw.real, tw.imag], axis=-1).astype(np.float32)
    return np.concatenate([pass_twiddles_np(n1), pass_twiddles_np(n2), four])


@functools.lru_cache(maxsize=None)
def split_tables(f: int, int16: bool, device: torch.device) -> torch.Tensor:
    """``split_tables_np`` on the device."""
    return torch.from_numpy(split_tables_np(f, int16)).to(device)


def split_chunk(items: int, antennas: int, f: int) -> int:
    """Frames of one chunk of the split pilots' chunked form: as many as a
    scratch of SPLIT_SCRATCH_BYTES holds, at least one, no more than there
    are.  With the passes as two launches a chunk, fewer, larger launches
    beat a scratch small enough for L2: a 16 x 32768 frame in chunks of 8
    symbols (a 32 MB scratch) took 1.24x the time of one chunk of 100 on an
    H100, the card draining between the launches (PERF.md, the split form).
    The data kernels keep theirs in L2 without that cost: one launch,
    ``split_ring``."""
    return max(1, min(items, SPLIT_SCRATCH_BYTES // (antennas * f * 8)))


def split_ring_tiles(antennas: int, f: int, k1: int = SPLIT_K1) -> Tuple[int, int]:
    """(column tiles, row tiles) of one symbol in the data kernels' ring:
    A x 128 / C column groups (``split_columns``), n1 / k1 bin groups (k1
    bins k1 a row tile: the exact kernels' SPLIT_K1 = 8, the bf16 kernel's
    SPEED_RING_K1 = 32; csrc/fft_split.cuh ring_row_tiles)."""
    n1, n2 = split_factors(f)
    return antennas * (n2 // split_columns(n1)), n1 // k1


def split_ring_bytes_per_value(k1: int) -> int:
    """Bytes of a ring value: float32 for the exact kernels' rings (k1 =
    SPLIT_K1), bf16 for the bf16 kernel's (its column tiles round B to bf16
    as they store it, the rounding its stage 2 takes anyway)."""
    return 4 if k1 == SPLIT_K1 else 2


def split_ring(items: int, antennas: int, f: int, sms: int = H100_SMS,
               k1: int = SPLIT_K1) -> Tuple[int, int]:
    """(slots R, lag L) of the data kernels' ring over ``items`` symbols of
    A rows at F with row tiles of ``k1`` bins k1 (csrc/fft_split.cuh
    ring_loop: the exact fft_mrc and mrc_demod at F = 16384 and 32768,
    k1 = SPLIT_K1; the bf16 fft_mrc_bf16 at 8192 to 32768, SPEED_RING_K1).

    Where SPLIT_RING_BYTES holds SPLIT_RING_MIN_SLOTS [2, A, F] symbol
    slots or more (float32, ``split_ring_bytes_per_value``; 16 antennas: 10
    at 32768, 20 at 16384; the bf16 ring's 20 / 40 / 80 at 32768 / 16384 /
    8192), R is as many as it holds and the ring stays in L2; L is the steps
    between a symbol's column tiles and its row tiles, enough tickets
    (ring_ticket) for SPLIT_RING_LAG_BLOCKS times the grid
    (SPLIT_RING_BLOCKS an SM of ``sms``) that a row tile seldom waits for its
    columns, at most R // 2 so that a column tile as seldom waits for its
    slot.  Where it holds fewer (64 antennas: 2 at 32768, 5 at 16384), a row
    tile's 16 rows a team outlast the few steps a slot has: 2 slots measured
    4.1x the two-launch form's time at 64 x 32768 on an H100, 8 slots at lag
    1 still 1.4x, the row tiles waiting for their columns (PERF.md).  There
    the ring takes as many slots as the chunked form's SPLIT_SCRATCH_BYTES
    and leaves L2 for device memory, with L = R // 2.  The bf16 row tile
    (k1 = SPEED_RING_K1) takes its antennas one after another on one
    warpgroup, so it holds its slot for A antenna products: past
    SPEED_RING_L2_ANTENNAS antennas (64 x 8192: 20 slots in the share) it
    takes the device-memory ring too.  R is never more than there are
    symbols, L at least 1; the kernel needs L <= items and, where a slot is
    reused (items > R), L < R: its C entry refuses any other pair."""
    slot = 2 * antennas * f * split_ring_bytes_per_value(k1)
    in_l2 = SPLIT_RING_BYTES // slot >= SPLIT_RING_MIN_SLOTS and (
        k1 == SPLIT_K1 or antennas <= SPEED_RING_L2_ANTENNAS)
    if in_l2:
        slots = max(1, min(items, SPLIT_RING_BYTES // slot))
        ct, rt = split_ring_tiles(antennas, f, k1)
        want = math.ceil(SPLIT_RING_LAG_BLOCKS * SPLIT_RING_BLOCKS * sms / (ct + rt))
        return slots, max(1, min(want, slots // 2))
    slots = max(1, min(items, SPLIT_SCRATCH_BYTES // slot))
    return slots, max(1, slots // 2)


def ring_ticket(t: int, items: int, lag: int, ct: int, rt: int) -> Tuple[bool, int, int]:
    """Ticket t of the ring -> (column tile?, symbol, tile index), as
    csrc/fft_split.cuh ring_ticket: steps [0, L) hold the ct column tiles
    of symbol step, steps [L, items) those and then the rt row tiles of
    symbol step - L, steps [items, items + L) the row tiles of symbol
    step - L; items (ct + rt) tickets in all."""
    head = lag * ct
    if t < head:
        return True, t // ct, t % ct
    t -= head
    both = (items - lag) * (ct + rt)
    if t < both:
        step, r = lag + t // (ct + rt), t % (ct + rt)
        return (True, step, r) if r < ct else (False, step - lag, r - ct)
    t -= both
    return False, items - lag + t // rt, t % rt


def split_ring_smem_bytes(f: int) -> int:
    """Dynamic shared memory of a ring-kernel block at F: the row pass's
    buffers of SPLIT_TEAMS antenna teams (``split_smem_bytes``), each team's
    estimate slice (SPLIT_K1 x 128 complex float32), the row tile's SPLIT_K1
    x 128 float32 gains and the pass twiddles of both FFTs (the first two
    parts of ``split_tables``, float32 pairs); a column tile takes
    ``split_column_smem_bytes`` of it."""
    n1, n2 = split_factors(f)
    twiddles = len(pass_twiddles_np(n1)) + len(pass_twiddles_np(n2))
    return (split_smem_bytes(SPLIT_TEAMS) + 4 * SPLIT_TEAMS * 2 * SPLIT_K1 * SPLIT_N2
            + 4 * SPLIT_K1 * SPLIT_N2 + 8 * twiddles)


# ---------------------------------------------------------------------------
# The exact data kernels at F = 8192, spread over the card (csrc/fft_spread.cuh)
# ---------------------------------------------------------------------------
#
# A launch of N = K S A antenna rows (row g = item A + a, symbol item = k S +
# s) runs on B = min(SMs, ceil(N / SPREAD_MIN_ROWS)) blocks; block b takes
# the rows [b N / B, (b + 1) N / B) (``spread_block_rows``) in order on the
# register FFT's team at 8192, adding Y conj(h) into its sums in registers.
# A symbol whose rows lie in one block is stored by it; the others' blocks
# (``spread_symbol_blocks``) each write a partial into slot
# ``spread_partial_slot`` of the scratch [B, 2, F, 2] and count in, and the
# last to count (which skips its own partial when it finds the others
# counted) adds the partials in block order and stores.

SPREAD_FFT = 8192
SPREAD_MIN_ROWS = 4       # rows a block, at least: fewer partials a symbol where rows are few
SPREAD_POWERS = (1, 2, 4, 8)   # the last pass's table rows in shared memory


class SpreadPlan(NamedTuple):
    blocks: int      # B (spread_plan: one block an SM, at most one for each SPREAD_MIN_ROWS rows)
    threads: int     # threads of a block (spread_plan: the register FFT's team at 8192, 256)
    smem_bytes: int  # dynamic shared memory of a block


def spread_smem_bytes() -> int:
    """Dynamic shared memory of a spread block (csrc/fft_spread.cuh
    kSmemBytes): the second pass's twiddles (pass_twiddles's first block),
    the last pass's rows SPREAD_POWERS (Ns entries each), two row buffers
    (two planes of ``plane_floats`` each), a four-byte flag padded to 16."""
    p = plan(SPREAD_FFT)
    ns = tw1 = p.radices[0] * p.radices[1]
    return 4 * (2 * (tw1 + len(SPREAD_POWERS) * ns) + 2 * 2 * plane_floats(SPREAD_FFT) + 4)


def spread_plan(items: int, antennas: int, sms: int = H100_SMS) -> SpreadPlan:
    """Launch geometry of the spread data kernels over ``items`` symbols of
    A antenna rows at F = 8192 on a card of ``sms`` SMs: one block an SM,
    no block with fewer than SPREAD_MIN_ROWS rows where there are rows
    enough (a streamed symbol of 16 rows is 4 blocks of 4, whose last adds
    4 partials, not 16 blocks of one).  The C entries check it against
    their own rule (csrc/fft_spread.cuh plan_ok, with the device's SMs).
    Raises for an empty launch."""
    if items < 1 or antennas < 1 or sms < 1:
        raise ValueError(f"spread_plan: {items} symbols, {antennas} antennas, {sms} SMs")
    rows = items * antennas
    blocks = min(sms, -(-rows // SPREAD_MIN_ROWS))
    return SpreadPlan(blocks, plan(SPREAD_FFT).threads, spread_smem_bytes())


def spread_block_rows(rows: int, blocks: int, b: int) -> range:
    """Rows of block b: [b N / B, (b + 1) N / B) (block_lo)."""
    return range(rows * b // blocks, rows * (b + 1) // blocks)


def spread_row_block(rows: int, blocks: int, g: int) -> int:
    """The block that takes row g (csrc/fft_spread.cuh block_of)."""
    return ((g + 1) * blocks - 1) // rows


def spread_symbol_blocks(item: int, antennas: int, rows: int, blocks: int) -> range:
    """The blocks that take rows of symbol ``item``, in the order their
    partials are added."""
    return range(spread_row_block(rows, blocks, item * antennas),
                 spread_row_block(rows, blocks, item * antennas + antennas - 1) + 1)


def spread_partial_slot(item: int, antennas: int, rows: int, blocks: int, b: int) -> int:
    """Slot of block b's partial of symbol ``item`` in the scratch: 0 for the
    block's first symbol, 1 for its last (a block holds part of at most two
    symbols, its first and its last)."""
    return 0 if item == spread_block_rows(rows, blocks, b).start // antennas else 1


# ---------------------------------------------------------------------------
# The exact data kernels at F = 256, 512, 2048, 4096: each symbol's antenna
# rows side by side over the card (csrc/fft_side.cuh)
# ---------------------------------------------------------------------------
#
# A launch of N = K S A antenna rows runs on B = min(blocks an SM x SMs,
# ceil(N / teams)) blocks of ``side_teams`` teams (``side_plan``); team u of
# the U = B teams takes the rows [u N / U, (u + 1) N / U) (``side_team_rows``)
# in order on the side form's register FFT (``side_geometry``: 16 values a
# thread), adding Y conj(h) into its sums in registers.  A symbol whose rows
# lie in one team is stored by it; otherwise each of its teams keeps a
# partial (the team's last symbol in shared memory, its first in the team's
# slot 2 + t of the scratch [B, 2 + teams, F, 2]) and the block adds them in
# team order; a symbol that also spans blocks is handed in as at F = 8192
# (the block's partial in slot ``spread_partial_slot``, a count per symbol,
# the last block to count adds the partials in block order).

# F -> (radices, threads per block, blocks an SM, exchange padding stride);
# csrc/fft_side.cuh's OFDM_SIDE_PLAN lines hold the same table.  The padding
# is 32 where a team is a warp or more (a warp's 32 consecutive positions in
# one run of the exchange), M = 16 where it is half a warp.
SIDE_PLANS = {
    256: ((16, 16), 256, 2, 16),
    512: ((16, 16, 2), 512, 1, 32),
    2048: ((16, 16, 8), 512, 1, 32),
    4096: ((16, 16, 16), 512, 1, 32),
}
SIDE_FFT_SIZES = tuple(SIDE_PLANS)


def side_geometry(f: int) -> Plan:
    """The side form's register FFT at F as a ``Plan`` (one team a row, its
    teams_per_symbol 1): the helpers above take it as ``p``."""
    if f not in SIDE_PLANS:
        raise ValueError(f"no side form for F={f}; sizes {SIDE_FFT_SIZES}")
    radices, block, min_blocks, pad = SIDE_PLANS[f]
    assert math.prod(radices) == f and max(radices) == radices[0] == 16
    return Plan(f, radices, radices[0], f // radices[0], 1, block, min_blocks, pad)


def side_teams(f: int) -> int:
    """Teams of a side block: its threads over the T of a row."""
    p = side_geometry(f)
    return p.block // p.threads


def side_twiddles_np(f: int) -> np.ndarray:
    """``pass_twiddles_np`` of the side form's radices."""
    return pass_twiddles_np(f, side_geometry(f))


@functools.lru_cache(maxsize=None)
def side_twiddles(f: int, device: torch.device) -> torch.Tensor:
    """``side_twiddles_np`` on the device: the table the side kernels read."""
    return torch.from_numpy(side_twiddles_np(f)).to(device)


def side_smem_bytes(f: int) -> int:
    """Dynamic shared memory of a side block (csrc/fft_side.cuh kSmemBytes):
    the pass twiddles, each team's two row buffers (``team_floats``), a
    four-byte flag padded to 16, the block's teams + 1 team boundaries
    (int32) padded to 16, then four int32 for each boundary (the symbol it
    splits, its first and last team, its count)."""
    p = side_geometry(f)
    teams = side_teams(f)
    return 4 * (2 * len(side_twiddles_np(f)) + teams * team_floats(f, p) + 4
                + -(-(teams + 1) // 4) * 4 + 4 * (teams + 1))


def side_slots(f: int) -> int:
    """Partials of a side block in the scratch: its first and last symbol's,
    then each team's first symbol's."""
    return 2 + side_teams(f)


def side_plan(items: int, antennas: int, f: int, sms: int = H100_SMS) -> SpreadPlan:
    """Launch geometry of the side data kernels over ``items`` symbols of A
    antenna rows at F on a card of ``sms`` SMs.  The fullest grid has as
    many blocks as the card holds at once (``SIDE_PLANS``' blocks an SM), no
    more than one for each ``side_teams`` rows, so that a team takes one row
    where the card has teams for every row and otherwise as few in sequence
    as the card allows.  Of the grids whose teams' chain of rows is at most
    one row longer, the one with the most blocks that each take whole
    symbols (B divides ``items``) is taken, since a symbol split over blocks
    costs its blocks ~1.5 rows of finish (``tools/spread_trace.py``,
    PERF.md): one 16 x F x 100 frame is 100 blocks of one symbol at 256,
    512, 2048 (4 rows a team, as on 132 blocks) and 4096 (8, where 132
    blocks would give 7); a streamed symbol is one block at 256 and 512, 4
    at 2048 and 8 at 4096, one row a team.  The C entries check it against
    their own rule (csrc/fft_side.cuh plan_ok, with the device's SMs).
    Raises for an empty launch."""
    if items < 1 or antennas < 1 or sms < 1:
        raise ValueError(f"side_plan: {items} symbols, {antennas} antennas, {sms} SMs")
    p = side_geometry(f)
    rows, teams = items * antennas, side_teams(f)
    full = min(p.min_blocks * sms, -(-rows // teams))
    chain = -(-rows // (full * teams))
    blocks = full
    for b in range(full, 0, -1):
        if -(-rows // (b * teams)) > chain + 1:
            break
        if items % b == 0:
            blocks = b
            break
    return SpreadPlan(blocks, p.block, side_smem_bytes(f))


def side_team_rows(rows: int, teams: int, u: int) -> range:
    """Rows of team u of the launch's U = B x teams: [u N / U, (u + 1) N / U)
    (csrc/fft_side.cuh team_lo); block b's are those of its teams."""
    return range(rows * u // teams, rows * (u + 1) // teams)


# ---------------------------------------------------------------------------
# The speed mode's plan (csrc/fft_mrc_bf16.cu, csrc/wgmma.cuh)
# ---------------------------------------------------------------------------
#
# The bf16 speed mode (exact=False) transforms a row of F = n1 x 128 samples
# in four steps, x[i1, i2] = x[128 i1 + i2]: the n1-point DFT over i1 in
# float32, the twiddle exp(-2 pi i i2 k1 / F) in float32 (1/32767 folded in
# for int16 rows), B rounded to bf16, then C = B W on the tensor cores with
# W[i2, k2] = exp(-2 pi i i2 k2 / 128) in bf16 and float32 accumulation;
# bin n1 k2 + k1 = C[k1, k2].  The kernels run stage 2 as wgmma.m64n256k16
# on chunks of 32 "complex rows" r = a n1 + k1 (antenna a, k1 < n1) of a
# symbol: complex row q = r % 32 of chunk r // 32 holds its real part in
# tile row 16 (q // 8) + q % 8 and its imaginary part 8 rows below, so the
# accumulator fragment of a thread holds Br W and Bi W of one (a, k1) and
# forms C's two parts in registers.  The tile and the B operand (256 rows
# of W, ``speed_w_row``; W is symmetric, row n is column n) are K-major bf16
# in shared memory with the 128-byte swizzle (``speed_swizzle``).  Stage 2
# runs as four wgmma.m64n64k16 products, quarter Q against B rows 64 Q ..
# 64 Q + 63 (k2 = 32 Q .. 32 Q + 31 of Wr, then of Wi), two in flight, so
# that a quarter's epilogue runs while the next multiplies.  A symbol's
# chunks are spread over a cluster of ``speed_cluster`` blocks.
#
# From n1 = 64 (F = 8192) a thread's column of n1 values no longer fits the
# chunk's registers: stage 1 is the split form's column pass (exact float32),
# and stage 2 takes SPEED_ROWS_K1 bins k1 of one symbol, a chunk of 32
# complex rows of each antenna in turn (row r = a n1 + k1, so chunk c is
# still rows 32 c .. 32 c + 31).  The data path runs both as one persistent
# launch on the exact kernels' ring (``split_ring`` with SPEED_RING_K1-bin
# row tiles, ``speed_ring_smem_bytes``): the column tiles store B rounded to
# bf16 into the slot, a row tile takes two antennas' 16 rows k1 a chunk by
# TMA into the swizzled tile while the last pair multiplies, and each of
# its two warpgroups (SPEED_ROWS_THREADS threads) multiplies two quarters
# and sums over the antennas in its registers, so it needs no cluster; the
# pilot runs the column pass into a
# scratch and spreads the antennas over a cluster of ``speed_cluster`` blocks (rank r
# takes antennas r, r + CL, ..., its two warpgroups in turn, a tile each),
# adds sum |h|^2 over it in distributed
# shared memory (``speed_pilot_rank_bins``) and copies W once a cluster, by
# a TMA multicast of its shared-memory image (``speed_w_image``).

SPEED_FFT_SIZES = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768)   # n1 = F / 128, 2 to 256
SPEED_N2 = 128
SPEED_CHUNK_ROWS = 32       # complex rows of a chunk: one m64 tile, re over im per 8
SPEED_TILE_ROWS = 64        # bf16 rows of the tile
SPEED_W_ROWS = 256          # rows of the B operand: Wr then Wi
SPEED_PART_STRIDE = 132     # floats a row of the pilot's h staging (padded)
SPEED_QUARTERS = 4          # stage 2 in four products of 32 bins k2
SPEED_DATA_CLUSTER = 2      # blocks a data symbol is spread over, at most
SPEED_PILOT_CLUSTER = 8     # blocks a pilot is spread over, at most
SPEED_THREADS = {False: 384, True: 256}  # data / pilot: warpgroup 0 the product, the rest stage 1
SPEED_ROWS_THREADS = 128    # n1 >= 64: the data path's math warpgroup (its fragments' bins)
SPEED_PILOT_ROWS_THREADS = 256  # n1 >= 64, the pilot: two warpgroups, antennas in turn
SPEED_ROWS_K1 = 32          # n1 >= 64: bins k1 of a block, one chunk of each antenna
SPEED_RING_K1 = 16          # the bf16 ring's row tile: bins k1, two antennas a chunk (kRingK1)
SPEED_SBO = 1024            # bytes between 8-row groups of a SW128 K-major operand


def speed_split(f: int) -> Tuple[int, int]:
    """(n1, n2) = (F / 128, 128) of the speed mode; raises for an F its
    kernels do not instantiate."""
    if f not in SPEED_FFT_SIZES:
        raise ValueError(f"the bf16 speed mode covers F in {SPEED_FFT_SIZES}, got {f}")
    return f // SPEED_N2, SPEED_N2


@profiling.counts(profiling.TABLE)
def speed_twiddles_np(f: int, int16: bool = False) -> np.ndarray:
    """[n1, 128] complex64 stage-1 twiddles exp(-2 pi i k1 i2 / F), computed
    in float64 and cast to complex64; for int16 rows divided by 32767 in
    complex64 (the JAX package's ``_twiddle`` and its sc16 fold,
    ``pallas_pipeline.py:833-838``)."""
    from ..golden.io import SC16_FULL_SCALE

    n1, n2 = speed_split(f)
    k1 = np.arange(n1)[:, None]
    i2 = np.arange(n2)[None, :]
    tw = np.exp(-2j * np.pi * k1 * i2 / f).astype(np.complex64)
    return tw / SC16_FULL_SCALE if int16 else tw


@profiling.counts(profiling.TABLE)
def speed_w_np() -> np.ndarray:
    """[128, 256] float32 [Wr | Wi] of exp(-2 pi i j k / 128), computed in
    float64 and cast to float32 (``pallas_pipeline._stage2_consts``); the
    kernels take it rounded to bf16 (``speed_w``)."""
    k = np.arange(SPEED_N2)
    ang = -2.0 * np.pi * np.outer(k, k) / SPEED_N2
    return np.concatenate([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def speed_w(device: torch.device) -> torch.Tensor:
    """``speed_w_np`` rounded to bf16 (torch rounds to nearest even, as
    ml_dtypes does) on the device: the table the kernels stage in shared
    memory and the plain versions multiply by."""
    return torch.from_numpy(speed_w_np()).to(torch.bfloat16).to(device)


@functools.lru_cache(maxsize=None)
def speed_twiddles(f: int, int16: bool, device: torch.device) -> torch.Tensor:
    """``speed_twiddles_np`` as [n1, 128, 2] float32 (re, im) on the device."""
    tw = speed_twiddles_np(f, int16)
    return torch.from_numpy(np.stack([tw.real, tw.imag], axis=-1)).to(device)


def speed_chunks(antennas: int, f: int) -> int:
    """Chunks of one symbol: A n1 complex rows, 32 a chunk, the last one
    padded."""
    n1, _ = speed_split(f)
    return -(-antennas * n1 // SPEED_CHUNK_ROWS)


def speed_cluster(antennas: int, f: int, pilot: bool, items: int = 1) -> int:
    """Blocks of the cluster a symbol (the pilot: a frame) is spread over:
    its chunks, at most 2 for the data path and 8 for the pilot, and no
    more than leaves every one of ``items`` symbols its cluster on the
    card's SMS SMs (fft_mrc_bf16.cu launch, which applies this rule with
    the device's count of SMs).  From F = 8192 the data path's row pass
    takes no cluster, and the pilot's (``pilot_rows_kernel``) one block an
    antenna up to 8, for each of the frame's n1 / 32 groups of bins k1: no
    more than leaves every block of the ``items`` frames an SM.  That
    cluster is the launch's: ``estimate_pilot_fused`` passes it to the
    kernel, which checks it, as it does ``pilot_plan``."""
    most = SPEED_PILOT_CLUSTER if pilot else SPEED_DATA_CLUSTER
    per = 1   # clusters of one item
    if f in SPEED_SPLIT_SIZES:
        if not pilot:
            return 1
        cl, per = min(antennas, most), speed_split(f)[0] // SPEED_ROWS_K1
    else:
        cl = min(speed_chunks(antennas, f), most)
    while cl > 1 and items * per * cl > SMS:
        cl -= 1
    return cl


def speed_pilot_rank_bins(f: int, clusters: int, rank: int, group: int) -> np.ndarray:
    """From F = 8192: the bins whose sum |h|^2 rank ``rank`` of the pilot's
    cluster for bins k1 = 32 group + q adds up over the cluster and writes
    (1 / sum): entries [rank B / CL, (rank + 1) B / CL) of the cluster's
    B = 32 x 128 bins, entry i = (k2 = i // 32, q = i % 32), bin
    n1 k2 + 32 group + q (csrc/fft_mrc_bf16.cu pilot_rows_kernel)."""
    n1, n2 = speed_split(f)
    i = np.arange(rank * SPEED_ROWS_K1 * n2 // clusters,
                  (rank + 1) * SPEED_ROWS_K1 * n2 // clusters)
    return n1 * (i // SPEED_ROWS_K1) + SPEED_ROWS_K1 * group + i % SPEED_ROWS_K1


def speed_tile_row(q: int, plane: int) -> int:
    """Tile row of plane 0 (real) or 1 (imaginary) of complex row q of a chunk."""
    return 16 * (q // 8) + q % 8 + 8 * plane


def speed_chunk_rows(antennas: int, f: int) -> np.ndarray:
    """[chunks, 64, 3] int: (antenna, k1, plane) of each row of each chunk's
    m64 tile, -1 for a padding row.  Complex row q of chunk c is r = 32 c +
    q, a = r // n1, k1 = r % n1; csrc/fft_mrc_bf16.cu computes the same map."""
    n1, _ = speed_split(f)
    chunks = speed_chunks(antennas, f)
    out = np.full((chunks, SPEED_TILE_ROWS, 3), -1, np.int64)
    for c in range(chunks):
        for q in range(SPEED_CHUNK_ROWS):
            r = SPEED_CHUNK_ROWS * c + q
            if r // n1 < antennas:
                for plane in (0, 1):
                    out[c, speed_tile_row(q, plane)] = (r // n1, r % n1, plane)
    return out


def speed_w_row(n: int) -> Tuple[int, int]:
    """(W row, plane) of row n of the B operand: quarter Q = n // 64 holds
    Wr's rows 32 Q .. 32 Q + 31 (plane 0), then Wi's (plane 1)."""
    return 32 * (n // 64) + n % 32, (n // 32) % 2


def speed_swizzle(rows: int, m: int, k: int) -> int:
    """Byte offset of element (row m, column k) of a K-major bf16 operand of
    ``rows`` rows and K = 128 in the 128-byte-swizzled layout: two K halves
    of 128-byte rows, the 16-byte piece XORed with m mod 8 (wgmma.cuh
    sw128_offset)."""
    return (k // 64) * rows * 128 + m * 128 + ((((k % 64) // 8) ^ (m % 8)) << 4) + (k % 8) * 2


@profiling.counts(profiling.TABLE)
def speed_w_image_np() -> np.ndarray:
    """[32768] float32: the B operand as the kernels lay it out in shared
    memory (``speed_swizzle`` of operand row n, column k holds W[row, 128
    plane + k], (row, plane) = ``speed_w_row(n)``), element i at byte 2 i;
    the pilot's row pass (F >= 8192) copies it into every block of a cluster
    by one TMA multicast, byte for byte (``speed_w_image``)."""
    n, k = np.meshgrid(np.arange(SPEED_W_ROWS), np.arange(SPEED_N2), indexing="ij")
    row, plane = speed_w_row(n)
    img = np.empty(SPEED_W_ROWS * SPEED_N2, np.float32)
    img[speed_swizzle(SPEED_W_ROWS, n, k) // 2] = speed_w_np()[row, SPEED_N2 * plane + k]
    return img


@functools.lru_cache(maxsize=None)
def speed_w_image(device: torch.device) -> torch.Tensor:
    """``speed_w_image_np`` rounded to bf16 as ``speed_w`` rounds W (the same
    values, laid out as the shared-memory operand) on the device."""
    return torch.from_numpy(speed_w_image_np()).to(torch.bfloat16).to(device)


def speed_smem_bytes(f: int, pilot: bool) -> int:
    """Dynamic shared memory of a speed kernel's block (fft_mrc_bf16.cu
    Smem): W and two tiles; the data path's two row stages and two h
    stages (32 KB each), or the pilot's h staging ([32][132] x 2 planes) and
    X with 1/|X|^2; 10 barrier slots; 1 KB of alignment slack.  From
    F = 8192 the data path's ring block (``speed_ring_smem_bytes``); the
    pilot's row pass: W, two tiles (two warpgroups), 1 KB of slack, X /
    |X|^2 of its 32 x 128 bins (two planes of 128 rows of 32 + 4 floats), a
    row stage for each warpgroup (32 KB) and the barrier of W's multicast
    (16 bytes)."""
    if f in SPEED_SPLIT_SIZES and not pilot:
        return speed_ring_smem_bytes(f)
    if f in SPEED_SPLIT_SIZES:
        tile = SPEED_TILE_ROWS * SPEED_N2 * 2
        stages = 2 * 2 * SPEED_CHUNK_ROWS * SPEED_N2 * 4
        return (SPEED_W_ROWS * SPEED_N2 * 2 + 2 * tile + 1024
                + 2 * SPEED_N2 * (SPEED_ROWS_K1 + 4) * 4 + stages + 16)
    base = SPEED_W_ROWS * SPEED_N2 * 2 + 2 * SPEED_TILE_ROWS * SPEED_N2 * 2
    stage = 2 * SPEED_CHUNK_ROWS * SPEED_N2 * 4
    mid = 2 * SPEED_CHUNK_ROWS * SPEED_PART_STRIDE * 4 + 12 * f if pilot else 4 * stage
    return base + mid + 10 * 8 + 1024


def speed_ring_smem_bytes(f: int) -> int:
    """Dynamic shared memory of a bf16 ring block at F = 8192 to 32768
    (csrc/fft_mrc_bf16.cu RingSmem): the column tile's buffers
    (``split_column_smem_bytes``) overlaid on the row tile's two bf16 tiles,
    rounded up to the 1 KB swizzle atom; W's image (64 KB); the pass
    twiddles of both FFTs (as ``split_ring_smem_bytes``); five barriers
    (full, empty, W in); 1 KB of alignment slack."""
    n1, n2 = speed_split(f)
    tiles = 2 * SPEED_TILE_ROWS * SPEED_N2 * 2
    region = -(-max(split_column_smem_bytes(n1), tiles) // 1024) * 1024
    twiddles = len(pass_twiddles_np(n1)) + len(pass_twiddles_np(n2))
    return region + SPEED_W_ROWS * SPEED_N2 * 2 + 8 * twiddles + 5 * 8 + 1024
