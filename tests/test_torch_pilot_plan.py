"""The pilot kernel's launch geometry (ofdm_ls_mrc_tpu_torch.ops.fft_plan
pilot_plan) and its split of sum_a |h|^2, checked on the CPU.

csrc/pilot_ls.cu runs one thread block cluster per frame: C blocks of a few
register-FFT teams, team g = rank * teams + team taking antenna rows g,
g + C * teams, ...; each team sums |h|^2 over its rows, each block over its
teams, and rank r over the C blocks for its share of the bins.  The CUDA
kernel cannot run here, so the plan's coverage and limits are checked for
every F and A = 1..64, and a numpy emulation of the split (float32, in the
kernel's order) is held within 1e-6 relative to estimate_pilot_plain's sum
and to the JAX estimate_pilot_fused's (Pallas, interpret mode), each on its
own h: float32 sums of the same terms in another order.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_ls_mrc_tpu.ops import fastpath as jfastpath
from ofdm_ls_mrc_tpu.ops import pallas_pipeline as jpp
from ofdm_ls_mrc_tpu.ops.cplx import CArray as JCArray
from ofdm_ls_mrc_tpu_torch.ops import fft_plan as fp
from ofdm_ls_mrc_tpu_torch.ops import ls as tls
from ofdm_ls_mrc_tpu_torch.ops import pipeline as pipe
from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray

SIZES = fp.PILOT_FFT_SIZES
ANTENNAS = range(1, 65)
SMEM_PER_BLOCK = 232448   # H100: 227 KB opt-in per block
SOURCE = Path(fp.__file__).resolve().parent.parent / "csrc" / "pilot_ls.cu"


def max_rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def emulate_sum(abs2: np.ndarray, p: fp.PilotPlan) -> np.ndarray:
    """sum_a |h|^2 [F] from |h|^2 [A, F] as the kernel forms it, in
    float32: per-team partials over the team's rows, the block's sum over
    its teams, then each rank's share of the bins summed over the C
    blocks."""
    a, f = abs2.shape
    abs2 = abs2.astype(np.float32)
    blocks = np.zeros((p.clusters, f), np.float32)
    for rank in range(p.clusters):
        for team in range(p.teams):
            part = np.zeros(f, np.float32)
            for row in fp.pilot_team_rows(a, p, rank, team):
                part += abs2[row]
            blocks[rank] += part
    out = np.full(f, np.nan, np.float32)
    for rank in range(p.clusters):
        bins = np.asarray(fp.pilot_rank_bins(f, p.clusters, rank))
        s = np.zeros(len(bins), np.float32)
        for c in range(p.clusters):
            s += blocks[c, bins]
        out[bins] = s
    return out


@pytest.mark.parametrize("f", SIZES)
def test_plan_covers_each_row_once(f):
    """Every antenna row is one (rank, team, step) of the plan, and no team
    holds more than the plan's rows."""
    for a in ANTENNAS:
        p = fp.pilot_plan(a, f)
        seen = {}
        for rank in range(p.clusters):
            for team in range(p.teams):
                rows = fp.pilot_team_rows(a, p, rank, team)
                assert len(rows) <= p.rows, (a, p)
                for step, row in enumerate(rows):
                    assert row not in seen, (a, p, row)
                    seen[row] = (rank, team, step)
        assert sorted(seen) == list(range(a)), (a, p)
        # No block of the cluster is left without a row.
        assert {r for r, _, _ in seen.values()} == set(range(p.clusters)), (a, p)


@pytest.mark.parametrize("f", SIZES)
def test_each_bin_sum_has_one_owner(f):
    for a in ANTENNAS:
        c = fp.pilot_plan(a, f).clusters
        owners = np.zeros(f, int)
        for rank in range(c):
            owners[np.asarray(fp.pilot_rank_bins(f, c, rank))] += 1
        assert np.all(owners == 1), (a, c)


@pytest.mark.parametrize("f", SIZES)
def test_plan_fits_the_card(f):
    """A portable cluster (at most 8 blocks), the kernel's thread cap, the
    rows a team needs and no more, and shared memory within a block's 227 KB
    whose regions that take 16-byte copies (the team buffers, X) start
    16-byte aligned."""
    t = fp.pilot_team_threads(f)
    # The split sizes' teams are the row pass's 8-lane teams of 128 bins.
    team_f = fp.SPLIT_N2 if f in fp.SPLIT_FFT_SIZES else f
    for a in ANTENNAS:
        p = fp.pilot_plan(a, f)
        assert 1 <= p.clusters <= fp.MAX_CLUSTER == 8
        assert p.threads == p.teams * t <= fp.pilot_max_threads(f) <= 1024
        assert p.rows == -(-a // (p.clusters * p.teams))
        assert p.smem_bytes == fp.pilot_smem_bytes(f, p.teams)
        assert p.smem_bytes <= SMEM_PER_BLOCK
        assert fp.team_floats(team_f) % 4 == 0 and (p.teams * fp.team_floats(team_f)) % 4 == 0
        assert p.clusters * p.teams * p.rows < a + p.clusters * p.rows  # < 1 idle team a block


@pytest.mark.parametrize("a,f,want", [
    (16, 1024, (4, 4, 1)),   # the main path: 16 one-warp teams on 4 SMs
    (64, 1024, (8, 4, 2)),   # 8 blocks x 4 teams x 2 rows
    (1, 1024, (1, 1, 1)),
    (1, 4096, (1, 1, 1)),
    (16, 4096, (8, 2, 1)),   # teams of four warps, two a block
    (16, 256, (2, 8, 1)),    # teams of 16 lanes, eight a block
    (1, 64, (1, 1, 1)),      # the 64-subcarrier configs: teams of 8 lanes
    (4, 64, (1, 4, 1)),
    (16, 64, (1, 16, 1)),    # sixteen teams a block, four a warp
    (64, 64, (4, 16, 1)),    # a cluster of 4, 16 bins a rank
    (3, 128, (1, 3, 1)),
    (64, 128, (4, 16, 1)),
    (16, 8192, (8, 1, 2)),   # one team of 256 threads a block, 2 rows a team
    (1, 8192, (1, 1, 1)),
    (64, 8192, (8, 1, 8)),
    (16, 16384, (8, 2, 1)),  # the split form: 16 clusters of 8 blocks x 2 antenna teams
    (5, 16384, (5, 1, 1)),
    (1, 32768, (1, 1, 1)),
    (16, 32768, (2, 4, 2)),  # 32 clusters of 2 blocks: every block resident at once
    (64, 32768, (2, 4, 8)),
])
def test_plan_shapes(a, f, want):
    assert fp.pilot_plan(a, f)[:3] == want


def test_plan_raises_for_what_the_kernel_cannot_launch():
    for f in (32, 1000, 65536):
        with pytest.raises(ValueError, match="F="):
            fp.pilot_plan(16, f)
    with pytest.raises(ValueError, match="antennas"):
        fp.pilot_plan(0, 1024)


def test_plan_rules_match_the_kernel_source():
    """The rules the plan shares with csrc/pilot_ls.cu: the portable
    cluster size, the thread cap, the row and bin split, and the shared
    memory layout the kernel checks the plan's bytes against."""
    src = SOURCE.read_text()
    assert int(re.search(r"constexpr int kMaxCluster = (\d+);", src).group(1)) == fp.MAX_CLUSTER
    assert ("return 2 * wfft::Geo<F>::T > 256 ? 256 : 2 * wfft::Geo<F>::T > 128 ? "
            "2 * wfft::Geo<F>::T : 128;") in src
    assert "const int g = rank * teams + team.id;" in src
    assert "const int step = C * teams;" in src
    assert "const int lo = rank * F / C, hi = (rank + 1) * F / C;" in src
    assert ("return (static_cast<size_t>(teams) * wfft::Geo<F>::kTeamFloats + 2 * F + "
            "(teams > 1 ? F : 0)) *") in src
    assert "float* const bsum = teams > 1 ? xs + 2 * F : smem;" in src


@pytest.mark.parametrize("a", [1, 5, 16])
def test_emulated_split_matches_plain_and_jax(a):
    f = 256
    rng = np.random.default_rng(a)
    z = 0.1 * (rng.standard_normal((a, f)) + 1j * rng.standard_normal((a, f)))
    re_, im_ = z.real.astype(np.float32), z.imag.astype(np.float32)
    pilot = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
    p = fp.pilot_plan(a, f)

    h, inv = pipe.estimate_pilot_plain(CArray(torch.from_numpy(re_), torch.from_numpy(im_)),
                                       tls.pad_pilot(pilot, "cpu"))
    got = emulate_sum(h.abs2().numpy(), p)
    assert np.all(np.isfinite(got))
    assert max_rel(got, 1 / inv.numpy()) < 1e-6

    # The JAX kernel keeps its bins in a permuted layout; the sum over
    # antennas is per position, so the split applies to it unchanged.
    h3, inv3 = jpp.estimate_pilot_fused(JCArray(jnp.asarray(re_), jnp.asarray(im_)),
                                        jfastpath.prepare_pilot_fast(pilot, f), interpret=True)
    hr, hi = np.asarray(h3.re).reshape(a, f), np.asarray(h3.im).reshape(a, f)
    got = emulate_sum(hr * hr + hi * hi, p)
    assert max_rel(got, 1 / np.asarray(inv3).reshape(f)) < 1e-6
