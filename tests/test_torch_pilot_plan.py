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

At F = 64, 128, 256, 512, 2048 and 4096 (fft_plan.PILOT_PUSH_SIZES) the
kernel is the push form instead: one row a team where the card has teams
for every row, C blocks a frame (no cluster where one block holds every
row, up to 16 past the portable 8), the twiddles in shared memory, and each
team's sums pushed into its slot of the shared memory of the rank that owns
the bins, which adds the C x teams slots in slot order.  Its plan, the
source's rules and a NumPy mirror of its arithmetic (its factorization,
pilot_geometry; the table it copies, pilot_twiddles_np; the sum's order)
are held below against estimate_pilot_plain, the JAX estimate_pilot_fused in
interpret mode (F >= 256) and the golden estimate (64, 128) within TOL =
5e-5 (tests/test_torch_pipeline.py's bound: both sides are float32 FFTs of
other factorizations, the sum taken in another order).

At F = 8192 (fft_plan.PILOT_ROW_FFT) the kernel takes 4 blocks per antenna
row instead, F = 64 x 128 split across them, in clusters of up to 4 rows,
and the sum over the antennas is a tree: the cluster's rows through
distributed shared memory, then the clusters' partials through a count
per frame and block slot, each level added in a fixed order.  Its plan,
its coverage of columns, rows and bins, the sum's single owner whatever
the order the blocks count in, and a numpy mirror of
the kernel's arithmetic (the register FFTs at 64 and 128 on the package's
tables) against estimate_pilot_plain and the JAX kernel in interpret mode
within TOL = 5e-5 (tests/test_torch_pipeline.py's bound) are checked below.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_ls_mrc_tpu.golden import dsp as jdsp
from ofdm_ls_mrc_tpu.golden.io import plane_to_sc16
from ofdm_ls_mrc_tpu.ops import fastpath as jfastpath
from ofdm_ls_mrc_tpu.ops import pallas_pipeline as jpp
from ofdm_ls_mrc_tpu.ops.cplx import CArray as JCArray
from ofdm_ls_mrc_tpu_torch import convert
from ofdm_ls_mrc_tpu_torch.ops import fft_plan as fp
from ofdm_ls_mrc_tpu_torch.ops import ls as tls
from ofdm_ls_mrc_tpu_torch.ops import pipeline as pipe
from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray
from test_torch_fft_plan import emulate
from test_torch_large_fft import column_twiddles

SIZES = fp.PILOT_FFT_SIZES
ANTENNAS = range(1, 65)
SMEM_PER_BLOCK = 232448   # H100: 227 KB opt-in per block
SOURCE = Path(fp.__file__).resolve().parent.parent / "csrc" / "pilot_ls.cu"
ROW_F = fp.PILOT_ROW_FFT
PUSH = fp.PILOT_PUSH_SIZES
PUSH_ANTENNAS = (1, 3, 4, 5, 16, 64)
TOL = 5e-5


def max_rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def emulate_sum(abs2: np.ndarray, p: fp.PilotPlan) -> np.ndarray:
    """sum_a |h|^2 [F] from |h|^2 [A, F] as the kernel forms it, in
    float32: per-team partials over the team's rows, the block's sum over
    its teams, then each rank's share of the bins summed over the C
    blocks (F = 1024); in the push form (``push_sum``) every team's partial
    added in slot order by the bins' owner."""
    a, f = abs2.shape
    abs2 = abs2.astype(np.float32)
    if f in PUSH:
        return push_sum(abs2, p)[0]
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


def row_cluster_cover(p: fp.PilotPlan):
    """At PILOT_ROW_FFT, how often each of a row's 128 columns and each of
    its F bins is taken by its PILOT_ROW_BLOCKS blocks (block r: the columns
    of the column pass's block, from 32 r, and the bins of its
    PILOT_ROW_K1 rows k1 16 r ..), and how often each bin's sum is written
    by the cluster's block slots (pilot_rank_bins)."""
    n1 = ROW_F // fp.SPLIT_N2
    c = fp.split_columns(n1)
    cols, bins, sums = np.zeros(fp.SPLIT_N2, int), np.zeros(ROW_F, int), np.zeros(ROW_F, int)
    for r in range(fp.PILOT_ROW_BLOCKS):
        cols[c * r:c * (r + 1)] += 1
        k1 = fp.PILOT_ROW_K1 * r + np.arange(fp.PILOT_ROW_K1)
        bins[(k1[None, :] + n1 * np.arange(fp.SPLIT_N2)[:, None]).ravel()] += 1
    for slot in range(p.clusters):
        sums[np.asarray(fp.pilot_rank_bins(ROW_F, p.clusters, slot))] += 1
    return cols, bins, sums


@pytest.mark.parametrize("f", SIZES)
def test_plan_covers_each_row_once(f):
    """Every antenna row is one (rank, team, step) of the plan, and no team
    holds more than the plan's rows.  At PILOT_ROW_FFT a row's blocks take
    each of its columns and bins once, and a cluster's block slots own each
    bin's sum once."""
    for a in ANTENNAS:
        p = fp.pilot_plan(a, f)
        if f == ROW_F:
            cols, bins, sums = row_cluster_cover(p)
            assert np.all(cols == 1) and np.all(bins == 1) and np.all(sums == 1), (a, p)
            continue
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


@pytest.mark.parametrize("k", [1, 20])
@pytest.mark.parametrize("a", [1, 3, 16, 64])
def test_row_cluster_plan_spreads_every_row(a, k):
    """F = 8192: PILOT_ROW_BLOCKS blocks per antenna row and frame (grid (4
    A, K)) in clusters of pilot_row_rows rows (4, 2 or 1, dividing A), so a
    16 x 8192 pilot takes 64 SMs, no block more than a 64-point column FFT a
    column and a 128-point FFT a row k1; the kernel's geometry and its check
    of the plan agree with fft_plan."""
    p = fp.pilot_plan(a, ROW_F, k)
    g = fp.pilot_row_rows(a)
    assert a % g == 0 and g == (4 if a % 4 == 0 else 2 if a % 2 == 0 else 1)
    assert p == fp.PilotPlan(fp.PILOT_ROW_BLOCKS * g, 1, 1, fp.SPLIT_COLUMN_THREADS,
                             fp.pilot_smem_bytes(ROW_F, 1))
    assert p.clusters <= fp.PILOT_ROW_BLOCKS * fp.PILOT_ROW_MAX_ROWS == 16
    n1 = ROW_F // fp.SPLIT_N2
    assert fp.split_columns(n1) * fp.PILOT_ROW_BLOCKS == fp.SPLIT_N2
    assert fp.PILOT_ROW_K1 * fp.PILOT_ROW_BLOCKS == n1
    assert fp.PILOT_ROW_K1 * fp.plan(fp.SPLIT_N2).threads <= p.threads
    assert 2 * (p.smem_bytes + 1024) <= 233472   # two blocks an SM
    if (a, k) == (16, 1):
        assert a * fp.PILOT_ROW_BLOCKS == 64 and p.clusters == 16
    src = SOURCE.read_text()
    assert f"constexpr int kRowBlocks = {fp.PILOT_ROW_BLOCKS};" in src
    assert f"constexpr int kRowN1 = {n1};" in src
    assert f"constexpr int kRowMaxRows = {fp.PILOT_ROW_MAX_ROWS};" in src
    assert "constexpr int kRowK1 = kRowN1 / kRowBlocks;" in src
    assert "return A % 4 == 0 ? 4 : A % 2 == 0 ? 2 : 1;" in src          # pilot_row_rows
    assert "cfg.gridDim = dim3(kRowBlocks * A, K);" in src
    assert "attr[0].val.clusterDim.x = row_rows(A) * kRowBlocks;" in src
    assert "clusters != ofdm::row_rows(A) * ofdm::kRowBlocks ||" in src
    assert ("return split::column_smem_bytes<kRowN1>() +\n"
            "         static_cast<size_t>(kRowK1) * split::RowGeo::kTeamFloats * sizeof(float) +\n"
            "         static_cast<size_t>(kRowBins) * sizeof(float);" in src)


def row_sum_by_counts(abs2: np.ndarray, order) -> tuple:
    """The F = 8192 pilot's sum over the antennas, emulated for one frame:
    each cluster of G = pilot_row_rows rows adds its rows' float32 |h|^2 in
    row order (each of its block slots a G-th of a rank's bins,
    pilot_rank_bins) into its partial (with one cluster, the sum); the
    clusters count in per slot in ``order`` (a list of clusters), and the
    one that completes a slot's count adds the partials of its bins in
    cluster order and sets the count back to 0.  Returns (the sums, how
    often each bin was written, the counts left)."""
    a, f = abs2.shape
    abs2 = abs2.astype(np.float32)
    g = fp.pilot_row_rows(a)
    clusters, slots = a // g, fp.PILOT_ROW_BLOCKS * g
    out, written = np.full(f, np.nan, np.float32), np.zeros(f, int)
    counts = np.zeros(fp.pilot_row_counts(1), int)
    partials = np.full((clusters, f), np.nan, np.float32)
    for c in range(clusters):
        for slot in range(slots):
            bins = np.asarray(fp.pilot_rank_bins(f, slots, slot))
            s = np.zeros(len(bins), np.float32)
            for row in range(g * c, g * (c + 1)):
                s += abs2[row, bins]
            partials[c, bins] = s
    for slot in range(slots):
        bins = np.asarray(fp.pilot_rank_bins(f, slots, slot))
        if clusters == 1:
            out[bins], written[bins] = partials[0, bins], written[bins] + 1
            continue
        for c in order:
            counts[slot] += 1
            if counts[slot] < clusters:
                continue
            counts[slot] = 0
            s = np.zeros(len(bins), np.float32)
            for c2 in range(clusters):
                s += partials[c2, bins]
            out[bins], written[bins] = s, written[bins] + 1
    return out, written, counts


@pytest.mark.parametrize("a", [1, 5, 16, 64])
def test_row_cluster_sum_has_one_owner_in_any_order(a):
    """Every bin's sum is written once, by the block of its slot that
    completes the count of the clusters, the same float32 bits whatever
    order the clusters finish in (no float atomics), within 1e-6 of the
    plain version's, and every count is left at 0 for the next launch on
    the stream."""
    rng = np.random.default_rng(a)
    z = 0.1 * (rng.standard_normal((a, ROW_F)) + 1j * rng.standard_normal((a, ROW_F)))
    x = tls.pad_pilot(np.exp(2j * np.pi * rng.random(ROW_F - 1)).astype(np.complex64), "cpu")
    h, inv = pipe.estimate_pilot_plain(CArray.from_numpy(z.astype(np.complex64), "cpu"), x)
    abs2 = h.abs2().numpy()
    first = None
    clusters = a // fp.pilot_row_rows(a)
    for seed in range(3):
        got, written, counts = row_sum_by_counts(
            abs2, np.random.default_rng(seed).permutation(clusters))
        assert np.all(written == 1) and np.all(counts == 0)
        if first is None:
            first = got
        np.testing.assert_array_equal(got, first)
    assert max_rel(first, 1 / inv.numpy()) < 1e-6


def row_cluster_mirror(re_: np.ndarray, im_: np.ndarray, x_full: CArray, scale: float):
    """csrc/pilot_ls.cu pilot_ls_row_kernel on one frame [A, 8192] in
    complex64: block r of row a runs the 64-point register FFT of its 32
    columns and the four-step twiddle (column_twiddles, the recurrence),
    then the 128-point register FFT of its 16 rows k1, each gathered from
    the row's four blocks, and h = Y conj(X) scale / |X|^2 at bins k1 + 64
    k2; the sum as row_sum_by_counts.  Returns (h [A, F] complex64, the sum
    [F] float32, how often each (antenna, bin) was written)."""
    a, f = re_.shape
    n1 = f // fp.SPLIT_N2
    c = fp.split_columns(n1)
    tw = column_twiddles(f)
    xr, xi = x_full.re.numpy(), x_full.im.numpy()
    den = (np.float32(scale) / (xr * xr + xi * xi)).astype(np.float32)
    h = np.full((a, f), np.nan, np.complex64)
    written = np.zeros((a, f), int)
    for ant in range(a):
        x = (re_[ant].astype(np.float32) + 1j * im_[ant].astype(np.float32)).astype(
            np.complex64).reshape(n1, fp.SPLIT_N2)
        cols = np.empty((n1, fp.SPLIT_N2), np.complex64)   # the row's column buffers
        for r in range(fp.PILOT_ROW_BLOCKS):
            for i2 in range(c * r, c * (r + 1)):
                cols[:, i2] = emulate(x[:, i2]) * tw[:, i2]
        for r in range(fp.PILOT_ROW_BLOCKS):
            for k1 in range(fp.PILOT_ROW_K1 * r, fp.PILOT_ROW_K1 * (r + 1)):
                y = emulate(cols[k1])
                bins = k1 + n1 * np.arange(fp.SPLIT_N2)
                hv = y * (xr[bins] - 1j * xi[bins]).astype(np.complex64) * den[bins]
                h[ant, bins] = hv.astype(np.complex64)
                written[ant, bins] += 1
    hr, hi = h.real.astype(np.float32), h.imag.astype(np.float32)
    sums, _, _ = row_sum_by_counts(hr * hr + hi * hi, range(a // fp.pilot_row_rows(a)))
    return h, sums, written


@pytest.mark.parametrize("a,dtype", [(3, "f32"), (2, "int16")])
def test_row_cluster_mirror_matches_plain_and_jax(a, dtype):
    """The F = 8192 pilot's mirror against estimate_pilot_plain and the JAX
    estimate_pilot_fused (Pallas, interpret mode) within TOL = 5e-5: h and
    sum |h|^2, float32 and sc16 rows (the scale in h, as the kernel takes
    it)."""
    rng = np.random.default_rng(a)
    z = 0.1 * (rng.standard_normal((a, ROW_F)) + 1j * rng.standard_normal((a, ROW_F)))
    if dtype == "int16":
        re_, im_ = plane_to_sc16(z.real), plane_to_sc16(z.imag)
    else:
        re_, im_ = z.real.astype(np.float32), z.imag.astype(np.float32)
    pilot = np.exp(2j * np.pi * rng.random(ROW_F - 1)).astype(np.complex64)
    x_full = tls.pad_pilot(pilot, "cpu")
    rows = CArray(torch.from_numpy(re_), torch.from_numpy(im_))
    h, sums, written = row_cluster_mirror(re_, im_, x_full, pipe._scale(rows))
    assert np.all(written == 1) and np.all(np.isfinite(h)) and np.all(np.isfinite(sums))
    h_p, inv_p = pipe.estimate_pilot_plain(rows, x_full)
    assert max_rel(h, h_p.to_numpy()) < TOL
    assert max_rel(sums, 1 / inv_p.numpy()) < TOL
    x_perm = jfastpath.prepare_pilot_fast(pilot, ROW_F)
    h3, inv3 = jpp.estimate_pilot_fused(JCArray(jnp.asarray(re_), jnp.asarray(im_)), x_perm,
                                        interpret=True)
    want_h, want_inv = convert.estimate_from_reference(np.asarray(h3.re), np.asarray(h3.im),
                                                       np.asarray(inv3), device="cpu")
    assert max_rel(h, want_h.to_numpy()) < TOL
    assert max_rel(sums, 1 / want_inv.numpy()) < TOL


@pytest.mark.parametrize("f", SIZES)
def test_plan_fits_the_card(f):
    """A portable cluster (at most 8 blocks; at PILOT_ROW_FFT and in the
    push form up to 16, the H100's most with the non-portable size
    allowed), the kernel's thread cap, the rows a team needs and no more,
    and shared memory within a block's 227 KB whose regions that take
    16-byte copies (the team buffers, X) start 16-byte aligned."""
    t = fp.pilot_team_threads(f)
    # The split sizes' teams are the row pass's 8-lane teams of 128 bins.
    team_f = fp.SPLIT_N2 if f in fp.SPLIT_FFT_SIZES else f
    push = f in fp.PILOT_PUSH_SIZES
    for a in ANTENNAS:
        p = fp.pilot_plan(a, f)
        assert p.threads == p.teams * t <= fp.pilot_max_threads(f) <= 1024
        assert p.smem_bytes == fp.pilot_smem_bytes(f, p.teams, p.clusters) <= SMEM_PER_BLOCK
        if f == ROW_F:   # blocks of a row in a cluster of rows: one block's share of one row
            assert p.rows == p.teams == 1 and 4 <= p.clusters <= 16
            assert p.clusters == fp.PILOT_ROW_BLOCKS * fp.pilot_row_rows(a)
            assert fp.split_column_smem_bytes(f // fp.SPLIT_N2) % 16 == 0
            continue
        most = fp.PILOT_PUSH_MAX_CLUSTER if push else fp.MAX_CLUSTER
        assert 1 <= p.clusters <= most == (16 if push else 8)
        assert p.rows == -(-a // (p.clusters * p.teams))
        assert p.smem_bytes == fp.pilot_smem_bytes(f, p.teams, p.clusters)
        assert p.smem_bytes <= SMEM_PER_BLOCK
        tf = (fp.team_floats(f, fp.pilot_geometry(f), 1) if push else fp.team_floats(team_f))
        assert tf % 4 == 0 and (p.teams * tf) % 4 == 0
        assert p.clusters * p.teams * p.rows < a + p.clusters * p.rows  # < 1 idle team a block


@pytest.mark.parametrize("a,f,want", [
    (16, 1024, (4, 4, 1)),   # the main path: 16 one-warp teams on 4 SMs
    (64, 1024, (8, 4, 2)),   # 8 blocks x 4 teams x 2 rows
    (1, 1024, (1, 1, 1)),
    (1, 4096, (1, 1, 1)),
    (16, 4096, (16, 1, 1)),  # the push form: one team of eight warps a block
    (16, 256, (2, 8, 1)),    # teams of 16 lanes, eight a block
    (1, 64, (1, 1, 1)),      # the 64-subcarrier configs: teams of 8 lanes
    (4, 64, (1, 4, 1)),
    (16, 64, (1, 16, 1)),    # sixteen teams a block, four a warp
    (64, 64, (4, 16, 1)),    # a cluster of 4, 16 bins a rank
    (3, 128, (1, 3, 1)),
    (64, 128, (4, 16, 1)),
    (16, 8192, (16, 1, 1)),  # 4 blocks per antenna row, 4 rows a cluster: 64 blocks
    (1, 8192, (4, 1, 1)),
    (64, 8192, (16, 1, 1)),
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
    assert "return 2 * wfft::Geo<F>::T > 128 ? 2 * wfft::Geo<F>::T : 128;" in src
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


@pytest.mark.parametrize("a", [5, 16, 64])
def test_emulated_split_at_1024_matches_plain(a):
    """F = 1024's cluster (pilot_ls_kernel): the teams' sums added into the
    block's, then each rank's bins over the C blocks, within 1e-6 of the
    plain version's sum."""
    f = 1024
    rng = np.random.default_rng(a)
    z = 0.1 * (rng.standard_normal((a, f)) + 1j * rng.standard_normal((a, f)))
    pilot = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
    h, inv = pipe.estimate_pilot_plain(CArray.from_numpy(z.astype(np.complex64), "cpu"),
                                       tls.pad_pilot(pilot, "cpu"))
    got = emulate_sum(h.abs2().numpy(), fp.pilot_plan(a, f))
    assert np.all(np.isfinite(got)) and max_rel(got, 1 / inv.numpy()) < 1e-6


@pytest.mark.parametrize("a,k", [(1, 1), (4, 1), (16, 1), (64, 1), (16, 20), (6, 3)])
def test_row_cluster_wrapper_hands_the_kernel_its_buffers(monkeypatch, a, k):
    """estimate_pilot_fused at F = 8192 on a recording library: the plan
    (4 G, 1, 1), the split table, the partials [K, A / G, F] where there is
    more than one cluster of rows (else none), and a zeroed count buffer of
    at least pilot_row_counts entries, the same buffer for the next call on
    the stream."""
    import contextlib

    from ofdm_ls_mrc_tpu_torch.kernels import build

    calls = []

    class Lib:
        def ofdm_pilot_ls(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(pipe, "_device_route", lambda x, name: True)
    monkeypatch.setattr(build, "load_library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: type("S", (), {
        "cuda_stream": 12345})())
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(pipe, "_pilot_counts", {})
    seen = []
    real_empty = torch.empty

    def empty(*args, **kwargs):
        t = real_empty(*args, **kwargs)
        seen.append(t)
        return t

    monkeypatch.setattr(torch, "empty", empty)
    rows = CArray(torch.zeros((k, a, ROW_F)), torch.zeros((k, a, ROW_F)))
    x = tls.pad_pilot(np.ones(ROW_F - 1, np.complex64), "cpu")
    for _ in range(2):
        pipe.estimate_pilot_fused(rows, x)
    (args, again) = calls
    p = fp.pilot_plan(a, ROW_F, k)
    assert args[10:14] == (p.clusters, p.teams, p.rows, p.smem_bytes)
    assert args[16] == fp.split_tables(ROW_F, False, torch.device("cpu")).data_ptr()
    counts = pipe._pilot_counts[(None, 12345)]
    assert counts.dtype == torch.int32 and counts.numel() >= fp.pilot_row_counts(k)
    assert not counts.any() and args[23] == again[23] == counts.data_ptr()
    clusters = a // fp.pilot_row_rows(a)
    if clusters > 1:
        part = next(t for t in seen if t.data_ptr() == args[21])
        assert tuple(part.shape) == (k, clusters, ROW_F) and part.dtype == torch.float32
    else:
        assert args[21] is None


# ---------------------------------------------------------------------------
# The push form (F = 64, 128, 256, 512, 2048, 4096)
# ---------------------------------------------------------------------------

def push_sum(abs2: np.ndarray, p: fp.PilotPlan):
    """The push form's sum over the antennas of one frame, float32: team g
    = rank teams + team adds its rows' |h|^2 in row order from 0; each
    block adds its teams' sums in team order; with one block that is the
    sum, else block b writes its partial of bin t = j + T m into slot b of
    rank o(m) = ((m + 1) C - 1) // M (position t - T (o M // C)), and rank
    r adds the C slots of its bins [T (r M // C), T ((r + 1) M // C)) in rank
    order.  Returns (the sums [F], how often each bin was written, how often
    each (rank, slot, position) was written)."""
    a, f = abs2.shape
    geo = fp.pilot_geometry(f)
    t, m_vals, c = geo.threads, geo.values, p.clusters
    width = fp.pilot_sums_width(f, c)
    recv = np.full((c, c, width), np.nan, np.float32)
    filled = np.zeros((c, c, width), int)
    bins = np.arange(f)
    owner = ((bins // t + 1) * c - 1) // m_vals
    pos = bins - t * (owner * m_vals // c)
    partial = np.zeros((c, f), np.float32)
    for rank in range(c):
        for team in range(p.teams):
            acc = np.zeros(f, np.float32)
            for row in fp.pilot_team_rows(a, p, rank, team):
                acc = (acc + abs2[row]).astype(np.float32)
            partial[rank] = (partial[rank] + acc).astype(np.float32)
        recv[owner, rank, pos] = partial[rank]
        filled[owner, rank, pos] += 1
    out = np.full(f, np.nan, np.float32)
    written = np.zeros(f, int)
    for rank in range(c):
        own = np.asarray(fp.pilot_rank_bins(f, c, rank))
        s = np.zeros(len(own), np.float32)
        for b in range(c):
            s = (s + recv[rank, b, :len(own)]).astype(np.float32)
        out[own] = s
        written[own] += 1
    return out, written, filled


def emulate_push_rows(x: np.ndarray) -> np.ndarray:
    """The push form's FFT of rows x [n, F], complex64, on its plan
    (``pilot_geometry``) and the table it copies into shared memory
    (``pilot_twiddles_np``): thread j of a team holds positions j + T m in
    register m; each pass runs its butterflies b = j + T q (twiddle, R-point
    DFT) and writes all but the last into the exchange plane at
    ``exchange_slot``; bin j + T m from register m (``lane_bins``)."""
    f = x.shape[-1]
    p = fp.pilot_geometry(f)
    m_vals, t = p.values, p.threads
    tab = fp.pilot_twiddles_np(f)
    tab = (tab[:, 0] + 1j * tab[:, 1]).astype(np.complex64)
    pos = np.arange(t)[:, None] + t * np.arange(m_vals)[None, :]
    regs = x.astype(np.complex64)[:, pos]                   # [n, T, M]
    plane = np.full((x.shape[0], fp.plane_floats(f, p)), np.nan, np.complex64)
    passes = list(zip(p.radices, fp.strides(f, p)))
    off = 0
    for k, (radix, ns) in enumerate(passes):
        if k > 0:
            regs = plane[:, fp.exchange_slot(f, pos, p)]
        q_count = m_vals // radix
        for q in range(q_count):
            b = np.arange(t) + t * q
            slots = q + q_count * np.arange(radix)
            v = regs[:, :, slots]
            if k > 0:
                v = (v * tab[off + np.arange(radix)[None, :] * ns + (b % ns)[:, None]]).astype(
                    np.complex64)
            k_ = np.arange(radix)
            dft = np.exp(-2j * np.pi * np.outer(k_, k_) / radix).astype(np.complex64)
            regs[:, :, slots] = v @ dft.T
        if k > 0:
            off += radix * ns
        if k + 1 < len(passes):
            b = (np.arange(t)[:, None] + t * np.arange(q_count)[None, :]).reshape(-1)
            dst = ((b // ns) * ns * radix + b % ns)[:, None] + ns * np.arange(radix)[None, :]
            vals = np.stack([regs[:, :, q + q_count * np.arange(radix)]
                             for q in range(q_count)], 2)
            plane[:, fp.exchange_slot(f, dst, p)] = vals.reshape(x.shape[0], -1, radix)
    out = np.full(x.shape, np.nan, np.complex64)
    out[:, fp.lane_bins(f, p)] = regs
    return out


def push_mirror(re_: np.ndarray, im_: np.ndarray, x_full: CArray, scale: float):
    """csrc/pilot_ls.cu pilot_ls_push_kernel on K frames [K, A, F] in
    numpy: each row's FFT (``emulate_push_rows``), h = Y conj(X) scale /
    |X|^2 in float32 as the kernel forms it (den = scale / |X|^2, then the
    products), the sum as ``push_sum``.  Returns (h [K, A, F] complex64,
    the sums [K, F] float32, how often each (frame, bin) was written, and
    each slot position)."""
    k_, a, f = re_.shape
    p = fp.pilot_plan(a, f, k_)
    y = emulate_push_rows((re_.astype(np.float32) + 1j * im_.astype(np.float32)).astype(
        np.complex64).reshape(-1, f)).reshape(k_, a, f)
    xr, xi = x_full.re.numpy(), x_full.im.numpy()
    den = (np.float32(scale) / (xr * xr + xi * xi)).astype(np.float32)
    vr, vi = y.real.astype(np.float32), y.imag.astype(np.float32)
    hr = ((vr * xr + vi * xi) * den).astype(np.float32)
    hi = ((vi * xr - vr * xi) * den).astype(np.float32)
    sums = np.empty((k_, f), np.float32)
    written = np.zeros((k_, f), int)
    filled = []
    for k in range(k_):
        sums[k], written[k], fl = push_sum(hr[k] * hr[k] + hi[k] * hi[k], p)
        filled.append(fl)
    return (hr + 1j * hi).astype(np.complex64), sums, written, filled


def push_rows(rng, shape, dtype):
    z = 0.1 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    if dtype == "int16":
        return plane_to_sc16(z.real), plane_to_sc16(z.imag)
    return z.real.astype(np.float32), z.imag.astype(np.float32)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("a", PUSH_ANTENNAS)
@pytest.mark.parametrize("f", PUSH)
def test_push_plan_covers_rows_and_bins_and_fits(f, a, k):
    """The push plan: every antenna row is one (rank, team, step), a row
    for every block and no team more than the plan's rows; each bin's sum
    has one owner and each owner's slots are written once by the teams;
    the block within PILOT_PUSH_THREADS threads and 227 KB of shared memory
    (its 16-byte regions aligned), a cluster of at most 16, one row a team
    where 16 blocks of the cap have teams for every row."""
    p = fp.pilot_plan(a, f, k)
    geo = fp.pilot_geometry(f)
    assert p.threads == p.teams * geo.threads <= fp.PILOT_PUSH_THREADS == fp.pilot_max_threads(f)
    assert 1 <= p.clusters <= fp.PILOT_PUSH_MAX_CLUSTER == 16
    assert p.smem_bytes == fp.pilot_smem_bytes(f, p.teams, p.clusters) <= SMEM_PER_BLOCK
    assert (2 * len(fp.pilot_twiddles_np(f))) % 4 == 0 and fp.team_floats(f, geo, 1) % 4 == 0
    assert p.rows == -(-a // (p.clusters * p.teams))
    assert p.clusters * p.teams * p.rows < a + p.clusters * p.rows   # < 1 idle team a block
    base = max(1, fp.PILOT_PUSH_BLOCK // geo.threads)   # teams of a 128-thread block
    cap = fp.PILOT_PUSH_THREADS // geo.threads
    if a <= fp.PILOT_PUSH_MAX_CLUSTER * base:   # one row a team, at most 4 warps a block
        assert p.rows == 1 and p.threads <= max(fp.PILOT_PUSH_BLOCK, geo.threads)
    else:                                       # 16 blocks, larger ones, rows as few as they allow
        assert p.clusters == 16 and p.rows == -(-a // (16 * cap))
    assert (p.clusters == 1) == (a <= base)     # one block where it holds every row
    seen = {}
    for rank in range(p.clusters):
        for team in range(p.teams):
            rows = fp.pilot_team_rows(a, p, rank, team)
            assert len(rows) <= p.rows
            for step, row in enumerate(rows):
                assert row not in seen
                seen[row] = (rank, team, step)
    assert sorted(seen) == list(range(a))
    assert {r for r, _, _ in seen.values()} == set(range(p.clusters))
    abs2 = np.random.default_rng(a).random((a, f)).astype(np.float32)
    _, written, filled = push_sum(abs2, p)
    assert np.all(written == 1)
    for rank in range(p.clusters):   # each block's slot of the owner's bins written once
        n = len(fp.pilot_rank_bins(f, p.clusters, rank))
        assert np.all(filled[rank][:, :n] == 1) and not filled[rank][:, n:].any()
        assert n % 4 == 0 and fp.pilot_rank_bins(f, p.clusters, rank).start % 4 == 0


def test_push_plan_shapes():
    """The main shapes: one block where it holds every row, else the
    antennas over as many blocks as the rows need."""
    want = {(4, 64): (1, 4, 1), (4, 128): (1, 4, 1), (16, 64): (1, 16, 1),
            (16, 256): (2, 8, 1), (16, 512): (4, 4, 1), (16, 2048): (16, 1, 1),
            (16, 4096): (16, 1, 1), (64, 64): (4, 16, 1), (64, 256): (8, 8, 1),
            (64, 512): (16, 4, 1), (64, 2048): (16, 4, 1), (64, 4096): (16, 2, 2)}
    for (a, f), shape in want.items():
        assert fp.pilot_plan(a, f)[:3] == shape, (a, f)


@pytest.mark.parametrize("a,f,k,shape", [
    (64, 2048, 1, (16, 4, 1)),    # one frame: 16 blocks of 4 one-row teams
    (64, 2048, 3, (16, 4, 1)),    # 48 blocks of one an SM: still one wave
    (64, 2048, 20, (16, 1, 4)),   # 320 blocks: one team of 4 rows, 3 blocks an SM
    (64, 4096, 20, (16, 2, 2)),   # no plan fits one wave: the widest blocks
    (16, 4096, 20, (16, 1, 1)),
    (64, 512, 20, (16, 4, 1)),
])
def test_push_plan_keeps_a_capture_on_the_card(a, f, k, shape):
    """Blocks larger than PILOT_PUSH_BLOCK only where the card holds the
    launch's K x C blocks at once (pilot_blocks_per_sm on 132 SMs); where no
    block size does, the largest (the fewest rows a team)."""
    p = fp.pilot_plan(a, f, k)
    assert p[:3] == shape
    fits = k * p.clusters <= fp.H100_SMS * fp.pilot_blocks_per_sm(p)
    widest = fp._push_plan(a, f, 1)
    assert fits or p == widest


def test_push_rules_match_the_kernel_source():
    """The rules the push plan shares with csrc/pilot_ls.cu: the block and
    cluster caps, the row plan of each F, the owner of a register, a rank's
    registers, the slot width and the shared memory the kernel checks the
    plan's bytes against; F = 1024 stays on pilot_ls_kernel."""
    src = SOURCE.read_text()
    assert f"constexpr int kPushMaxThreads = {fp.PILOT_PUSH_THREADS};" in src
    assert f"constexpr int kPushMaxCluster = {fp.PILOT_PUSH_MAX_CLUSTER};" in src
    for f in PUSH:
        side = f in fp.SIDE_PLANS
        assert fp.pilot_geometry(f) == (fp.side_geometry(f) if side else fp.plan(f))
        if side:
            assert (f"struct PushPlanOf<{f}> {{\n  using type = wfft::SidePlan<{f}>;" in src)
        assert f"OFDM_PILOT_CASE({f}, launch_push)" in src
    assert "OFDM_PILOT_CASE(1024, launch_pilot)" in src
    assert "using type = wfft::Plan<F>;" in src
    assert "static_cast<unsigned>((t / TT + 1) * C - 1) / M" in src
    assert "rank * width + t - TT * (o * M / C);" in src
    assert "const int m0 = rank * M / C, m1 = (rank + 1) * M / C;" in src
    assert "return T * ((M + clusters - 1) / clusters);" in src
    assert "const int g = rank * teams + team.id;" in src
    assert ("return static_cast<size_t>(kTwFloats + 2 * F + teams * kTeamFloats +\n"
            "                               (clusters > 1 ? clusters * width(clusters) : 0)) *"
            ) in src
    assert "static constexpr int kNeed = 2 * G::kPlane;" in src
    # the block's teams in team order, then the blocks' slots in rank order
    assert "for (int p = 1; p < teams; ++p) {" in src
    assert "for (int b = 1; b < C; ++b) {" in src


@pytest.mark.parametrize("dtype", ["f32", "int16"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("a", PUSH_ANTENNAS)
@pytest.mark.parametrize("f", PUSH)
def test_push_mirror_matches_plain(f, a, k, dtype):
    """The mirror on K frames of A rows against estimate_pilot_plain within
    TOL: h and sum |h|^2 (and the invert = 0 variant's sum is the same
    numbers), every (frame, bin) written once; at 64 and 128 also against
    the golden estimate (bins 1..F-1: h = conj(hconj), hsqrd)."""
    rng = np.random.default_rng(f + 7 * a + k)
    re_, im_ = push_rows(rng, (k, a, f), dtype)
    pilot = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
    x_full = tls.pad_pilot(pilot, "cpu")
    rows = CArray(torch.from_numpy(re_), torch.from_numpy(im_))
    h, sums, written, _ = push_mirror(re_, im_, x_full, pipe._scale(rows))
    assert np.all(written == 1) and np.all(np.isfinite(h)) and np.all(np.isfinite(sums))
    h_p, inv_p = pipe.estimate_pilot_plain(rows, x_full)
    _, sum_p = pipe.estimate_pilot_plain(rows, x_full, invert=False)
    assert max_rel(h, h_p.to_numpy()) < TOL
    assert max_rel(sums, 1 / inv_p.numpy()) < TOL
    assert max_rel(sums, sum_p.numpy()) < TOL
    if f in fp.SIDE_PLANS:
        return
    scale = np.float32(pipe._scale(rows))
    for fr in range(k):
        y = (re_[fr].astype(np.float32) * scale + 1j * (im_[fr].astype(np.float32) * scale))
        hconj, hsqrd = jdsp.estimate_channel(y.astype(np.complex64), pilot)
        assert max_rel(h[fr][:, 1:], np.conj(hconj)) < TOL
        assert max_rel(sums[fr][1:], hsqrd) < TOL


@pytest.mark.parametrize("a", PUSH_ANTENNAS)
@pytest.mark.parametrize("f", [f for f in PUSH if f in fp.SIDE_PLANS])
def test_push_mirror_matches_jax(f, a):
    """The mirror against the JAX estimate_pilot_fused (Pallas, interpret
    mode; F >= 256) within TOL, h and sum |h|^2 in natural order; int16
    rows at 4 and 16 antennas, f32 at the others (the sc16 scale in h as
    the kernel takes it)."""
    dtype = "int16" if a in (4, 16) else "f32"
    rng = np.random.default_rng(3 * f + a)
    re_, im_ = push_rows(rng, (a, f), dtype)
    pilot = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
    x_full = tls.pad_pilot(pilot, "cpu")
    rows = CArray(torch.from_numpy(re_), torch.from_numpy(im_))
    h, sums, _, _ = push_mirror(re_[None], im_[None], x_full, pipe._scale(rows))
    h3, inv3 = jpp.estimate_pilot_fused(JCArray(jnp.asarray(re_), jnp.asarray(im_)),
                                        jfastpath.prepare_pilot_fast(pilot, f), interpret=True)
    want_h, want_inv = convert.estimate_from_reference(np.asarray(h3.re), np.asarray(h3.im),
                                                       np.asarray(inv3), device="cpu")
    assert max_rel(h[0], want_h.to_numpy()) < TOL
    assert max_rel(sums[0], 1 / want_inv.numpy()) < TOL


def test_push_sum_is_the_same_in_any_order_of_the_teams():
    """The sum's order is fixed by the teams and the ranks, not by when a
    team or block finishes: the float32 sums are bit for bit those of
    adding each block's teams in team order and the blocks in rank order,
    and differ (in the last bits) from adding the blocks in reverse, which
    the kernel never does (no float atomics)."""
    f, a = 4096, 64
    p = fp.pilot_plan(a, f)
    abs2 = (np.random.default_rng(5).random((a, f)) * 10 ** np.random.default_rng(6).uniform(
        -3, 3, (a, 1))).astype(np.float32)
    got, _, _ = push_sum(abs2, p)
    blocks = []
    for rank in range(p.clusters):
        part = np.zeros(f, np.float32)
        for team in range(p.teams):
            acc = np.zeros(f, np.float32)
            for row in fp.pilot_team_rows(a, p, rank, team):
                acc = (acc + abs2[row]).astype(np.float32)
            part = (part + acc).astype(np.float32)
        blocks.append(part)
    fwd = np.zeros(f, np.float32)
    for v in blocks:
        fwd = (fwd + v).astype(np.float32)
    rev = np.zeros(f, np.float32)
    for v in reversed(blocks):
        rev = (rev + v).astype(np.float32)
    np.testing.assert_array_equal(got, fwd)
    assert np.any(got != rev)


@pytest.mark.parametrize("a,f", [(4, 64), (16, 512), (16, 4096), (64, 2048)])
def test_push_wrapper_hands_the_kernel_its_plan_and_table(monkeypatch, a, f):
    """estimate_pilot_fused at a push size on a recording library: the
    plan (clusters, teams, rows, shared memory) of pilot_plan and the
    push form's twiddle table (pilot_twiddles), no scratch and no counts;
    pilot_ls_sum counted for invert = False."""
    import contextlib

    from ofdm_ls_mrc_tpu_torch.kernels import build

    calls = []

    class Lib:
        def ofdm_pilot_ls(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(pipe, "_device_route", lambda x, name: True)
    monkeypatch.setattr(build, "load_library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: type("S", (), {
        "cuda_stream": 12345})())
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(pipe, "launch_counts", {k: 0 for k in pipe.launch_counts})
    rows = CArray(torch.zeros((3, a, f)), torch.zeros((3, a, f)))
    x = tls.pad_pilot(np.ones(f - 1, np.complex64), "cpu")
    pipe.estimate_pilot_fused(rows, x)
    pipe.estimate_pilot_fused(rows, x, invert=False)
    (args, args_sum) = calls
    p = fp.pilot_plan(a, f, 3)
    assert args[10:14] == (p.clusters, p.teams, p.rows, p.smem_bytes)
    assert args[16] == fp.pilot_twiddles(f, torch.device("cpu")).data_ptr()
    assert args[20] == 1 and args_sum[20] == 0
    assert args[21] is None and args[23] is None
    assert pipe.launch_counts["pilot_ls"] == 1 and pipe.launch_counts["pilot_ls_sum"] == 1
