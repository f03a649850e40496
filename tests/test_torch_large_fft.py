"""The large-F geometry of the fused kernels, F = 8192, 16384 and 32768 (the
FFT sizes of DVB-T2's 8K, 16K and 32K modes), on the CPU.

1. The port's plain versions against the JAX Pallas kernels in interpret
   mode, 2 antennas and 3 symbols a frame, float32 and int16 rows, each JAX
   result computed once per module: ``estimate_pilot_fused`` +
   ``fused_pipeline`` + ``to_reference_order`` within ``TOL`` = 5e-5
   max-rel (tests/test_torch_pipeline.py's bound: the JAX kernels' bf16
   hi/lo dots against plain float32), ``fused_demod`` within ``JAX_TOL`` =
   2e-4 (tests/test_torch_fused_mrc.py's); the speed branch (exact=False) by
   tests/test_torch_speed_mode.py's rule: the JAX kernels took their bf16
   path (their output within -40 dB of their exact one, not equal to it),
   and the port's speed output is at least ``GAP_DB`` = 20 dB closer to the
   JAX speed output than that.  The receivers route 'fused' at these F with
   no warning.
2. The kernels' plans, emulated in numpy on the package's own tables
   (``ops/fft_plan.py``) against ``np.fft``: the register FFT at 8192, the
   split form's two passes (``csrc/fft_split.cuh``) at 8192-32768, the
   column and row passes' index maps, the split pilot's geometry and its
   sum over the antennas, and the speed kernels' row pass (n1 >= 64: the
   wgmma operands and fragments of tests/test_torch_speed_mode.py's mirror,
   a block taking 32 bins k1 over every antenna).  The CUDA kernels run only
   on the card (tests/test_torch_cuda.py, ``chip_smoke.py`` phase 15).
"""

import re
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_ls_mrc_tpu.golden.io import plane_to_sc16
from ofdm_ls_mrc_tpu.ops import fastpath as jfastpath
from ofdm_ls_mrc_tpu.ops import fft as jfft
from ofdm_ls_mrc_tpu.ops import ls as jls
from ofdm_ls_mrc_tpu.ops import pallas_pipeline as jpp
from ofdm_ls_mrc_tpu.ops.cplx import CArray as JCArray
from ofdm_ls_mrc_tpu.ops.pallas_mrc import fused_demod as jax_fused_demod
from ofdm_ls_mrc_tpu_torch import FrameConfig, convert
from ofdm_ls_mrc_tpu_torch.models import StreamingDemodulator, UplinkReceiver
from ofdm_ls_mrc_tpu_torch.models.uplink import speed_mode
from ofdm_ls_mrc_tpu_torch.ops import fft_plan as fp
from ofdm_ls_mrc_tpu_torch.ops import fused_mrc
from ofdm_ls_mrc_tpu_torch.ops import pipeline as pipe
from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray
from ofdm_ls_mrc_tpu_torch.ops.ls import pad_pilot
from test_torch_fft_plan import emulate
from test_torch_speed_mode import (_bf16_bits, chunk_product, fragment, stage1_chunks,
                                   w_operand)

SIZES = (8192, 16384, 32768)
DTYPES = ("f32", "int16")
A, S = 2, 3
TOL = 5e-5
JAX_TOL = 2e-4
GAP_DB = 20.0
CSRC = Path(fp.__file__).resolve().parent.parent / "csrc"


def max_rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def evm_db(got, want):
    return float(10 * np.log10(np.mean(np.abs(got - want) ** 2) / np.mean(np.abs(want) ** 2)))


def make_case(f, dtype, seed=0):
    """Rows [S, A, F] as (re, im) planes (f32, or sc16 int16) and the pilot."""
    rng = np.random.default_rng(seed + f)
    z = 0.1 * (rng.standard_normal((S, A, f)) + 1j * rng.standard_normal((S, A, f)))
    if dtype == "int16":
        re, im = plane_to_sc16(z.real), plane_to_sc16(z.imag)
    else:
        re, im = z.real.astype(np.float32), z.imag.astype(np.float32)
    pilot = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
    return re, im, pilot


def port_rows(f, dtype) -> CArray:
    re, im, _ = make_case(f, dtype)
    return CArray(torch.from_numpy(re), torch.from_numpy(im))


_JAX = {}


def jax_fused(f, dtype):
    """The JAX fused kernels on row 0 (pilot) and rows 1.. (data), interpret
    mode, exact and speed: {exact: (h_re, h_im, inv, out)}, and the permuted
    pilot (cached)."""
    if (f, dtype) not in _JAX:
        re, im, pilot = make_case(f, dtype)
        x_perm = jfastpath.prepare_pilot_fast(pilot, f)
        rows = JCArray(jnp.asarray(re), jnp.asarray(im))
        res = {}
        for exact in (True, False):
            h3, inv3 = jpp.estimate_pilot_fused(rows[0], x_perm, interpret=True, exact=exact)
            eq = jpp.fused_pipeline(rows[1:], h3.re, h3.im, inv3, interpret=True, exact=exact)
            res[exact] = (np.asarray(h3.re), np.asarray(h3.im), np.asarray(inv3),
                          jpp.to_reference_order(eq, f).to_numpy())
        _JAX[f, dtype] = (res, x_perm.to_numpy())
    return _JAX[f, dtype]


_DEMOD = {}


def jax_demod(f):
    """(data [S-1, A, F], hconj, hsqrd from the JAX composed estimate, the
    JAX fused_demod output in interpret mode) (cached)."""
    if f not in _DEMOD:
        rng = np.random.default_rng(f + 1)
        crandn = lambda shape: (rng.standard_normal(shape)
                                + 1j * rng.standard_normal(shape)).astype(np.complex64)
        pilot_td, data_td = crandn((A, f)), crandn((S - 1, A, f))
        px = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
        fft = jfft.get_fft("four_step")
        hconj, hsqrd = jls.estimate_channel_full(fft(JCArray.from_numpy(pilot_td)),
                                                 jls.pad_pilot(px))
        want = jax_fused_demod(JCArray.from_numpy(data_td), hconj, hsqrd,
                               interpret=True).to_numpy()
        _DEMOD[f] = (data_td, hconj.to_numpy(), np.array(hsqrd, np.float32), want)
    return _DEMOD[f]


# -- 1. the plain versions against the JAX kernels -------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", SIZES)
def test_estimate_pilot_plain_matches_jax_kernel(f, dtype):
    (res, x_perm) = jax_fused(f, dtype)
    h_re, h_im, inv, _ = res[True]
    want_h, want_inv = convert.estimate_from_reference(h_re, h_im, inv, device="cpu")
    x_full = convert.pilot_from_reference(x_perm, device="cpu")
    got_h, got_inv = pipe.estimate_pilot_plain(port_rows(f, dtype)[0], x_full)
    assert max_rel(got_h.to_numpy(), want_h.to_numpy()) < TOL
    assert max_rel(1 / got_inv.numpy(), 1 / want_inv.numpy()) < TOL


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", SIZES)
def test_fused_pipeline_plain_matches_jax_kernel(f, dtype):
    (res, x_perm) = jax_fused(f, dtype)
    h_re, h_im, inv, want = res[True]
    h, inv_t = convert.estimate_from_reference(h_re, h_im, inv, device="cpu")
    got = pipe.fused_pipeline_plain(port_rows(f, dtype)[1:], h, inv_t).to_numpy()
    assert got.shape == (S - 1, f - 1)
    assert max_rel(got, want) < TOL
    # The whole frame through the port's wrappers: on CPU tensors, the two
    # plain versions.
    x_full = convert.pilot_from_reference(x_perm, device="cpu")
    rows = port_rows(f, dtype)
    whole = pipe.demod_parts_fused(rows[0], rows[1:], x_full).to_numpy()
    h_own, inv_own = pipe.estimate_pilot_plain(rows[0], x_full)
    np.testing.assert_array_equal(whole, pipe.fused_pipeline_plain(rows[1:], h_own,
                                                                   inv_own).to_numpy())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", SIZES)
def test_speed_plain_matches_jax_speed_kernels(f, dtype):
    (res, x_perm) = jax_fused(f, dtype)
    jax_speed, jax_exact = res[False][3], res[True][3]
    assert -80.0 < evm_db(jax_speed, jax_exact) < -40.0   # the JAX run took its bf16 path
    x_full = convert.pilot_from_reference(x_perm, device="cpu")
    rows = port_rows(f, dtype)
    got = pipe.demod_parts_fused(rows[0], rows[1:], x_full, exact=False).to_numpy()
    assert evm_db(got, jax_speed) <= evm_db(jax_speed, jax_exact) - GAP_DB
    h, inv = pipe.estimate_pilot_speed_plain(rows[0], x_full)
    want_h, want_inv = convert.estimate_from_reference(*res[False][:3], device="cpu")
    assert evm_db(h.to_numpy(), want_h.to_numpy()) <= evm_db(
        want_h.to_numpy(), convert.estimate_from_reference(*res[True][:3], device="cpu")[0]
        .to_numpy()) - GAP_DB


@pytest.mark.parametrize("f", SIZES)
def test_fused_demod_plain_matches_jax_kernel(f):
    data_td, hconj, hsqrd, want = jax_demod(f)
    got = fused_mrc.fused_demod(CArray.from_numpy(data_td, "cpu"),
                                CArray.from_numpy(hconj, "cpu"), torch.from_numpy(hsqrd))
    assert got.shape == (S - 1, f)
    assert max_rel(got.to_numpy(), want) < JAX_TOL


@pytest.mark.parametrize("f", SIZES)
def test_receivers_route_fused_without_a_warning(f):
    """'fused' stays 'fused' at these F (no RuntimeWarning), and exact=False
    selects the speed kernels; 65536 keeps the warned fallback."""
    pilot = np.ones(f - 1, np.complex64)
    cfg = FrameConfig(num_antennas=A, fft_size=f, cyclic_prefix=0, frame_len=S)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        for exact in (True, False):
            rx = UplinkReceiver(cfg, pilot, pipeline="fused", exact=exact, device="cpu")
            assert rx.pipeline == "fused"
            assert speed_mode(cfg, rx.pipeline, exact) is (not exact)
        assert StreamingDemodulator(cfg, pilot, pipeline="fused", device="cpu").pipeline == "fused"
    assert pipe.supports_fused(f) and pipe.supports_speed(f) and f in fused_mrc.MRC_DEMOD_FFT_SIZES
    big = FrameConfig(num_antennas=A, fft_size=65536, cyclic_prefix=0, frame_len=S)
    with pytest.warns(RuntimeWarning, match="fused pipeline unavailable"):
        assert UplinkReceiver(big, np.ones(65535, np.complex64), pipeline="fused",
                              fft_impl="four_step", device="cpu").pipeline == "fast"


# -- 2. the plans, emulated on the package's tables -------------------------------

def test_register_plan_at_8192_matches_numpy():
    """One team of 256 threads, 32 values each, radices (32, 16, 16)."""
    p = fp.plan(8192)
    assert (p.radices, p.threads, p.teams_per_symbol, p.block) == ((32, 16, 16), 256, 1, 256)
    assert fp.smem_bytes(8192) == 204800 <= 232448
    rng = np.random.default_rng(8)
    x = rng.standard_normal(8192) + 1j * rng.standard_normal(8192)
    assert max_rel(emulate(x), np.fft.fft(x)) < 1e-6


def column_twiddles(f: int, int16: bool = False) -> np.ndarray:
    """[n1, 128] complex64: the column pass's four-step twiddles
    (fft_split.cu): lane j of the n1-point FFT's team of T lanes forms
    k1 = j + T m from the table's entries k1 = j, T and 0 by products in
    float32, the step scaled by 1 / the k1 = 0 entry (the sc16 scale)."""
    n1, n2 = fp.split_factors(f)
    tab = fp.split_tables_np(f, int16)
    four = tab[len(fp.pass_twiddles_np(n1)) + len(fp.pass_twiddles_np(n2)):]
    four = (four[:, 0] + 1j * four[:, 1]).astype(np.complex64).reshape(n1, n2)
    t = fp.plan(n1).threads
    s0 = (np.float32(1) / four[0].real).astype(np.float32)
    step = (four[t] * s0).astype(np.complex64)
    out = np.empty((n1, n2), np.complex64)
    for j in range(t):
        w = four[j].copy()
        for m in range(n1 // t):
            out[j + t * m] = w
            w = (w * step).astype(np.complex64)
    return out


def emulate_split(x: np.ndarray, int16_scale: float = 1.0) -> np.ndarray:
    """The split form on one row, complex64 as the kernels compute it: the
    column pass (the register FFT at n1 on each column i2, then the
    four-step twiddle, ``column_twiddles``), the row pass (the register FFT
    at 128 on each row k1), bin k1 + n1 k2."""
    f = x.shape[0]
    n1, n2 = fp.split_factors(f)
    cols = x.astype(np.complex64).reshape(n1, n2)
    b = np.stack([emulate(cols[:, i2]) for i2 in range(n2)], axis=1)
    b = b * column_twiddles(f) * int16_scale
    c = np.stack([emulate(b[k1]) for k1 in range(n1)])       # [k1, k2]
    return c.T.reshape(f)                                     # bin n1 k2 + k1


@pytest.mark.parametrize("f", SIZES)
def test_split_form_matches_numpy(f):
    rng = np.random.default_rng(f)
    x = rng.standard_normal(f) + 1j * rng.standard_normal(f)
    got = emulate_split(x)
    assert np.all(np.isfinite(got))
    assert max_rel(got, np.fft.fft(x)) < 2e-6


@pytest.mark.parametrize("int16", [False, True])
@pytest.mark.parametrize("f", SIZES)
def test_column_twiddles_by_recurrence(f, int16):
    """The column pass forms its twiddles by products from three table
    entries: within 2e-6 of the table (the sc16 scale carried by the k1 = 0
    entry, not compounded), and the split form on them within 2e-6 of
    numpy, the exact kernels' 2e-5 bound kept with room."""
    got = column_twiddles(f, int16)
    want = fp.speed_twiddles_np(f, int16)
    assert float(np.max(np.abs(got - want)) / np.max(np.abs(want))) < 2e-6
    rng = np.random.default_rng(f + 1)
    x = rng.standard_normal(f) + 1j * rng.standard_normal(f)
    assert max_rel(emulate_split(x), np.fft.fft(x)) < 2e-6
    src = (CSRC / "fft_split.cuh").read_text()   # column_tile, every caller's column pass
    assert "fw[1] = __ldg(four + T * kN2 + i2);" in src and "w = cmul(w, step);" in src


@pytest.mark.parametrize("f", SIZES)
def test_split_table_layout(f):
    """split_tables: the column FFT's pass twiddles, the row FFT's, then the
    [n1, 128] four-step twiddles, each as the kernels index them."""
    n1, n2 = fp.split_factors(f)
    tab = fp.split_tables_np(f)
    a, b = len(fp.pass_twiddles_np(n1)), len(fp.pass_twiddles_np(n2))
    r1, r0 = fp.plan(n1).radices[1], fp.plan(n1).radices[0]
    assert a == r1 * r0 and b == fp.plan(n2).radices[1] * fp.plan(n2).radices[0]
    assert len(tab) == a + b + n1 * n2
    np.testing.assert_array_equal(tab[:a], fp.pass_twiddles_np(n1))
    np.testing.assert_array_equal(tab[a:a + b], fp.pass_twiddles_np(n2))
    tw = fp.speed_twiddles_np(f).reshape(-1)
    np.testing.assert_array_equal(tab[a + b:, 0], tw.real)
    np.testing.assert_array_equal(tab[a + b:, 1], tw.imag)
    sc = fp.split_tables_np(f, int16=True)[a + b:]
    np.testing.assert_array_equal(sc[:, 0] + 1j * sc[:, 1], fp.speed_twiddles_np(f, True).reshape(-1))


def test_split_constants_match_the_header():
    text = (CSRC / "fft_split.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("kN2") == fp.SPLIT_N2
    assert const("kK1") == fp.SPLIT_K1
    assert const("kMaxTeams") == fp.SPLIT_TEAMS
    assert const("kColumnThreads") == fp.SPLIT_COLUMN_THREADS
    assert "g = (team.id & 3) + 4 * (w & 1);" in text and "p = w >> 1;" in text
    assert "return 4 * (2 * p + (g >> 2)) + (g & 3);" in text
    assert "return wfft::Geo<N1>::kTwiddles + RowGeo::kTwiddles;" in text
    col = text   # the column tile's geometry, shared by the column pass and the ring
    assert ("return 2 * wfft::Geo<N1>::kPlane + (columns<N1>() >= 32 ? 1 : 2);"
            in col)                                                  # split_column_stride
    assert "return kColumnThreads / wfft::Geo<N1>::T;" in col   # split_columns
    for name in ("fft_mrc.cu", "mrc_demod.cu", "pilot_ls.cu", "fft_mrc_bf16.cu"):
        assert '#include "fft_split.cuh"' in (CSRC / name).read_text()


@pytest.mark.parametrize("n1", [64, 128, 256])
def test_column_pass_geometry(n1):
    """A block's loads and stores cover its [n1][C] samples once (a team a
    column), the blocks cover the 128 columns, the transposes into and out
    of the columns hit 32 banks a warp, and the block fits the card three
    times an SM."""
    c = fp.split_columns(n1)
    stride = fp.split_column_stride(n1)
    assert c * fp.plan(n1).threads == fp.SPLIT_COLUMN_THREADS and 128 % c == 0
    idx = np.arange(n1 * c)
    i1, col = idx // c, idx % c
    assert len({(int(a), int(b)) for a, b in zip(i1, col)}) == n1 * c
    assert stride >= 2 * fp.plane_floats(n1)
    for w0 in range(0, n1 * c, 32):   # one warp's 32 consecutive indices
        banks = (col[w0:w0 + 32] * stride + i1[w0:w0 + 32]) % 32
        assert len(set(banks.tolist())) == 32
    assert 3 * (fp.split_column_smem_bytes(n1) + 1024) <= 233472


def row_team(team_id: int):
    """(k1 g, antenna team p) of a row-pass team (fft_split.cuh RowTeam)."""
    w = team_id >> 2
    return (team_id & 3) + 4 * (w & 1), w >> 1


@pytest.mark.parametrize("teams", [1, 2, 3, 4])
def test_row_pass_teams_cover_each_k1_and_antenna_team_once(teams):
    ids = range(teams * fp.SPLIT_K1)
    pairs = [row_team(i) for i in ids]
    assert sorted(pairs) == [(g, p) for g in range(fp.SPLIT_K1) for p in range(teams)]
    for i in ids:
        g, p = row_team(i)
        assert 4 * (2 * p + (g >> 2)) + (g & 3) == i   # row_team_id
    for w in range(2 * teams):  # a warp: 4 consecutive k1 of one antenna team
        gs, ps = zip(*(row_team(i) for i in range(4 * w, 4 * w + 4)))
        assert len(set(ps)) == 1 and list(gs) == list(range(gs[0], gs[0] + 4))
    assert fp.split_smem_bytes(teams) <= 232448


@pytest.mark.parametrize("f", SIZES)
def test_split_blocks_cover_every_bin_once(f):
    """The exact row pass's blocks (kK1 bins k1, 128 k2) and the speed row
    pass's (32 bins k1; thread t's 32 fragment bins) each write every bin of
    a symbol once."""
    n1, _ = fp.split_factors(f)
    seen = np.zeros(f, int)
    if f in fp.SPLIT_FFT_SIZES:
        for blk in range(n1 // fp.SPLIT_K1):
            i = np.arange(fp.SPLIT_K1 * 128)
            np.add.at(seen, blk * fp.SPLIT_K1 + i % fp.SPLIT_K1 + n1 * (i // fp.SPLIT_K1), 1)
        assert np.all(seen == 1)
    seen[:] = 0
    for blk in range(n1 // fp.SPEED_ROWS_K1):
        for t in range(fp.SPEED_ROWS_THREADS):
            q, t4 = 8 * (t >> 5) + ((t & 31) >> 2), t & 3
            for ix in range(32):
                k2 = 32 * (ix >> 3) + 8 * ((ix >> 1) & 3) + 2 * t4 + (ix & 1)
                seen[n1 * k2 + fp.SPEED_ROWS_K1 * blk + q] += 1
    assert np.all(seen == 1)


PILOT_ANTENNAS = (1, 3, 5, 16, 64)
PILOT_FRAMES = (1, 20)


def plain_abs2(a: int, f: int, exact: bool, seed: int) -> np.ndarray:
    """|h|^2 [A, F] of the plain pilot (exact or speed) on random rows."""
    rng = np.random.default_rng(seed)
    z = 0.1 * (rng.standard_normal((a, f)) + 1j * rng.standard_normal((a, f)))
    rows = CArray.from_numpy(z.astype(np.complex64), "cpu")
    x = pad_pilot(np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64), "cpu")
    h, inv = (pipe.estimate_pilot_plain if exact else pipe.estimate_pilot_speed_plain)(rows, x)
    return h.abs2().numpy(), 1 / inv.numpy()


def emulate_cluster_pilot(abs2: np.ndarray, clusters: int, groups: int, k1s, block_rows,
                          rank_bins) -> tuple:
    """A clustered row pass over one frame: cluster gi (of ``groups``) takes
    bins k1s(gi) x every k2; its block ``rank`` sums |h|^2 over the antenna
    rows ``block_rows(rank)`` (a list of each team's rows, float32, each team
    in row order, the teams then added in order), and rank r adds the C
    blocks' sums (in rank order) of ``rank_bins(rank, gi)``.  Returns (how
    often each (antenna, bin) was taken, how often each bin was written, the
    sums)."""
    a, f = abs2.shape
    n1 = f // 128
    abs2 = abs2.astype(np.float32)
    taken, written = np.zeros((a, f), int), np.zeros(f, int)
    out = np.full(f, np.nan, np.float32)
    for gi in range(groups):
        bins = (np.asarray(k1s(gi))[:, None] + n1 * np.arange(128)[None, :]).ravel()
        blocks = np.zeros((clusters, f), np.float32)
        for rank in range(clusters):
            for team in block_rows(rank):
                part = np.zeros(len(bins), np.float32)
                for row in team:
                    taken[row, bins] += 1
                    part += abs2[row, bins]
                blocks[rank, bins] += part
        for rank in range(clusters):
            mine = np.asarray(rank_bins(rank, gi))
            written[mine] += 1
            s = np.zeros(len(mine), np.float32)
            for c in range(clusters):
                s += blocks[c, mine]
            out[mine] = s
    return taken, written, out


@pytest.mark.parametrize("k", PILOT_FRAMES)
@pytest.mark.parametrize("a", PILOT_ANTENNAS)
@pytest.mark.parametrize("f", fp.SPLIT_FFT_SIZES)
def test_split_pilot_plan_and_sum(f, a, k):
    """The exact split pilot's cluster plan (csrc/pilot_ls.cu
    pilot_ls_rows_kernel) for K frames, emulated on one frame: a cluster of
    C blocks for each 8 bins k1, its antenna teams' rows (pilot_team_rows),
    every (antenna, bin) taken once, the ranks' shares (split_pilot_rank_bins)
    writing every bin once, and sum |h|^2 in the kernel's order within 1e-6
    of the plain version's; more than n1 / 8 blocks a frame wherever there
    are antennas to spread and SMs for them.  The emulation adds each
    block's teams in team order, then the blocks in rank order, as the
    kernel's reduce does."""
    n1, _ = fp.split_factors(f)
    groups = n1 // fp.SPLIT_K1
    p = fp.pilot_plan(a, f, k)
    c = fp.split_pilot_clusters(a, f, k)
    assert p.clusters <= c <= fp.MAX_CLUSTER
    assert k * groups * p.clusters * p.threads <= fp.SPLIT_PILOT_THREADS_PER_SM * fp.SMS or c == 1
    assert p.rows == -(-a // (p.clusters * p.teams)) and p.teams <= fp.SPLIT_TEAMS
    assert (p.clusters - 1) * p.teams < a
    assert p.smem_bytes == fp.split_smem_bytes(p.teams) + 8 * fp.SPLIT_K1 * fp.SPLIT_N2
    if k == 1 and a > 1:
        assert groups * p.clusters > groups
    src = (CSRC / "pilot_ls.cu").read_text()
    assert "!ofdm::pilot_plan_ok(A, clusters, teams, rows, ofdm::split::kMaxTeams) ||" in src
    assert "const int g = rank * P + rt.p;" in src and "const int step = C * P;" in src
    assert "const int lo = rank * kBins / C, hi = (rank + 1) * kBins / C;" in src
    assert "inv_k[k1_0 + gi + N1 * k2] = invert ? 1.0f / s : s;" in src
    assert "peer[split::row_team_id(gi, p) * RG::kTeamFloats + k2]" in src
    assert ("return split::row_smem_bytes(teams) + 2 * split::kK1 * split::kN2 * sizeof(float);"
            in src)
    abs2, want = plain_abs2(a, f, True, a + k)
    taken, written, got = emulate_cluster_pilot(
        abs2, p.clusters, groups, lambda gi: range(fp.SPLIT_K1 * gi, fp.SPLIT_K1 * (gi + 1)),
        lambda rank: [fp.pilot_team_rows(a, p, rank, t) for t in range(p.teams)],
        lambda rank, gi: fp.split_pilot_rank_bins(f, p.clusters, rank, gi))
    assert np.all(taken == 1) and np.all(written == 1)
    assert max_rel(got, want) < 1e-6


@pytest.mark.parametrize("k", PILOT_FRAMES)
@pytest.mark.parametrize("a", PILOT_ANTENNAS)
@pytest.mark.parametrize("f", fp.SPEED_SPLIT_SIZES)
def test_speed_pilot_cluster_plan_and_sum(f, a, k):
    """The bf16 pilot's row pass from F = 8192 (fft_mrc_bf16.cu
    pilot_rows_kernel) for K frames, emulated on one frame: a cluster of CL
    blocks for each 32 bins k1, rank r taking antennas r, r + CL, ... over
    its two warpgroups in turn (warpgroup w: r + CL w, r + CL (w + 2), ...;
    warpgroup 0's sums, then warpgroup 1's added), every (antenna, bin)
    taken once, the ranks' shares (speed_pilot_rank_bins) writing every bin
    once, and sum |h|^2 in the kernel's order within 1e-6 of the plain speed
    version's; the launch takes speed_cluster's cluster, and the C entry
    checks it."""
    n1, _ = fp.speed_split(f)
    groups = n1 // fp.SPEED_ROWS_K1
    cl = fp.speed_cluster(a, f, True, k)
    assert 1 <= cl <= min(a, fp.SPEED_PILOT_CLUSTER) and (k * groups * cl <= fp.SMS or cl == 1)
    if k == 1:
        assert cl == min(a, fp.SPEED_PILOT_CLUSTER)
    assert fp.speed_cluster(a, f, False, k) == 1
    src = (CSRC / "fft_mrc_bf16.cu").read_text()
    assert "if (cl < 1 || cl > kPilotCluster || cl > p.A) return cudaErrorInvalidValue;" in src
    assert "fft_plan.speed_cluster(a, f, True, k) if split else 0" in (
        CSRC.parent / "ops" / "pipeline.py").read_text()
    assert "const int step = 2 * CL;" in src and "int a = rank + CL * wgi;" in src
    assert "const int rounds = ((p.A - rank + CL - 1) / CL + 1) / 2;" in src
    assert "nat[k2 * kNatStride + q] = w ? nat[k2 * kNatStride + q] + sums[ix] : sums[ix];" in src
    assert f"constexpr int kPilotRowsThreads = {fp.SPEED_PILOT_ROWS_THREADS};" in src
    assert "const int lo = rank * kBins / CL, hi = (rank + 1) * kBins / CL;" in src
    assert "inv_k[N1 * (i >> 5) + kRowsK1 * grp + (i & 31)] = 1.0f / s;" in src
    abs2, want = plain_abs2(a, f, False, a + k)
    taken, written, got = emulate_cluster_pilot(
        abs2, cl, groups, lambda gi: range(fp.SPEED_ROWS_K1 * gi, fp.SPEED_ROWS_K1 * (gi + 1)),
        lambda rank: [range(rank + cl * w, a, 2 * cl) for w in (0, 1)],
        lambda rank, gi: fp.speed_pilot_rank_bins(f, cl, rank, gi))
    assert np.all(taken == 1) and np.all(written == 1)
    assert max_rel(got, want) < 1e-6


def test_speed_w_image_is_the_shared_memory_operand():
    """The 64 KB the bf16 pilot multicasts from F = 8192 is, byte for byte,
    the B operand the other speed kernels build from W row by row."""
    img = fp.speed_w_image("cpu")
    assert img.dtype == torch.bfloat16 and img.numel() * 2 == 65536
    np.testing.assert_array_equal(img.view(torch.int16).numpy().view(np.uint16), w_operand())


def emulate_speed_rows(x: CArray, f: int, epilogue, cluster: int) -> dict:
    """fft_mrc_bf16.cu's pilot row pass for one frame (n1 >= 64,
    pilot_rows_kernel): the blocks of group g take bins k1 = 32 g + q,
    block ``rank`` of its cluster the antennas rank, rank + cluster, ...
    (its two warpgroups in turn), each the chunk c = a n1/32 + g of the tile
    layout (speed_chunk_rows), quarter by quarter through the wgmma mirror
    against W's multicast image; thread t folds C of its row q at its
    fragment's columns into its sums, and the cluster's sums are added in
    rank order.  Returns {bin: sum over the antennas}."""
    n1, _ = fp.speed_split(f)
    a = x.shape[0]
    groups = n1 // fp.SPEED_ROWS_K1
    tiles = stage1_chunks(x, f)
    w_mem = fp.speed_w_image("cpu").view(torch.int16).numpy().view(np.uint16)
    out = {}
    for g in range(groups):
        blocks = []
        for rank in range(cluster):
            sums = {}
            for ant in range(rank, a, cluster):
                c = ant * groups + g
                for quarter in range(4):
                    d = chunk_product(tiles[c], w_mem, quarter)
                    for t in range(128):
                        q = 8 * (t // 32) + (t % 32) // 4
                        k1 = fp.SPEED_ROWS_K1 * g + q
                        for j in range(4):
                            for cc in range(2):
                                cval = complex(d[fragment(t, cc, j)] - d[fragment(t, 2 + cc, j + 4)],
                                               d[fragment(t, cc, j + 4)] + d[fragment(t, 2 + cc, j)])
                                b = n1 * (32 * quarter + fragment(t, cc, j)[1]) + k1
                                sums[b] = sums.get(b, 0j) + epilogue(ant, b, cval)
            blocks.append(sums)
        for b in blocks[0]:
            out[b] = sum(blk.get(b, 0j) for blk in blocks)
    return out


# The bf16 ring's tile, as csrc/fft_mrc_bf16.cu lands it by TMA: for pair b
# of antennas, antenna 2 b + i's run of 32 slot rows (its planes interleaved
# by 8 rows, fft_split.cuh slot_row) at tile rows 32 i .., tile row m:
# complex row q = 8 (m // 16) + m % 8 (antenna 2 b + q // 16, k1 = k1_0 + q %
# 16), plane (m // 8) % 2, each element at speed_swizzle (the 128-byte
# swizzle); warpgroup w's thread t folds quarters 2 w and 2 w + 1 of complex
# row q of the tile at its fragment's columns (j, cc): C_re = D[r0, c0] -
# D[r0 + 8, c0 + 32], C_im = D[r0, c0 + 32] + D[r0 + 8, c0], bin n1 (32 Q +
# c0) + k1, its antenna's h; the two antennas' threads (t, t + 64) add their
# sums at the end.
_M, _K = np.meshgrid(np.arange(64), np.arange(128), indexing="ij")
TILE_Q = (8 * (_M // 16) + _M % 8).ravel()
TILE_PLANE = ((_M // 8) % 2).ravel()
TILE_COL = _K.ravel()
TILE_M = _M.ravel()
TILE_AT = np.array([fp.speed_swizzle(64, m, k) // 2 for m, k in zip(_M.ravel(), _K.ravel())])
_T, _JC = np.meshgrid(np.arange(128), np.arange(8), indexing="ij")
FOLD_Q = 8 * (_T // 32) + (_T % 32) // 4
FOLD_R0 = 16 * (_T // 32) + (_T % 32) // 4
FOLD_C0 = 8 * (_JC // 2) + 2 * (_T % 4) + _JC % 2


def emulate_speed_ring(y: CArray, h: np.ndarray, inv: np.ndarray, slots: int, lag: int):
    """fft_mrc_bf16_ring_kernel tile by tile in ticket order (ring_ticket
    with the bf16 row tiles) over the S symbols of one frame y [S, A, F]
    (f32 or int16): a column tile writes its columns' n1-point DFT times
    the four-step twiddle (column_twiddles, the sc16 scale folded in),
    rounded to bf16, into slot s % R; a row tile of 32 bins k1 takes each
    antenna in turn, its 32 rows of the slot landing in the swizzled tile
    (TILE_*), then the four quarters through the wgmma mirror against W's
    image and each warpgroup thread's fold of C conj(h) into its sums; the
    store is sum * inv in reference order, the DC bin dropped.  Returns
    (out [S, F-1], the times each tile element was written per antenna)."""
    s_, a, f = y.shape
    n1, n2 = fp.speed_split(f)
    c = fp.split_columns(n1)
    ct, rt = fp.split_ring_tiles(a, f, fp.SPEED_RING_K1)
    tw = column_twiddles(f, y.dtype == torch.int16)
    rows = (y.re.numpy().astype(np.float32) + 1j * y.im.numpy().astype(np.float32)
            ).astype(np.complex64)
    w_mem = fp.speed_w_image("cpu").view(torch.int16).numpy().view(np.uint16)
    # bf16 bits, [R][A][n1 / 8][2][8][128] (fft_split.cuh slot_row): row k1 of
    # plane p at 16 (k1 // 8) + 8 p + k1 % 8.
    ring = np.zeros((slots, a, 2 * n1, n2), np.uint16)
    k1s = np.arange(n1)
    slot_row = 16 * (k1s // 8) + k1s % 8
    owner = [-1] * slots
    out = np.full((s_, f - 1), np.nan, np.complex128)
    writes = np.zeros(64 * 128, int)
    jo = pipe.reference_order_index(f)
    for t in range(s_ * (ct + rt)):
        column, item, idx = fp.ring_ticket(t, s_, lag, ct, rt)
        slot = item % slots
        if column:
            ant, c0 = idx // (n2 // c), (idx % (n2 // c)) * c
            x = rows[item, ant].reshape(n1, n2)[:, c0:c0 + c]
            b = (np.fft.fft(x, axis=0) * tw[:, c0:c0 + c]).astype(np.complex64)
            ring[slot, ant, slot_row, c0:c0 + c] = _bf16_bits(b.real)
            ring[slot, ant, slot_row + 8, c0:c0 + c] = _bf16_bits(b.imag)
            owner[slot] = item
            continue
        assert owner[slot] == item
        k1_0 = fp.SPEED_RING_K1 * idx
        sums = np.zeros((128, 32), np.complex128)     # thread t of the warpgroups' fragments
        for pair in range(-(-a // 2)):
            tile = np.zeros(64 * 128, np.uint16)
            live = min(2, a - 2 * pair)
            for i in range(live):
                run = ring[slot, 2 * pair + i, 2 * k1_0:2 * k1_0 + 32]   # one run of 32 rows
                m = TILE_M >= 32 * i
                m &= TILE_M < 32 * (i + 1)
                tile[TILE_AT[m]] = run[TILE_M[m] - 32 * i, TILE_COL[m]]
                q = TILE_Q[m]
                assert np.array_equal(run[TILE_M[m] - 32 * i, TILE_COL[m]], ring[
                    slot, 2 * pair + i, slot_row[k1_0 + q % 16] + 8 * TILE_PLANE[m], TILE_COL[m]])
                np.add.at(writes, TILE_AT[m], 1)
            ant = 2 * pair + FOLD_Q // 16
            ok = ant < a
            for quarter in range(4):
                d = chunk_product(tile, w_mem, quarter)
                cval = (d[FOLD_R0, FOLD_C0] - d[FOLD_R0 + 8, FOLD_C0 + 32]
                        + 1j * (d[FOLD_R0, FOLD_C0 + 32] + d[FOLD_R0 + 8, FOLD_C0]))
                bins = n1 * (32 * quarter + FOLD_C0) + k1_0 + FOLD_Q % 16
                hv = np.where(ok, h[np.minimum(ant, a - 1), bins], 0)
                sums[:, 8 * quarter:8 * quarter + 8] += cval * np.conj(hv)
        first = FOLD_Q[:, 0] < 16
        total = sums[first] + sums[~first]            # thread t + 64 to thread t
        bins = (n1 * (32 * (np.arange(32) // 8)[None, :] + FOLD_C0[first][:, np.arange(32) % 8])
                + k1_0 + FOLD_Q[first][:, :1])
        eq = np.zeros(f, np.complex128)
        eq[bins] = total * inv[bins]
        live_bins = np.isin(jo, bins)
        out[item, live_bins] = eq[jo[live_bins]]
    return out, writes


@pytest.mark.parametrize("f,a,dtype", [(8192, 2, "f32"), (8192, 3, "int16"), (16384, 1, "int16"),
                                       (32768, 1, "f32"), (32768, 2, "f32")])
def test_speed_rows_mirror_reproduces_the_plain_versions(f, a, dtype):
    """The pilot row pass's mirror (h, inv; its antennas over the cluster of
    speed_cluster) against estimate_pilot_speed_plain on the same pilot:
    only the accumulation order differs (float32, 1e-5).  The data path's
    mirror, the bf16 ring over three symbols on R = 2 slots (every slot
    rewritten in the launch), against fused_pipeline_speed_plain at the
    speed kernels' criterion (PERF.md section 2: EVM against the plain
    version at least SPEED_GAP_DB = 20 dB below the plain version's against
    the exact path, max-rel < 1e-2: the column twiddles by recurrence, a
    few ulp off the plain version's table, flip a bf16 rounding now and
    then), and every tile element is written, each antenna's rows once
    a row tile."""
    rng = np.random.default_rng(f + a)
    z = 0.1 * (rng.standard_normal((4, a, f)) + 1j * rng.standard_normal((4, a, f)))
    if dtype == "int16":
        rows = CArray(torch.from_numpy(plane_to_sc16(z.real)), torch.from_numpy(plane_to_sc16(z.imag)))
    else:
        rows = CArray.from_numpy(z.astype(np.complex64), "cpu")
    x_full = pad_pilot(np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64), "cpu")
    xr, xi = x_full.re.numpy(), x_full.im.numpy()
    h = np.full((a, f), np.nan, np.complex128)

    def pilot_epi(ant, b, cval):
        hv = cval * complex(xr[b], -xi[b]) / (xr[b] ** 2 + xi[b] ** 2)
        h[ant, b] = hv
        return abs(hv) ** 2

    sums = emulate_speed_rows(rows[0], f, pilot_epi, fp.speed_cluster(a, f, True))
    assert sorted(sums) == list(range(f))
    h_p, inv_p = pipe.estimate_pilot_speed_plain(rows[0], x_full)
    assert max_rel(h, h_p.to_numpy()) < 1e-5
    assert max_rel(np.array([sums[b].real for b in range(f)]), 1 / inv_p.numpy()) < 1e-5
    data = CArray(rows.re[1:], rows.im[1:])
    got, writes = emulate_speed_ring(data, h_p.to_numpy(), inv_p.numpy(), slots=2, lag=1)
    assert writes.sum() == 32 * 128 * a * (f // 128 // fp.SPEED_RING_K1) * 3   # a run an antenna
    assert a == 1 or np.all(writes >= 1)
    want = pipe.fused_pipeline_speed_plain(data, h_p, inv_p).to_numpy()
    exact = pipe.fused_pipeline_plain(data, h_p, inv_p).to_numpy()
    assert np.all(np.isfinite(got))
    assert evm_db(got, want) <= evm_db(want, exact) - GAP_DB and max_rel(got, want) < 1e-2


@pytest.mark.parametrize("f", SIZES)
def test_split_scratch_and_chunks(f):
    """The chunked scratch: [2, chunk, A, F] where the kernel runs the
    chunked split form at F (the exact pilots at 16384 and 32768, the speed
    kernels from 8192; the exact data kernels take the ring,
    tests/test_torch_split_ring.py), as many symbols a chunk as 512 MB holds,
    at least one, never more symbols than there are."""
    for sizes in (fp.SPLIT_FFT_SIZES, fp.SPEED_SPLIT_SIZES):
        scratch, chunk = pipe._split_scratch(100, 16, f, sizes, torch.device("cpu"))
        if f not in sizes:
            assert scratch is None and chunk == 0
            continue
        assert tuple(scratch.shape) == (2, chunk, 16, f)
        assert chunk == min(100, fp.SPLIT_SCRATCH_BYTES // (16 * f * 8))
    assert fp.split_chunk(3, 16, f) == 3
    assert fp.split_chunk(10**6, 16, f) * 16 * f * 8 <= fp.SPLIT_SCRATCH_BYTES
    assert fp.split_chunk(5, 10**6, f) == 1
