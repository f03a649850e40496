"""The exact data kernels at F = 256, 512, 2048 and 4096 (csrc/fft_side.cuh:
fft_mrc.cu fft_mrc_side_kernel, mrc_demod.cu mrc_demod_side_kernel)
checked on the CPU through their plan (ofdm_ls_mrc_tpu_torch.ops.fft_plan
side_plan).

A launch of N = K S A antenna rows runs on B blocks of ``side_teams``
teams, team u of the U = B teams taking the rows [u N / U, (u + 1) N / U)
in order on the side form's register FFT (16 values a thread), adding
Y conj(h) (or Y hc) into its sums in row order; a symbol that lies in one
team is stored by it, the others' teams keep partials that the block adds
in team order, and a symbol that also spans blocks is handed in, counted,
and added by the last block to count in block order.  The CUDA kernels
cannot run here, so the plan's coverage (every row to one team, every
symbol's bins to one owner whatever the order the blocks count in, every
partial slot to at most one symbol), a numpy mirror of the FFT on the
package's tables and a mirror of the kernels' sums against the plain
versions and the JAX package's fused_pipeline and fused_demod (Pallas in
interpret mode) within TOL = 5e-5 are checked below, as are the constants
the plan shares with the source, the buffers the wrappers hand the
kernels, and the register plans left as they were.
"""

import contextlib
import re
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
from ofdm_ls_mrc_tpu_torch import convert
from ofdm_ls_mrc_tpu_torch.kernels import build
from ofdm_ls_mrc_tpu_torch.ops import fft_plan as fp
from ofdm_ls_mrc_tpu_torch.ops import fused_mrc
from ofdm_ls_mrc_tpu_torch.ops import pipeline as pipe
from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray

SIZES = fp.SIDE_FFT_SIZES
TOL = 5e-5
CSRC = Path(fp.__file__).resolve().parent.parent / "csrc"
ANTENNAS = (1, 2, 3, 5, 16, 64)
SYMBOLS = (1, 7, 100)
SMEM_PER_SM = 233472      # H100: 228 KB of shared memory per SM
SMEM_PER_BLOCK = 232448   # 227 KB opt-in per block


def max_rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def dft_matrix(r: int) -> np.ndarray:
    k = np.arange(r)
    return np.exp(-2j * np.pi * np.outer(k, k) / r).astype(np.complex64)


def emulate_rows(x: np.ndarray) -> np.ndarray:
    """The side kernels' FFT of rows x [n, F], complex64: thread j of a team
    holds positions j + T m in register m; each pass runs its butterflies
    b = j + T q on the package's table (``side_twiddles_np``) and writes all
    but the last into the exchange plane at ``exchange_slot``; bin j + T m
    from register m (``lane_bins``)."""
    f = x.shape[-1]
    p = fp.side_geometry(f)
    m_vals, t = p.values, p.threads
    tab = fp.side_twiddles_np(f)
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
            regs[:, :, slots] = v @ dft_matrix(radix).T
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


class Launch:
    """A side launch's geometry over ``items`` symbols of A rows at F on a
    card of ``sms`` SMs, as the kernels compute it: the teams' rows, each
    symbol's teams and blocks."""

    def __init__(self, items: int, a: int, f: int, sms: int = fp.H100_SMS):
        self.a, self.f = a, f
        self.rows = items * a
        self.plan = fp.side_plan(items, a, f, sms)
        self.per = fp.side_teams(f)
        self.teams = self.plan.blocks * self.per

    def team_rows(self, u: int) -> range:
        return fp.side_team_rows(self.rows, self.teams, u)

    def symbol_teams(self, item: int) -> list:
        """The non-empty teams that take rows of symbol ``item``, in order."""
        lo, hi = item * self.a, (item + 1) * self.a
        first = (lo * self.teams) // self.rows
        out = []
        for u in range(max(0, first - 1), self.teams):
            r = self.team_rows(u)
            if r.start >= hi:
                break
            if len(r) and r.start < hi and r.stop > lo:
                out.append(u)
        return out


def owners(launch: Launch, order_seed: int):
    """Who stores each symbol, emulated as the kernels decide it: the team
    whose rows hold all of the symbol's; else the block whose teams hold
    them all (after adding their partials); else, of the blocks that count
    in (in a random order), the one that completes the count, which sets it
    back to 0.  Also the partial slots each symbol takes: a team's buffer
    (its last symbol), a team's scratch slot (its first, where it goes on),
    a block's scratch slot 0 or 1.  Returns (owner of each symbol, counts
    left, slots)."""
    items = launch.rows // launch.a
    rng = np.random.default_rng(order_seed)
    owner, counts, slots = [None] * items, np.zeros(items, int), {}

    def take(key, item):
        assert slots.setdefault(key, item) == item, (key, item, slots[key])

    for item in range(items):
        us = launch.symbol_teams(item)
        if len(us) == 1:
            owner[item] = ("team", us[0])
            continue
        for u in us:
            last = (launch.team_rows(u).stop - 1) // launch.a == item
            take(("buffer", u) if last else ("team slot", u), item)
        blocks = sorted({u // launch.per for u in us})
        if len(blocks) == 1:
            owner[item] = ("block", blocks[0])
            continue
        for b in blocks:
            lo_b = launch.team_rows(b * launch.per).start
            take(("block slot", b, 0 if item == lo_b // launch.a else 1), item)
        for b in rng.permutation(blocks):
            counts[item] += 1
            if counts[item] == len(blocks):
                counts[item] = 0
                assert owner[item] is None
                owner[item] = ("block", int(b))
    return owner, counts, slots


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("s", SYMBOLS)
@pytest.mark.parametrize("a", ANTENNAS)
@pytest.mark.parametrize("f", SIZES)
def test_plan_gives_every_row_one_team(f, a, s, k):
    """Every (frame, symbol, antenna) row of K frames goes to exactly one
    team; no more blocks than the card holds at once, nor than one for each
    ``side_teams`` rows; blocks of whole symbols where the teams' chain of
    rows stays within one row of the fullest grid's, else the fullest
    grid; a block's rows are its teams' (the spread plan's block ranges)."""
    items = k * s
    launch = Launch(items, a, f)
    p, rows = launch.plan, launch.rows
    geo = fp.side_geometry(f)
    full = min(geo.min_blocks * fp.H100_SMS, -(-rows // launch.per))
    full_chain = -(-rows // (full * launch.per))
    aligned = [b for b in range(1, full + 1)
               if items % b == 0 and -(-rows // (b * launch.per)) <= full_chain + 1]
    assert p.blocks == (max(aligned) if aligned else full)
    assert p.threads == geo.block == launch.per * geo.threads
    seen = np.zeros(rows, int)
    for u in range(launch.teams):
        seen[launch.team_rows(u).start:launch.team_rows(u).stop] += 1
    assert np.all(seen == 1)
    for b in range(p.blocks):
        lo = launch.team_rows(b * launch.per).start
        hi = launch.team_rows((b + 1) * launch.per - 1).stop
        assert range(lo, hi) == fp.spread_block_rows(rows, p.blocks, b)
        assert hi - lo >= rows // p.blocks
    chain = max(len(launch.team_rows(u)) for u in range(launch.teams))
    assert chain == -(-rows // launch.teams) <= full_chain + 1
    if items % p.blocks == 0:   # whole symbols a block: no symbol spans blocks
        assert all(fp.spread_block_rows(rows, p.blocks, b).start % a == 0
                   for b in range(p.blocks))
    if (a, s, k) == (16, 100, 1):   # one frame: a symbol a block
        assert p.blocks == 100
        assert chain == {256: 1, 512: 1, 2048: 4, 4096: 8}[f]
    if (a, s, k) == (16, 1, 1):     # a streamed symbol: one row a team
        assert p.blocks == {256: 1, 512: 1, 2048: 4, 4096: 8}[f] and chain == 1


@pytest.mark.parametrize("s", SYMBOLS)
@pytest.mark.parametrize("a", ANTENNAS)
@pytest.mark.parametrize("f", SIZES)
def test_every_bin_has_one_owner_in_any_order(f, a, s):
    """Each symbol is stored once, by one team or one block whatever the
    order its blocks count in; a partial slot holds at most one symbol;
    every count is left at 0 for the next launch on the stream; a team's
    store covers the F bins (thread j: bins j + T m), as does a block's
    (thread i: bins i + block c)."""
    launch = Launch(s, a, f, sms=3)   # few SMs: symbols split over blocks too
    for seed in range(3):
        owner, counts, _ = owners(launch, seed)
        assert all(o is not None for o in owner) and np.all(counts == 0)
    geo = fp.side_geometry(f)
    assert sorted(fp.lane_bins(f, geo).reshape(-1)) == list(range(f))
    block_bins = np.arange(geo.block)[:, None] + geo.block * np.arange(f // geo.block)[None, :]
    assert sorted(block_bins.reshape(-1)) == list(range(f))


@pytest.mark.parametrize("f", SIZES)
def test_teams_without_rows_between_a_symbols_teams_add_zeros(f):
    """Where a block has fewer rows than teams (4 x 6 symbols: 24 rows on
    blocks of 16 teams at F = 256, 512), teams that take no row fall
    between a symbol's first and last team; the kernel adds every team from
    the first to the last (csrc/fft_side.cuh), so a team without rows
    writes zeros into its buffer.  At the larger F the plan gives each team
    a row there."""
    launch = Launch(6, 4, f)
    between = []
    for item in range(6):
        us = launch.symbol_teams(item)
        between += [u for u in range(us[0], us[-1] + 1) if not len(launch.team_rows(u))]
    assert bool(between) == (fp.side_teams(f) == 16)
    src = (CSRC / "fft_side.cuh").read_text()
    assert ("  if (n == 0) {  // no row: zeros, which the block's sum adds for a team between "
            "qa and qb\n#pragma unroll\n    for (int m = 0; m < S::kM; ++m) bufs[j + S::kT * m] "
            "= bufs[S::kPlane + j + S::kT * m] = 0.0f;" in src)


def test_plan_raises_for_an_empty_launch_or_size():
    for items, a in ((0, 16), (1, 0)):
        with pytest.raises(ValueError, match="side_plan"):
            fp.side_plan(items, a, 2048)
    with pytest.raises(ValueError, match="no side form"):
        fp.side_plan(1, 16, 1024)


@pytest.mark.parametrize("f", SIZES)
def test_side_fft_emulation_matches_numpy(f):
    """The mirror of the side form's FFT (16 values a thread, radices
    ``SIDE_PLANS``) on the package's float32 table matches np.fft within
    1e-6."""
    rng = np.random.default_rng(f)
    x = rng.standard_normal((2, f)) + 1j * rng.standard_normal((2, f))
    got = emulate_rows(x)
    assert np.all(np.isfinite(got))
    assert max_rel(got, np.fft.fft(x, axis=-1)) < 1e-6


def bank_degree(words) -> int:
    """Shared-memory wavefronts one warp access of 32-bit words takes."""
    banks = {}
    for w in set(int(w) for w in words):
        banks.setdefault(w % 32, set()).add(w)
    return max(len(v) for v in banks.values())


@pytest.mark.parametrize("f", SIZES)
def test_side_exchange_banks_and_shared_memory(f):
    """Every staged read, exchange read, first exchange write and h read of
    a warp hits 32 banks; the second pass's write (Ns = 16) does too where a
    team is half a warp (F = 256, padding after every 16), and takes two
    wavefronts where a warp's 32 lanes write two runs of 16 (T >= 32,
    padding after every 32, which keeps the reads whole); every access the
    kernel makes as a base plus a constant (fft_warp.cuh slot_step) lands on
    its slot; the block's shared memory fits the H100, and as many blocks an
    SM as the plan says."""
    p = fp.side_geometry(f)
    m_vals, t = p.values, p.threads
    lanes = np.arange(32)
    team, j = (lanes // t, lanes % t) if t <= 32 else (np.zeros(32, int), lanes)
    base = team * fp.team_floats(f, p)
    for m in range(m_vals):
        assert bank_degree(base + j + t * m) == 1                            # staged f32, h
        assert bank_degree((2 * base + j + t * m) // 2) == 1                 # staged int16
        assert bank_degree(base + fp.exchange_slot(f, j + t * m, p)) == 1    # exchange read
    pad = p.pad or p.values

    def step(d):   # slot_step
        return d + d // pad

    jj = np.arange(t)
    for m in range(m_vals):   # reads: slot(j + T m) = slot(j) + step(T m)
        assert np.all(fp.exchange_slot(f, jj + t * m, p) == fp.exchange_slot(f, jj, p) + step(t * m))
    for k, (radix, ns) in enumerate(list(zip(p.radices, fp.strides(f, p)))[:-1]):
        for q in range(m_vals // radix):
            b = j + t * q
            for r in range(radix):
                e = (b // ns) * ns * radix + b % ns + ns * r
                want = 2 if (k == 1 and t >= 32) else 1
                assert bank_degree(base + fp.exchange_slot(f, e, p)) == want  # exchange write
            bb = jj + t * q
            base_e = (bb // ns) * ns * radix + bb % ns
            for r in range(radix):
                assert np.all(fp.exchange_slot(f, base_e + ns * r, p)
                              == fp.exchange_slot(f, base_e, p) + step(ns * r))
    assert fp.plane_floats(f, p) % 4 == 0 and fp.team_floats(f, p) % 4 == 0
    assert len(fp.side_twiddles_np(f)) % 2 == 0
    assert fp.side_smem_bytes(f) <= SMEM_PER_BLOCK
    assert p.min_blocks * (fp.side_smem_bytes(f) + 1024) <= SMEM_PER_SM


def side_mirror(y_re, y_im, h, gain, scale: float, sms: int, conjugate: bool):
    """csrc/fft_side.cuh side_rows on rows [K, S, A, F] (planes) with h
    [K, A, F] complex64 and gains [K, F] (inv; mrc_demod: 1 / hsqrd, K = 1)
    in numpy: each row's FFT (``emulate_rows``), Y conj(h) (or Y h) in
    complex64, each team's sums in row order in float32, a symbol stored
    from one team, or its teams' partials added in team order within each
    block and the blocks' in block order, then times gain * scale.  Returns
    (eq [K, S, F] complex64, how often each symbol was stored)."""
    k_, s_, a, f = y_re.shape
    items = k_ * s_
    launch = Launch(items, a, f, sms)
    x = (y_re.astype(np.float32) + 1j * y_im.astype(np.float32)).astype(np.complex64)
    spec = emulate_rows(x.reshape(-1, f)).reshape(k_, s_, a, f)
    hh = h.conj() if conjugate else h
    prod = (spec * hh[:, None]).astype(np.complex64).reshape(-1, f)

    def add(acc, v):
        return v if acc is None else (acc + v).astype(np.complex64)

    partial = {}
    for u in range(launch.teams):
        acc = None
        rows = launch.team_rows(u)
        for g in rows:
            acc = add(None if g == rows.start or g % a == 0 else acc, prod[g])
            if (g + 1) % a == 0 or g + 1 == rows.stop:
                partial[g // a, u] = acc
    eq = np.full((items, f), np.nan, np.complex64)
    stored = np.zeros(items, int)
    for item in range(items):
        blocks = {}
        for u in launch.symbol_teams(item):
            b = u // launch.per
            blocks[b] = add(blocks.get(b), partial[item, u])
        acc = None
        for b in sorted(blocks):
            acc = add(acc, blocks[b])
        g = (gain[item // s_] * np.float32(scale)).astype(np.float32)
        eq[item] = (acc * g).astype(np.complex64)
        stored[item] += 1
    return eq.reshape(k_, s_, f), stored


def rows_of(rng, shape, dtype):
    z = 0.1 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    if dtype == "int16":
        return plane_to_sc16(z.real), plane_to_sc16(z.imag)
    return z.real.astype(np.float32), z.imag.astype(np.float32)


@pytest.mark.parametrize("f", SIZES)
@pytest.mark.parametrize("a,s,k,sms,dtype", [(3, 3, 1, 1, "f32"), (2, 3, 1, 1, "int16"),
                                             (5, 2, 2, 1, "f32"), (1, 3, 1, 132, "int16"),
                                             (16, 2, 1, 132, "f32")])
def test_mirror_reproduces_the_plain_versions(f, a, s, k, sms, dtype):
    """The mirror, with symbols split over teams and blocks (one SM: few
    blocks) and whole in one team or block, against fused_pipeline_plain
    (reference order, inv, the sc16 scale) and fused_demod_plain (true
    order, hc, 1 / hsqrd) within TOL."""
    rng = np.random.default_rng(f + a * 10 + s)
    y_re, y_im = rows_of(rng, (k, s, a, f), dtype)
    h = (rng.standard_normal((k, a, f)) + 1j * rng.standard_normal((k, a, f))).astype(
        np.complex64)
    inv = (1.0 / np.sum(np.abs(h) ** 2, axis=1)).astype(np.float32)
    y = CArray(torch.from_numpy(y_re), torch.from_numpy(y_im))
    scale = pipe._scale(y)
    eq, stored = side_mirror(y_re, y_im, h, inv, scale, sms, True)
    assert np.all(stored == 1) and np.all(np.isfinite(eq))
    want = pipe.fused_pipeline_plain(y, CArray.from_numpy(h, "cpu"),
                                     torch.from_numpy(inv)).to_numpy()
    assert max_rel(eq[..., pipe.reference_order_index(f)], want) < TOL
    hc = h[0].conj()
    hs = (1.0 / inv[0]).astype(np.float32)
    eq2, _ = side_mirror(y_re[:1], y_im[:1], hc[None], (1.0 / hs)[None], scale, sms, False)
    want2 = fused_mrc.fused_demod_plain(y[0], CArray.from_numpy(hc, "cpu"),
                                        torch.from_numpy(hs)).to_numpy()
    assert max_rel(eq2[0][:, 1:], want2[:, 1:]) < TOL


@pytest.mark.parametrize("dtype", ["f32", "int16"])
@pytest.mark.parametrize("f", SIZES)
def test_mirror_matches_jax_fused_pipeline(f, dtype):
    """The mirror on 3 antennas x 3 data symbols (the estimate of the JAX
    estimate_pilot_fused, in natural order) against the JAX fused_pipeline
    + to_reference_order, Pallas in interpret mode, within TOL, with the
    symbols split over teams and blocks."""
    a, s = 3, 3
    rng = np.random.default_rng(f + (18 if dtype == "f32" else 19))
    re_, im_ = rows_of(rng, (s + 1, a, f), dtype)
    pilot = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
    rows = JCArray(jnp.asarray(re_), jnp.asarray(im_))
    h3, inv3 = jpp.estimate_pilot_fused(rows[0], jfastpath.prepare_pilot_fast(pilot, f),
                                        interpret=True)
    eq3 = jpp.fused_pipeline(rows[1:], h3.re, h3.im, inv3, interpret=True)
    want = jpp.to_reference_order(eq3, f).to_numpy()
    h, inv = convert.estimate_from_reference(np.asarray(h3.re), np.asarray(h3.im),
                                             np.asarray(inv3), device="cpu")
    y = CArray(torch.from_numpy(re_[1:]), torch.from_numpy(im_[1:]))
    eq, stored = side_mirror(re_[None, 1:], im_[None, 1:], h.to_numpy()[None],
                             inv.numpy()[None], pipe._scale(y), 1, True)
    assert np.all(stored == 1)
    got = eq[0][..., pipe.reference_order_index(f)]
    assert got.shape == want.shape == (s, f - 1)
    assert max_rel(got, want) < TOL
    assert max_rel(got, pipe.fused_pipeline_plain(y, h, inv).to_numpy()) < TOL


@pytest.mark.parametrize("dtype", ["f32", "int16"])
@pytest.mark.parametrize("f", SIZES)
def test_mirror_matches_jax_fused_demod(f, dtype):
    """The mirror of mrc_demod_side_kernel on 2 antennas x 3 symbols (the
    JAX composed estimate: hconj, hsqrd) against the JAX fused_demod,
    Pallas in interpret mode, within TOL, outside the DC bin (meaningless in
    both)."""
    a, s = 2, 3
    rng = np.random.default_rng(f + (28 if dtype == "f32" else 29))
    re_, im_ = rows_of(rng, (s, a, f), dtype)
    y = CArray(torch.from_numpy(re_), torch.from_numpy(im_))
    scale = pipe._scale(y)
    pilot_td = (rng.standard_normal((a, f)) + 1j * rng.standard_normal((a, f))).astype(
        np.complex64)
    px = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
    hconj, hsqrd = jls.estimate_channel_full(jfft.get_fft("four_step")(
        JCArray.from_numpy(pilot_td)), jls.pad_pilot(px))
    data = (re_.astype(np.float32) * np.float32(scale)
            + 1j * (im_.astype(np.float32) * np.float32(scale))).astype(np.complex64)
    want = jax_fused_demod(JCArray.from_numpy(data), hconj, hsqrd, interpret=True).to_numpy()
    hc, hs = hconj.to_numpy(), np.array(hsqrd, np.float32)
    eq, stored = side_mirror(re_[None], im_[None], hc[None], (1.0 / hs)[None], scale, 1, False)
    assert np.all(stored == 1)
    assert max_rel(eq[0][:, 1:], want[:, 1:]) < TOL
    plain = fused_mrc.fused_demod_plain(y, CArray.from_numpy(hc, "cpu"), torch.from_numpy(hs))
    assert max_rel(eq[0][:, 1:], plain.to_numpy()[:, 1:]) < TOL


def test_plan_constants_match_the_source():
    """The rules the plan shares with csrc/fft_side.cuh and the C entries:
    the side plans, the blocks, the teams' rows, the scratch's slots, the
    shared memory layout the entries check the plan's bytes against, and
    the routing of the four sizes to the side kernels (and away from the
    register kernels)."""
    src = (CSRC / "fft_side.cuh").read_text()
    rows = re.findall(r"^OFDM_SIDE_PLAN\((\d+), (\d+), (\d+), (\d+), (\d+), (\d+), (\d+)\)",
                      src, re.M)
    header = {int(r[0]): (tuple(int(v) for v in r[1:4] if int(v) > 1), int(r[4]), int(r[5]),
                          int(r[6])) for r in rows}
    assert header == fp.SIDE_PLANS
    assert "const unsigned long long x = static_cast<unsigned long long>(rows) * u;" in src
    assert ("return static_cast<int>(x >> 32 ? x / teams\n"
            "                                  : static_cast<unsigned>(x) / "
            "static_cast<unsigned>(teams));" in src)                          # team_lo
    assert "const long long most = (rows + kTeams - 1) / kTeams;" in src      # plan_blocks
    assert "const long long fit = static_cast<long long>(Shape<F>::kBlocksPerSm) * sms;" in src
    assert "const long long chain = (rows + full * kTeams - 1) / (full * kTeams);" in src
    assert ("for (long long b = full; b >= 1 && (rows + b * kTeams - 1) / (b * kTeams) <= "
            "chain + 1; --b) {\n    if ((rows / A) % b == 0) return static_cast<int>(b);" in src)
    assert "static constexpr int kSlots = 2 + kTeams;" in src
    assert ("static constexpr int kTeamOffset = 2 * G::kTwiddles;\n"
            "  static constexpr int kFlagOffset = kTeamOffset + kTeams * G::kTeamFloats;\n"
            "  static constexpr int kBoundInts = (kTeams + 4) / 4 * 4;\n"
            "  static constexpr size_t kSmemBytes =\n"
            "      static_cast<size_t>(kFlagOffset + 4 + kBoundInts + 4 * (kTeams + 1)) * "
            "sizeof(float);"
            in src)
    # A block's slot of a symbol it shares: 0 where the symbol holds its first row.
    assert "partial<F>(p, b, first_row <= blo ? 0 : 1)" in src
    assert "team_lo(p.rows, p.blocks, b0) == first_row ? 0 : 1" in src
    assert "return F == 256 || F == 512 || F == 2048 || F == 4096;" in src
    assert tuple(fp.SIDE_FFT_SIZES) == (256, 512, 2048, 4096)
    for f in SIZES:
        p = fp.side_geometry(f)
        assert fp.side_slots(f) == 2 + p.block // p.threads
        teams = fp.side_teams(f)
        assert fp.side_smem_bytes(f) == 4 * (2 * len(fp.side_twiddles_np(f))
                                             + teams * fp.team_floats(f, p) + 4
                                             + (teams + 4) // 4 * 4 + 4 * (teams + 1))
    for name in ("fft_mrc", "mrc_demod"):
        entry = (CSRC / f"{name}.cu").read_text()
        assert "!ofdm::side::plan_ok(F, rows, A, slots, lag, h" in entry
        for e, aligned in ((e, a) for e in ("int16_t", "float") for a in ("true", "false")):
            assert f"side::launch<F>({name}_side_kernel<F, {e}, {aligned}>, p, st)" in entry
        for f in SIZES:
            assert f"OFDM_{name.upper()}_CASE({f})" not in entry   # not on team_rows
            assert f"ofdm::side_{name}<{f}>(i16, al, p, st)" in entry
        for f in (64, 128, 1024):
            assert f"OFDM_{name.upper()}_CASE({f})" in entry       # still on team_rows


def test_register_plans_are_unchanged():
    """``PLANS`` and csrc/fft_warp.cuh's Plan<F> lines are those the pilot,
    the split form and the data kernels at 64, 128 and 1024 run."""
    assert fp.PLANS == {64: ((8, 8), 4, 128, 4), 128: ((16, 8), 4, 128, 4),
                        256: ((16, 16), 4, 128, 4), 512: ((32, 16), 4, 128, 2),
                        1024: ((32, 32), 4, 128, 2), 2048: ((32, 8, 8), 2, 128, 1),
                        4096: ((32, 16, 8), 2, 256, 1), 8192: ((32, 16, 16), 1, 256, 1)}
    header = (CSRC / "fft_warp.cuh").read_text()
    assert re.findall(r"^OFDM_WARP_PLAN\(.*\)$", header, re.M) == [
        "OFDM_WARP_PLAN(64, 8, 8, 1, 4, 128, 4)", "OFDM_WARP_PLAN(128, 16, 8, 1, 4, 128, 4)",
        "OFDM_WARP_PLAN(256, 16, 16, 1, 4, 128, 4)", "OFDM_WARP_PLAN(512, 32, 16, 1, 4, 128, 2)",
        "OFDM_WARP_PLAN(1024, 32, 32, 1, 4, 128, 2)", "OFDM_WARP_PLAN(2048, 32, 8, 8, 2, 128, 1)",
        "OFDM_WARP_PLAN(4096, 32, 16, 8, 2, 256, 1)", "OFDM_WARP_PLAN(8192, 32, 16, 16, 1, 256, 1)"]
    for f in fp.PLANS:
        assert fp.pass_twiddles_np(f).shape == fp.pass_twiddles_np(f, fp.plan(f)).shape


class _Lib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.mark.parametrize("f", SIZES)
@pytest.mark.parametrize("k,s,a", [(1, 100, 16), (1, 1, 16), (20, 100, 16), (1, 1, 64),
                                   (2, 7, 3)])
def test_wrappers_hand_the_kernels_their_plan(monkeypatch, f, k, s, a):
    """fused_pipeline (exact) and fused_demod at the side sizes on a
    recording library: the twiddles are the side form's table, the scratch
    the partials [B, 2 + teams, F, 2] float32, slots and lag the plan's
    blocks and shared memory, the counts int32 zeros (at least K S) that
    the next call on the stream takes again."""
    lib = _Lib()
    monkeypatch.setattr(pipe, "_device_route", lambda x, name: True)
    monkeypatch.setattr(fused_mrc, "_device_route", lambda x, name: True)
    monkeypatch.setattr(build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: type("S", (), {
        "cuda_stream": 4321})())
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(pipe, "_spread_counts", {})
    seen = []
    real_empty = torch.empty

    def empty(*args, **kwargs):
        t = real_empty(*args, **kwargs)
        seen.append(t)
        return t

    monkeypatch.setattr(torch, "empty", empty)
    row = torch.zeros((1, 1, 1, f))
    y = CArray(row.expand(k, s, a, f), row.expand(k, s, a, f))
    h = CArray(torch.zeros((k, a, f)), torch.zeros((k, a, f)))
    for _ in range(2):
        pipe.fused_pipeline(y, h, torch.ones((k, f)))
    fused_mrc.fused_demod(y[0], h[0], torch.ones(f))
    counts = pipe._spread_counts[(None, 4321)]
    assert counts.dtype == torch.int32 and counts.numel() >= k * s and not counts.any()
    table = fp.side_twiddles(f, torch.device("cpu"))
    for name, args in lib.calls:
        items = k * s if name == "ofdm_fft_mrc" else s
        p = fp.side_plan(items, a, f)
        part = next(t for t in seen if t.data_ptr() == args[-5])
        assert tuple(part.shape) == (p.blocks, fp.side_slots(f), f, 2)
        assert part.dtype == torch.float32
        assert args[-4:] == (p.blocks, p.smem_bytes, counts.data_ptr(), 4321)
        assert table.data_ptr() in args
    assert [n for n, _ in lib.calls] == ["ofdm_fft_mrc", "ofdm_fft_mrc", "ofdm_mrc_demod"]
