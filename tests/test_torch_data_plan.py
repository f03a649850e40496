"""The exact data kernels at F = 8192 (csrc/fft_spread.cuh: fft_mrc.cu
fft_mrc_spread_kernel, mrc_demod.cu mrc_demod_spread_kernel) checked on the
CPU through their plan (ofdm_ls_mrc_tpu_torch.ops.fft_plan spread_plan).

A launch of N = K S A antenna rows runs on B = min(SMs, ceil(N / 4))
blocks, block b taking the rows [b N / B, (b + 1) N / B) in order on one
team of the register FFT, adding Y conj(h) (or Y hc) into its sums in row
order; a symbol that lies in one block is stored by it, the others' blocks
write partials, count in per symbol, and the last to count adds the
partials in block order.  The CUDA kernels cannot run here, so the plan's
coverage (every row to one block, every symbol's bins to one owner
whatever the order the blocks count in, a partial slot to at most one
symbol), the last pass's twiddles by products, and a numpy mirror of the
kernels' arithmetic (the register FFT on the package's tables with those
twiddles, the split and the fixed-order sums) against the
plain versions and the JAX package's fused_pipeline and fused_demod (Pallas
in interpret mode) within TOL = 5e-5 are checked below, as are the
constants the plan shares with the source and the buffers the wrappers
hand the kernels.
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

F = fp.SPREAD_FFT
TOL = 5e-5
CSRC = Path(fp.__file__).resolve().parent.parent / "csrc"
ANTENNAS = (1, 2, 3, 16, 64)
SYMBOLS = (1, 7, 100)


def max_rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def dft_matrix(r: int) -> np.ndarray:
    k = np.arange(r)
    return np.exp(-2j * np.pi * np.outer(k, k) / r).astype(np.complex64)


def last_twiddles() -> np.ndarray:
    """[T, M // R, R] complex64: the last pass's twiddles as the spread
    kernels form them (csrc/fft_spread.cuh last_pass): butterfly b = j + T q
    (column c = b < Ns) takes exp(-2 pi i c r / F) for r in fp.SPREAD_POWERS
    from ``pass_twiddles_np``'s last block and the others as float32
    complex products, w3 = w2 w1, w5 = w4 w1, w6 = w4 w2, w7 = w4 w3,
    w(8 + r) = w8 w(r)."""
    p = fp.plan(F)
    radix, ns, t = p.radices[2], p.radices[0] * p.radices[1], p.threads
    last = fp.pass_twiddles_np(F)[p.radices[0] * p.radices[1]:]
    last = (last[:, 0] + 1j * last[:, 1]).astype(np.complex64).reshape(radix, ns)
    q_count = p.values // radix
    c = np.arange(t)[:, None] + t * np.arange(q_count)[None, :]
    w = np.empty((t, q_count, radix), np.complex64)
    w[..., 0] = 1
    for r in fp.SPREAD_POWERS:
        w[..., r] = last[r][c]

    def mul(x, y):   # float32 complex product, as fft.cuh cmul
        xr, xi, yr, yi = x.real, x.imag, y.real, y.imag
        return (xr * yr - xi * yi).astype(np.float32) + 1j * (xr * yi + xi * yr).astype(
            np.float32)

    for r, (x, y) in {3: (2, 1), 5: (4, 1), 6: (4, 2), 7: (4, 3)}.items():
        w[..., r] = mul(w[..., x], w[..., y])
    for r in range(1, 8):
        w[..., 8 + r] = mul(w[..., 8], w[..., r])
    return w


def emulate_rows(x: np.ndarray) -> np.ndarray:
    """The spread kernels' FFT of rows x [n, F], complex64: thread j of the
    team holds positions j + T m in register m; the first two passes as
    tests/test_torch_fft_plan.py emulate runs them (the package's table, the
    exchanges at ``exchange_slot``), the last with ``last_twiddles``
    (products of the table's rows 1, 2, 4, 8); bin j + T m from register
    m."""
    p = fp.plan(F)
    m_vals, t = p.values, p.threads
    tab = fp.pass_twiddles_np(F)
    tab = (tab[:, 0] + 1j * tab[:, 1]).astype(np.complex64)
    last = last_twiddles()
    j = np.arange(t)[:, None]
    pos = j + t * np.arange(m_vals)[None, :]
    regs = x.astype(np.complex64)[:, pos]                  # [n, T, M]
    plane = np.full((x.shape[0], fp.plane_floats(F)), np.nan, np.complex64)
    passes = list(zip(p.radices, fp.strides(F)))
    off = 0
    for k, (radix, ns) in enumerate(passes):
        if k > 0:
            regs = plane[:, fp.exchange_slot(F, pos)]
        q_count = m_vals // radix
        for q in range(q_count):
            b = np.arange(t) + t * q
            slots = q + q_count * np.arange(radix)
            v = regs[:, :, slots]
            if k == len(passes) - 1:
                v = (v * last[:, q, :]).astype(np.complex64)
            elif k > 0:
                v = v * tab[off + np.arange(radix)[None, :] * ns + (b % ns)[:, None]]
            regs[:, :, slots] = v @ dft_matrix(radix).T
        if k > 0:
            off += radix * ns
        if k + 1 < len(passes):
            b = (np.arange(t)[:, None] + t * np.arange(q_count)[None, :]).reshape(-1)
            dst = ((b // ns) * ns * radix + b % ns)[:, None] + ns * np.arange(radix)[None, :]
            vals = np.stack([regs[:, :, q + q_count * np.arange(radix)]
                             for q in range(q_count)], 2)
            plane[:, fp.exchange_slot(F, dst)] = vals.reshape(x.shape[0], -1, radix)
    out = np.full(x.shape, np.nan, np.complex64)
    out[:, fp.lane_bins(F)] = regs
    return out


def count_owners(items: int, a: int, order_seed: int):
    """Which block stores each symbol, emulated: a symbol whose rows lie in
    one block is stored by it; the blocks of a split symbol count in (the
    blocks in a random order), the one that completes its count stores it
    and sets the count back to 0.  Returns (owner of each symbol, the
    counts left)."""
    rows = items * a
    blocks = fp.spread_plan(items, a).blocks
    counts = np.zeros(items, int)
    owner = np.full(items, -1)
    rng = np.random.default_rng(order_seed)
    for item in range(items):
        bs = fp.spread_symbol_blocks(item, a, rows, blocks)
        if len(bs) == 1:
            owner[item] = bs[0]
            continue
        for b in rng.permutation(list(bs)):
            counts[item] += 1
            if counts[item] == len(bs):
                counts[item] = 0
                assert owner[item] == -1
                owner[item] = b
    return owner, counts


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("s", SYMBOLS)
@pytest.mark.parametrize("a", ANTENNAS)
def test_plan_gives_every_row_one_block(a, s, k):
    """Every (symbol, antenna) row of K frames goes to exactly one block; no
    more blocks than SMs, none with fewer than SPREAD_MIN_ROWS - 1 rows
    (all of them where there are fewer); a block holds part of at most two
    symbols, so a partial slot holds at most one symbol's partial;
    block_of inverts the ranges."""
    items = k * s
    rows = items * a
    p = fp.spread_plan(items, a)
    assert p.blocks == min(fp.H100_SMS, -(-rows // fp.SPREAD_MIN_ROWS))
    assert p.threads == fp.plan(F).threads == 256
    seen = np.zeros(rows, int)
    slots = {}
    for b in range(p.blocks):
        r = fp.spread_block_rows(rows, p.blocks, b)
        assert len(r) >= min(rows, fp.SPREAD_MIN_ROWS - 1)
        for g in r:
            seen[g] += 1
            assert fp.spread_row_block(rows, p.blocks, g) == b
        for item in sorted({g // a for g in r}):
            whole = item * a >= r.start and (item + 1) * a <= r.stop
            if not whole:
                key = (b, fp.spread_partial_slot(item, a, rows, p.blocks, b))
                assert key not in slots, (key, item, slots[key])
                slots[key] = item
    assert np.all(seen == 1)
    for item in range(items):
        bs = fp.spread_symbol_blocks(item, a, rows, p.blocks)
        got = sorted({fp.spread_row_block(rows, p.blocks, g)
                      for g in range(item * a, (item + 1) * a)})
        assert got == list(bs)
    if (a, s, k) == (16, 100, 1):   # one frame: 12 or 13 rows on each of the 132 SMs
        assert p.blocks == 132
        assert {len(fp.spread_block_rows(rows, p.blocks, b)) for b in range(132)} == {12, 13}
    if (a, s) == (16, 1) and k == 1:  # a streamed symbol: 4 blocks of 4 rows
        assert p.blocks == 4


@pytest.mark.parametrize("s", SYMBOLS)
@pytest.mark.parametrize("a", ANTENNAS)
def test_every_bin_has_one_owner_in_any_order(a, s):
    """Each symbol is stored once, by one block whatever the order its
    blocks count in, and that block's team stores every one of its F bins
    once (thread j of the team's T holds bins j + T m); every count is left
    at 0 for the next launch on the stream."""
    owners = [count_owners(s, a, seed) for seed in range(3)]
    for owner, counts in owners:
        assert np.all(owner >= 0) and np.all(counts == 0)
    bins = fp.lane_bins(F)
    assert sorted(bins.reshape(-1)) == list(range(F))


def test_plan_raises_for_an_empty_launch():
    for items, a in ((0, 16), (1, 0)):
        with pytest.raises(ValueError, match="spread_plan"):
            fp.spread_plan(items, a)


def test_last_pass_twiddles_are_float32_products():
    """The last pass (radix 16, Ns = 512) takes the table's rows 1, 2, 4, 8
    as they are and the others as products, within 4e-7 of the float64
    values; the FFT with them matches np.fft within 1e-6."""
    w = last_twiddles()
    p = fp.plan(F)
    t, radix = p.threads, p.radices[2]
    c = np.arange(t)[:, None, None] + t * np.arange(p.values // radix)[None, :, None]
    want = np.exp(-2j * np.pi * c * np.arange(radix)[None, None, :] / F)
    assert w.dtype == np.complex64 and np.max(np.abs(w - want)) < 4e-7
    tab = fp.pass_twiddles_np(F)[p.radices[0] * p.radices[1]:]
    for r in fp.SPREAD_POWERS:
        row = tab[r * 512:(r + 1) * 512]
        np.testing.assert_array_equal(w[..., r], (row[:, 0] + 1j * row[:, 1])[c[..., 0]])
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, F)) + 1j * rng.standard_normal((2, F))
    assert max_rel(emulate_rows(x), np.fft.fft(x, axis=-1)) < 1e-6


def spread_mirror(y_re, y_im, h, gain, scale: float, sms: int, conjugate: bool):
    """csrc/fft_spread.cuh spread_rows on rows [K, S, A, F] (planes) with h
    [K, A, F] complex64 and gains [K, F] (inv; mrc_demod: 1 / hsqrd, K = 1)
    in numpy: each row's FFT (``emulate_rows``), Y conj(h) (or Y h) in
    complex64, each block's sums in row order in float32, a symbol stored
    from one block or added over its blocks' partials in block order, then
    times gain * scale.  Returns (eq [K, S, F] complex64, how often each
    symbol was stored)."""
    k_, s_, a, _ = y_re.shape
    items, rows = k_ * s_, k_ * s_ * a
    blocks = fp.spread_plan(items, a, sms).blocks
    x = (y_re.astype(np.float32) + 1j * y_im.astype(np.float32)).astype(np.complex64)
    spec = emulate_rows(x.reshape(rows, F)).reshape(k_, s_, a, F)
    hh = h.conj() if conjugate else h
    prod = (spec * hh[:, None]).astype(np.complex64).reshape(rows, F)
    partial = {}
    for b in range(blocks):
        acc = None
        for g in fp.spread_block_rows(rows, blocks, b):
            acc = prod[g] if acc is None or g % a == 0 else (acc + prod[g]).astype(np.complex64)
            if (g + 1) % a == 0 or g + 1 == fp.spread_block_rows(rows, blocks, b).stop:
                partial[g // a, b] = acc
    eq = np.full((items, F), np.nan, np.complex64)
    stored = np.zeros(items, int)
    for item in range(items):
        acc = None
        for b in fp.spread_symbol_blocks(item, a, rows, blocks):
            acc = partial[item, b] if acc is None else (acc + partial[item, b]).astype(np.complex64)
        g = (gain[item // s_] * np.float32(scale)).astype(np.float32)
        eq[item] = (acc * g).astype(np.complex64)
        stored[item] += 1
    return eq.reshape(k_, s_, F), stored


def rows_of(rng, shape, dtype):
    z = 0.1 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    if dtype == "int16":
        return plane_to_sc16(z.real), plane_to_sc16(z.imag)
    return z.real.astype(np.float32), z.imag.astype(np.float32)


@pytest.mark.parametrize("a,s,k,sms,dtype", [(3, 3, 1, 4, "f32"), (2, 3, 1, 2, "int16"),
                                             (3, 2, 2, 3, "f32"), (1, 3, 1, 132, "int16")])
def test_mirror_reproduces_the_plain_versions(a, s, k, sms, dtype):
    """The mirror, with symbols split over blocks (few SMs) and whole in one,
    against fused_pipeline_plain (reference order, inv, the sc16 scale) and
    fused_demod_plain (true order, hc, 1 / hsqrd) within TOL."""
    rng = np.random.default_rng(a * 10 + s)
    y_re, y_im = rows_of(rng, (k, s, a, F), dtype)
    h = (rng.standard_normal((k, a, F)) + 1j * rng.standard_normal((k, a, F))).astype(
        np.complex64)
    inv = (1.0 / np.sum(np.abs(h) ** 2, axis=1)).astype(np.float32)
    y = CArray(torch.from_numpy(y_re), torch.from_numpy(y_im))
    scale = pipe._scale(y)
    eq, stored = spread_mirror(y_re, y_im, h, inv, scale, sms, True)
    assert np.all(stored == 1) and np.all(np.isfinite(eq))
    want = pipe.fused_pipeline_plain(y, CArray.from_numpy(h, "cpu"),
                                     torch.from_numpy(inv)).to_numpy()
    assert max_rel(eq[..., pipe.reference_order_index(F)], want) < TOL
    hc = h[0].conj()
    hs = (1.0 / inv[0]).astype(np.float32)
    eq2, _ = spread_mirror(y_re[:1], y_im[:1], hc[None], (1.0 / hs)[None], scale, sms, False)
    want2 = fused_mrc.fused_demod_plain(y[0], CArray.from_numpy(hc, "cpu"),
                                        torch.from_numpy(hs)).to_numpy()
    assert max_rel(eq2[0][:, 1:], want2[:, 1:]) < TOL


@pytest.mark.parametrize("dtype", ["f32", "int16"])
def test_mirror_matches_jax_fused_pipeline(dtype):
    """The mirror on 3 antennas x 3 data symbols (the estimate of the JAX
    estimate_pilot_fused, in natural order) against the JAX fused_pipeline
    + to_reference_order, Pallas in interpret mode, within TOL, with the
    symbols split over blocks."""
    a, s = 3, 3
    rng = np.random.default_rng(18 if dtype == "f32" else 19)
    re_, im_ = rows_of(rng, (s + 1, a, F), dtype)
    pilot = np.exp(2j * np.pi * rng.random(F - 1)).astype(np.complex64)
    rows = JCArray(jnp.asarray(re_), jnp.asarray(im_))
    h3, inv3 = jpp.estimate_pilot_fused(rows[0], jfastpath.prepare_pilot_fast(pilot, F),
                                        interpret=True)
    eq3 = jpp.fused_pipeline(rows[1:], h3.re, h3.im, inv3, interpret=True)
    want = jpp.to_reference_order(eq3, F).to_numpy()
    h, inv = convert.estimate_from_reference(np.asarray(h3.re), np.asarray(h3.im),
                                             np.asarray(inv3), device="cpu")
    y = CArray(torch.from_numpy(re_[1:]), torch.from_numpy(im_[1:]))
    eq, stored = spread_mirror(re_[None, 1:], im_[None, 1:], h.to_numpy()[None],
                               inv.numpy()[None], pipe._scale(y), 4, True)
    assert np.all(stored == 1)
    got = eq[0][..., pipe.reference_order_index(F)]
    assert got.shape == want.shape == (s, F - 1)
    assert max_rel(got, want) < TOL
    assert max_rel(got, pipe.fused_pipeline_plain(y, h, inv).to_numpy()) < TOL


@pytest.mark.parametrize("dtype", ["f32", "int16"])
def test_mirror_matches_jax_fused_demod(dtype):
    """The mirror of mrc_demod_spread_kernel on 3 antennas x 3 symbols (the
    JAX composed estimate: hconj, hsqrd) against the JAX fused_demod,
    Pallas in interpret mode, within TOL, outside the DC bin (meaningless in
    both)."""
    a, s = 3, 3
    rng = np.random.default_rng(28 if dtype == "f32" else 29)
    re_, im_ = rows_of(rng, (s, a, F), dtype)
    y = CArray(torch.from_numpy(re_), torch.from_numpy(im_))
    scale = pipe._scale(y)
    pilot_td = (rng.standard_normal((a, F)) + 1j * rng.standard_normal((a, F))).astype(
        np.complex64)
    px = np.exp(2j * np.pi * rng.random(F - 1)).astype(np.complex64)
    hconj, hsqrd = jls.estimate_channel_full(jfft.get_fft("four_step")(
        JCArray.from_numpy(pilot_td)), jls.pad_pilot(px))
    data = (re_.astype(np.float32) * np.float32(scale)
            + 1j * (im_.astype(np.float32) * np.float32(scale))).astype(np.complex64)
    want = jax_fused_demod(JCArray.from_numpy(data), hconj, hsqrd, interpret=True).to_numpy()
    hc, hs = hconj.to_numpy(), np.array(hsqrd, np.float32)
    eq, stored = spread_mirror(re_[None], im_[None], hc[None], (1.0 / hs)[None], scale, 2,
                               False)
    assert np.all(stored == 1)
    assert max_rel(eq[0][:, 1:], want[:, 1:]) < TOL
    plain = fused_mrc.fused_demod_plain(y, CArray.from_numpy(hc, "cpu"), torch.from_numpy(hs))
    assert max_rel(eq[0][:, 1:], plain.to_numpy()[:, 1:]) < TOL


def test_plan_constants_match_the_source():
    """The rules the plan shares with csrc/fft_spread.cuh and the C entries:
    the rows a block, the last pass's staged rows, the blocks, the row ranges, the
    shared memory layout the entries check the plan's bytes against."""
    src = (CSRC / "fft_spread.cuh").read_text()
    assert f"constexpr int kF = {F};" in src
    assert f"constexpr int kMinRows = {fp.SPREAD_MIN_ROWS};" in src
    assert f"constexpr int kPowers = {len(fp.SPREAD_POWERS)};" in src
    assert "pw[i] = p.tw[Geo::kTw1 + (1 << (i / kNs)) * kNs + i % kNs];" in src
    assert [1 << i for i in range(len(fp.SPREAD_POWERS))] == list(fp.SPREAD_POWERS)
    assert "return rows * b / blocks;" in src                               # block_lo
    assert "return static_cast<int>(((g + 1) * blocks - 1) / rows);" in src  # block_of
    assert "const long long most = (rows + kMinRows - 1) / kMinRows;" in src  # plan_blocks
    assert "return static_cast<int>(most < sms ? most : sms);" in src
    assert "const int slot = item == block_lo(p.rows, p.blocks, b) / p.A ? 0 : 1;" in src
    assert ("constexpr int kBufOffset = 2 * (Geo::kTw1 + kPowers * kNs);\n"
            "constexpr int kFlagOffset = kBufOffset + 2 * 2 * kPlane;\n"
            "constexpr size_t kSmemBytes = static_cast<size_t>(kFlagOffset + 4) * sizeof(float);"
            in src)
    p = fp.plan(F)
    assert fp.spread_smem_bytes() == 4 * (2 * (512 + 4 * 512) + 2 * 2 * fp.plane_floats(F)
                                          + 4) == 155664 <= 232448
    assert p.radices == (32, 16, 16) and p.threads == 256
    for name in ("fft_mrc", "mrc_demod"):
        entry = (CSRC / f"{name}.cu").read_text()
        assert "!ofdm::spread::plan_ok(rows, slots, lag, h" in entry
        for e, aligned in ((e, a) for e in ("int16_t", "float") for a in ("true", "false")):
            assert f"ofdm::spread::launch({name}_spread_kernel<{e}, {aligned}>, p, st)" in entry
        assert f"OFDM_{name.upper()}_CASE(8192)" not in entry   # the register kernel stops at 4096


class _Lib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.mark.parametrize("k,s,a", [(1, 100, 16), (1, 1, 16), (20, 100, 16), (1, 1, 64),
                                   (2, 7, 3)])
def test_wrappers_hand_the_kernels_their_plan(monkeypatch, k, s, a):
    """fused_pipeline (exact) and fused_demod at F = 8192 on a recording
    library: the scratch is the partials [B, 2, F, 2] float32, slots and
    lag the plan's blocks and shared memory, the counts int32 zeros (at
    least K S) that the next call on the stream takes again."""
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
    row = torch.zeros((1, 1, 1, F))
    y = CArray(row.expand(k, s, a, F), row.expand(k, s, a, F))
    h = CArray(torch.zeros((k, a, F)), torch.zeros((k, a, F)))
    for _ in range(2):
        pipe.fused_pipeline(y, h, torch.ones((k, F)))
    fused_mrc.fused_demod(y[0], h[0], torch.ones(F))
    counts = pipe._spread_counts[(None, 4321)]
    assert counts.dtype == torch.int32 and counts.numel() >= k * s and not counts.any()
    for name, args in lib.calls:
        items = k * s if name == "ofdm_fft_mrc" else s
        p = fp.spread_plan(items, a)
        part = next(t for t in seen if t.data_ptr() == args[-5])
        assert tuple(part.shape) == (p.blocks, 2, F, 2) and part.dtype == torch.float32
        assert args[-4:] == (p.blocks, p.smem_bytes, counts.data_ptr(), 4321)
    assert [n for n, _ in lib.calls] == ["ofdm_fft_mrc", "ofdm_fft_mrc", "ofdm_mrc_demod"]
