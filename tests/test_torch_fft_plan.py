"""The data kernels' register FFT (csrc/fft_warp.cuh) checked on the CPU
through its host tables (ofdm_ls_mrc_tpu_torch.ops.fft_plan).

The CUDA kernels cannot run here, so a numpy emulation of their arithmetic
runs the same passes on the package's own twiddle table, exchange slots
and bin-to-lane map, and must reproduce np.fft.fft within 1e-6 relative
(float32 tables and arithmetic: a few 1e-7).  The kernel header's plan
table and small-DFT constants are read from the source and held to the
package's; the exchange must be free of shared-memory bank conflicts.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ofdm_ls_mrc_tpu_torch.ops import fft_plan as fp
from ofdm_ls_mrc_tpu_torch.ops import pipeline as pipe
from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray
from ofdm_ls_mrc_tpu_torch.ops.fused_mrc import MRC_DEMOD_FFT_SIZES

HEADER = Path(fp.__file__).resolve().parent.parent / "csrc" / "fft_warp.cuh"
# The register FFT's sizes: the fused sizes but the split form's (which run
# it at F = n1 and 128, tests/test_torch_large_fft.py).
SIZES = sorted((set(MRC_DEMOD_FFT_SIZES) | set(pipe.FUSED_FFT_SIZES)) - set(fp.SPLIT_FFT_SIZES))
SMEM_PER_SM = 233472      # H100: 228 KB of shared memory per SM
SMEM_PER_BLOCK = 232448   # 227 KB opt-in per block


def dft_matrix(r: int) -> np.ndarray:
    k = np.arange(r)
    return np.exp(-2j * np.pi * np.outer(k, k) / r).astype(np.complex64)


def emulate(x: np.ndarray) -> np.ndarray:
    """The kernel's passes over one row, in complex64: thread j reads
    positions j + T m into register m, runs its butterflies b = j + T q
    (twiddle, R-point DFT), and writes each pass but the last into the
    exchange plane at exchange_slot; the result is scattered by lane_bins."""
    f = x.shape[0]
    p = fp.plan(f)
    m_vals, t = p.values, p.threads
    tab = fp.pass_twiddles_np(f)
    tab = (tab[:, 0] + 1j * tab[:, 1]).astype(np.complex64)
    j = np.arange(t)[:, None]
    pos = j + t * np.arange(m_vals)[None, :]
    regs = x.astype(np.complex64)[pos]
    plane = np.full(fp.plane_floats(f), np.nan, np.complex64)
    off = 0
    passes = list(zip(p.radices, fp.strides(f)))
    for k, (radix, ns) in enumerate(passes):
        if k > 0:
            regs = plane[fp.exchange_slot(f, pos)]
        q_count = m_vals // radix
        for q in range(q_count):
            b = np.arange(t) + t * q
            slots = q + q_count * np.arange(radix)
            v = regs[:, slots]
            if k > 0:
                v = v * tab[off + np.arange(radix)[None, :] * ns + (b % ns)[:, None]]
            regs[:, slots] = v @ dft_matrix(radix).T
        if k > 0:
            off += radix * ns
        if k + 1 < len(passes):
            b = (np.arange(t)[:, None] + t * np.arange(q_count)[None, :]).reshape(-1)
            dst = ((b // ns) * ns * radix + b % ns)[:, None] + ns * np.arange(radix)[None, :]
            vals = np.stack([regs[:, q + q_count * np.arange(radix)] for q in range(q_count)], 1)
            plane[fp.exchange_slot(f, dst)] = vals.reshape(-1, radix)
    out = np.full(f, np.nan, np.complex64)
    out[fp.lane_bins(f)] = regs
    return out


@pytest.mark.parametrize("f", SIZES)
def test_register_fft_emulation_matches_numpy(f):
    rng = np.random.default_rng(f)
    x = rng.standard_normal(f) + 1j * rng.standard_normal(f)
    want = np.fft.fft(x)
    got = emulate(x)
    assert np.all(np.isfinite(got))
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-6


@pytest.mark.parametrize("f", SIZES)
def test_lane_bins_cover_every_bin_once(f):
    bins = fp.lane_bins(f)
    p = fp.plan(f)
    assert bins.shape == (p.threads, p.values)
    assert sorted(bins.reshape(-1)) == list(range(f))


def test_plans_match_the_kernel_header():
    rows = re.findall(r"^OFDM_WARP_PLAN\((\d+), (\d+), (\d+), (\d+), (\d+), (\d+), (\d+)\)",
                      HEADER.read_text(), re.M)
    header = {int(r[0]): (tuple(int(v) for v in r[1:4] if int(v) > 1),
                          int(r[4]), int(r[5]), int(r[6])) for r in rows}
    assert header == fp.PLANS
    assert set(fp.PLANS) == set(SIZES)


def test_small_dft_constants_are_cos_pi_16():
    body = HEADER.read_text().split("constexpr float cos_pi16(int k)")[1].split("}")[0]
    got = {int(k): np.float32(v) for k, v in re.findall(r"k == (\d)\s+\? ([0-9.]+)f", body)}
    assert sorted(got) == list(range(8)) and body.rstrip().endswith(": 0.0f;")  # k = 8
    for k, v in got.items():
        assert v == np.float32(np.cos(np.pi * k / 16)), k


def bank_degree(words) -> int:
    """Shared-memory wavefronts one warp access of 32-bit words takes."""
    banks = {}
    for w in set(int(w) for w in words):
        banks.setdefault(w % 32, set()).add(w)
    return max(len(v) for v in banks.values())


@pytest.mark.parametrize("f", SIZES)
def test_exchange_is_free_of_bank_conflicts(f):
    """Every staged read, exchange write and exchange read of a warp (its
    lanes possibly spread over several teams' buffers) hits 32 banks."""
    p = fp.plan(f)
    m_vals, t = p.values, p.threads
    lanes = np.arange(32)
    team, j = (lanes // t, lanes % t) if t <= 32 else (np.zeros(32, int), lanes)
    base = team * fp.team_floats(f)
    for m in range(m_vals):
        assert bank_degree(base + j + t * m) == 1                           # staged f32
        assert bank_degree((2 * base + j + t * m) // 2) == 1                # staged int16
        assert bank_degree(base + fp.exchange_slot(f, j + t * m)) == 1      # exchange read
    for radix, ns in list(zip(p.radices, fp.strides(f)))[:-1]:
        for q in range(m_vals // radix):
            b = j + t * q
            for r in range(radix):
                e = (b // ns) * ns * radix + b % ns + ns * r
                assert bank_degree(base + fp.exchange_slot(f, e)) == 1     # exchange write


@pytest.mark.parametrize("f", SIZES)
def test_shared_memory_fits_and_aligns(f):
    p = fp.plan(f)
    assert fp.plane_floats(f) % 4 == 0 and fp.team_floats(f) % 4 == 0   # 16-byte rows
    assert len(fp.pass_twiddles_np(f)) % 2 == 0                          # buffers 16-byte aligned
    assert fp.plane_floats(f) >= fp.exchange_slot(f, f - 1) + 1
    assert fp.smem_bytes(f) <= SMEM_PER_BLOCK
    assert p.min_blocks * (fp.smem_bytes(f) + 1024) <= SMEM_PER_SM
    assert p.symbols_per_block * p.teams_per_symbol * p.threads == p.block


def test_pass_twiddles_are_float64_rounded():
    f = 4096
    tab = fp.pass_twiddles_np(f)
    p = fp.plan(f)
    ns = fp.strides(f)
    assert tab.dtype == np.float32 and len(tab) == sum(r * s for r, s in zip(p.radices[1:], ns[1:]))
    r, c = 5, 17  # pass 1: entry r Ns + c
    ang = -2.0 * np.pi * c * r / (ns[1] * p.radices[1])
    assert tab[r * ns[1] + c, 0] == np.float32(np.cos(ang))
    assert tab[r * ns[1] + c, 1] == np.float32(np.sin(ang))
    assert fp.pass_twiddles(f, torch.device("cpu")) is fp.pass_twiddles(f, torch.device("cpu"))


@pytest.mark.parametrize("cp,dtype,aligned", [(0, torch.float32, True), (72, torch.float32, True),
                                              (72, torch.int16, True), (1, torch.float32, False),
                                              (7, torch.int16, False)])
def test_rows_aligned_selects_the_load_path(cp, dtype, aligned):
    frame = torch.zeros((5, 4, 1024 + cp), dtype=dtype)
    rows = CArray(frame, frame.clone())[1:, :, cp:]
    assert pipe._rows_aligned(rows) is aligned


def test_unknown_size_raises():
    with pytest.raises(ValueError):
        fp.plan(32)
