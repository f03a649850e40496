"""The split-phase data path (ofdm_ls_mrc_tpu_torch.ops.fused_mrc and
UplinkReceiver.estimate_channel/demod_data) against the JAX
``pallas_mrc.fused_demod`` kernel in interpret mode, the JAX receiver and
the NumPy golden.

Inputs are made with numpy from a seed; the JAX estimate (hconj, hsqrd) is
handed to both sides, so each comparison is of the data kernel alone.
Tolerances are max-abs / max|want|: 2e-4 against the JAX kernel and
receiver (its fp32-HIGHEST four-step dots against torch.fft; the bound of
tests/test_pallas.py's XLA comparison), 5e-4 against the golden.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_ls_mrc_tpu.golden import dsp
from ofdm_ls_mrc_tpu.golden.io import plane_to_sc16
from ofdm_ls_mrc_tpu.models import UplinkReceiver as JaxReceiver
from ofdm_ls_mrc_tpu.ops import fft as jfft
from ofdm_ls_mrc_tpu.ops import ls as jls
from ofdm_ls_mrc_tpu.ops import mrc as jmrc
from ofdm_ls_mrc_tpu.ops.cplx import CArray as JCArray
from ofdm_ls_mrc_tpu.ops.pallas_mrc import fused_demod as jax_fused_demod
from ofdm_ls_mrc_tpu_torch import FrameConfig
from ofdm_ls_mrc_tpu_torch.models import UplinkReceiver
from ofdm_ls_mrc_tpu_torch.ops import fused_mrc
from ofdm_ls_mrc_tpu_torch.ops import mrc as tmrc
from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray

JAX_TOL = 2e-4
GOLDEN_TOL = 5e-4


def crandn(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def max_rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def case(a, f, s, seed):
    """Data rows [S, A, F] and the JAX composed estimate of a random pilot."""
    rng = np.random.default_rng(seed)
    pilot_td = crandn(rng, (a, f))
    data_td = crandn(rng, (s, a, f))
    px = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
    fft = jfft.get_fft("four_step")
    hconj, hsqrd = jls.estimate_channel_full(fft(JCArray.from_numpy(pilot_td)),
                                             jls.pad_pilot(px))
    return data_td, hconj, hsqrd, pilot_td, px


def port_estimate(hconj, hsqrd):
    return (CArray.from_numpy(hconj.to_numpy(), "cpu"),
            torch.from_numpy(np.array(hsqrd, dtype=np.float32)))


# The cases of tests/test_pallas.py: (a, F, S).
CASES = [(4, 64, 6), (8, 256, 10), (2, 1024, 9), (4, 128, 12)]


@pytest.mark.parametrize("a,f,s", CASES)
def test_fused_demod_matches_jax_kernel(a, f, s):
    data_td, hconj, hsqrd, _, _ = case(a, f, s, seed=f + a)
    want = jax_fused_demod(JCArray.from_numpy(data_td), hconj, hsqrd,
                           interpret=True).to_numpy()
    y = CArray.from_numpy(data_td, "cpu")
    th, tsq = port_estimate(hconj, hsqrd)
    plain = fused_mrc.fused_demod_plain(y, th, tsq).to_numpy()
    wrapped = fused_mrc.fused_demod(y, th, tsq).to_numpy()
    assert plain.shape == want.shape == (s, f)
    assert max_rel(plain, want) < JAX_TOL
    np.testing.assert_array_equal(wrapped, plain)


@pytest.mark.parametrize("a", [3, 5, 6, 7])
def test_fused_demod_any_antenna_count(a):
    """Every antenna is in the sum (the JAX kernel once dropped a % ac)."""
    data_td, hconj, hsqrd, pilot_td, px = case(a, 64, 4, seed=a)
    want = jax_fused_demod(JCArray.from_numpy(data_td), hconj, hsqrd,
                           interpret=True).to_numpy()
    th, tsq = port_estimate(hconj, hsqrd)
    got = fused_mrc.fused_demod(CArray.from_numpy(data_td, "cpu"), th, tsq)
    assert max_rel(got.to_numpy(), want) < JAX_TOL
    want_h, want_hs = dsp.estimate_channel(pilot_td, px)
    gold = np.stack([dsp.demod_symbol(data_td[i], want_h, want_hs) for i in range(4)])
    assert max_rel(tmrc.finalize(got).to_numpy(), gold) < GOLDEN_TOL


@pytest.mark.parametrize("f", [64, 1024])
def test_fused_demod_int16_equals_widened_f32(f):
    rng = np.random.default_rng(f)
    z = 0.1 * crandn(rng, (5, 3, f))
    re, im = plane_to_sc16(z.real), plane_to_sc16(z.imag)
    wre, wim = (v.astype(np.float32) / np.float32(32767.0) for v in (re, im))
    _, hconj, hsqrd, _, _ = case(3, f, 5, seed=f)
    th, tsq = port_estimate(hconj, hsqrd)
    got = fused_mrc.fused_demod(CArray(torch.from_numpy(re), torch.from_numpy(im)), th, tsq)
    same = fused_mrc.fused_demod(CArray(torch.from_numpy(wre), torch.from_numpy(wim)), th, tsq)
    np.testing.assert_array_equal(got.to_numpy(), same.to_numpy())
    want = jax_fused_demod(JCArray(jnp.asarray(wre), jnp.asarray(wim)), hconj, hsqrd,
                           interpret=True).to_numpy()
    assert max_rel(got.to_numpy(), want) < JAX_TOL


def test_fused_demod_rejects_what_the_kernel_does_not_take():
    th = CArray.from_numpy(np.ones((2, 32), np.complex64), "cpu")
    for f in (32, 96, 65536):
        y = CArray.from_numpy(np.ones((3, 2, f), np.complex64), "cpu")
        with pytest.raises(ValueError, match="F="):
            fused_mrc.fused_demod(y, th, torch.ones(f))
    with pytest.raises(ValueError, match=r"\[S, A, F\]"):
        fused_mrc.fused_demod(CArray.from_numpy(np.ones((2, 64), np.complex64), "cpu"),
                              th, torch.ones(64))


@pytest.mark.parametrize("pipeline", ["fused", "composed"])
@pytest.mark.parametrize("cp", [0, 72])
def test_split_phase_matches_jax_receiver_and_golden(pipeline, cp):
    rng = np.random.default_rng(20 + cp)
    a, f, s = 4, 256, 9
    cfg = FrameConfig(num_antennas=a, fft_size=f, cyclic_prefix=cp, frame_len=s)
    frame = crandn(rng, (s, a, f + cp))
    pilot = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
    rx = UplinkReceiver(cfg, pilot, pipeline=pipeline, device="cpu")
    hconj, hsqrd = rx.estimate_channel(frame[0])
    got = rx.demod_data(frame[1:], hconj, hsqrd).to_numpy()
    assert got.shape == (s - 1, f - 1)
    jrx = JaxReceiver(cfg, pilot, pipeline="composed")
    jh, jsq = jrx.estimate_channel(frame[0])
    assert max_rel(got, jrx.demod_data(frame[1:], jh, jsq).to_numpy()) < JAX_TOL
    # The JAX kernel on the same data rows, finalized as its callers do.
    jeq = jax_fused_demod(JCArray.from_numpy(frame[1:, :, cp:]), jh, jsq, interpret=True)
    assert max_rel(got, jmrc.finalize(jeq).to_numpy()) < JAX_TOL
    assert max_rel(got, dsp.demod_frame(frame, pilot, cp)) < GOLDEN_TOL


def test_split_phase_estimates_are_interchangeable():
    """An estimate from either pipeline (or from the JAX receiver) demods
    the same under both."""
    rng = np.random.default_rng(30)
    cfg = FrameConfig(num_antennas=2, fft_size=256, cyclic_prefix=8, frame_len=4)
    frame = crandn(rng, (4, 2, 264))
    pilot = np.exp(2j * np.pi * rng.random(255)).astype(np.complex64)
    fused = UplinkReceiver(cfg, pilot, pipeline="fused", device="cpu")
    composed = UplinkReceiver(cfg, pilot, pipeline="composed", device="cpu")
    est = fused.estimate_channel(frame[0])
    jh, jsq = JaxReceiver(cfg, pilot, pipeline="composed").estimate_channel(frame[0])
    jest = (CArray.from_numpy(jh.to_numpy(), "cpu"), torch.from_numpy(np.array(jsq)))
    want = composed.demod_data(frame[1:], *composed.estimate_channel(frame[0])).to_numpy()
    for rx in (fused, composed):
        for e in (est, jest):
            assert max_rel(rx.demod_data(frame[1:], *e).to_numpy(), want) < 1e-5
    assert jnp.allclose(jsq, jnp.asarray(est[1].numpy()), rtol=1e-5)
