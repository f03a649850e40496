"""The port's whole-frame path and UplinkReceiver (ofdm_ls_mrc_tpu_torch)
against the JAX UplinkReceiver / demod_frame_fused and the NumPy golden.

The JAX fused receiver runs its Pallas kernels in interpret mode
(fft_impl="four_step", as tests/test_pallas_pipeline.py does); each JAX
result is computed once per module.  Tolerances: max-rel 5e-5 against the
JAX package (its bf16 hi/lo-split DFT is about 4e-6 relative), rtol = atol
= 2e-4 against the golden (the bound of tests/test_pallas_pipeline.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_ls_mrc_tpu.golden import dsp
from ofdm_ls_mrc_tpu.golden.io import plane_to_sc16
from ofdm_ls_mrc_tpu.models import UplinkReceiver as JaxReceiver
from ofdm_ls_mrc_tpu.ops import fastpath as jfastpath
from ofdm_ls_mrc_tpu.ops import pallas_pipeline as jpp
from ofdm_ls_mrc_tpu.ops.cplx import CArray as JCArray
from ofdm_ls_mrc_tpu.sim import ChannelModel, evm_db, make_tx_frame, random_symbols
from ofdm_ls_mrc_tpu_torch import FrameConfig, convert
from ofdm_ls_mrc_tpu_torch.models import UplinkReceiver
from ofdm_ls_mrc_tpu_torch.ops import pipeline as pipe
from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray

TOL = 5e-5
GOLDEN = dict(rtol=2e-4, atol=2e-4)


def crandn(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def max_rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def make_frame(a, f, s, cp, seed):
    rng = np.random.default_rng(seed)
    cfg = FrameConfig(num_antennas=a, fft_size=f, cyclic_prefix=cp, frame_len=s)
    frame = crandn(rng, (s, a, f + cp))
    pilot = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
    return cfg, frame, pilot


# Reference geometry's width at 4 antennas, with the live RX cyclic prefix.
MAIN = (4, 1024, 9, 72)
_JAX = {}


def jax_main():
    """JAX fused and composed receivers on the MAIN frame (cached)."""
    if not _JAX:
        cfg, frame, pilot = make_frame(*MAIN, seed=11)
        _JAX["fused"] = JaxReceiver(cfg, pilot, pipeline="fused",
                                    fft_impl="four_step").demod_frame(frame).to_numpy()
        _JAX["composed"] = JaxReceiver(cfg, pilot, pipeline="composed").demod_frame(
            frame).to_numpy()
    return _JAX


@pytest.mark.parametrize("pipeline", ["fused", "composed"])
def test_receiver_matches_jax_and_golden(pipeline):
    cfg, frame, pilot = make_frame(*MAIN, seed=11)
    got = UplinkReceiver(cfg, pilot, pipeline=pipeline, device="cpu").demod_frame(frame).to_numpy()
    assert got.shape == (cfg.num_data_symbols, cfg.num_subcarriers)
    for jax_pipeline, want in jax_main().items():
        assert max_rel(got, want) < TOL, jax_pipeline
    np.testing.assert_allclose(got, dsp.demod_frame(frame, pilot, cfg.cyclic_prefix), **GOLDEN)


def test_demod_frame_fused_matches_jax():
    cfg, frame, pilot = make_frame(*MAIN, seed=11)
    x_full = convert.pilot_from_reference(
        jfastpath.prepare_pilot_fast(pilot, cfg.fft_size).to_numpy(), device="cpu")
    got = pipe.demod_frame_fused(CArray.from_numpy(frame, "cpu"), x_full,
                                 cp=cfg.cyclic_prefix).to_numpy()
    assert max_rel(got, jax_main()["fused"]) < TOL


def test_sc16_frame_matches_jax_kernel_and_golden():
    """int16 planes straight into the fused path (one antenna, F=256, cp 0)."""
    rng = np.random.default_rng(12)
    s, a, f = 17, 1, 256
    z = 0.1 * crandn(rng, (s, a, f))
    re, im = plane_to_sc16(z.real), plane_to_sc16(z.imag)
    pilot = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
    want = jpp.demod_frame_fused(JCArray(jnp.asarray(re), jnp.asarray(im)),
                                 jfastpath.prepare_pilot_fast(pilot, f), cp=0,
                                 interpret=True).to_numpy()
    cfg = FrameConfig(num_antennas=a, fft_size=f, cyclic_prefix=0, frame_len=s)
    got = UplinkReceiver(cfg, pilot, device="cpu").demod_frame(
        CArray(torch.from_numpy(re), torch.from_numpy(im))).to_numpy()
    assert max_rel(got, want) < TOL
    dequant = (re.astype(np.float32) + 1j * im.astype(np.float32)) / 32767.0
    np.testing.assert_allclose(got, dsp.demod_frame(dequant.astype(np.complex64), pilot, 0),
                               **GOLDEN)


@pytest.mark.parametrize("a,f,s", [(1, 256, 5), (4, 256, 17), (4, 1024, 9)])
def test_demod_parts_equals_demod_frame(a, f, s):
    cfg, frame, pilot = make_frame(a, f, s, 0, seed=13)
    rx = UplinkReceiver(cfg, pilot, device="cpu")
    whole = rx.demod_frame(frame).to_numpy()
    parts = rx.demod_parts(frame[0], frame[1:]).to_numpy()
    np.testing.assert_array_equal(parts, whole)


@pytest.mark.parametrize("pipeline", ["fused", "composed"])
@pytest.mark.parametrize("cp", [0, 72])
def test_demod_capture_equals_per_frame(pipeline, cp):
    rng = np.random.default_rng(14)
    cfg = FrameConfig(num_antennas=4, fft_size=256, cyclic_prefix=cp, frame_len=5)
    frames = crandn(rng, (3, 5, 4, 256 + cp))
    pilot = np.exp(2j * np.pi * rng.random(255)).astype(np.complex64)
    rx = UplinkReceiver(cfg, pilot, pipeline=pipeline, device="cpu")
    got = rx.demod_capture(frames).to_numpy()
    assert got.shape == (3, 4, 255)
    for k in range(3):
        assert max_rel(got[k], rx.demod_frame(frames[k]).to_numpy()) < 1e-6


@pytest.mark.parametrize("cp", [0, 72])
def test_split_phase_matches_jax(cp):
    cfg, frame, pilot = make_frame(4, 256, 9, cp, seed=15)
    rx = UplinkReceiver(cfg, pilot, device="cpu")
    jrx = JaxReceiver(cfg, pilot, pipeline="composed")
    hconj, hsqrd = rx.estimate_channel(frame[0])
    jhconj, jhsqrd = jrx.estimate_channel(frame[0])
    assert max_rel(hconj.to_numpy(), jhconj.to_numpy()) < TOL
    assert max_rel(hsqrd.numpy(), np.asarray(jhsqrd)) < TOL
    got = rx.demod_data(frame[1:], hconj, hsqrd).to_numpy()
    assert max_rel(got, jrx.demod_data(frame[1:], jhconj, jhsqrd).to_numpy()) < TOL
    np.testing.assert_allclose(got, rx.demod_frame(frame).to_numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pipeline", ["fused", "composed"])
def test_evm_through_channel(pipeline):
    rng = np.random.default_rng(16)
    cfg = FrameConfig(num_antennas=4, fft_size=256, cyclic_prefix=16, frame_len=9)
    data, _ = random_symbols(rng, (cfg.num_data_symbols, cfg.num_subcarriers), "16qam")
    pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)).astype(np.complex64)
    rx_frame = ChannelModel(4, 256, num_taps=8, snr_db=30.0, seed=9).apply(
        make_tx_frame(data, pilot, 16), 16)
    out = UplinkReceiver(cfg, pilot, pipeline=pipeline, device="cpu").demod_frame(rx_frame).to_numpy()
    assert evm_db(np.fft.fftshift(out, axes=-1), data) < -30.0


def test_warmup_and_module_buffers():
    cfg, frame, pilot = make_frame(2, 256, 3, 8, seed=17)
    rx = UplinkReceiver(cfg, pilot, device="cpu")
    rx.warmup()
    assert set(dict(rx.named_buffers())) == {"x_full_re", "x_full_im"}
    assert rx.device == torch.device("cpu")
    np.testing.assert_array_equal(rx(frame).to_numpy(), rx.demod_frame(frame).to_numpy())


def test_loud_errors(monkeypatch):
    cfg, frame, pilot = make_frame(2, 256, 3, 0, seed=18)
    with pytest.raises(NotImplementedError, match="fast"):
        UplinkReceiver(cfg, pilot, pipeline="fast")
    with pytest.raises(NotImplementedError, match="exact"):
        UplinkReceiver(cfg, pilot, exact=False)
    with pytest.raises(ValueError, match="unknown pipeline"):
        UplinkReceiver(cfg, pilot, pipeline="xla")
    small = FrameConfig(num_antennas=2, fft_size=128, frame_len=3)
    with pytest.raises(ValueError, match="fft_size"):
        UplinkReceiver(small, pilot[:127])
    UplinkReceiver(small, pilot[:127], pipeline="composed", device="cpu")  # any size
    with pytest.raises(ValueError, match="cyclic_prefix=0"):
        UplinkReceiver(FrameConfig(num_antennas=2, fft_size=256, cyclic_prefix=8,
                                   frame_len=3), pilot, device="cpu").demod_parts(frame[0], frame[1:])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        UplinkReceiver(cfg, pilot, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA"):
        UplinkReceiver(cfg, pilot)  # the default device is the card
