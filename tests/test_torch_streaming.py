"""The per-symbol streaming demodulator (ofdm_ls_mrc_tpu_torch.models.
streaming), its state files (io/state.py) and the state map (convert.py)
against the JAX StreamingDemodulator, the port's demod_frame and the golden.

Inputs are made with numpy from a seed.  The JAX fused body runs its
Pallas kernel interpreted on the CPU (fft_impl="four_step"); its results
are computed once per module.  Tolerances are max-abs / max|want|: 2e-4
against the JAX package (its bf16 hi/lo-split stage-2 DFT), 1e-5 against
the port's own whole-frame path (the same float32 formulas), 5e-4 against
the golden.
"""

import numpy as np
import pytest
import torch

from ofdm_ls_mrc_tpu.golden import dsp
from ofdm_ls_mrc_tpu.models import StreamingDemodulator as JaxStreaming
from ofdm_ls_mrc_tpu_torch import FrameConfig, convert
from ofdm_ls_mrc_tpu_torch.golden.io import complex_to_sc16, load_times
from ofdm_ls_mrc_tpu_torch.models import StreamingDemodulator, UplinkReceiver
from ofdm_ls_mrc_tpu_torch.ops import pipeline as pipe
from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray
from ofdm_ls_mrc_tpu_torch.utils.timing import PhaseTimer

JAX_TOL = 2e-4
PORT_TOL = 1e-5
GOLDEN_TOL = 5e-4

CFG = FrameConfig(num_antennas=2, fft_size=256, cyclic_prefix=16, frame_len=5)
BODIES = ["composed", "fused"]


def crandn(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def max_rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def make(seed=0, cfg=CFG):
    rng = np.random.default_rng(seed)
    frame = crandn(rng, (cfg.frame_len, cfg.num_antennas, cfg.symbol_len))
    pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)).astype(np.complex64)
    return frame, pilot


def stream(sd, frame):
    sd.push_pilot(frame[0])
    return np.stack([sd.push_symbol(frame[i], slot=i).to_numpy()
                     for i in range(1, len(frame))])


_JAX = {}


def jax_streaming(body):
    """The JAX demodulator after the frame's pilot, and its rows (cached)."""
    if body not in _JAX:
        frame, pilot = make()
        sd = JaxStreaming(CFG, pilot, fft_impl="four_step", pipeline=body)
        assert sd.pipeline == body
        _JAX[body] = (sd, stream(sd, frame))
    return _JAX[body]


@pytest.mark.parametrize("body", BODIES)
def test_streaming_matches_jax_and_demod_frame(body):
    frame, pilot = make()
    sd = StreamingDemodulator(CFG, pilot, pipeline=body, device="cpu")
    rows = stream(sd, frame)
    assert rows.shape == (CFG.num_data_symbols, CFG.num_subcarriers)
    for jax_body in BODIES:
        assert max_rel(rows, jax_streaming(jax_body)[1]) < JAX_TOL, jax_body
    for pipeline in ("fused", "composed"):
        whole = UplinkReceiver(CFG, pilot, pipeline=pipeline, device="cpu").demod_frame(frame)
        assert max_rel(rows, whole.to_numpy()) < PORT_TOL
    assert max_rel(rows, dsp.demod_frame(frame, pilot, CFG.cyclic_prefix)) < GOLDEN_TOL


@pytest.mark.parametrize("body", BODIES)
def test_int16_symbols_match_quantized_golden(body):
    frame, pilot = make(seed=1)
    frame = 0.05 * frame
    planes, quantized = [], []
    for sym in frame:
        sc16 = complex_to_sc16(sym)
        re, im = np.ascontiguousarray(sc16[:, ::2]), np.ascontiguousarray(sc16[:, 1::2])
        planes.append(CArray(torch.from_numpy(re), torch.from_numpy(im)))
        quantized.append((re.astype(np.float32) + 1j * im.astype(np.float32)) / 32767.0)
    want = dsp.demod_frame(np.stack(quantized).astype(np.complex64), pilot, CFG.cyclic_prefix)
    sd = StreamingDemodulator(CFG, pilot, pipeline=body, device="cpu")
    sd.warmup(int16=True)
    assert not sd.has_estimate
    sd.push_pilot(planes[0])
    rows = np.stack([sd.push_symbol(p).to_numpy() for p in planes[1:]])
    assert max_rel(rows, want) < GOLDEN_TOL


def test_fused_state_map_from_jax():
    """convert.streaming_state_from_reference turns the JAX fused state
    (fastpath permuted h, 1/sum|h|^2) into the port's fused (h, inv)."""
    frame, pilot = make()
    jsd, _ = jax_streaming("fused")
    h, inv = convert.streaming_state_from_reference(
        np.asarray(jsd._hconj.re), np.asarray(jsd._hconj.im), np.asarray(jsd._hsqrd),
        device="cpu")
    sd = StreamingDemodulator(CFG, pilot, pipeline="fused", device="cpu")
    sd.push_pilot(frame[0])
    assert max_rel(h.to_numpy(), sd._h.to_numpy()) < JAX_TOL
    assert max_rel(1 / inv.numpy(), 1 / sd._g.numpy()) < JAX_TOL
    sd._h, sd._g = h, inv
    want = jax_streaming("fused")[1][0]
    assert max_rel(sd.push_symbol(frame[1]).to_numpy(), want) < JAX_TOL


@pytest.mark.parametrize("saver", BODIES)
@pytest.mark.parametrize("loader", BODIES)
def test_state_files_cross_packages(tmp_path, saver, loader):
    """A .npz saved by either package, from either body, resumes in the
    other package under either body."""
    frame, pilot = make()
    want = jax_streaming("composed")[1][0]

    port_path = str(tmp_path / "port_state")  # no extension: written as given
    sd = StreamingDemodulator(CFG, pilot, pipeline=saver, device="cpu")
    sd.push_pilot(frame[0])
    sd.save_state(port_path, frame_index=7)
    jsd = JaxStreaming(CFG, pilot, fft_impl="four_step", pipeline=loader)
    assert jsd.resume(port_path) == 7
    assert max_rel(jsd.push_symbol(frame[1]).to_numpy(), want) < JAX_TOL

    jax_path = str(tmp_path / "jax_state")
    jax_streaming(saver)[0].save_state(jax_path, frame_index=9)
    sd2 = StreamingDemodulator(CFG, pilot, pipeline=loader, device="cpu")
    assert sd2.resume(jax_path) == 9
    assert max_rel(sd2.push_symbol(frame[1]).to_numpy(), want) < JAX_TOL


def test_resume_rejects_other_geometry(tmp_path):
    frame, pilot = make()
    sd = StreamingDemodulator(CFG, pilot, device="cpu")
    sd.push_pilot(frame[0])
    path = str(tmp_path / "state.npz")
    sd.save_state(path)
    other = FrameConfig(num_antennas=4, fft_size=256, cyclic_prefix=16, frame_len=5)
    _, other_pilot = make(cfg=other)
    with pytest.raises(ValueError, match="num_antennas"):
        StreamingDemodulator(other, other_pilot, device="cpu").resume(path)
    with pytest.raises(RuntimeError, match="no channel estimate"):
        StreamingDemodulator(CFG, pilot, device="cpu").save_state(path)


@pytest.mark.parametrize("body", BODIES)
def test_timer_and_async(body, tmp_path):
    frame, pilot = make(seed=2)
    timer = PhaseTimer(num_slots=CFG.frame_len)
    sd = StreamingDemodulator(CFG, pilot, pipeline=body, timer=timer, device="cpu")
    sd.push_pilot(frame[0], slot=0)
    rows = [sd.push_symbol(frame[i], slot=i).to_numpy() for i in range(1, CFG.frame_len)]
    s = timer.summary()
    assert s["chanest"][0] > 0 and s["decode"][0] > 0 and timer.frame_latency() > 0
    assert timer.counts["decode"][1:].tolist() == [1] * (CFG.frame_len - 1)
    for i in range(1, CFG.frame_len):
        np.testing.assert_array_equal(sd.push_symbol_async(frame[i]).to_numpy(), rows[i - 1])
    assert timer.counts["decode"][1:].tolist() == [1] * (CFG.frame_len - 1)
    timer.store_times(str(tmp_path / "time_gpu.dat"))
    assert load_times(str(tmp_path / "time_gpu.dat")).shape == (5,)


def test_fused_body_runs_the_kernels_wrappers(monkeypatch):
    """The fused body calls estimate_pilot_fused once per pilot and
    fused_pipeline once per symbol, with S = 1."""
    calls = []
    real_est, real_pipe = pipe.estimate_pilot_fused, pipe.fused_pipeline

    def est(pilot, x_full):
        calls.append(("estimate", pilot.shape))
        return real_est(pilot, x_full)

    def data(y, h, inv):
        calls.append(("data", y.shape))
        return real_pipe(y, h, inv)

    monkeypatch.setattr(pipe, "estimate_pilot_fused", est)
    monkeypatch.setattr(pipe, "fused_pipeline", data)
    frame, pilot = make()
    stream(StreamingDemodulator(CFG, pilot, pipeline="fused", device="cpu"), frame)
    a, f = CFG.num_antennas, CFG.fft_size
    assert calls == [("estimate", (a, f))] + [("data", (1, a, f))] * CFG.num_data_symbols


def test_pilot_refresh_and_loud_errors(monkeypatch):
    frame, pilot = make(seed=3)
    other, _ = make(seed=4)
    sd = StreamingDemodulator(CFG, pilot, device="cpu")
    with pytest.raises(RuntimeError, match="push_pilot"):
        sd.push_symbol(frame[1])
    with pytest.raises(RuntimeError, match="push_pilot"):
        sd.push_symbol_async(frame[1])
    sd.push_pilot(frame[0])
    a = sd.push_symbol(frame[1]).to_numpy()
    sd.push_pilot(other[0])
    assert not np.allclose(a, sd.push_symbol(frame[1]).to_numpy())
    small = FrameConfig(num_antennas=2, fft_size=128, cyclic_prefix=0, frame_len=3)
    with pytest.raises(ValueError, match="fft_size"):  # no silent fallback
        StreamingDemodulator(small, pilot[:127], pipeline="fused", device="cpu")
    StreamingDemodulator(small, pilot[:127], device="cpu")  # composed covers any size
    with pytest.raises(ValueError, match="unknown pipeline"):
        StreamingDemodulator(CFG, pilot, pipeline="fast", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        StreamingDemodulator(CFG, pilot)  # the default device is the card
