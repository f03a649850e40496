"""The port's own copies of the JAX package's NumPy-only modules
(config.FrameConfig, golden, sim, utils.timing) give the originals' output
for the same inputs and seeds, exactly: the port no longer imports the
originals, so these tests keep the two from drifting apart."""

import dataclasses

import numpy as np
import pytest

import ofdm_ls_mrc_tpu.golden as jgolden
import ofdm_ls_mrc_tpu.sim as jsim
from ofdm_ls_mrc_tpu.config import FrameConfig as JaxFrameConfig
from ofdm_ls_mrc_tpu.utils.timing import PhaseTimer as JaxPhaseTimer
from ofdm_ls_mrc_tpu_torch import FrameConfig, golden, sim
from ofdm_ls_mrc_tpu_torch.utils.timing import PhaseTimer


def crandn(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("cp", [0, 72])
def test_golden_demod_frame_is_the_reference_copy(cp):
    rng = np.random.default_rng(cp)
    frame = crandn(rng, (5, 4, 256 + cp))
    pilot = np.exp(2j * np.pi * rng.random(255)).astype(np.complex64)
    np.testing.assert_array_equal(golden.demod_frame(frame, pilot, cp),
                                  jgolden.demod_frame(frame, pilot, cp))
    h, hs = golden.estimate_channel(frame[0, :, cp:], pilot)
    jh, jhs = jgolden.estimate_channel(frame[0, :, cp:], pilot)
    np.testing.assert_array_equal(h, jh)
    np.testing.assert_array_equal(hs, jhs)


def test_golden_ops_are_the_reference_copy():
    rng = np.random.default_rng(1)
    x = crandn(rng, (3, 255))
    data = crandn(rng, (255,))
    for name in ("pilot_shift", "output_shift", "tx_shift"):
        np.testing.assert_array_equal(getattr(golden, name)(x), getattr(jgolden, name)(x))
    cube = crandn(rng, (2, 3, 5))
    np.testing.assert_array_equal(golden.rot_cube(cube), jgolden.rot_cube(cube))
    np.testing.assert_array_equal(golden.modulate_symbol(data, 16),
                                  jgolden.modulate_symbol(data, 16))
    np.testing.assert_array_equal(golden.add_cyclic_prefix(x, 8), jgolden.add_cyclic_prefix(x, 8))
    h = crandn(rng, (4, 2, 16))
    np.testing.assert_array_equal(golden.zf_precoder(h), jgolden.zf_precoder(h))
    assert golden.PILOT_FILL == jgolden.PILOT_FILL


def test_golden_io_is_the_reference_copy(tmp_path):
    rng = np.random.default_rng(2)
    z = 0.3 * crandn(rng, (4, 64))
    np.testing.assert_array_equal(golden.io.complex_to_sc16(z), jgolden.io.complex_to_sc16(z))
    np.testing.assert_array_equal(golden.io.plane_to_sc16(z.real),
                                  jgolden.io.plane_to_sc16(z.real))
    iq = golden.io.complex_to_sc16(z)
    np.testing.assert_array_equal(golden.io.sc16_to_complex(iq), jgolden.io.sc16_to_complex(iq))
    assert golden.io.SC16_FULL_SCALE == jgolden.io.SC16_FULL_SCALE
    golden.write_pilot(str(tmp_path / "p.dat"), z[0])
    np.testing.assert_array_equal(golden.load_pilot(str(tmp_path / "p.dat"), 64),
                                  jgolden.load_pilot(str(tmp_path / "p.dat"), 64))
    golden.store_times(str(tmp_path / "t.dat"), 1.0, 2.0, 3.0, 4.0, 5.0)
    np.testing.assert_array_equal(jgolden.load_times(str(tmp_path / "t.dat")),
                                  [1.0, 2.0, 3.0, 4.0, 5.0])
    golden.append_output(str(tmp_path / "o.dat"), z[:, :63], truncate=True)
    np.testing.assert_array_equal(jgolden.read_output(str(tmp_path / "o.dat"), 63), z[:, :63])


@pytest.mark.parametrize("cp", [0, 16])
def test_sim_channel_is_the_reference_copy(cp):
    data, idx = sim.random_symbols(np.random.default_rng(3), (4, 255), "16qam")
    jdata, jidx = jsim.random_symbols(np.random.default_rng(3), (4, 255), "16qam")
    np.testing.assert_array_equal(data, jdata)
    np.testing.assert_array_equal(idx, jidx)
    pilot = np.exp(2j * np.pi * np.random.default_rng(4).random(255)).astype(np.complex64)
    tx = sim.make_tx_frame(data, pilot, cp)
    np.testing.assert_array_equal(tx, jsim.make_tx_frame(data, pilot, cp))
    rx = sim.ChannelModel(4, 256, num_taps=8, snr_db=20.0, seed=9).apply(tx, cp)
    jrx = jsim.ChannelModel(4, 256, num_taps=8, snr_db=20.0, seed=9).apply(tx, cp)
    np.testing.assert_array_equal(rx, jrx)
    assert sim.evm_db(rx[1:, 0, cp:cp + 255], data) == jsim.evm_db(jrx[1:, 0, cp:cp + 255], data)
    for scheme in sim.CONSTELLATIONS:
        np.testing.assert_array_equal(sim.CONSTELLATIONS[scheme], jsim.CONSTELLATIONS[scheme])
        np.testing.assert_array_equal(sim.demap_symbols(data, scheme),
                                      jsim.demap_symbols(data, scheme))


def test_frame_config_is_the_reference_copy():
    port = {f.name: f.default for f in dataclasses.fields(FrameConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JaxFrameConfig)}
    assert port == ref
    cfg = FrameConfig(num_antennas=4, fft_size=256, cyclic_prefix=16, frame_len=9)
    jcfg = JaxFrameConfig(num_antennas=4, fft_size=256, cyclic_prefix=16, frame_len=9)
    for prop in ("num_subcarriers", "num_data_symbols", "symbol_len", "samples_per_frame"):
        assert getattr(cfg, prop) == getattr(jcfg, prop)
    for bad in (dict(num_antennas=0), dict(fft_size=7), dict(cyclic_prefix=-1),
                dict(frame_len=1)):
        with pytest.raises(ValueError):
            FrameConfig(**bad).validate()
        with pytest.raises(ValueError):
            JaxFrameConfig(**bad).validate()


def test_phase_timer_is_the_reference_copy(tmp_path):
    timers = (PhaseTimer(num_slots=4, num_times=2), JaxPhaseTimer(num_slots=4, num_times=2))
    for t in timers:
        for i, p in enumerate(("read", "fft", "decode", "drop", "chanest")):
            for slot in range(4):
                t.add(p, slot, 1e-3 * (i + 1) * (slot + 1))
        t.add("decode", 2, 7e-3)
    assert timers[0].summary() == timers[1].summary()
    assert timers[0].frame_latency() == timers[1].frame_latency()
    for k, t in enumerate(timers):
        t.store_times(str(tmp_path / f"t{k}.dat"))
    assert (tmp_path / "t0.dat").read_bytes() == (tmp_path / "t1.dat").read_bytes()
