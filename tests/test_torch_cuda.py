"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device.  On a machine with
one (and nvcc), run them without JAX, whose conftest is not needed here:

  python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerance: max-rel 2e-5, both sides being float32 FFTs (or sums) taken in
another order; sum_a|h|^2 is compared as such (inv = its reciprocal peaks at
the weakest bin).
"""

import numpy as np
import pytest
import torch

from ofdm_ls_mrc_tpu_torch import FrameConfig, golden, sim
from ofdm_ls_mrc_tpu_torch.models import StreamingDemodulator, UplinkReceiver
from ofdm_ls_mrc_tpu_torch.ops import fft_plan, fused_mrc, ls
from ofdm_ls_mrc_tpu_torch.ops import pipeline as pipe
from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray
from ofdm_ls_mrc_tpu_torch.tools import dma_probe

pytestmark = pytest.mark.cuda

TOL = 2e-5
# The pilot kernel's clusters (F, antennas): every F, antenna counts that
# give one block (1, 3), several blocks with idle teams (5), the main path's
# 4 x 4 teams (16), several rows a team (64), and teams of 16 lanes (256,
# 512) and of four warps (4096).
PILOT_GEOMETRIES = [(256, 1), (256, 5), (256, 16), (512, 3), (1024, 1), (1024, 3),
                    (1024, 5), (1024, 16), (1024, 64), (2048, 16), (4096, 5), (4096, 16),
                    (4096, 64)]
# The data kernels' row mapping: every F of the size list, antenna counts
# that leave teams without a row or give them several (1, 3, 5, 16, 64), one
# data symbol (the streaming shape), and a ragged last block where a block
# holds 2 symbols (F = 256, 512: an odd symbol count).
FFT_MRC_GEOMETRIES = [(256, 1, 6), (512, 3, 4), (1024, 16, 101), (1024, 1, 3),
                      (1024, 3, 2), (1024, 5, 6), (1024, 64, 5), (2048, 2, 4), (4096, 4, 9)]
# Cyclic prefixes: 0 and 72 keep rows 16-byte aligned (cp.async loads); 1 and
# 7 do not (the element-by-element load path).
DATA_CPS = [0, 1, 7, 72]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def max_rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def frame_on(dev, f, a, s, cp, dtype, seed=0):
    rng = np.random.default_rng(seed)
    z = 0.1 * (rng.standard_normal((s, a, f + cp)) + 1j * rng.standard_normal((s, a, f + cp)))
    if dtype == "int16":
        frame = CArray(torch.from_numpy(golden.io.plane_to_sc16(z.real)).to(dev),
                       torch.from_numpy(golden.io.plane_to_sc16(z.imag)).to(dev))
    else:
        frame = CArray.from_numpy(z.astype(np.complex64), dev)
    pilot = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
    return frame, pilot


@pytest.mark.parametrize("frames", [1, 3])
@pytest.mark.parametrize("dtype", ["f32", "int16"])
@pytest.mark.parametrize("cp", DATA_CPS)
@pytest.mark.parametrize("f,a", PILOT_GEOMETRIES)
def test_pilot_ls_kernel_matches_plain(dev, f, a, cp, dtype, frames):
    """K pilot rows [K, A, F] read in place from K frames of 2 symbols, one
    launch (K clusters)."""
    rows, pilot = frame_on(dev, f, 2 * a * frames, 1, cp, dtype)
    y = CArray(rows.re.reshape(frames, 2, a, f + cp), rows.im.reshape(frames, 2, a, f + cp))
    y = y[:, 0, :, cp:]
    x_full = ls.pad_pilot(pilot, dev)
    before = pipe.launch_counts["pilot_ls"]
    h, inv = pipe.estimate_pilot_fused(y, x_full)
    h_p, inv_p = pipe.estimate_pilot_plain(y, x_full)
    torch.cuda.synchronize()
    assert pipe.launch_counts["pilot_ls"] == before + 1
    assert h.shape == (frames, a, f) and inv.shape == (frames, f)
    assert max_rel(h.to_numpy(), h_p.to_numpy()) < TOL
    assert max_rel(1 / inv.cpu().numpy(), 1 / inv_p.cpu().numpy()) < TOL


def test_pilot_ls_refuses_a_plan_off_its_layout(dev):
    """The C entry point checks the geometry it is given against the
    kernel's own layout: pilot_plan's passes, a wrong row count, shared
    memory size or cluster size returns cudaErrorInvalidValue (1)."""
    from ofdm_ls_mrc_tpu_torch.kernels import build

    frame, pilot = frame_on(dev, 1024, 16, 1, 0, "f32")
    x_full = ls.pad_pilot(pilot, dev)
    y = frame[0]
    h = torch.empty((2, 16, 1024), device=dev)
    inv = torch.empty(1024, device=dev)
    lib = build.load_library()
    tw = fft_plan.pass_twiddles(1024, dev)

    def launch(p):
        return lib.ofdm_pilot_ls(
            y.re.data_ptr(), y.im.data_ptr(), 0, 1, 0, y.re.stride(0), 1.0, 1, 16, 1024,
            p.clusters, p.teams, p.rows, p.smem_bytes, x_full.re.data_ptr(),
            x_full.im.data_ptr(), tw.data_ptr(), h[0].data_ptr(), h[1].data_ptr(), inv.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)

    plan = fft_plan.pilot_plan(16, 1024)
    assert launch(plan) == 0
    for bad in (plan._replace(rows=2), plan._replace(smem_bytes=plan.smem_bytes + 16),
                fft_plan.PilotPlan(9, 2, 1, 64, fft_plan.pilot_smem_bytes(1024, 2))):
        assert launch(bad) == 1
    torch.cuda.synchronize()


def test_pilot_ls_rejects_what_the_plan_cannot_launch(dev):
    rows, pilot = frame_on(dev, 128, 4, 1, 0, "f32")
    with pytest.raises(ValueError, match="F=128"):
        pipe.estimate_pilot_fused(rows[0], ls.pad_pilot(pilot, dev))
    rows, pilot = frame_on(dev, 256, 4, 1, 0, "f32")
    many = CArray(rows.re.expand(65536, 4, 256), rows.im.expand(65536, 4, 256))
    with pytest.raises(ValueError, match="frames"):
        pipe.estimate_pilot_fused(many, ls.pad_pilot(pilot, dev))


@pytest.mark.parametrize("dtype", ["f32", "int16"])
@pytest.mark.parametrize("cp", DATA_CPS)
@pytest.mark.parametrize("f,a,s", FFT_MRC_GEOMETRIES)
def test_fft_mrc_kernel_matches_plain(dev, f, a, s, cp, dtype):
    frame, pilot = frame_on(dev, f, a, s, cp, dtype)
    y = frame[..., cp:]
    h, inv = pipe.estimate_pilot_plain(y[0], ls.pad_pilot(pilot, dev))
    before = pipe.launch_counts["fft_mrc"]
    out = pipe.fused_pipeline(y[1:], h, inv)
    torch.cuda.synchronize()
    assert pipe.launch_counts["fft_mrc"] == before + 1
    want = pipe.fused_pipeline_plain(y[1:], h, inv).to_numpy()
    assert out.shape == (s - 1, f - 1)
    assert max_rel(out.to_numpy(), want) < TOL


def test_receiver_on_card_matches_golden(dev):
    rng = np.random.default_rng(7)
    cfg = FrameConfig(num_antennas=16, fft_size=1024, cyclic_prefix=72, frame_len=101)
    data, _ = sim.random_symbols(rng, (cfg.num_data_symbols, cfg.num_subcarriers), "16qam")
    pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)).astype(np.complex64)
    rx_frame = sim.ChannelModel(16, 1024, num_taps=16, snr_db=25.0, seed=9).apply(
        sim.make_tx_frame(data, pilot, 72), 72)
    out = UplinkReceiver(cfg, pilot, device=dev).demod_frame(rx_frame).to_numpy()
    assert max_rel(out, golden.demod_frame(rx_frame, pilot, 72)) < 5e-5
    assert sim.evm_db(np.fft.fftshift(out, axes=-1), data) < -30.0


@pytest.mark.parametrize("dtype", ["f32", "int16"])
@pytest.mark.parametrize("cp", [0, 1, 72])
def test_capture_is_one_launch_per_kernel(dev, cp, dtype):
    rng = np.random.default_rng(8)
    cfg = FrameConfig(num_antennas=4, fft_size=1024, cyclic_prefix=cp, frame_len=9)
    shape = (3, 9, 4, 1024 + cp)
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    if dtype == "int16":
        frames = CArray(torch.from_numpy(golden.io.plane_to_sc16(0.1 * z.real)).to(dev),
                        torch.from_numpy(golden.io.plane_to_sc16(0.1 * z.imag)).to(dev))
    else:
        frames = CArray.from_numpy(z.astype(np.complex64), dev)
    pilot = np.exp(2j * np.pi * rng.random(1023)).astype(np.complex64)
    rx = UplinkReceiver(cfg, pilot, device=dev)
    pipe.reset_launch_counts()
    got = rx.demod_capture(frames).to_numpy()
    assert pipe.launch_counts == {"pilot_ls": 1, "fft_mrc": 1}
    for k in range(3):
        assert max_rel(got[k], rx.demod_frame(frames[k]).to_numpy()) < 1e-6


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    frame, pilot = frame_on(dev, 256, 2, 3, 0, "f32")
    x_full = ls.pad_pilot(pilot, dev)
    with pytest.raises(TypeError):
        pipe.estimate_pilot_fused(CArray(frame.re[0].double(), frame.im[0].double()), x_full)
    with pytest.raises(ValueError):
        pipe.estimate_pilot_fused(frame[0], ls.pad_pilot(pilot, "cpu"))
    with pytest.raises(ValueError):  # rows not contiguous
        pipe.estimate_pilot_fused(CArray(frame.re[0].t(), frame.im[0].t()), x_full)
    h, inv = pipe.estimate_pilot_plain(frame[0], x_full)
    with pytest.raises(ValueError):
        pipe.fused_pipeline(frame[1:], h, inv[:-1])


# (F, antennas, data symbols): the BASELINE 64-bin geometries, ragged last
# blocks (4 symbols a block at F = 64 and 128, 2 at 256 and 512), every F of
# the size list, one data symbol, and 1, 3, 5, 16 and 64 antennas.
DEMOD_GEOMETRIES = [(64, 1, 9), (64, 4, 17), (128, 3, 10), (256, 5, 7), (512, 3, 5),
                    (1024, 16, 100), (1024, 1, 1), (1024, 64, 4), (2048, 3, 2),
                    (4096, 2, 3)]


@pytest.mark.parametrize("dtype", ["f32", "int16"])
@pytest.mark.parametrize("cp", DATA_CPS)
@pytest.mark.parametrize("f,a,s", DEMOD_GEOMETRIES)
def test_mrc_demod_kernel_matches_plain(dev, f, a, s, cp, dtype):
    frame, pilot = frame_on(dev, f, a, s + 1, cp, dtype)
    rx = UplinkReceiver(FrameConfig(num_antennas=a, fft_size=f, cyclic_prefix=cp,
                                    frame_len=s + 1), pilot, pipeline="composed", device=dev)
    hconj, hsqrd = rx.estimate_channel(frame[0])
    y = frame[1:, :, cp:]
    before = fused_mrc.launch_counts["mrc_demod"]
    got = fused_mrc.fused_demod(y, hconj, hsqrd)
    torch.cuda.synchronize()
    assert fused_mrc.launch_counts["mrc_demod"] == before + 1
    want = fused_mrc.fused_demod_plain(y, hconj, hsqrd).to_numpy()
    assert got.shape == (s, f)
    # The DC bin is meaningless (hconj zeroed there); compare bins 1..F-1.
    assert max_rel(got.to_numpy()[:, 1:], want[:, 1:]) < TOL


def test_split_phase_on_card_matches_golden(dev):
    rng = np.random.default_rng(7)
    cfg = FrameConfig(num_antennas=16, fft_size=1024, cyclic_prefix=72, frame_len=101)
    data, _ = sim.random_symbols(rng, (cfg.num_data_symbols, cfg.num_subcarriers), "16qam")
    pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)).astype(np.complex64)
    rx_frame = sim.ChannelModel(16, 1024, num_taps=16, snr_db=25.0, seed=9).apply(
        sim.make_tx_frame(data, pilot, 72), 72)
    rx = UplinkReceiver(cfg, pilot, device=dev)
    frame = CArray.from_numpy(rx_frame, dev)
    fused_mrc.reset_launch_counts()
    out = rx.demod_data(frame[1:], *rx.estimate_channel(frame[0])).to_numpy()
    assert fused_mrc.launch_counts["mrc_demod"] == 1
    assert max_rel(out, golden.demod_frame(rx_frame, pilot, 72)) < 5e-5
    assert sim.evm_db(np.fft.fftshift(out, axes=-1), data) < -30.0


@pytest.mark.parametrize("pipeline", ["composed", "fused"])
@pytest.mark.parametrize("dtype", ["f32", "int16"])
def test_streaming_on_card_matches_demod_frame(dev, pipeline, dtype):
    frame, pilot = frame_on(dev, 1024, 16, 11, 72, dtype)
    cfg = FrameConfig(num_antennas=16, fft_size=1024, cyclic_prefix=72, frame_len=11)
    want = UplinkReceiver(cfg, pilot, pipeline="composed", device=dev).demod_frame(
        frame).to_numpy()
    sd = StreamingDemodulator(cfg, pilot, pipeline=pipeline, device=dev)
    pipe.reset_launch_counts()
    sd.push_pilot(frame[0])
    rows = np.stack([sd.push_symbol(frame[i], slot=i).to_numpy() for i in range(1, 11)])
    if pipeline == "fused":
        assert pipe.launch_counts == {"pilot_ls": 1, "fft_mrc": 10}
    assert max_rel(rows, want) < TOL


# (variant, ts, S, antennas, F): the main path's frame, a ragged last window
# at a small shape, and each window height and depth in both forms.
PROBE_CASES = [("auto", 2, 101, 16, 1024), ("manual2", 2, 101, 16, 1024),
               ("manual3s", 2, 101, 16, 1024), ("manual4", 2, 101, 16, 1024),
               ("manual4", 1, 101, 16, 1024), ("manual3s", 1, 101, 16, 1024),
               ("manual3", 2, 5, 3, 256), ("manual2s", 1, 7, 4, 512),
               ("manual4", 4, 9, 2, 128), ("manual2s", 8, 11, 1, 256),
               ("manual4s", 8, 17, 4, 512), ("manual2", 8, 9, 2, 256),
               ("auto", 2, 5, 3, 256)]


@pytest.mark.parametrize("compute", [0, 2])
@pytest.mark.parametrize("variant,ts,s,a,f", PROBE_CASES)
def test_io_probe_kernels_match_plain(dev, variant, ts, s, a, f, compute):
    yre, yim, bias, w = dma_probe.make_frames(1, s, a, f, dev, seed=3)
    bias = bias + 0.5
    name = "io_manual" if variant.startswith("manual") else "io_auto"
    before = dma_probe.launch_counts[name]
    got = dma_probe.io_probe(yre[0], yim[0], bias, w, variant=variant, ts=ts,
                             compute=compute)
    torch.cuda.synchronize()
    assert dma_probe.launch_counts[name] == before + 1
    want = dma_probe.io_probe_plain(yre[0], yim[0], bias, w, compute)
    for g, h in zip(got, want):
        assert max_rel(g.cpu().numpy(), h.cpu().numpy()) < TOL


def test_new_wrappers_reject_what_the_kernels_do_not_take(dev):
    frame, pilot = frame_on(dev, 256, 2, 3, 0, "f32")
    hconj, hsqrd = UplinkReceiver(FrameConfig(num_antennas=2, fft_size=256, frame_len=3),
                                  pilot, pipeline="composed", device=dev
                                  ).estimate_channel(frame[0])
    with pytest.raises(ValueError):
        fused_mrc.fused_demod(frame[1:], hconj, hsqrd[:-1])
    with pytest.raises(ValueError):  # rows not contiguous
        fused_mrc.fused_demod(CArray(frame.re[1:].transpose(1, 2), frame.im[1:].transpose(1, 2)),
                              hconj, hsqrd)
    yre, yim, bias, w = dma_probe.make_frames(1, 16, 16, 1024, dev)
    with pytest.raises(ValueError, match="shared memory"):
        dma_probe.io_probe(yre[0], yim[0], bias, w, variant="manual3", ts=8)
    with pytest.raises(ValueError):
        dma_probe.io_probe(yre[0], yim[0], bias[:-1], w, variant="auto")
