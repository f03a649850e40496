"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device.  On a machine with
one (and nvcc), run them without JAX, whose conftest is not needed here:

  python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerance: max-rel 2e-5, both sides being float32 FFTs (or sums) taken in
another order; sum_a|h|^2 is compared as such (inv = its reciprocal peaks at
the weakest bin).  The bf16 speed kernels (exact=False) against their plain
versions: EVM at least 20 dB below the plain version's EVM against the
exact path, and max-rel under 1e-2.  A bf16 rounding of stage 1 that flips
between the two float32 orders moves one output by about
2^-8 / sqrt(128) of its scale, so kernel and plain agree far better than
either agrees with the exact path, but not to 2e-5.
"""

import warnings

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
# 4 x 4 teams (16), several rows a team (64), and teams of 8 lanes (64,
# 128: 16 teams a block, a cluster of 4 at 64 antennas), of 16 lanes (256,
# 512) and of four warps (4096).
PILOT_GEOMETRIES = [(64, 1), (64, 4), (64, 16), (128, 3), (128, 64), (256, 1), (256, 5),
                    (256, 16), (512, 3), (1024, 1), (1024, 3), (1024, 5), (1024, 16),
                    (1024, 64), (2048, 16), (4096, 5), (4096, 16), (4096, 64)]
# The data kernels' row mapping: every F of the size list, antenna counts
# that leave teams without a row or give them several (1, 3, 5, 16, 64), one
# data symbol (the streaming shape), and a ragged last block where a block
# holds 2 symbols (F = 256, 512: an odd symbol count) or 4 (F = 64, 128: the
# BASELINE 64-subcarrier frames, 8 data symbols, and ragged counts); at
# the side form's sizes (256, 512, 2048, 4096) also the full 16 x F x 101
# frame and 64 antennas (symbols split over teams and blocks).
FFT_MRC_GEOMETRIES = [(64, 1, 8), (64, 4, 8), (64, 16, 101), (128, 3, 5),
                      (256, 1, 6), (512, 3, 4), (1024, 16, 101), (1024, 1, 3),
                      (1024, 3, 2), (1024, 5, 6), (1024, 64, 5), (2048, 2, 4), (4096, 4, 9)]
FFT_MRC_GEOMETRIES += [(f, a, s) for f in (256, 512, 2048, 4096) for a, s in ((16, 101), (64, 5))]
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


def evm_db(got, want):
    return float(10 * np.log10(np.mean(np.abs(got - want) ** 2) / np.mean(np.abs(want) ** 2)))


def assert_speed_agrees(kernel, plain, exact):
    """The speed kernels' criterion (module docstring)."""
    assert evm_db(kernel, plain) <= evm_db(plain, exact) - 20.0
    assert max_rel(kernel, plain) < 1e-2


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


@pytest.mark.parametrize("dtype", ["f32", "int16"])
@pytest.mark.parametrize("cp", [0, 1, 72])
@pytest.mark.parametrize("f,a", [(64, 4), (1024, 16), (1024, 32), (1024, 64), (4096, 5)])
def test_pilot_ls_sum_variant_matches_plain(dev, f, a, cp, dtype):
    """invert=False: the kernel writes sum_a |h|^2 itself (the sharded
    receivers' partial sum), counted as pilot_ls_sum; compared as the sum,
    2 frames in one launch."""
    rows, pilot = frame_on(dev, f, 2 * a * 2, 1, cp, dtype, seed=4)
    y = CArray(rows.re.reshape(2, 2, a, f + cp), rows.im.reshape(2, 2, a, f + cp))[:, 0, :, cp:]
    x_full = ls.pad_pilot(pilot, dev)
    before = dict(pipe.launch_counts)
    h, s = pipe.estimate_pilot_fused(y, x_full, invert=False)
    h_p, s_p = pipe.estimate_pilot_plain(y, x_full, invert=False)
    torch.cuda.synchronize()
    assert pipe.launch_counts["pilot_ls_sum"] == before["pilot_ls_sum"] + 1
    assert pipe.launch_counts["pilot_ls"] == before["pilot_ls"]
    assert max_rel(h.to_numpy(), h_p.to_numpy()) < TOL
    assert max_rel(s.cpu().numpy(), s_p.cpu().numpy()) < TOL


@pytest.fixture
def nccl_mesh(dev, tmp_path):
    """A process group of one rank over NCCL on the card."""
    import torch.distributed as dist

    from ofdm_ls_mrc_tpu_torch import parallel

    parallel.initialize(f"file://{tmp_path / 'store'}", 1, 0, "nccl")
    try:
        yield parallel.make_mesh(1, 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", ["f32", "int16"])
def test_sharded_receiver_over_nccl_matches_unsharded(dev, nccl_mesh, dtype):
    """World size 1 over NCCL, 64 antennas x 1024 x 11 symbols, cp 72: the
    sharded receiver's whole frame, capture and streaming rows against
    UplinkReceiver(fused) on the same frames, through pilot_ls_sum and
    fft_mrc, one all-reduce a call of the expected payload."""
    from ofdm_ls_mrc_tpu_torch import parallel
    from ofdm_ls_mrc_tpu_torch.parallel import collectives

    cfg = FrameConfig(num_antennas=64, fft_size=1024, cyclic_prefix=72, frame_len=11)
    frame, pilot = frame_on(dev, 1024, 64, 22, 72, dtype, seed=6)
    frames = CArray(frame.re.reshape(2, 11, 64, 1096), frame.im.reshape(2, 11, 64, 1096))
    one = UplinkReceiver(cfg, pilot, device=dev)
    rx = parallel.ShardedUplinkReceiver(cfg, pilot, nccl_mesh, device=dev)
    pipe.reset_launch_counts()
    collectives.reset()
    got = rx.demod_frame(frames[0]).to_numpy()
    torch.cuda.synchronize()
    assert pipe.launch_counts == {"pilot_ls": 0, "fft_mrc": 1, "pilot_ls_sum": 1,
                                  "pilot_ls_bf16": 0, "fft_mrc_bf16": 0}
    assert collectives.signature() == (1, parallel.expected_payload_words(cfg))
    assert max_rel(got, one.demod_frame(frames[0]).to_numpy()) < TOL
    cap = rx.demod_capture(frames).to_numpy()
    assert max_rel(cap, one.demod_capture(frames).to_numpy()) < TOL
    sd = parallel.ShardedStreamingDemodulator(cfg, pilot, nccl_mesh, device=dev)
    sd.push_pilot(frames[0, 0])
    rows = np.stack([sd.push_symbol(frames[0, i]).to_numpy() for i in range(1, 11)])
    assert max_rel(rows, got) < TOL


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
            1, None, 0, None, torch.cuda.current_stream(dev).cuda_stream)

    plan = fft_plan.pilot_plan(16, 1024)
    assert launch(plan) == 0
    for bad in (plan._replace(rows=2), plan._replace(smem_bytes=plan.smem_bytes + 16),
                fft_plan.PilotPlan(9, 2, 1, 64, fft_plan.pilot_smem_bytes(1024, 2))):
        assert launch(bad) == 1
    torch.cuda.synchronize()


def test_pilot_ls_rejects_what_the_plan_cannot_launch(dev):
    rows, pilot = frame_on(dev, 192, 4, 1, 0, "f32")
    with pytest.raises(ValueError, match="F=192"):
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


# The speed kernels' shapes: every F of 256-4096 (n1 = 2 .. 32), antenna
# counts whose complex rows leave a chunk part empty (1, 3, 5), fill chunks
# of 32 complex rows exactly (16, 64), split over a cluster of blocks or
# not, one data symbol (the streaming shape) and the main path's 16 x 1024
# x 100.
SPEED_GEOMETRIES = [(256, 1, 3), (256, 3, 5), (256, 5, 2), (256, 64, 2), (512, 3, 4),
                    (512, 16, 3), (1024, 16, 101), (1024, 1, 2), (1024, 3, 5),
                    (1024, 64, 3), (2048, 2, 3), (2048, 5, 2), (4096, 4, 2), (4096, 3, 3)]


@pytest.mark.parametrize("dtype", ["f32", "int16"])
@pytest.mark.parametrize("cp", [0, 7, 72])
@pytest.mark.parametrize("f,a,s", SPEED_GEOMETRIES)
def test_fft_mrc_bf16_kernel_matches_plain(dev, f, a, s, cp, dtype):
    frame, pilot = frame_on(dev, f, a, s, cp, dtype, seed=3)
    y = frame[..., cp:]
    h, inv = pipe.estimate_pilot_plain(y[0], ls.pad_pilot(pilot, dev))
    before = dict(pipe.launch_counts)
    out = pipe.fused_pipeline(y[1:], h, inv, exact=False)
    torch.cuda.synchronize()
    assert pipe.launch_counts == {**before, "fft_mrc_bf16": before["fft_mrc_bf16"] + 1}
    assert out.shape == (s - 1, f - 1)
    assert_speed_agrees(out.to_numpy(), pipe.fused_pipeline_speed_plain(y[1:], h, inv).to_numpy(),
                        pipe.fused_pipeline_plain(y[1:], h, inv).to_numpy())


@pytest.mark.parametrize("frames", [1, 3])
@pytest.mark.parametrize("dtype", ["f32", "int16"])
@pytest.mark.parametrize("cp", [0, 7, 72])
@pytest.mark.parametrize("f,a", sorted({(f, a) for f, a, _ in SPEED_GEOMETRIES}))
def test_pilot_ls_bf16_kernel_matches_plain(dev, f, a, cp, dtype, frames):
    """K pilots [K, A, F] read in place, one launch (a cluster per frame); h
    and sum_a |h|^2 against the plain version."""
    rows, pilot = frame_on(dev, f, 2 * a * frames, 1, cp, dtype, seed=6)
    y = CArray(rows.re.reshape(frames, 2, a, f + cp), rows.im.reshape(frames, 2, a, f + cp))
    y = y[:, 0, :, cp:]
    x_full = ls.pad_pilot(pilot, dev)
    before = dict(pipe.launch_counts)
    h, inv = pipe.estimate_pilot_fused(y, x_full, exact=False)
    torch.cuda.synchronize()
    assert pipe.launch_counts == {**before, "pilot_ls_bf16": before["pilot_ls_bf16"] + 1}
    assert h.shape == (frames, a, f) and inv.shape == (frames, f)
    h_p, inv_p = pipe.estimate_pilot_speed_plain(y, x_full)
    h_e, inv_e = pipe.estimate_pilot_plain(y, x_full)
    assert_speed_agrees(h.to_numpy(), h_p.to_numpy(), h_e.to_numpy())
    assert_speed_agrees(1 / inv.cpu().numpy(), 1 / inv_p.cpu().numpy(), 1 / inv_e.cpu().numpy())


@pytest.mark.parametrize("dtype", ["f32", "int16"])
def test_speed_receiver_on_card(dev, dtype):
    """UplinkReceiver(exact=False) on the main geometry through a 16-tap 25 dB
    channel: both speed kernels once, EVM at most -35 dB against the golden
    and below -30 dB against the sent symbols; demod_capture of 3 frames is
    one launch of each and equals its frames."""
    rng = np.random.default_rng(7)
    cfg = FrameConfig(num_antennas=16, fft_size=1024, cyclic_prefix=72, frame_len=101)
    data, _ = sim.random_symbols(rng, (cfg.num_data_symbols, cfg.num_subcarriers), "16qam")
    pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)).astype(np.complex64)
    rx_frame = sim.ChannelModel(16, 1024, num_taps=16, snr_db=25.0, seed=9).apply(
        sim.make_tx_frame(data, pilot, 72), 72)
    frame = CArray.from_numpy(0.5 * rx_frame, dev)
    if dtype == "int16":
        frame = CArray(torch.from_numpy(golden.io.plane_to_sc16(0.5 * rx_frame.real)).to(dev),
                       torch.from_numpy(golden.io.plane_to_sc16(0.5 * rx_frame.imag)).to(dev))
    rx = UplinkReceiver(cfg, pilot, exact=False, device=dev)
    pipe.reset_launch_counts()
    out = rx.demod_frame(frame).to_numpy()
    assert pipe.launch_counts["pilot_ls_bf16"] == pipe.launch_counts["fft_mrc_bf16"] == 1
    assert pipe.launch_counts["pilot_ls"] == pipe.launch_counts["fft_mrc"] == 0
    gold = golden.demod_frame(frame.to_numpy() if dtype == "f32" else
                              (frame.re.cpu().numpy() + 1j * frame.im.cpu().numpy())
                              / golden.io.SC16_FULL_SCALE, pilot, 72)
    assert evm_db(out, gold) <= -35.0
    assert sim.evm_db(np.fft.fftshift(out, axes=-1), data) < -30.0
    frames = CArray(torch.stack([frame.re] * 3), torch.stack([frame.im] * 3))
    pipe.reset_launch_counts()
    cap = rx.demod_capture(frames).to_numpy()
    assert pipe.launch_counts["pilot_ls_bf16"] == pipe.launch_counts["fft_mrc_bf16"] == 1
    for k in range(3):
        assert max_rel(cap[k], out) < 1e-6


def test_speed_wrappers_reject_what_the_kernels_do_not_take(dev):
    frame, pilot = frame_on(dev, 128, 2, 3, 0, "f32")
    x_full = ls.pad_pilot(pilot, dev)
    with pytest.raises(ValueError, match="speed mode"):  # F = 128: no speed kernel
        pipe.estimate_pilot_fused(frame[0], x_full, exact=False)
    frame, pilot = frame_on(dev, 256, 2, 3, 0, "f32")
    x_full = ls.pad_pilot(pilot, dev)
    with pytest.raises(ValueError, match="1/sum"):
        pipe.estimate_pilot_fused(frame[0], x_full, invert=False, exact=False)
    h, inv = pipe.estimate_pilot_plain(frame[0], x_full)
    with pytest.raises(ValueError):
        pipe.fused_pipeline(frame[1:], h, inv[:-1], exact=False)
    with pytest.raises(TypeError):
        pipe.fused_pipeline(CArray(frame.re[1:].double(), frame.im[1:].double()), h, inv,
                            exact=False)


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
    assert pipe.launch_counts == {"pilot_ls": 1, "fft_mrc": 1, "pilot_ls_sum": 0,
                                  "pilot_ls_bf16": 0, "fft_mrc_bf16": 0}
    for k in range(3):
        assert max_rel(got[k], rx.demod_frame(frames[k]).to_numpy()) < 1e-6


# The large-F geometry: F = 8192 (the register FFT's one team of 256 threads
# a symbol, the pilot's one-team blocks) and 16384, 32768 (the exact
# kernels' split form; the speed kernels take it from 8192): the main
# path's 16 antennas, antenna counts that leave row-pass teams idle or
# uneven (1, 3, 5), several rows a team (64), one data symbol, and enough
# symbols for several chunks of the split form's scratch.
LARGE_GEOMETRIES = [(8192, 16, 101), (8192, 3, 5), (8192, 64, 2), (16384, 16, 30),
                    (16384, 5, 3), (16384, 1, 2), (32768, 16, 21), (32768, 3, 4),
                    (32768, 64, 2)]


@pytest.mark.parametrize("dtype", ["f32", "int16"])
@pytest.mark.parametrize("cp", [0, 1, 72])
@pytest.mark.parametrize("f,a,s", LARGE_GEOMETRIES)
def test_large_fft_exact_kernels_match_plain(dev, f, a, s, cp, dtype):
    """pilot_ls (and its sum variant), fft_mrc and mrc_demod at F = 8192 to
    32768 against their plain versions, one launch each; three pilots in one
    call."""
    frame, pilot = frame_on(dev, f, a, s, cp, dtype, seed=5)
    y = frame[..., cp:]
    x_full = ls.pad_pilot(pilot, dev)
    pipe.reset_launch_counts()
    fused_mrc.reset_launch_counts()
    h, inv = pipe.estimate_pilot_fused(y[0], x_full)
    _, hsq = pipe.estimate_pilot_fused(y[0], x_full, invert=False)
    h_p, inv_p = pipe.estimate_pilot_plain(y[0], x_full)
    out = pipe.fused_pipeline(y[1:], h_p, inv_p)
    rx = UplinkReceiver(FrameConfig(num_antennas=a, fft_size=f, cyclic_prefix=cp, frame_len=s),
                        pilot, pipeline="composed", device=dev)
    hconj, hsqrd = rx.estimate_channel(frame[0])
    eq = fused_mrc.fused_demod(y[1:], hconj, hsqrd)
    many = CArray(torch.stack([y.re[0]] * 3), torch.stack([y.im[0]] * 3))
    h3, inv3 = pipe.estimate_pilot_fused(many, x_full)
    torch.cuda.synchronize()
    assert {k: v for k, v in pipe.launch_counts.items() if v} == {
        "pilot_ls": 2, "pilot_ls_sum": 1, "fft_mrc": 1}
    assert fused_mrc.launch_counts["mrc_demod"] == 1
    assert out.shape == (s - 1, f - 1)
    want = pipe.fused_pipeline_plain(y[1:], h_p, inv_p).to_numpy()
    assert max_rel(out.to_numpy(), want) < TOL
    h_p, sum_p = h_p.to_numpy(), 1 / inv_p.cpu().numpy()
    assert max_rel(h.to_numpy(), h_p) < TOL and max_rel(1 / inv.cpu().numpy(), sum_p) < TOL
    assert max_rel(hsq.cpu().numpy(), sum_p) < TOL
    for k in range(3):
        assert max_rel(h3.to_numpy()[k], h_p) < TOL
        assert max_rel(1 / inv3.cpu().numpy()[k], sum_p) < TOL
    want = fused_mrc.fused_demod_plain(y[1:], hconj, hsqrd).to_numpy()
    assert max_rel(eq.to_numpy()[:, 1:], want[:, 1:]) < TOL


@pytest.mark.parametrize("dtype", ["f32", "int16"])
@pytest.mark.parametrize("cp", [0, 7])
@pytest.mark.parametrize("f,a,s", LARGE_GEOMETRIES)
def test_large_fft_speed_kernels_match_plain(dev, f, a, s, cp, dtype):
    """pilot_ls_bf16 and fft_mrc_bf16 at F = 8192 to 32768 (the column pass
    and the one-warpgroup row pass) against their plain versions."""
    frame, pilot = frame_on(dev, f, a, s, cp, dtype, seed=6)
    y = frame[..., cp:]
    x_full = ls.pad_pilot(pilot, dev)
    pipe.reset_launch_counts()
    h, inv = pipe.estimate_pilot_fused(y[0], x_full, exact=False)
    h_p, inv_p = pipe.estimate_pilot_speed_plain(y[0], x_full)
    out = pipe.fused_pipeline(y[1:], h_p, inv_p, exact=False)
    torch.cuda.synchronize()
    assert pipe.launch_counts["pilot_ls_bf16"] == pipe.launch_counts["fft_mrc_bf16"] == 1
    h_e, inv_e = pipe.estimate_pilot_plain(y[0], x_full)
    assert_speed_agrees(h.to_numpy(), h_p.to_numpy(), h_e.to_numpy())
    assert_speed_agrees(1 / inv.cpu().numpy(), 1 / inv_p.cpu().numpy(), 1 / inv_e.cpu().numpy())
    assert out.shape == (s - 1, f - 1)
    assert_speed_agrees(out.to_numpy(),
                        pipe.fused_pipeline_speed_plain(y[1:], h_p, inv_p).to_numpy(),
                        pipe.fused_pipeline_plain(y[1:], h_p, inv_p).to_numpy())


def large_pilots(dev, f, a, k, dtype, cp=72):
    """K pilots [K, A, F], read in place from K frames of one symbol (rows
    past a cyclic prefix of cp, strided by frame), and the padded pilot."""
    frame, pilot = frame_on(dev, f, a * k, 1, cp, dtype, seed=a + k)
    rows = CArray(frame.re.reshape(k, a, f + cp)[..., cp:], frame.im.reshape(k, a, f + cp)[..., cp:])
    return rows, ls.pad_pilot(pilot, dev)


# The large-F pilots' clusters (fft_plan.pilot_plan, speed_cluster): one
# antenna (no cluster), five (uneven blocks), the main path's 16 and 64
# (several rows a team), one frame and three (a smaller cluster).
@pytest.mark.parametrize("dtype", ["f32", "int16"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("a", [1, 5, 16, 64])
@pytest.mark.parametrize("f", [16384, 32768])
def test_large_pilot_clusters_match_plain(dev, f, a, k, dtype):
    """The exact split pilot, inv and the sum variant, one launch of each
    wrapper, against the plain version."""
    y, x_full = large_pilots(dev, f, a, k, dtype)
    pipe.reset_launch_counts()
    h, inv = pipe.estimate_pilot_fused(y, x_full)
    _, hsq = pipe.estimate_pilot_fused(y, x_full, invert=False)
    torch.cuda.synchronize()
    assert {n: v for n, v in pipe.launch_counts.items() if v} == {"pilot_ls": 1, "pilot_ls_sum": 1}
    h_p, inv_p = pipe.estimate_pilot_plain(y, x_full)
    sum_p = 1 / inv_p.cpu().numpy()
    assert max_rel(h.to_numpy(), h_p.to_numpy()) < TOL
    assert max_rel(1 / inv.cpu().numpy(), sum_p) < TOL
    assert max_rel(hsq.cpu().numpy(), sum_p) < TOL


@pytest.mark.parametrize("dtype", ["f32", "int16"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("a", [1, 5, 16, 64])
@pytest.mark.parametrize("f", [8192, 16384, 32768])
def test_large_speed_pilot_clusters_match_plain(dev, f, a, k, dtype):
    """The bf16 pilot's clustered row pass (W multicast once a cluster)
    against the plain speed version, one launch."""
    y, x_full = large_pilots(dev, f, a, k, dtype)
    pipe.reset_launch_counts()
    h, inv = pipe.estimate_pilot_fused(y, x_full, exact=False)
    torch.cuda.synchronize()
    assert {n: v for n, v in pipe.launch_counts.items() if v} == {"pilot_ls_bf16": 1}
    h_p, inv_p = pipe.estimate_pilot_speed_plain(y, x_full)
    h_e, inv_e = pipe.estimate_pilot_plain(y, x_full)
    assert_speed_agrees(h.to_numpy(), h_p.to_numpy(), h_e.to_numpy())
    assert_speed_agrees(1 / inv.cpu().numpy(), 1 / inv_p.cpu().numpy(), 1 / inv_e.cpu().numpy())


@pytest.mark.parametrize("f", [4096, 8192, 32768])
def test_speed_pilot_entry_refuses_a_wrong_w_or_cluster(dev, f):
    """ofdm_pilot_ls_bf16 takes W as ``w`` below F = 8192 and as its
    shared-memory image ``w_image`` from 8192, with the row pass's cluster
    (1 to min(A, 8)); any other pairing is cudaErrorInvalidValue (1), not a
    launch on the wrong layout."""
    from ofdm_ls_mrc_tpu_torch.kernels import build

    a = 4
    y, x_full = large_pilots(dev, f, a, 1, "f32", cp=0)
    y = y[0]
    split = f in fft_plan.SPEED_SPLIT_SIZES
    tw = (fft_plan.split_tables if split else fft_plan.speed_twiddles)(f, False, dev)
    w, img = fft_plan.speed_w(dev), fft_plan.speed_w_image(dev)
    h = CArray(*(torch.empty((1, a, f), device=dev) for _ in range(2)))
    inv = torch.empty((1, f), device=dev)
    scratch = torch.empty((2, 1, a, f), device=dev) if split else None
    lib = build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(w_ptr, img_ptr, clusters):
        return lib.ofdm_pilot_ls_bf16(
            y.re.data_ptr(), y.im.data_ptr(), 0, 0, y.re.stride(0), 1, a, f,
            x_full.re.data_ptr(), x_full.im.data_ptr(), tw.data_ptr(), w_ptr, img_ptr,
            clusters, h.re.data_ptr(), h.im.data_ptr(), inv.data_ptr(),
            None if scratch is None else scratch.data_ptr(), 1, stream)

    wp, ip = w.data_ptr(), img.data_ptr()
    if split:
        assert call(None, ip, fft_plan.speed_cluster(a, f, True)) == 0
        bad = [(wp, None, 4), (wp, ip, 4), (None, ip, 0), (None, ip, a + 1), (None, ip, 9)]
    else:
        assert call(wp, None, 0) == 0
        bad = [(None, ip, 0), (wp, ip, 0), (wp, None, 2)]
    torch.cuda.synchronize()
    for args in bad:
        assert call(*args) == 1, args
    torch.cuda.synchronize()


@pytest.mark.parametrize("f", [8192, 16384, 32768])
def test_large_fft_receiver_on_card_matches_golden(dev, f):
    """UplinkReceiver(fused) at 16 x F, cp 72 F / 1024, 11 symbols, through a
    16-tap 25 dB channel: exact within 5e-5 of the golden, bf16 at most
    -35 dB from it, both below -30 dB against the sent symbols, and no
    fallback warning."""
    rng = np.random.default_rng(f)
    cp = 72 * f // 1024
    cfg = FrameConfig(num_antennas=16, fft_size=f, cyclic_prefix=cp, frame_len=11)
    data, _ = sim.random_symbols(rng, (cfg.num_data_symbols, cfg.num_subcarriers), "16qam")
    pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)).astype(np.complex64)
    rx_frame = sim.ChannelModel(16, f, num_taps=16, snr_db=25.0, seed=9).apply(
        sim.make_tx_frame(data, pilot, cp), cp)
    gold = golden.demod_frame(rx_frame, pilot, cp)
    frame = CArray.from_numpy(rx_frame, dev)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        exact = UplinkReceiver(cfg, pilot, device=dev)
        speed = UplinkReceiver(cfg, pilot, exact=False, device=dev)
    pipe.reset_launch_counts()
    out = exact.demod_frame(frame).to_numpy()
    fast = speed.demod_frame(frame).to_numpy()
    assert {k: v for k, v in pipe.launch_counts.items() if v} == {
        "pilot_ls": 1, "fft_mrc": 1, "pilot_ls_bf16": 1, "fft_mrc_bf16": 1}
    assert max_rel(out, gold) < 5e-5
    assert evm_db(fast, gold) <= -35.0
    for got in (out, fast):
        assert sim.evm_db(np.fft.fftshift(got, axes=-1), data) < -30.0


def test_large_fft_wrappers_raise_past_32768(dev):
    """F = 65536 has no kernel: each wrapper raises for a CUDA tensor."""
    frame, pilot = frame_on(dev, 65536, 1, 2, 0, "f32")
    x_full = ls.pad_pilot(pilot, dev)
    for exact in (True, False):
        with pytest.raises(ValueError, match="65536"):
            pipe.estimate_pilot_fused(frame[0], x_full, exact=exact)
    h, inv = pipe.estimate_pilot_plain(frame[0], x_full)
    for exact in (True, False):
        with pytest.raises(ValueError, match="65536"):
            pipe.fused_pipeline(frame[1:], h, inv, exact=exact)
    with pytest.raises(ValueError, match="65536"):
        fused_mrc.fused_demod(frame[1:], h.conj(), 1 / inv)


@pytest.mark.parametrize("f", fft_plan.SPLIT_FFT_SIZES)
def test_ring_entries_refuse_a_schedule_they_cannot_run(dev, f):
    """ofdm_fft_mrc and ofdm_mrc_demod at F = 16384 and 32768 run on the ring
    of ``fft_plan.split_ring``: the tightest ring (2 slots, lag 1, over 12
    symbols, each slot rewritten five times in the launch) matches the plain
    version; a lag of 0, a lag past the symbols, a lag as large as the
    slots where a slot is reused, or no ring or counters is
    cudaErrorInvalidValue (1), not a launch."""
    from ofdm_ls_mrc_tpu_torch.kernels import build

    a, s = 4, 12
    frame, pilot = frame_on(dev, f, a, s + 1, 0, "f32", seed=7)
    h, inv = pipe.estimate_pilot_plain(frame[0], ls.pad_pilot(pilot, dev))
    hc, hs = CArray(h.re.contiguous(), (-h.im).contiguous()), (1 / inv).contiguous()
    y = frame[1:]
    st = y.re.stride()
    tw = fft_plan.split_tables(f, False, dev)
    lib = build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    want = (pipe.fused_pipeline_plain(y, h, inv).to_numpy(),
            fused_mrc.fused_demod_plain(y, hc, hs).to_numpy()[:, 1:])

    def run(slots, lag, ring=True, counters=True):
        out = CArray(torch.empty((s, f - 1), device=dev), torch.empty((s, f - 1), device=dev))
        eq = CArray(torch.empty((s, f), device=dev), torch.empty((s, f), device=dev))
        r = torch.empty((2, max(slots, 1), a, f), device=dev) if ring else None
        errs = []
        for call in ("fft_mrc", "mrc_demod"):
            c = torch.zeros(1 + 2 * s, dtype=torch.int32, device=dev) if counters else None
            ptrs = (None if r is None else r.data_ptr(), slots, lag,
                    None if c is None else c.data_ptr(), stream)
            if call == "fft_mrc":
                errs.append(lib.ofdm_fft_mrc(
                    y.re.data_ptr(), y.im.data_ptr(), 0, 1, 0, st[0], st[1], 1.0, 1, s, a, f,
                    h.re.data_ptr(), h.im.data_ptr(), inv.data_ptr(), tw.data_ptr(),
                    out.re.data_ptr(), out.im.data_ptr(), *ptrs))
            else:
                errs.append(lib.ofdm_mrc_demod(
                    y.re.data_ptr(), y.im.data_ptr(), 0, 1, st[0], st[1], 1.0, s, a, f,
                    hc.re.data_ptr(), hc.im.data_ptr(), hs.data_ptr(), tw.data_ptr(),
                    eq.re.data_ptr(), eq.im.data_ptr(), *ptrs))
        torch.cuda.synchronize()
        return errs, out.to_numpy(), eq.to_numpy()[:, 1:]

    errs, out, eq = run(2, 1)
    assert errs == [0, 0]
    assert max_rel(out, want[0]) < TOL and max_rel(eq, want[1]) < TOL
    for bad in ((2, 0), (2, 2), (2, s + 1), (0, 1)):
        assert run(*bad)[0] == [1, 1], bad
    assert run(2, 1, ring=False)[0] == [1, 1]
    assert run(2, 1, counters=False)[0] == [1, 1]


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
DEMOD_GEOMETRIES += [(f, a, s) for f in (256, 512, 2048, 4096) for a, s in ((16, 100), (64, 4))]


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
        assert pipe.launch_counts == {"pilot_ls": 1, "fft_mrc": 10, "pilot_ls_sum": 0,
                                      "pilot_ls_bf16": 0, "fft_mrc_bf16": 0}
    assert max_rel(rows, want) < TOL


# (variant, ts, S, antennas, F): the main path's frame, a ragged last window
# at a small shape, and each window height and depth in both forms; auto at
# every A of 1, 3, 16, 17 and 64 (one and two M tiles of the burn, zero
# rows) x F of 128, 1024 and 4096 on a ragged S (13 symbols: items that do
# not fill the last wave); the manual ring at 17 and 64 antennas.
PROBE_CASES = ([("auto", 2, 101, 16, 1024), ("manual2", 2, 101, 16, 1024),
                ("manual3s", 2, 101, 16, 1024), ("manual4", 2, 101, 16, 1024),
                ("manual4", 1, 101, 16, 1024), ("manual3s", 1, 101, 16, 1024),
                ("manual3", 2, 5, 3, 256), ("manual2s", 1, 7, 4, 512),
                ("manual4", 4, 9, 2, 128), ("manual2s", 8, 11, 1, 256),
                ("manual4s", 8, 17, 4, 512), ("manual2", 8, 9, 2, 256),
                ("auto", 2, 5, 3, 256), ("manual2", 2, 13, 17, 1024),
                ("manual2", 1, 13, 64, 256)]
               + [("auto", 2, 13, a, f) for a in (1, 3, 16, 17, 64) for f in (128, 1024, 4096)])


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


@pytest.mark.parametrize("variant,ts,s,a,f", PROBE_CASES)
def test_io_probe_burn_at_scale_one_matches_plain(dev, variant, ts, s, a, f):
    """The compute-2 burn on the tensor cores, where it shows: burn_scale=1,
    the re output against the plain chain within BURN_TOL of the largest
    burn term (bf16 rounding after each product flips where the two f32
    sums round apart)."""
    yre, yim, bias, w = dma_probe.make_frames(1, s, a, f, dev, seed=4)
    err = dma_probe.burn_error(yre[0], yim[0], bias + 0.5, w, 2, variant=variant, ts=ts)
    assert err < dma_probe.BURN_TOL


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


# -- the live path: pinned feed and the demod app on the card ----------------

def _ring_pair(rows, cols, length, dtype):
    import uuid

    from ofdm_ls_mrc_tpu_torch.io.ring import SymbolRing

    uid = f"/ofdm_tcuda_{uuid.uuid4().hex[:10]}"
    w = SymbolRing(uid, rows, cols, length, master=True, timeout=30.0, dtype=dtype)
    r = SymbolRing(uid, rows, cols, length, master=False, timeout=30.0, dtype=dtype)
    return w, r


def _write_all(w, frames):
    """Producer thread body: every frame with backpressure; a consumer that
    died shuts the ring down, which ends the writes."""
    from ofdm_ls_mrc_tpu_torch.io.ring import RingShutdown

    try:
        for f in frames:
            w.write_batch(f)
    except RingShutdown:
        pass


def _ring_frames(n, fl, rows, cols, seed=5):
    rng = np.random.default_rng(seed)
    z = 0.1 * (rng.standard_normal((n, fl, rows, cols)) + 1j * rng.standard_normal((n, fl, rows, cols)))
    return z.astype(np.complex64)


@pytest.mark.parametrize("int16", [False, True])
def test_pinned_feed_frames_equal_ring_contents(dev, int16):
    """Frames through the pinned host buffers and the side-stream copy land
    on the card equal to what the ring holds, float and int16 planes."""
    import threading

    from ofdm_ls_mrc_tpu_torch.io.feed import RingFeed

    fl, n = 5, 6
    frames = _ring_frames(n, fl, 4, 256)
    w, r = _ring_pair(4, 256, 2 * fl, "sc16" if int16 else "complex64")
    writer = threading.Thread(target=_write_all, args=(w, frames))
    writer.start()
    feed = RingFeed(r, FrameConfig(num_antennas=4, fft_size=256, frame_len=fl), int16=int16,
                    device=dev)
    assert all(b.re_t.is_pinned() and b.im_t.is_pinned() for b in feed._buffers)
    held = []
    try:
        for frame in feed.frames(max_frames=n):
            assert frame.device.type == "cuda"
            held.append(frame)
    finally:
        feed.stop()
        writer.join(timeout=30)
        assert not writer.is_alive()
        r.close()
        w.close()
    torch.cuda.synchronize()
    for k, frame in enumerate(held):
        if int16:
            iq = golden.io.complex_to_sc16(frames[k])
            want_re, want_im = iq[..., 0::2], iq[..., 1::2]
        else:
            want_re, want_im = frames[k].real, frames[k].imag
        np.testing.assert_array_equal(frame.re.cpu().numpy(), want_re)
        np.testing.assert_array_equal(frame.im.cpu().numpy(), want_im)
    assert feed.h2d_seconds > 0


def test_feed_recycles_a_buffer_only_after_its_copy(dev):
    """A host buffer goes back to the reader only once its H2D copy event
    has completed, even when the copy stream is held up."""
    import threading

    from ofdm_ls_mrc_tpu_torch.io.feed import RingFeed

    fl, n = 3, 4
    frames = _ring_frames(n, fl, 4, 256, seed=6)
    w, r = _ring_pair(4, 256, 2 * fl, "complex64")
    writer = threading.Thread(target=_write_all, args=(w, frames))
    writer.start()
    feed = RingFeed(r, FrameConfig(num_antennas=4, fft_size=256, frame_len=fl), device=dev)
    copies = {}
    to_device = feed._to_device

    def slow_copy(buf):
        with torch.cuda.stream(feed._copy_stream):
            torch.cuda._sleep(50_000_000)             # tens of ms on the copy stream
        frame, start, done = to_device(buf)
        copies[id(buf)] = done
        return frame, start, done

    put = feed._free.put
    recycled = []

    def checked_put(buf):
        if buf is not None:
            recycled.append(copies[id(buf)].query())
        put(buf)

    feed._to_device = slow_copy
    feed._free.put = checked_put
    held = []
    try:
        for frame in feed.frames(max_frames=n):
            held.append(frame)
    finally:
        feed.stop()
        writer.join(timeout=30)
        assert not writer.is_alive()
        r.close()
        w.close()
    assert len(recycled) == n and all(recycled)
    for k, frame in enumerate(held):
        np.testing.assert_array_equal(frame.re.cpu().numpy(), frames[k].real)


def _run_app_on_port_ring(tmp_path, frames, cp, flags, device):
    """The port's SymbolRing as master writing ``frames`` while the port's
    demod_app drains the ring on ``device``; returns (output rows, stdout)."""
    import subprocess
    import sys
    import threading
    import uuid
    from pathlib import Path

    from ofdm_ls_mrc_tpu_torch.io.ring import SymbolRing

    n, fl, a, cols = frames.shape
    # The writer waits out the app's start-up (and its first kernel build).
    w = SymbolRing(f"/ofdm_tcuda_{uuid.uuid4().hex[:10]}", a, cols, fl, master=True,
                   timeout=300.0)
    out = tmp_path / f"out_{device}_{'_'.join(flags) or 'whole'}.dat"
    writer = threading.Thread(target=_write_all, args=(w, frames))
    cmd = [sys.executable, "-m", "ofdm_ls_mrc_tpu_torch.apps.demod_app", "--shm-uid", w.uid,
           "--antennas", str(a), "--fft-size", str(cols - cp), "--cp-size", str(cp),
           "--frame-len", str(fl), "--num-frames", str(n), "--device", device,
           "--output", str(out), "--pilots", str(tmp_path / "none.dat"), *flags]
    app = subprocess.Popen(cmd, cwd=Path(__file__).resolve().parent.parent,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    writer.start()
    try:
        stdout, stderr = app.communicate(timeout=300)
    finally:
        if app.poll() is None:
            app.kill()
            app.wait()
        w.shutdown()
        writer.join(timeout=30)
        assert not writer.is_alive()
        w.close()
    assert app.returncode == 0, stdout + stderr
    return golden.read_output(str(out), cols - cp - 1), stdout


@pytest.mark.parametrize("flags", [[], ["--batch-frames", "3"], ["--per-symbol"],
                                   ["--mesh", "1x1"], ["--mesh", "1x1", "--per-symbol"]])
def test_demod_app_on_card_matches_cpu(dev, tmp_path, flags):
    """The app's whole-frame, batched and per-symbol modes on the card give
    the CPU run's output on the same frames within 2e-5, through the
    kernels (pilot_ls and fft_mrc launched in the frame loop; under --mesh
    1x1, NCCL over a group of one, the pilot's sum|h|^2 variant)."""
    import json

    frames = _ring_frames(4, 7, 4, 256 + 16, seed=7)
    got, stdout = _run_app_on_port_ring(tmp_path, frames, 16, flags, "cuda")
    want, _ = _run_app_on_port_ring(tmp_path, frames, 16, flags, "cpu")
    assert "demodulated 4 frame(s)" in stdout
    assert got.shape == want.shape == (4 * 6, 255)
    assert max_rel(got, want) < TOL
    launches = json.loads(next(ln for ln in stdout.splitlines()
                               if ln.startswith("kernel launches "))[len("kernel launches "):])
    per_symbol = "--per-symbol" in flags
    pilot = "pilot_ls_sum" if "--mesh" in flags else "pilot_ls"
    assert launches[pilot] == (2 if flags[:1] == ["--batch-frames"] else 4)
    assert launches["fft_mrc"] == (24 if per_symbol else launches[pilot])


def test_entry_points_take_card_tensors_with_the_default_device():
    """device="cuda" (no index) names the current card: the receiver and
    the streaming demodulator take CArrays whose tensors are on cuda:0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    frame, pilot = frame_on(torch.device("cuda", 0), 256, 2, 3, 0, "f32")
    cfg = FrameConfig(num_antennas=2, fft_size=256, frame_len=3)
    sd = StreamingDemodulator(cfg, pilot, pipeline="fused")
    assert sd.device == frame.device
    sd.push_pilot(frame[0])
    row = sd.push_symbol(frame[1])
    want = UplinkReceiver(cfg, pilot).demod_frame(frame).to_numpy()[0]
    assert max_rel(row.to_numpy(), want) < TOL


@pytest.mark.parametrize("n,start", [(2048, 700), (5000, 4000), (300_000, 123_457)])
def test_pn_correlate_on_card_matches_the_sliding_dot(dev, n, start):
    """ops/correlate on cuFFT: the reference's trigger metric within rtol
    1e-3, atol 1e-4 (tests/test_correlate.py), and the first lag at the
    threshold found on the card, as the host scan finds it."""
    from ofdm_ls_mrc_tpu_torch.ops.correlate import find_frame_start, pn_correlate
    from ofdm_ls_mrc_tpu_torch.sim import pn

    seq = pn.max_len_sequence(255)
    rng = np.random.default_rng(n)
    buf = (0.1 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    buf[start:start + seq.size] += seq
    x = CArray.from_numpy(buf, dev)
    mags = pn_correlate(x, seq)
    assert mags.device == x.device and mags.shape == (n - seq.size + 1,)
    want = np.abs(np.correlate(buf, np.conj(seq), mode="valid")) / seq.size
    np.testing.assert_allclose(mags.cpu().numpy(), want, rtol=1e-3, atol=1e-4)
    i, peak = find_frame_start(x, seq, 0.5)
    assert (i, type(peak)) == (pn.correlate_frame_start(buf, seq, 0.5)[0], float) and i == start
    assert find_frame_start(x, seq, 5.0)[0] == -1


@pytest.mark.parametrize("f,u,a,cp", [(64, 4, 8, 8), (1024, 4, 16, 72)])
def test_downlink_on_card_matches_cpu(dev, f, u, a, cp):
    """DownlinkTransmitter on the card against its CPU run on the same
    inputs: the ZF precoder and the modulator within 1e-4 (float32 LU,
    einsums and FFTs in another order), and h @ w = I on the card."""
    from ofdm_ls_mrc_tpu_torch.models import DownlinkTransmitter
    from ofdm_ls_mrc_tpu_torch.ops import zf

    rng = np.random.default_rng(f + a)
    h = ((rng.standard_normal((f - 1, u, a)) + 1j * rng.standard_normal((f - 1, u, a)))
         / np.sqrt(2)).astype(np.complex64)
    x = sim.random_symbols(rng, (u, f - 1), "16qam")[0]
    cfg = FrameConfig(num_antennas=a, fft_size=f, cyclic_prefix=cp, frame_len=3)
    card, cpu = DownlinkTransmitter(cfg, device=dev), DownlinkTransmitter(cfg, device="cpu")
    ant = card.precode(h, x)
    assert ant.device == dev
    np.testing.assert_allclose(ant.to_numpy(), cpu.precode(h, x).to_numpy(), atol=1e-4)
    np.testing.assert_allclose(card.modulate(ant).to_numpy(),
                               cpu.modulate(ant.to_numpy()).to_numpy(), atol=1e-4)
    w = zf.zf_precoder(CArray.from_numpy(h, dev)).to_numpy()
    np.testing.assert_allclose(np.einsum("sua,sav->suv", h, w),
                               np.broadcast_to(np.eye(u), (f - 1, u, u)), atol=1e-3)
