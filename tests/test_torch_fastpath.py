"""The port's 'fast' pipeline and FFT implementations (``ops/fft.py``,
``ops/fastpath.py``) against the JAX package's on the CPU, and the
receivers' routing of pipeline x fft_impl x F beside the JAX receivers'.

Tolerances: ``TOL`` = 5e-5 max-rel against the JAX package
(tests/test_torch_receiver.py:28: float32 GEMMs summed in another order);
``GOLDEN`` rtol = atol = 2e-4 against the NumPy golden.  The JAX fused
receivers run their Pallas kernels in interpret mode.  Sizes: 2 antennas,
3 symbols (one pilot, two data), cp 4.
"""

import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ofdm_ls_mrc_tpu import FrameConfig as JaxFrameConfig
from ofdm_ls_mrc_tpu import parallel as jpar
from ofdm_ls_mrc_tpu.golden.io import plane_to_sc16
from ofdm_ls_mrc_tpu.models import StreamingDemodulator as JaxStreaming
from ofdm_ls_mrc_tpu.models import UplinkReceiver as JaxReceiver
from ofdm_ls_mrc_tpu.ops import fastpath as jfast
from ofdm_ls_mrc_tpu.ops import fft as jfft
from ofdm_ls_mrc_tpu.ops.cplx import CArray as JCArray
from ofdm_ls_mrc_tpu_torch import FrameConfig, golden, parallel
from ofdm_ls_mrc_tpu_torch.models import StreamingDemodulator, UplinkReceiver
from ofdm_ls_mrc_tpu_torch.ops import fastpath
from ofdm_ls_mrc_tpu_torch.ops import fft as tfft
from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray
from ofdm_ls_mrc_tpu_torch.parallel import collectives

TOL = 5e-5
GOLDEN = dict(rtol=2e-4, atol=2e-4)
A, S, CP = 2, 3, 4


def max_rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def crandn(rng, shape):
    return (0.1 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            ).astype(np.complex64)


def make_case(f, seed=3):
    rng = np.random.default_rng(seed + f)
    cfg = FrameConfig(num_antennas=A, fft_size=f, cyclic_prefix=CP, frame_len=S)
    jcfg = JaxFrameConfig(num_antennas=A, fft_size=f, cyclic_prefix=CP, frame_len=S)
    pilot = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
    return cfg, jcfg, pilot, crandn(rng, (S, A, f + CP))


def planes(frame, dtype):
    """(port CArray, JAX CArray) of the frame: float32, or int16 sc16 planes."""
    if dtype == "f32":
        return CArray.from_numpy(frame, "cpu"), JCArray.from_numpy(frame)
    re, im = plane_to_sc16(frame.real), plane_to_sc16(frame.imag)
    import jax.numpy as jnp
    return (CArray(torch.from_numpy(re), torch.from_numpy(im)),
            JCArray(jnp.asarray(re), jnp.asarray(im)))


# -- ops/fft.py -----------------------------------------------------------------

FFT_CASES = [(name, f) for name in ("fft_matmul", "ifft_matmul", "fft_four_step",
                                    "ifft_four_step") for f in (64, 192, 256, 1024)]
FFT_CASES += [("fft_four_step", 8192), ("ifft_four_step", 8192)]


@pytest.mark.parametrize("name,f", FFT_CASES)
def test_gemm_ffts_match_jax(name, f):
    x = crandn(np.random.default_rng(f), (3, f))
    got = getattr(tfft, name)(CArray.from_numpy(x, "cpu")).to_numpy()
    want = getattr(jfft, name)(JCArray.from_numpy(x)).to_numpy()
    assert max_rel(got, want) < TOL
    ref = np.fft.fft(x) if name.startswith("fft") else np.fft.ifft(x) * f
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3 * np.abs(ref).max())


def test_fft_registry_default_and_precision():
    assert set(tfft.FFT_IMPLS) == set(jfft.FFT_IMPLS) == set(tfft.IFFT_IMPLS)
    assert tfft.get_fft("xla") is tfft.fft and tfft.get_ifft("matmul") is tfft.ifft_matmul
    assert tfft.default_impl() == "xla"
    for n in (64, 128, 192, 256, 1024, 8192):
        assert tfft._split(n) == jfft._split(n)
        np.testing.assert_array_equal(tfft._twiddle(*tfft._split(n), -1.0),
                                      jfft._twiddle(*jfft._split(n), -1.0))
    saved = torch.backends.cuda.matmul.allow_tf32
    seen = []
    real_einsum = torch.einsum

    def spy(*args):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real_einsum(*args)

    try:
        torch.einsum = spy
        tfft.fft_four_step(CArray.from_numpy(crandn(np.random.default_rng(1), (2, 256)), "cpu"))
        tfft.set_precision("default")
        tfft.fft_four_step(CArray.from_numpy(crandn(np.random.default_rng(1), (2, 256)), "cpu"))
    finally:
        torch.einsum = real_einsum
        tfft.set_precision("highest")
    assert seen[:8] == [False] * 8 and seen[8:] == [True] * 8
    assert torch.backends.cuda.matmul.allow_tf32 == saved    # restored, never set globally


# -- ops/fastpath.py ------------------------------------------------------------

FAST_CASES = [(f, dtype) for f in (192, 256, 1024, 8192) for dtype in ("f32", "int16")]


@pytest.mark.parametrize("f,dtype", FAST_CASES)
def test_fastpath_matches_jax(f, dtype):
    cfg, _, pilot, frame = make_case(f)
    t, j = planes(frame, dtype)
    assert fastpath._fast_split(f) == jfast._fast_split(f)
    np.testing.assert_array_equal(fastpath._edge_gather(f), jfast._edge_gather(f))
    yt, yj = t[..., CP:], j[..., CP:]
    got = fastpath.fft_permuted(yt)
    want = jfast.fft_permuted(yj)
    assert max_rel(got.to_numpy(), want.to_numpy()) < TOL
    xp = fastpath.prepare_pilot_fast(pilot, f, "cpu")
    np.testing.assert_array_equal(xp.to_numpy(), jfast.prepare_pilot_fast(pilot, f).to_numpy())
    h, hsq = fastpath.ls_permuted(got[0], xp)
    jh, jhsq = jfast.ls_permuted(want[0], jfast.prepare_pilot_fast(pilot, f))
    assert max_rel(h.to_numpy(), jh.to_numpy()) < TOL
    assert max_rel(hsq.numpy(), np.asarray(jhsq)) < TOL
    out = fastpath.demod_frame_fast(t, xp, cp=CP).to_numpy()
    jout = jfast.demod_frame_fast(j, jfast.prepare_pilot_fast(pilot, f), cp=CP).to_numpy()
    assert out.shape == (S - 1, f - 1)
    assert max_rel(out, jout) < TOL
    gold_in = frame if dtype == "f32" else golden.io.sc16_to_complex(
        golden.io.complex_to_sc16(frame)).reshape(frame.shape)
    np.testing.assert_allclose(out, golden.demod_frame(gold_in, pilot, CP), **GOLDEN)


def test_fastpath_batches_frames_and_widens_before_the_presum():
    """demod_frame_fast takes a leading frame axis (demod_capture), and
    full-scale int16 rows do not wrap in the Karatsuba pre-sum."""
    cfg, _, pilot, frame = make_case(256)
    xp = fastpath.prepare_pilot_fast(pilot, 256, "cpu")
    two = np.stack([frame, frame[::-1]])
    got = fastpath.demod_frame_fast(CArray.from_numpy(two, "cpu"), xp, cp=CP).to_numpy()
    for k in range(2):
        want = fastpath.demod_frame_fast(CArray.from_numpy(two[k], "cpu"), xp, cp=CP).to_numpy()
        assert max_rel(got[k], want) < 1e-6
    full = torch.full((1, 2, 256), 32767, dtype=torch.int16)
    b = fastpath.stage1_twiddled(CArray(full, full))
    # k1 = 0, i2 = 0: the sum over i1 of both planes, 2 x 32767 each; an
    # int16 pre-sum would have wrapped 32767 + 32767 to -2.
    assert b.dtype == torch.float32
    assert float(b.re[0, 0, 0]) == float(b.im[0, 0, 0]) == 2 * 32767


# -- routing: pipeline x fft_impl x F ------------------------------------------
#
# (receiver, pipeline asked, fft_impl, F) -> (the JAX receiver's route, the
# port's route, the port's warnings, why they differ).  A route is the
# pipeline that runs.

ROUTES = [
    ("uplink", "fused", None, 256, "composed", "fused", 0,
     "fused keeps the CUDA kernels under 'xla': the JAX downgrade is for XLA without Pallas"),
    ("uplink", "fused", "four_step", 256, "fused", "fused", 0, ""),
    ("uplink", "fused", None, 64, "composed", "fused", 0,
     "the port's kernels take F = 64 and 128; the TPU kernel starts at 256"),
    ("uplink", "fused", "four_step", 192, "fast", "fast", 1, ""),
    ("uplink", "fused", None, 192, "composed", "composed", 2, ""),
    ("uplink", "fused", "four_step", 8192, "fused", "fused", 0, ""),
    ("uplink", "fused", None, 8192, "composed", "fused", 0,
     "fused keeps the CUDA kernels under 'xla': the JAX downgrade is for XLA without Pallas"),
    ("uplink", "fused", None, 65536, "composed", "composed", 2,
     "the port's fused kernels stop at F = 32768, the largest FFT of a public OFDM standard: "
     "'fused' falls back to 'fast', then to 'composed' for 'xla'"),
    ("uplink", "fast", "four_step", 256, "fast", "fast", 0, ""),
    ("uplink", "fast", "matmul", 1024, "fast", "fast", 0, ""),
    ("uplink", "fast", None, 1024, "composed", "composed", 1, ""),
    ("uplink", "composed", "four_step", 192, "composed", "composed", 0, ""),
    ("streaming", "fused", None, 256, "composed", "fused", 0,
     "fused keeps the CUDA kernels under 'xla': the JAX downgrade is for XLA without Pallas"),
    ("streaming", "fused", "four_step", 192, "composed", "composed", 1, ""),
    ("streaming", "fused", "four_step", 8192, "fused", "fused", 0, ""),
    ("streaming", "composed", "matmul", 1024, "composed", "composed", 0, ""),
    ("sharded", "fused", None, 256, "fused", "fused", 0, ""),
    ("sharded", "fused", None, 192, "fast", "fast", 1, ""),
    ("sharded", "fused", None, 8192, "fused", "fused", 0, ""),
    ("sharded", "fast", None, 1024, "fast", "fast", 0, ""),
    ("sharded", "composed", "four_step", 256, "composed", "composed", 0, ""),
    ("sharded-streaming", "fused", None, 192, "fast", "fast", 1, ""),
    ("sharded-streaming", "fused", None, 8192, "fused", "fused", 0, ""),
    ("sharded-streaming", "fast", None, 256, "fast", "fast", 0, ""),
    ("sharded-streaming", "composed", "matmul", 256, "composed", "composed", 0, ""),
]


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    store = tmp_path_factory.mktemp("store") / "store"
    parallel.initialize(f"file://{store}", 1, 0, "gloo")
    yield parallel.make_mesh(1, 1)
    dist.destroy_process_group()


def stream(sd, frame):
    sd.push_pilot(frame[0])
    return np.stack([sd.push_symbol(frame[i]).to_numpy() for i in range(1, S)])


def build(kind, cfg, pilot, pipeline, fft_impl, mesh):
    if kind == "uplink":
        return UplinkReceiver(cfg, pilot, pipeline=pipeline, fft_impl=fft_impl, device="cpu")
    if kind == "streaming":
        return StreamingDemodulator(cfg, pilot, pipeline=pipeline, fft_impl=fft_impl,
                                    device="cpu")
    if kind == "sharded":
        return parallel.ShardedUplinkReceiver(cfg, pilot, mesh, pipeline=pipeline,
                                              fft_impl=fft_impl, device="cpu")
    return parallel.ShardedStreamingDemodulator(cfg, pilot, mesh, pipeline=pipeline,
                                                fft_impl=fft_impl, device="cpu")


def build_jax(kind, jcfg, pilot, pipeline, fft_impl):
    if kind == "uplink":
        return JaxReceiver(jcfg, pilot, pipeline=pipeline, fft_impl=fft_impl)
    if kind == "streaming":
        return JaxStreaming(jcfg, pilot, pipeline=pipeline, fft_impl=fft_impl)
    m = jpar.make_mesh(1, 1)
    if kind == "sharded":
        return jpar.ShardedUplinkReceiver(jcfg, pilot, m, pipeline=pipeline, fft_impl=fft_impl)
    return jpar.ShardedStreamingDemodulator(jcfg, pilot, m, pipeline=pipeline,
                                            fft_impl=fft_impl)


@pytest.mark.parametrize("kind,pipeline,fft_impl,f,jax_route,port_route,warns,why", ROUTES)
def test_routing_table(mesh, kind, pipeline, fft_impl, f, jax_route, port_route, warns, why):
    """Each row: the JAX receiver's route and the port's, the port's
    RuntimeWarnings, and the output held to the JAX receiver's within TOL.
    A row whose routes differ names why."""
    cfg, jcfg, pilot, frame = make_case(f)
    assert jax_route == port_route or why
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jrx = build_jax(kind, jcfg, pilot, pipeline, fft_impl)
    assert jrx.pipeline == jax_route
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        rx = build(kind, cfg, pilot, pipeline, fft_impl, mesh)
    port_warns = [w for w in tw if issubclass(w.category, RuntimeWarning)]
    assert rx.pipeline == port_route
    assert len(port_warns) == warns, [str(w.message) for w in port_warns]
    if pipeline == "fused" and port_route != "fused":
        assert "fused pipeline unavailable" in str(port_warns[0].message)
    if kind in ("uplink", "sharded"):
        got, want = rx.demod_frame(frame).to_numpy(), jrx.demod_frame(frame).to_numpy()
    else:
        got, want = stream(rx, frame), stream(jrx, frame)
    assert got.shape == (S - 1, f - 1)
    assert max_rel(got, want) < TOL
    np.testing.assert_allclose(got, golden.demod_frame(frame, pilot, CP), **GOLDEN)


@pytest.mark.parametrize("fft_impl", ["four_step", "matmul"])
@pytest.mark.parametrize("f", [192, 1024])
def test_fast_receiver_matches_jax_demod_frame_fast(f, fft_impl):
    """UplinkReceiver(pipeline='fast') against the JAX fastpath itself, a
    frame and a two-frame capture; its split phase takes fft_impl."""
    cfg, _, pilot, frame = make_case(f)
    rx = UplinkReceiver(cfg, pilot, pipeline="fast", fft_impl=fft_impl, device="cpu")
    assert rx.pipeline == "fast" and rx.fft_impl == fft_impl
    want = jfast.demod_frame_fast(JCArray.from_numpy(frame), jfast.prepare_pilot_fast(pilot, f),
                                  cp=CP).to_numpy()
    assert max_rel(rx.demod_frame(frame).to_numpy(), want) < TOL
    cap = rx.demod_capture(np.stack([frame, frame])).to_numpy()
    assert max_rel(cap[1], want) < TOL
    h = rx.estimate_channel(frame[0])
    split = rx.demod_data(frame[1:], *h).to_numpy()
    np.testing.assert_allclose(split, golden.demod_frame(frame, pilot, CP), **GOLDEN)


@pytest.mark.parametrize("f", [192, 256])
def test_sharded_fast_body_at_world_size_1(mesh, f):
    """The fast shard bodies at world size 1 against the unsharded fast
    receiver: one all-reduce of (2 S_l + 1) F words a frame (the JAX
    package's payload), F + 4 x 2 F words for a streamed frame."""
    cfg = FrameConfig(num_antennas=4, fft_size=f, cyclic_prefix=CP, frame_len=5)
    rng = np.random.default_rng(8)
    pilot = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
    frame = crandn(rng, (5, 4, f + CP))
    want = UplinkReceiver(cfg, pilot, pipeline="fast", fft_impl="four_step",
                          device="cpu").demod_frame(frame).to_numpy()
    rx = parallel.ShardedUplinkReceiver(cfg, pilot, mesh, pipeline="fast", device="cpu")
    collectives.reset()
    got = rx.demod_frame(frame).to_numpy()
    assert collectives.signature() == (1, collectives.expected_payload_words(cfg, fast=True))
    assert collectives.signature()[1] == (2 * 4 + 1) * f
    assert max_rel(got, want) < TOL
    collectives.reset()
    cap = rx.demod_capture(np.stack([frame, frame])).to_numpy()
    assert collectives.signature() == (1, collectives.expected_payload_words(cfg, frames=2,
                                                                             fast=True))
    assert max_rel(cap[1], want) < TOL
    sd = parallel.ShardedStreamingDemodulator(cfg, pilot, mesh, pipeline="fast", device="cpu")
    collectives.reset()
    rows = stream_n(sd, frame)
    pilot_words, sym_words = collectives.expected_streaming_words(cfg, fast=True)
    assert (pilot_words, sym_words) == (f, 2 * f)
    assert collectives.signature() == (5, pilot_words + 4 * sym_words)
    assert max_rel(rows, want) < TOL


def stream_n(sd, frame):
    sd.push_pilot(frame[0])
    return np.stack([sd.push_symbol(frame[i]).to_numpy() for i in range(1, len(frame))])


def test_sharded_streaming_fast_state_is_portable(mesh, tmp_path):
    """The fast body's permuted estimate is saved in the true-order layout
    that StreamingDemodulator and the JAX package read, and resumes."""
    cfg, _, pilot, frame = make_case(256)
    sd = parallel.ShardedStreamingDemodulator(cfg, pilot, mesh, pipeline="fast", device="cpu")
    sd.push_pilot(frame[0])
    path = str(tmp_path / "est.npz")
    sd.save_state(path, frame_index=3)
    plain = StreamingDemodulator(cfg, pilot, device="cpu")
    assert plain.resume(path) == 3
    again = parallel.ShardedStreamingDemodulator(cfg, pilot, mesh, pipeline="fast", device="cpu")
    assert again.resume(path) == 3
    for i in (1, 2):
        want = plain.push_symbol(frame[i]).to_numpy()
        assert max_rel(again.push_symbol(frame[i]).to_numpy(), want) < TOL
        assert max_rel(sd.push_symbol(frame[i]).to_numpy(), want) < TOL
