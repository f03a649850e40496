"""The fused path's plain versions and wrappers (ofdm_ls_mrc_tpu_torch.ops.
pipeline) and the state converters (convert.py) against the JAX fused path.

The JAX Pallas kernels run in interpret mode on the CPU, as the reference's
own tests run them; each JAX result is computed once per module and shared.
Tolerance for kernel outputs: max-rel 5e-5.  The JAX kernels' stage-2 DFT
uses bf16 hi/lo-split dots, about 4e-6 relative (pallas_pipeline.py:29-31);
the port computes in plain float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_ls_mrc_tpu.golden.io import plane_to_sc16
from ofdm_ls_mrc_tpu.ops import fastpath as jfastpath
from ofdm_ls_mrc_tpu.ops import pallas_pipeline as jpp
from ofdm_ls_mrc_tpu.ops.cplx import CArray as JCArray
from ofdm_ls_mrc_tpu_torch import convert
from ofdm_ls_mrc_tpu_torch.ops import ls as tls
from ofdm_ls_mrc_tpu_torch.ops import mrc as tmrc
from ofdm_ls_mrc_tpu_torch.ops import pipeline as pipe
from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray

TOL = 5e-5

# (antennas, fft size, symbols, input dtype): the reference geometry's width
# at 4 antennas, and the smallest fused size at one antenna.
CASES = [(4, 1024, 9, "f32"), (4, 1024, 9, "int16"), (1, 256, 5, "f32"), (1, 256, 5, "int16")]
IDS = [f"a{a}-f{f}-s{s}-{d}" for a, f, s, d in CASES]


def max_rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def make_case(a, f, s, dtype, seed=0):
    """Data rows [S, A, F] as (re, im) planes and the pilot, from a seed."""
    rng = np.random.default_rng(seed)
    z = 0.1 * (rng.standard_normal((s, a, f)) + 1j * rng.standard_normal((s, a, f)))
    if dtype == "int16":
        re, im = plane_to_sc16(z.real), plane_to_sc16(z.imag)
    else:
        re, im = z.real.astype(np.float32), z.imag.astype(np.float32)
    pilot = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
    return re, im, pilot


_JAX = {}


def jax_fused(case):
    """JAX estimate_pilot_fused on row 0 and fused_pipeline +
    to_reference_order on rows 1.., both in interpret mode (cached)."""
    if case not in _JAX:
        a, f, s, dtype = case
        re, im, pilot = make_case(*case)
        x_perm = jfastpath.prepare_pilot_fast(pilot, f)
        rows = JCArray(jnp.asarray(re), jnp.asarray(im))
        h3, inv3 = jpp.estimate_pilot_fused(rows[0], x_perm, interpret=True)
        eq = jpp.fused_pipeline(rows[1:], h3.re, h3.im, inv3, interpret=True)
        out = jpp.to_reference_order(eq, f).to_numpy()
        _JAX[case] = (np.asarray(h3.re), np.asarray(h3.im), np.asarray(inv3),
                      out, x_perm.to_numpy())
    return _JAX[case]


def port_rows(case):
    re, im, _ = make_case(*case)
    return CArray(torch.from_numpy(re), torch.from_numpy(im))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_estimate_pilot_plain_matches_jax_kernel(case):
    h_re, h_im, inv, _, x_perm = jax_fused(case)
    want_h, want_inv = convert.estimate_from_reference(h_re, h_im, inv, device="cpu")
    x_full = convert.pilot_from_reference(x_perm, device="cpu")
    got_h, got_inv = pipe.estimate_pilot_plain(port_rows(case)[0], x_full)
    assert max_rel(got_h.to_numpy(), want_h.to_numpy()) < TOL
    # inv = 1/sum_a|h|^2 peaks where |h| is smallest, so its max-rel
    # measures the error at the weakest bin; sum_a|h|^2 itself is held to
    # the same bound as h.
    assert max_rel(1 / got_inv.numpy(), 1 / want_inv.numpy()) < TOL


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fused_pipeline_plain_matches_jax_kernel(case):
    h_re, h_im, inv, want, _ = jax_fused(case)
    h, inv_n = convert.estimate_from_reference(h_re, h_im, inv, device="cpu")
    got = pipe.fused_pipeline_plain(port_rows(case)[1:], h, inv_n).to_numpy()
    assert got.shape == want.shape
    assert max_rel(got, want) < TOL


@pytest.mark.parametrize("case", CASES[:1] + CASES[2:3], ids=[IDS[0], IDS[2]])
def test_wrappers_on_cpu_are_the_plain_versions(case):
    rows = port_rows(case)
    _, _, pilot = make_case(*case)
    x_full = tls.pad_pilot(pilot, "cpu")
    h, inv = pipe.estimate_pilot_fused(rows[0], x_full)
    h_p, inv_p = pipe.estimate_pilot_plain(rows[0], x_full)
    np.testing.assert_array_equal(h.to_numpy(), h_p.to_numpy())
    np.testing.assert_array_equal(inv.numpy(), inv_p.numpy())
    out = pipe.fused_pipeline(rows[1:], h, inv)
    np.testing.assert_array_equal(out.to_numpy(),
                                  pipe.fused_pipeline_plain(rows[1:], h, inv).to_numpy())


def test_frame_axis_batches_frames():
    """A leading K axis gives the per-frame results (one launch on the card)."""
    parts = [make_case(4, 256, 5, "f32", seed=k) for k in range(3)]
    frames = CArray(torch.from_numpy(np.stack([p[0] for p in parts])),
                    torch.from_numpy(np.stack([p[1] for p in parts])))
    x_full = tls.pad_pilot(parts[0][2], "cpu")
    h, inv = pipe.estimate_pilot_fused(frames[:, 0], x_full)
    out = pipe.fused_pipeline(frames[:, 1:], h, inv).to_numpy()
    assert out.shape == (3, 4, 255)
    for k in range(3):
        h_k, inv_k = pipe.estimate_pilot_fused(frames[k, 0], x_full)
        want = pipe.fused_pipeline(frames[k, 1:], h_k, inv_k).to_numpy()
        assert max_rel(out[k], want) < 1e-6


@pytest.mark.parametrize("f", [256, 1024])
def test_pilot_from_reference_is_pad_pilot(f):
    rng = np.random.default_rng(f)
    pilot = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
    got = convert.pilot_from_reference(jfastpath.prepare_pilot_fast(pilot, f).to_numpy(),
                                       device="cpu")
    np.testing.assert_array_equal(got.to_numpy(), tls.pad_pilot(pilot, "cpu").to_numpy())


@pytest.mark.parametrize("f", [256, 1024, 4096])
def test_kernel_layout_map_matches_reference_epilogue(f):
    """convert's kernel-layout map and pipeline.reference_order_index,
    composed, equal the JAX to_reference_order epilogue."""
    rng = np.random.default_rng(f)
    nat = (rng.standard_normal((3, f)) + 1j * rng.standard_normal((3, f))).astype(np.complex64)
    kernel_layout = nat[:, convert.kernel_true_frequency(f)]
    want = jpp.to_reference_order(JCArray.from_numpy(kernel_layout), f).to_numpy()
    np.testing.assert_array_equal(nat[:, pipe.reference_order_index(f)], want)


@pytest.mark.parametrize("f", [256, 1024, 4096])
def test_reference_order_index(f):
    """Natural-order index == finalize (DC drop + ifftshift) == the reference
    fastpath edge gather mapped through its permutation."""
    idx = pipe.reference_order_index(f)
    np.testing.assert_array_equal(idx, convert.perm_true_frequency(f)[jfastpath._edge_gather(f)])
    rng = np.random.default_rng(0)
    eq = CArray.from_numpy(rng.standard_normal((2, f)).astype(np.float32), "cpu")
    np.testing.assert_array_equal(eq[..., torch.from_numpy(idx)].to_numpy(),
                                  tmrc.finalize(eq).to_numpy())


# F -> (the port's rule, the reference's rule).  The port's kernels take a
# power of two from 64 to 32768; the TPU kernel wants a (2^k, 128) split,
# which starts at 256 (it sends 64 and 128 to its 'fast' path) and has no
# upper bound.
SUPPORTS_FUSED = {64: (True, False), 128: (True, False), 192: (False, False),
                  256: (True, True), 512: (True, True), 1024: (True, True),
                  2048: (True, True), 4096: (True, True), 8192: (True, True),
                  16384: (True, True), 32768: (True, True), 65536: (False, True)}


@pytest.mark.parametrize("f", sorted(SUPPORTS_FUSED))
def test_supports_fused(f):
    """Both rules, case by case: the port's is wider below 256 and stops at
    32768 (the register FFT to 8192, its split form at 16384 and 32768)."""
    port, reference = SUPPORTS_FUSED[f]
    assert pipe.supports_fused(f) == port
    assert jpp.supports_fused(f) == reference


def test_convert_defaults_to_the_card(monkeypatch):
    """Every convert helper puts its tensors on the card unless asked for
    the CPU, and raises where there is no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.ones(256, np.complex64)
    h = np.ones((2, 2, 128), np.float32)
    inv = np.ones((2, 128), np.float32)
    calls = [lambda **kw: convert.pilot_from_reference(x, **kw),
             lambda **kw: convert.estimate_from_reference(h, h, inv, **kw),
             lambda **kw: convert.streaming_state_from_reference(
                 h.reshape(2, 256), h.reshape(2, 256), inv.reshape(256), **kw)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA"):
            call()
        call(device="cpu")
