"""Port ops (ofdm_ls_mrc_tpu_torch.ops) against the JAX reference ops on the
same inputs, made with numpy from a seed.  Tolerance: max-rel 1e-5, i.e.
float32 rounding of the same formulas (the FFTs differ in algorithm)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_ls_mrc_tpu.ops import cplx as jcplx
from ofdm_ls_mrc_tpu.ops import fastpath as jfastpath
from ofdm_ls_mrc_tpu.ops import fft as jfft
from ofdm_ls_mrc_tpu.ops import ls as jls
from ofdm_ls_mrc_tpu.ops import modulate as jmod
from ofdm_ls_mrc_tpu.ops import mrc as jmrc
from ofdm_ls_mrc_tpu.ops import shift as jshift
from ofdm_ls_mrc_tpu_torch.ops import fft as tfft
from ofdm_ls_mrc_tpu_torch.ops import ls as tls
from ofdm_ls_mrc_tpu_torch.ops import modulate as tmod
from ofdm_ls_mrc_tpu_torch.ops import mrc as tmrc
from ofdm_ls_mrc_tpu_torch.ops import shift as tshift
from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray
from ofdm_ls_mrc_tpu_torch.ops.pipeline import widen_sc16

TOL = 1e-5


def crandn(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def max_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def both(x):
    """The same host array as a JAX CArray and a port CArray (CPU)."""
    return jcplx.CArray.from_numpy(x), CArray.from_numpy(x, "cpu")


def host(x):
    """Either package's CArray -> complex64 numpy."""
    return x.to_numpy()


BINARY = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "mul_conj": lambda a, b: a.mul_conj(b),
}
UNARY = {
    "conj": lambda a: a.conj(),
    "roll": lambda a: a.roll(5, axis=-1),
    "getitem": lambda a: a[1:, ..., 3:],
    "reshape": lambda a: a.reshape(-1, 8),
    "scale": lambda a: a * 0.5,
    "div_real": lambda a: a.div_real(a.abs2() + 1.0),
}


@pytest.mark.parametrize("op", sorted(BINARY))
def test_cplx_binary(op):
    rng = np.random.default_rng(1)
    a, b = crandn(rng, (3, 4, 16)), crandn(rng, (3, 4, 16))
    (ja, ta), (jb, tb) = both(a), both(b)
    assert max_rel(host(BINARY[op](ta, tb)), host(BINARY[op](ja, jb))) < TOL


@pytest.mark.parametrize("op", sorted(UNARY))
def test_cplx_unary(op):
    rng = np.random.default_rng(2)
    ja, ta = both(crandn(rng, (3, 4, 16)))
    got, want = UNARY[op](ta), UNARY[op](ja)
    assert got.shape == tuple(want.shape)
    assert max_rel(host(got), host(want)) < TOL


def test_cplx_abs2_and_host_boundary():
    rng = np.random.default_rng(3)
    x = crandn(rng, (2, 32))
    ja, ta = both(x)
    assert max_rel(ta.abs2().numpy(), np.asarray(ja.abs2())) < TOL
    np.testing.assert_array_equal(ta.to_numpy(), x)
    assert ta.dtype == torch.float32 and ta.device.type == "cpu"
    real = CArray.from_numpy(x.real, "cpu")
    assert torch.count_nonzero(real.im) == 0


def test_cplx_rejects_mismatched_planes_and_complex_scale():
    with pytest.raises(ValueError):
        CArray(torch.zeros(3), torch.zeros(4))
    with pytest.raises(TypeError):
        CArray(torch.zeros(3), torch.zeros(3)) * 1j


@pytest.mark.parametrize("n", [1023, 1024])
def test_shifts(n):
    rng = np.random.default_rng(4)
    ja, ta = both(crandn(rng, (2, n)))
    assert max_rel(host(tshift.pilot_shift(ta)), host(jshift.pilot_shift(ja))) < TOL
    assert max_rel(host(tshift.output_shift(ta)), host(jshift.output_shift(ja))) < TOL


@pytest.mark.parametrize("cp", [0, 72])
def test_cyclic_prefix(cp):
    rng = np.random.default_rng(5)
    ja, ta = both(crandn(rng, (3, 2, 256)))
    added_t, added_j = tmod.add_cyclic_prefix(ta, cp), jmod.add_cyclic_prefix(ja, cp)
    assert max_rel(host(added_t), host(added_j)) < TOL
    dropped = tmod.drop_cyclic_prefix(added_t, cp)
    assert max_rel(host(dropped), host(jmod.drop_cyclic_prefix(added_j, cp))) < TOL
    np.testing.assert_array_equal(host(dropped), host(ta))


@pytest.mark.parametrize("f", [256, 1024])
def test_fft_matches_reference(f):
    rng = np.random.default_rng(6)
    ja, ta = both(crandn(rng, (3, 4, f)))
    got = host(tfft.fft(ta))
    assert max_rel(got, host(jfft.fft_xla(ja))) < TOL
    assert max_rel(got, host(jfft.fft_four_step(ja))) < TOL
    assert max_rel(host(tfft.ifft(ta)), host(jfft.ifft_xla(ja))) < TOL


@pytest.mark.parametrize("a", [1, 4])
def test_ls_estimate(a):
    rng = np.random.default_rng(7)
    f = 256
    pilot = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
    jx, tx = jls.pad_pilot(pilot), tls.pad_pilot(pilot, "cpu")
    np.testing.assert_array_equal(host(tx), host(jx))
    jy, ty = both(crandn(rng, (a, f)))
    jh, jsq = jls.estimate_channel_full(jy, jx)
    th, tsq = tls.estimate_channel_full(ty, tx)
    assert max_rel(host(th), host(jh)) < TOL
    assert max_rel(tsq.numpy(), np.asarray(jsq)) < TOL
    assert np.all(host(th)[:, 0] == 0) and float(tsq[0]) == 1.0


@pytest.mark.parametrize("a", [1, 4])
def test_mrc(a):
    rng = np.random.default_rng(8)
    s, f = 5, 256
    jd, td = both(crandn(rng, (s, a, f)))
    jh, th = both(crandn(rng, (a, f)))
    hsq = (rng.random(f) + 0.5).astype(np.float32)
    assert max_rel(host(tmrc.mrc_numerator(td, th)),
                   host(jmrc.mrc_numerator(jd, jh))) < TOL
    t_eq = tmrc.mrc_combine(td, th, torch.from_numpy(hsq))
    j_eq = jmrc.mrc_combine(jd, jh, jnp.asarray(hsq))
    assert max_rel(host(t_eq), host(j_eq)) < TOL
    assert max_rel(host(tmrc.finalize(t_eq)), host(jmrc.finalize(j_eq))) < TOL


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_widen_sc16(dtype):
    rng = np.random.default_rng(9)
    re = rng.integers(-32767, 32768, (4, 64)).astype(dtype)
    im = rng.integers(-32767, 32768, (4, 64)).astype(dtype)
    got = widen_sc16(CArray(torch.from_numpy(re), torch.from_numpy(im)))
    want = jfastpath.widen_sc16(jcplx.CArray(jnp.asarray(re), jnp.asarray(im)))
    assert got.dtype == torch.float32
    assert max_rel(host(got), host(want)) < TOL
