"""The plain reference against a NumPy LS + MRC written out at tiny sizes,
and the port's CPU path against the reference through the harness."""

import numpy as np
import pytest
import torch

from conftest import run_tiny
from portbench import check, spec

REF = spec.reference({"reference": "ls_mrc"})


def numpy_demod(y: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Frames [K, S, A, F] complex, pilot [F - 1] -> [K, S - 1, F - 1], one
    frame, antenna and symbol at a time."""
    k_n, s_n, a_n, f = y.shape
    xf = np.concatenate([[1.0], x])
    out = np.zeros((k_n, s_n - 1, f - 1), complex)
    for k in range(k_n):
        h = [np.fft.fft(y[k, 0, a]) / xf for a in range(a_n)]
        g = sum(np.abs(ha) ** 2 for ha in h)
        for s in range(1, s_n):
            eq = sum(np.conj(h[a]) * np.fft.fft(y[k, s, a]) for a in range(a_n)) / g
            out[k, s - 1] = np.fft.ifftshift(eq[1:])
    return out


@pytest.mark.parametrize("a,f,s", [(1, 8, 2), (4, 64, 5), (3, 128, 3), (2, 256, 4)])
def test_reference_matches_numpy(a, f, s):
    rng = np.random.default_rng(f + a)
    re = rng.integers(-3000, 3000, (2, s, a, f)).astype(np.int16)
    im = rng.integers(-3000, 3000, (2, s, a, f)).astype(np.int16)
    x = np.exp(2j * np.pi * rng.random(f - 1))
    got = REF.demod(torch.from_numpy(re), torch.from_numpy(im), torch.from_numpy(x)).numpy()
    want = numpy_demod((re + 1j * im) / 32767.0, x)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10 * np.abs(want).max())


def test_out_err_reads_the_widest_gap_over_the_rms():
    rng = np.random.default_rng(3)
    re = torch.from_numpy(rng.integers(-3000, 3000, (3, 4, 2, 16)).astype(np.int16))
    im = torch.from_numpy(rng.integers(-3000, 3000, (3, 4, 2, 16)).astype(np.int16))
    x = torch.from_numpy(np.exp(2j * np.pi * rng.random(15)))
    ref = REF.demod(re, im, x)
    out = ref.clone()
    rms = float(ref[1].abs().square().mean().sqrt())
    out[1, 2, 5] += 0.01 * rms
    err = check.out_err(out.real.float(), out.imag.float(), re, im, x, REF)
    assert err == pytest.approx(0.01, rel=1e-3)
    nan = out.clone()
    nan[0, 0, 0] = float("nan")
    assert check.out_err(nan.real.float(), nan.imag.float(), re, im, x, REF) == float("inf")


def test_the_port_on_the_cpu_agrees_with_the_reference(tiny):
    out = run_tiny(*tiny)
    assert out["result"]["correct"], out["checks"]
    assert out["checks"]["out_err"]["value"] < 2e-5
    assert out["compared"] == 3
