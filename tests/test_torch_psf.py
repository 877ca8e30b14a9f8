"""The port's PSF operator (``torch.fft``) against ``repro.imaging.psf``
(``jnp.fft``), both on the CPU.

Inputs are drawn with numpy from a seed, or taken from the JAX
``simulate``.  Tolerances: fp32 rtol/atol 2e-5 for one convolution (the
two FFT libraries round differently); the adjoint identity at the JAX
package's own 1e-4 (``tests/test_imaging.py``); the power-iteration norm,
60 chained round trips, at rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.imaging import psf as jpsf
from repro_torch.imaging import psf

torch.set_num_threads(2)

F32 = dict(rtol=2e-5, atol=2e-5)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


@pytest.fixture(scope="module")
def sim():
    d = jpsf.simulate(6, jax.random.PRNGKey(3), stamp=21)
    return np.asarray(d.Y), np.asarray(d.X_true), np.asarray(d.psfs)


def test_fast_size_and_pad_for_match_jax():
    for n in range(1, 201):
        assert psf.fast_size(n) == jpsf.fast_size(n), n
        assert psf.pad_for(n) == jpsf.pad_for(n), n
        assert psf.pad_for(n, 5) == jpsf.pad_for(n, 5), n
    assert psf.pad_for(psf.STAMP) == 81


@pytest.mark.parametrize("stamp", [21, 41])
def test_psf_fft_pair_matches_jax(stamp):
    psfs = _normal(stamp, (3, stamp, stamp))
    got = psf.psf_fft_pair(_t(psfs))
    want = np.asarray(jpsf.psf_fft_pair(jnp.asarray(psfs)))
    assert got.dtype == torch.complex64
    assert tuple(got.shape) == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                               atol=2e-5 * scale)


def test_paired_convolutions_match_jax(sim):
    Y, X, P = sim
    kf = psf.psf_fft_pair(_t(P))
    jkf = jpsf.psf_fft_pair(jnp.asarray(P))
    np.testing.assert_allclose(psf.H_fp(_t(X), kf).numpy(),
                               np.asarray(jpsf.H_fp(jnp.asarray(X), jkf)),
                               **F32)
    np.testing.assert_allclose(psf.Ht_fp(_t(Y), kf).numpy(),
                               np.asarray(jpsf.Ht_fp(jnp.asarray(Y), jkf)),
                               **F32)
    a, b = psf.conv_pair_f(_t(X), _t(Y), kf)
    ja, jb = jpsf.conv_pair_f(jnp.asarray(X), jnp.asarray(Y), jkf)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), **F32)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), **F32)
    assert a.is_contiguous() and b.is_contiguous()


def test_one_shot_convolutions_match_jax(sim):
    Y, X, P = sim
    np.testing.assert_allclose(psf.H(_t(X), _t(P)).numpy(),
                               np.asarray(jpsf.H(jnp.asarray(X),
                                                 jnp.asarray(P))), **F32)
    np.testing.assert_allclose(psf.Ht(_t(Y), _t(P)).numpy(),
                               np.asarray(jpsf.Ht(jnp.asarray(Y),
                                                  jnp.asarray(P))), **F32)


def test_bf16_operands_go_through_fp32():
    """Half-precision stamps are transformed in fp32 and cast back
    (``_real``); bf16 rounding of the result, so rtol/atol 2e-2."""
    x = np.asarray(jnp.asarray(_normal(5, (3, 21, 21)), jnp.bfloat16),
                   np.float32)
    P = _normal(6, (3, 21, 21))
    got = psf.H_fp(_t(x, torch.bfloat16), psf.psf_fft_pair(_t(P)))
    assert got.dtype == torch.bfloat16
    want = jpsf.H_fp(jnp.asarray(x, jnp.bfloat16),
                     jpsf.psf_fft_pair(jnp.asarray(P)))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("stamp", [9, 21, 41])
def test_adjoint_identity(stamp):
    """<H x, y> == <x, Ht y>, through the pair and through conv_pair_f."""
    x, y, p = (_t(_normal(stamp + i, (3, stamp, stamp))) for i in range(3))
    kf = psf.psf_fft_pair(p)
    for Hx, Hty in ((psf.H_fp(x, kf), psf.Ht_fp(y, kf)),
                    psf.conv_pair_f(x, y, kf)):
        lhs = float(torch.sum(Hx * y))
        rhs = float(torch.sum(x * Hty))
        assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), 1.0)


def test_spectral_norm_with_jax_start(sim):
    """JAX splits PRNGKey(0) into the u and v start vectors; injected,
    the 60-step power iteration lands on the same norm."""
    _, _, P = sim
    ku, kv = jax.random.split(jax.random.PRNGKey(0))
    u0 = np.asarray(jax.random.normal(ku, P.shape))
    v0 = np.asarray(jax.random.normal(kv, P.shape))
    got = psf.spectral_norm(_t(P), u0=u0, v0=v0)
    want = jpsf.spectral_norm(jnp.asarray(P))
    assert got == pytest.approx(want, rel=1e-5)
    # the pair may be passed in, as the solver does
    kf = psf.psf_fft_pair(_t(P))
    assert psf.spectral_norm(_t(P), u0=u0, v0=v0, kf_pair=kf) == got


def test_simulate_shapes_and_normalisation():
    """The port draws from a torch.Generator, so it matches the JAX
    simulation in distribution only: check shapes, unit-flux galaxies and
    PSFs, and a noise level near sigma."""
    g = torch.Generator().manual_seed(1)
    d = psf.simulate(64, g, stamp=21, device="cpu")
    for a in (d.Y, d.X_true, d.psfs):
        assert tuple(a.shape) == (64, 21, 21)
        assert a.dtype == torch.float32
        assert bool(torch.isfinite(a).all())
    np.testing.assert_allclose(d.X_true.sum(dim=(1, 2)).numpy(), 1.0,
                               rtol=1e-5)
    np.testing.assert_allclose(d.psfs.sum(dim=(1, 2)).numpy(), 1.0,
                               rtol=1e-5)
    resid = d.Y - psf.H(d.X_true, d.psfs)
    assert float(resid.std()) == pytest.approx(d.sigma, rel=0.05)
    again = psf.simulate(64, torch.Generator().manual_seed(1), stamp=21,
                         device="cpu")
    assert torch.equal(again.Y, d.Y)


def test_simulate_without_cuda_needs_cpu_device():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        psf.simulate(2, stamp=9)
