"""The port's PSF operator (``torch.fft``) against ``repro.imaging.psf``
(``jnp.fft``), both on the CPU.

Inputs are drawn with numpy from a seed, or taken from the JAX
``simulate``.  Tolerances: fp32 rtol/atol 2e-5 for one convolution (the
two FFT libraries round differently); the adjoint identity at the JAX
package's own 1e-4 (``tests/test_imaging.py``); the power-iteration norm,
60 chained round trips, at rtol 1e-5.  The start vectors that
``spectral_norm`` keeps per shape are held bit for bit to a fresh CPU
seed-0 draw, and a solve after a hit to one after a miss.
"""
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.imaging import psf as jpsf
from repro_torch.core.problem import solve
from repro_torch.imaging import psf
from repro_torch.imaging.condat import SolverConfig

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


# ---------------------------------------------------------------------
# The kept default start vectors of spectral_norm
# ---------------------------------------------------------------------

@pytest.fixture
def starts(monkeypatch):
    """An empty memo and zeroed counters for the test alone."""
    kept = OrderedDict()
    monkeypatch.setattr(psf, "_default_starts", kept)
    monkeypatch.setitem(psf.DEFAULT_STARTS, "hits", 0)
    monkeypatch.setitem(psf.DEFAULT_STARTS, "misses", 0)
    return kept


def _seed0_draw(shape):
    g = torch.Generator().manual_seed(0)
    u0 = torch.randn(shape, generator=g)
    return u0, torch.randn(shape, generator=g)


def _counts():
    return psf.DEFAULT_STARTS["hits"], psf.DEFAULT_STARTS["misses"]


def _pair_bytes(shape):
    return 2 * 4 * int(np.prod(shape))


@pytest.mark.parametrize("shape", [(3, 9, 9), (2, 21, 21), (1, 41, 41)])
def test_default_starts_are_the_seed0_draw(starts, shape):
    psf.spectral_norm(_t(_normal(1, shape)), iters=4)
    assert _counts() == (0, 1)
    (key, (u, v)), = starts.items()
    assert key == (shape, "cpu")
    u0, v0 = _seed0_draw(shape)
    assert u.dtype == v.dtype == torch.float32
    assert torch.equal(u, u0) and torch.equal(v, v0)


def test_second_default_call_hits_with_the_same_norm(starts):
    P = _t(_normal(2, (4, 21, 21)))
    first = psf.spectral_norm(P)
    second = psf.spectral_norm(P)
    assert _counts() == (1, 1)
    u0, v0 = _seed0_draw((4, 21, 21))
    assert first == second == psf.spectral_norm(P, u0=u0, v0=v0)


@pytest.mark.parametrize("kind", ["tensor", "numpy"])
def test_injected_draws_bypass_the_memo(starts, kind):
    u0, v0 = _seed0_draw((3, 9, 9))
    if kind == "numpy":
        u0, v0 = u0.numpy(), v0.numpy()
    psf.spectral_norm(_t(_normal(3, (3, 9, 9))), iters=4, u0=u0, v0=v0)
    assert _counts() == (0, 0)
    assert not starts


def test_two_shapes_make_two_entries(starts):
    for shape in ((3, 9, 9), (5, 9, 9), (3, 9, 9)):
        psf.spectral_norm(_t(_normal(4, shape)), iters=2)
    assert list(starts) == [((5, 9, 9), "cpu"), ((3, 9, 9), "cpu")]
    assert _counts() == (1, 2)


def test_least_recently_used_entry_is_evicted(starts, monkeypatch):
    """Room for the pairs of three and four 9 x 9 stamps: a third shape
    evicts the one used least recently, not the one drawn first."""
    monkeypatch.setattr(psf, "_DEFAULT_STARTS_CAP",
                        _pair_bytes((3, 9, 9)) + _pair_bytes((4, 9, 9)))
    a, b, c = (_t(_normal(5, (n, 9, 9))) for n in (2, 3, 4))
    for P in (a, b, a, c):
        psf.spectral_norm(P, iters=2)
    assert list(starts) == [((2, 9, 9), "cpu"), ((4, 9, 9), "cpu")]
    assert _counts() == (1, 3)
    psf.spectral_norm(b, iters=2)
    assert list(starts) == [((4, 9, 9), "cpu"), ((3, 9, 9), "cpu")]
    assert _counts() == (1, 4)


def test_pair_over_the_cap_is_used_but_not_kept(starts, monkeypatch):
    monkeypatch.setattr(psf, "_DEFAULT_STARTS_CAP",
                        _pair_bytes((2, 9, 9)))
    small, large = _t(_normal(6, (2, 9, 9))), _t(_normal(6, (3, 9, 9)))
    psf.spectral_norm(small, iters=2)
    got = psf.spectral_norm(large, iters=8)
    assert list(starts) == [((2, 9, 9), "cpu")]
    u0, v0 = _seed0_draw((3, 9, 9))
    assert got == psf.spectral_norm(large, iters=8, u0=u0, v0=v0)
    psf.spectral_norm(large, iters=2)
    assert _counts() == (0, 3)


def _small_catalogue():
    d = psf.simulate(12, torch.Generator().manual_seed(5), stamp=13,
                     device="cpu")
    return d.Y, d.psfs


def _default_solve(Y, P):
    return solve("deconvolve", Y, P, cfg=SolverConfig(n_scales=3),
                 device="cpu", max_iter=8, chunk=4, tol=0.0)


def test_solve_leaves_the_kept_starts_unwritten(starts):
    Y, P = _small_catalogue()
    _default_solve(Y, P)
    (u, v), = starts.values()
    u0, v0 = _seed0_draw(tuple(P.shape))
    assert torch.equal(u, u0) and torch.equal(v, v0)


def test_solve_after_a_hit_is_bit_identical_to_after_a_miss(starts):
    Y, P = _small_catalogue()
    miss = _default_solve(Y, P)
    assert _counts() == (0, 1)
    hit = _default_solve(Y, P)
    assert _counts() == (1, 1)
    np.testing.assert_array_equal(miss.x, hit.x)
    assert miss.log.costs == hit.log.costs


def test_concurrent_callers_of_one_shape_draw_once(starts):
    P = _t(_normal(7, (4, 15, 15)))
    barrier = threading.Barrier(8)

    def call():
        barrier.wait()
        return psf.spectral_norm(P, iters=6)

    with ThreadPoolExecutor(8) as pool:
        norms = list(pool.map(lambda _: call(), range(8)))
    assert _counts() == (7, 1)
    assert len(set(norms)) == 1
    assert len(starts) == 1
