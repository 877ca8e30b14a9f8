"""The port's starlet smoothing and transforms against the JAX package.

The same inputs, drawn with numpy from a seed, go through
``repro_torch`` on the CPU (where ``ops.smooth`` takes its plain
version) and through ``repro``: its Pallas kernel in interpret mode
(``repro.kernels.starlet2d.ops.smooth``, as the package's own tests run
it on the CPU) and its ``smooth_ref`` oracle.

Tolerances are the reference's own (``tests/test_kernels.py``): fp32
rtol/atol 2e-5, where only the order of summation differs; bf16 2e-2,
where the port accumulates in fp32 and rounds once (the kernel contract)
while JAX's oracle rounds after every tap.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.imaging import starlet as jstarlet
from repro.kernels.starlet2d import ops as jops
from repro.kernels.starlet2d.ref import smooth_ref as jsmooth_ref
from repro_torch.imaging import starlet
from repro_torch.kernels.starlet2d import ops
from repro_torch.kernels.starlet2d.kernel import smooth_fwd
from repro_torch.kernels.starlet2d.ref import smooth_ref

torch.set_num_threads(2)

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


SMOOTH_CASES = [((16, 41, 41), j) for j in range(4)] + \
    [((9, 32, 32), j) for j in range(4)] + [((5, 13, 13), 3)]


@pytest.mark.parametrize("shape,scale", SMOOTH_CASES)
def test_smooth_matches_jax_kernel_and_oracle(shape, scale):
    """(5, 13, 13) at scale 3 has taps 16 apart on a 13-pixel axis: the
    periodic wrap must hold for offsets beyond the axis."""
    x = _normal(100 + scale, shape)
    got = ops.smooth(_t(x), scale=scale).numpy()
    np.testing.assert_allclose(got, smooth_ref(_t(x), scale).numpy(),
                               rtol=0, atol=0)
    np.testing.assert_allclose(
        got, np.asarray(jsmooth_ref(jnp.asarray(x), scale)), **F32)
    np.testing.assert_allclose(
        got, np.asarray(jops.smooth(jnp.asarray(x), scale=scale)), **F32)


@pytest.mark.parametrize("scale", [0, 3])
def test_smooth_bf16_matches_jax(scale):
    x = _normal(7, (16, 41, 41))
    xb = jnp.asarray(x, jnp.bfloat16)
    got = ops.smooth(_t(np.asarray(xb, np.float32), torch.bfloat16),
                     scale=scale)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jsmooth_ref(xb, scale), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)


def test_imaging_smooth_takes_any_leading_shape():
    """``imaging.starlet.smooth`` reshapes (..., H, W) to the kernel's
    (N, H, W) and back."""
    x = _normal(3, (2, 3, 21, 21))
    got = starlet.smooth(_t(x), 2).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jstarlet.smooth(jnp.asarray(x), 2)), **F32)


@pytest.mark.parametrize("n_scales", [1, 3, 4])
def test_batched_forward_adjoint_match_jax(n_scales):
    x = _normal(11, (9, 32, 32))
    co = ops.forward(_t(x), n_scales)
    want = np.asarray(jops.forward(jnp.asarray(x), n_scales))
    np.testing.assert_allclose(co.numpy(), want, **F32)
    u = _normal(12, (n_scales, 9, 32, 32))
    np.testing.assert_allclose(
        ops.adjoint(_t(u), n_scales).numpy(),
        np.asarray(jops.adjoint(jnp.asarray(u), n_scales)), **F32)
    np.testing.assert_allclose(
        ops.decompose(_t(x), n_scales).numpy(),
        np.asarray(jops.decompose(jnp.asarray(x), n_scales)), **F32)


def test_imaging_transforms_match_jax():
    x = _normal(13, (3, 41, 41))
    np.testing.assert_allclose(
        starlet.decompose(_t(x), 4).numpy(),
        np.asarray(jstarlet.decompose(jnp.asarray(x), 4)), **F32)
    np.testing.assert_allclose(
        starlet.forward(_t(x), 4).numpy(),
        np.asarray(jstarlet.forward(jnp.asarray(x), 4)), **F32)
    u = _normal(14, (4, 3, 41, 41))
    np.testing.assert_allclose(
        starlet.adjoint(_t(u), 4).numpy(),
        np.asarray(jstarlet.adjoint(jnp.asarray(u), 4)), **F32)


@pytest.mark.parametrize("n_scales", [1, 2, 4])
def test_decompose_recompose_reconstructs(n_scales):
    """The scales telescope, so their sum is the input; fp32 rounding of
    the J differences leaves a few ulps (atol 1e-6 on unit-scale data)."""
    x = _t(_normal(20 + n_scales, (4, 41, 41)))
    co = starlet.decompose(x, n_scales)
    assert co.shape == (n_scales + 1, 4, 41, 41)
    np.testing.assert_allclose(starlet.recompose(co).numpy(), x.numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_scales", [1, 2, 3, 4])
def test_adjoint_dot_product(n_scales):
    """<Phi x, u> == <x, Phi^T u> to fp32 precision (the JAX package's
    own bound, ``tests/test_imaging.py``)."""
    x = _t(_normal(30, (32, 32)))
    u = _t(_normal(31, (n_scales, 32, 32)))
    lhs = float(torch.sum(starlet.forward(x, n_scales) * u))
    rhs = float(torch.sum(x * starlet.adjoint(u, n_scales)))
    assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), 1.0)


def test_noise_std_scales_with_jax_draw():
    """JAX draws its calibration noise from PRNGKey(1); injected, the two
    estimates agree (population std: ``correction=0``)."""
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8, 41, 41)))
    got = starlet.noise_std_scales(4, noise=noise, device="cpu")
    assert got.shape == (4,) and got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jstarlet.noise_std_scales(4)), **F32)


@pytest.mark.parametrize("shape", [(41, 41), (21, 21)])
def test_spectral_norm_with_jax_start(shape):
    """30 power-iteration steps from JAX's PRNGKey(0) start vector; the
    norm is a reduction over many steps, so fp32 rtol 1e-5."""
    x0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), shape))
    got = starlet.spectral_norm(4, shape, x0=x0, device="cpu")
    want = jstarlet.spectral_norm(4, shape)
    assert got == pytest.approx(want, rel=1e-5)


def test_spectral_norm_default_start_is_memoized_and_seeded():
    a = starlet.spectral_norm(3, (21, 21), device="cpu")
    b = starlet.spectral_norm(3, (21, 21), device="cpu")
    assert a == b
    # the operator norm does not depend on the start vector
    want = jstarlet.spectral_norm(3, (21, 21))
    assert a == pytest.approx(want, rel=1e-3)


def test_cpu_smoothing_launches_no_kernel():
    before = smooth_fwd.launches
    ops.smooth(_t(_normal(1, (2, 13, 13))), scale=1)
    assert smooth_fwd.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        ops.smooth(_t(_normal(1, (2, 13, 13))), scale=1, use_kernel=True)
    assert smooth_fwd.launches == before
