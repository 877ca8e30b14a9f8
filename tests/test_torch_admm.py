"""The port's fused ADMM elementwise tail against
``repro.kernels.admm_elwise``.

On the CPU the port's wrapper takes its plain version (``ref.py``); it is
compared with JAX's Pallas kernel in interpret mode and with JAX's
oracle, on the case list of ``tests/test_kernels.py`` (non-block-aligned
K included).  The port keeps the multiplier stack plane-major,
(5, K, A); the JAX package keeps (K, 5, A), so the tests swap the first
two axes at the boundary.

Tolerances: fp32 rtol/atol 2e-5 and bf16 2e-2 (``tests/test_kernels.py``);
the clip/fold algebra against the textbook step 8 rtol 1e-5 / atol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.admm_elwise.ops import admm_elwise as jadmm
from repro.kernels.admm_elwise.ref import admm_elwise_ref as jadmm_ref
from repro_torch.kernels.admm_elwise.kernel import admm_elwise_fwd
from repro_torch.kernels.admm_elwise.ops import admm_elwise

torch.set_num_threads(2)

AE_KW = dict(c1=0.4, c2=0.4, c3=0.8, t1=0.025, t2=0.025)
AE_CASES = [(2048, 128), (1000, 256), (130, 128), (512, 512)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)


def _draw(seed, shape, jdtype):
    """A numpy draw rounded to ``jdtype``, so both packages see the same
    values."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.asarray(jnp.asarray(a, jdtype), np.float32)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


@pytest.mark.parametrize("case", AE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_admm_elwise_matches_jax(case, dtype):
    K, A = case
    jdt, tdt = DTYPES[dtype]
    Wh, Wl = _draw(1, (K, A), jdt), _draw(2, (K, A), jdt)
    YZ = _draw(3, (K, 5, A), jdt)
    got = admm_elwise(torch.tensor(Wh, dtype=tdt),
                      torch.tensor(Wl, dtype=tdt),
                      torch.tensor(np.swapaxes(YZ, 0, 1), dtype=tdt), **AE_KW)
    assert got.dtype == tdt and tuple(got.shape) == (5, K, A)
    got = np.swapaxes(_f32(got), 0, 1)
    jin = [jnp.asarray(a, jdt) for a in (Wh, Wl, YZ)]
    np.testing.assert_allclose(got, _f32(jadmm_ref(*jin, **AE_KW)),
                               **_tol(dtype))
    kern = jadmm(*jin, use_kernel=True, interpret=True, **AE_KW)
    np.testing.assert_allclose(got, _f32(kern), **_tol(dtype))


def test_admm_elwise_matches_unfused_formulation():
    """The clip/fold algebra equals the textbook step 8: soft-threshold
    P/Q, three dual ascent updates and the Z right-hand sides."""
    K, A = 257, 64
    c1, c2, c3, t1, t2 = (AE_KW[k] for k in ("c1", "c2", "c3", "t1", "t2"))
    Wh, Wl = (torch.tensor(_draw(s, (K, A), jnp.float32)) for s in (4, 5))
    YZ = torch.tensor(_draw(6, (5, K, A), jnp.float32))
    y1, y2, y3 = YZ[0], YZ[1], YZ[2]

    def soft(x, t):
        return torch.sign(x) * torch.clamp(x.abs() - t, min=0.0)

    P = soft(Wh - y1 / c1, t1)
    Q = soft(Wl - y2 / c2, t2)
    Y1 = y1 + c1 * (P - Wh)
    Y2 = y2 + c2 * (Q - Wl)
    Y3 = y3 + c3 * (Wh - Wl)
    expect = torch.stack([Y1, Y2, Y3, c1 * P + Y1 - Y3 + c3 * Wl,
                          c2 * Q + Y2 + Y3])
    got = admm_elwise(Wh, Wl, YZ, **AE_KW)
    np.testing.assert_allclose(got.numpy(), expect.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_admm_elwise_ignores_old_z_planes():
    """Z1 and Z2 are outputs only: the new state does not depend on
    their old values."""
    Wh, Wl = (torch.tensor(_draw(s, (33, 16), jnp.float32)) for s in (7, 8))
    YZ = torch.tensor(_draw(9, (5, 33, 16), jnp.float32))
    YZ2 = YZ.clone()
    YZ2[3:] = 123.0
    assert torch.equal(admm_elwise(Wh, Wl, YZ, **AE_KW),
                       admm_elwise(Wh, Wl, YZ2, **AE_KW))


def test_cpu_wrapper_launches_no_kernel_and_refuses_use_kernel():
    Wh = torch.zeros((4, 8))
    YZ = torch.zeros((5, 4, 8))
    before = admm_elwise_fwd.launches
    admm_elwise(Wh, Wh, YZ, **AE_KW)
    assert admm_elwise_fwd.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        admm_elwise(Wh, Wh, YZ, use_kernel=True, **AE_KW)
    assert admm_elwise_fwd.launches == before
