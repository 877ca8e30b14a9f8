"""The port's fused starlet transforms (Phi and Phi^T) against the JAX
package.

On the CPU ``ops.forward``/``ops.adjoint`` take their plain versions
(``forward_ref``/``adjoint_ref``, the cascades composed of
``smooth_ref``); on the card they launch one fused kernel each, which
``chip_smoke.py`` holds against the same plain versions.  The same
inputs, drawn with numpy from a seed, go through ``repro``'s batched
transforms with its Pallas smoothing in interpret mode, as the package's
own tests run it on the CPU.

The shapes cover one stamp, a ragged count, the 41 x 41 survey stamps,
a power-of-two width, and 13 x 13 at J = 5, where the taps of scales 3
and 4 (16 and 32 apart) wrap more than once around the stamp.

Tolerances are the reference's own (``tests/test_kernels.py``): fp32
rtol/atol 2e-5, where only the order of summation differs; bf16 2e-2.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.imaging import starlet as jstarlet
from repro.kernels.starlet2d import ops as jops
from repro_torch.imaging import starlet
from repro_torch.kernels.starlet2d import kernel as kernel_mod
from repro_torch.kernels.starlet2d import ops
from repro_torch.kernels.starlet2d.kernel import (smooth_fwd,
                                                  starlet_adjoint_fwd,
                                                  starlet_forward_fwd)
from repro_torch.kernels.starlet2d.ref import adjoint_ref, forward_ref

torch.set_num_threads(2)

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


CASES = [(n, s, j) for n in (1, 7, 9) for s in (13, 32, 41)
         for j in (1, 2, 4, 5)]


@pytest.mark.parametrize("n,s,n_scales", CASES)
def test_forward_adjoint_match_jax(n, s, n_scales):
    x = _normal(1000 + 10 * n + s, (n, s, s))
    u = _normal(2000 + 10 * n + s, (n_scales, n, s, s))
    fwd = ops.forward(_t(x), n_scales)
    adj = ops.adjoint(_t(u), n_scales)
    assert fwd.shape == (n_scales, n, s, s) and adj.shape == (n, s, s)
    # on the CPU the ops are their plain versions, bit for bit
    assert torch.equal(fwd, forward_ref(_t(x), n_scales))
    assert torch.equal(adj, adjoint_ref(_t(u), n_scales))
    np.testing.assert_allclose(
        fwd.numpy(), np.asarray(jops.forward(jnp.asarray(x), n_scales)),
        **F32)
    np.testing.assert_allclose(
        adj.numpy(), np.asarray(jops.adjoint(jnp.asarray(u), n_scales)),
        **F32)


@pytest.mark.parametrize("n,s,n_scales", [(7, 13, 5), (9, 41, 4)])
def test_forward_adjoint_bf16_match_jax(n, s, n_scales):
    """bf16 through both packages: each rounds the output of every
    smoothing (accumulated in fp32) and every difference and sum."""
    xb = jnp.asarray(_normal(3000 + s, (n, s, s)), jnp.bfloat16)
    ub = jnp.asarray(_normal(3100 + s, (n_scales, n, s, s)), jnp.bfloat16)
    fwd = ops.forward(_t(np.asarray(xb, np.float32), torch.bfloat16),
                      n_scales)
    adj = ops.adjoint(_t(np.asarray(ub, np.float32), torch.bfloat16),
                      n_scales)
    assert fwd.dtype == adj.dtype == torch.bfloat16
    np.testing.assert_allclose(
        fwd.float().numpy(),
        np.asarray(jops.forward(xb, n_scales), np.float32), **BF16)
    np.testing.assert_allclose(
        adj.float().numpy(),
        np.asarray(jops.adjoint(ub, n_scales), np.float32), **BF16)


@pytest.mark.parametrize("lead", [(), (3,), (2, 3)])
def test_imaging_transforms_take_any_leading_shape(lead):
    """``imaging.starlet.forward``/``adjoint`` run the batched ops on a
    flattened (N, H, W) view and keep the shapes (J, ..., H, W) and
    (..., H, W)."""
    x = _normal(40 + len(lead), lead + (21, 21))
    u = _normal(50 + len(lead), (4,) + lead + (21, 21))
    fwd = starlet.forward(_t(x), 4)
    adj = starlet.adjoint(_t(u), 4)
    assert fwd.shape == (4,) + lead + (21, 21)
    assert adj.shape == lead + (21, 21)
    np.testing.assert_allclose(
        fwd.numpy(), np.asarray(jstarlet.forward(jnp.asarray(x), 4)), **F32)
    np.testing.assert_allclose(
        adj.numpy(), np.asarray(jstarlet.adjoint(jnp.asarray(u), 4)), **F32)


def test_imaging_adjoint_reads_only_n_scales_planes():
    """As in the reference, extra trailing planes (the coarse scale of a
    ``decompose``) are ignored."""
    co = _normal(60, (5, 2, 13, 13))
    np.testing.assert_allclose(
        starlet.adjoint(_t(co), 4).numpy(),
        np.asarray(jstarlet.adjoint(jnp.asarray(co), 4)), **F32)


@pytest.mark.parametrize("n_scales", [1, 2, 4, 5])
def test_batched_adjoint_dot_product(n_scales):
    """<Phi x, u> == <x, Phi^T u> over a whole stamp stack, to fp32
    precision (the JAX package's own bound, ``tests/test_imaging.py``)."""
    x = _t(_normal(70, (7, 13, 13)))
    u = _t(_normal(71, (n_scales, 7, 13, 13)))
    lhs = float(torch.sum(ops.forward(x, n_scales) * u))
    rhs = float(torch.sum(x * ops.adjoint(u, n_scales)))
    assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), 1.0)


def test_cpu_cascades_launch_no_kernel():
    counters = (smooth_fwd, starlet_forward_fwd, starlet_adjoint_fwd)
    before = [f.launches for f in counters]
    x = _t(_normal(80, (2, 13, 13)))
    u = _t(_normal(81, (3, 2, 13, 13)))
    ops.forward(x, 3)
    ops.adjoint(u, 3)
    starlet.forward(x, 3)
    starlet.adjoint(u, 3)
    with pytest.raises(ValueError, match="CUDA"):
        ops.forward(x, 3, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.adjoint(u, 3, use_kernel=True)
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("name,const", [("MAX_SCALES", "kMaxScales"),
                                        ("_CASCADE_THREADS", "kThreads"),
                                        ("MAX_REGS_SIDE", "kMaxRegsSide")])
def test_wrapper_limits_match_the_kernel_source(name, const):
    """The limits the wrappers check and document are the constants the
    kernels are built with."""
    csrc = Path(kernel_mod.__file__).resolve().parents[2] / "csrc"
    src = "".join(f.read_text() for f in sorted(csrc.glob("starlet2d*")))
    assert re.findall(rf"constexpr int {const} = (\d+);", src) == [
        str(getattr(kernel_mod, name))]
