"""The port's Condat pieces against ``repro.imaging.condat`` and the
fused elementwise passes against ``repro.kernels.condat_elwise``.

On the CPU the port's wrappers take their plain versions (``ref.py``);
they are compared with JAX's oracles and with its Pallas kernels in
interpret mode, on the case lists of ``tests/test_kernels.py``.  The JAX
package draws its operator-norm start vectors and calibration noise from
fixed PRNG keys; the tests hand those draws to the port.

Tolerances: fp32 rtol/atol 2e-5 and bf16 2e-2 for the elementwise passes
(``tests/test_kernels.py``); the step sizes, which come out of power
iterations, rtol 1e-5; a whole solve's cost history rtol 1e-4 and its
iterate rtol 1e-4 / atol 1e-6 (``tests/test_solve_many.py``), in sparse
and in low-rank mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.imaging import condat as jcondat
from repro.imaging import psf as jpsf
from repro.kernels.condat_elwise import ops as jops
from repro.kernels.condat_elwise.ref import (condat_dual_ref as jdual_ref,
                                             condat_primal_ref as jprimal_ref)
from repro_torch.imaging import condat, psf
from repro_torch.kernels.condat_elwise import ops
from repro_torch.kernels.condat_elwise.kernel import (condat_dual_fwd,
                                                      condat_primal_fwd)

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)


def _draw(seed, shape, jdtype, uniform=False):
    """A numpy draw rounded to ``jdtype``, so both packages see the same
    values."""
    rng = np.random.default_rng(seed)
    a = rng.random(shape) if uniform else rng.standard_normal(shape)
    return np.asarray(jnp.asarray(a.astype(np.float32), jdtype), np.float32)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


def _jax_draws(shape_psfs, stamp):
    """The draws JAX's ``step_sizes`` makes, as numpy."""
    ku, kv = jax.random.split(jax.random.PRNGKey(0))
    return dict(
        u0=np.asarray(jax.random.normal(ku, shape_psfs)),
        v0=np.asarray(jax.random.normal(kv, shape_psfs)),
        x0=np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                        (stamp, stamp))),
        noise=np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                           (8, 41, 41))))


CP_CASES = [(100, 41), (130, 21), (16, 41), (256, 33)]


@pytest.mark.parametrize("case", CP_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_condat_primal_matches_jax(case, dtype):
    N, S = case
    jdt, tdt = DTYPES[dtype]
    X, Ua, g = (_draw(30 + i, (N, S, S), jdt) for i in range(3))
    jX, jUa, jg = (jnp.asarray(a, jdt) for a in (X, Ua, g))
    tX, tUa, tg = (_t(a, tdt) for a in (X, Ua, g))
    got = ops.condat_primal(tX, tUa, tg, 0.31)
    assert got.dtype == tdt
    np.testing.assert_allclose(_f32(got), _f32(jprimal_ref(jX, jUa, jg, 0.31)),
                               **_tol(dtype))
    xn, xb = ops.condat_primal(tX, tUa, tg, 0.31, with_xbar=True)
    rn, rb = jprimal_ref(jX, jUa, jg, 0.31, with_xbar=True)
    np.testing.assert_allclose(_f32(xn), _f32(rn), **_tol(dtype))
    np.testing.assert_allclose(_f32(xb), _f32(rb), **_tol(dtype))
    # and JAX's Pallas kernel, in interpret mode
    kn, kb = jops.condat_primal(jX, jUa, jg, 0.31, with_xbar=True,
                                use_kernel=True, interpret=True)
    np.testing.assert_allclose(_f32(xn), _f32(kn), **_tol(dtype))
    np.testing.assert_allclose(_f32(xb), _f32(kb), **_tol(dtype))


@pytest.mark.parametrize("case", [(3, 100, 41), (4, 37, 21), (2, 130, 33)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_condat_dual_matches_jax(case, dtype):
    J, N, S = case
    jdt, tdt = DTYPES[dtype]
    U, Cn, Co = (_draw(33 + i, (J, N, S, S), jdt) for i in range(3))
    W = _draw(36, (J, N, 1, 1), jdt, uniform=True)
    sig = torch.tensor(0.47)              # a 0-d tensor, as the solver has
    got = ops.condat_dual(*(_t(a, tdt) for a in (U, Cn, Co, W)), sig)
    assert got.dtype == tdt and tuple(got.shape) == U.shape
    jin = [jnp.asarray(a, jdt) for a in (U, Cn, Co, W)]
    np.testing.assert_allclose(_f32(got), _f32(jdual_ref(*jin, 0.47)),
                               **_tol(dtype))
    np.testing.assert_allclose(
        _f32(got), _f32(jops.condat_dual(*jin, 0.47, use_kernel=True,
                                         interpret=True)), **_tol(dtype))


# a step size per instance (solve_many): B instances of n stamps each,
# n ragged against the 128-stamp block of the JAX kernel
PER_INSTANCE = [(8, 13, 21), (3, 37, 21), (1, 16, 13)]


@pytest.mark.parametrize("case", PER_INSTANCE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_condat_primal_per_instance_matches_jax_vmap(case, dtype):
    """tau of shape (B,) over (B, n, S, S) stamps against the JAX
    package's Pallas kernel under ``jax.vmap`` (interpret mode), as its
    ``solve_many`` batches it; and each instance bit-identical to its own
    call with one step size."""
    B, n, S = case
    jdt, tdt = DTYPES[dtype]
    X, Ua, g = (_draw(70 + i, (B, n, S, S), jdt) for i in range(3))
    tau = np.linspace(0.2, 0.5, B).astype(np.float32)
    tX, tUa, tg = (_t(a, tdt) for a in (X, Ua, g))
    xn, xb = ops.condat_primal(tX, tUa, tg, torch.tensor(tau),
                               with_xbar=True)

    def one(x, u, gr, t):
        return jops.condat_primal(x, u, gr, t, with_xbar=True,
                                  use_kernel=True, interpret=True)

    kn, kb = jax.vmap(one)(*(jnp.asarray(a, jdt) for a in (X, Ua, g)),
                           jnp.asarray(tau))
    np.testing.assert_allclose(_f32(xn), _f32(kn), **_tol(dtype))
    np.testing.assert_allclose(_f32(xb), _f32(kb), **_tol(dtype))
    for b in range(B):
        rn, rb = ops.condat_primal(tX[b], tUa[b], tg[b],
                                   torch.tensor(tau[b]), with_xbar=True)
        assert torch.equal(xn[b], rn) and torch.equal(xb[b], rb)


@pytest.mark.parametrize("case", PER_INSTANCE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_condat_dual_per_instance_matches_jax_vmap(case, dtype):
    """sig of shape (B,) over the scale-major (J, B, n, S, S) stack of a
    bucket against the JAX kernel under ``jax.vmap`` (interpret mode);
    each instance bit-identical to its own call."""
    B, n, S = case
    J = 3
    jdt, tdt = DTYPES[dtype]
    U, Cn, Co = (_draw(80 + i, (J, B, n, S, S), jdt) for i in range(3))
    W = _draw(83, (J, B, n, 1, 1), jdt, uniform=True)
    sig = np.linspace(0.3, 0.6, B).astype(np.float32)
    tin = [_t(a, tdt) for a in (U, Cn, Co, W)]
    got = ops.condat_dual(*tin, torch.tensor(sig))

    def one(u, cn, co, w, s):
        return jops.condat_dual(u, cn, co, w, s, use_kernel=True,
                                interpret=True)

    want = jax.vmap(one, in_axes=(1, 1, 1, 1, 0), out_axes=1)(
        *(jnp.asarray(a, jdt) for a in (U, Cn, Co, W)), jnp.asarray(sig))
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))
    for b in range(B):
        own = ops.condat_dual(*(x[:, b] for x in tin), torch.tensor(sig[b]))
        assert torch.equal(got[:, b], own)


def test_per_instance_step_sizes_must_match_the_instance_axis():
    X = _t(_draw(1, (2, 4, 9, 9), jnp.float32))
    with pytest.raises(ValueError, match="instance axis"):
        ops.condat_primal(X, X, X, torch.tensor([0.1, 0.2, 0.3]))
    with pytest.raises(ValueError, match="instance axis"):
        ops.condat_dual(X, X, X, X[..., :1, :1], torch.tensor([0.1] * 4))


def test_dual_weight_broadcasts_over_leading_axes():
    """A per-record weight (1, n, 1, 1) broadcasts over the scales."""
    U, Cn, Co = (_draw(50 + i, (3, 8, 9, 9), jnp.float32) for i in range(3))
    W = _draw(53, (1, 8, 1, 1), jnp.float32, uniform=True)
    got = ops.condat_dual(*(_t(a) for a in (U, Cn, Co, W)), 0.5)
    want = jdual_ref(*(jnp.asarray(a) for a in (U, Cn, Co, W)), 0.5)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol("float32"))


def test_cpu_wrappers_launch_no_kernel_and_refuse_use_kernel():
    X = _t(_draw(1, (4, 9, 9), jnp.float32))
    W = _t(_draw(2, (4, 1, 1), jnp.float32, uniform=True))
    before = (condat_primal_fwd.launches, condat_dual_fwd.launches)
    ops.condat_primal(X, X, X, 0.1)
    ops.condat_primal(X, X, X, 0.1, with_xbar=True)
    ops.condat_dual(X, X, X, W, 0.1)
    assert (condat_primal_fwd.launches, condat_dual_fwd.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        ops.condat_primal(X, X, X, 0.1, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.condat_dual(X, X, X, W, 0.1, use_kernel=True)
    assert (condat_primal_fwd.launches, condat_dual_fwd.launches) == before


@pytest.fixture(scope="module")
def small():
    d = jpsf.simulate(8, jax.random.PRNGKey(4), stamp=21)
    Y, P = np.asarray(d.Y), np.asarray(d.psfs)
    return Y, P, _jax_draws(P.shape, 21)


def test_weight_matrix_matches_jax(small):
    Y, P, dr = small
    got = condat.weight_matrix(_t(P), 0.02, 4, 3.0, noise=dr["noise"])
    want = jcondat.weight_matrix(jnp.asarray(P), 0.02, 4, 3.0)
    assert tuple(got.shape) == want.shape == (4, 8, 1, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=0)


def test_step_sizes_match_jax(small):
    Y, P, dr = small
    cfg = condat.SolverConfig(mode="sparse", n_scales=4)
    tau, sig, W = condat.step_sizes(_t(Y), _t(P), cfg, 0.02, **dr)
    jtau, jsig, jW = jcondat.step_sizes(
        jnp.asarray(Y), jnp.asarray(P),
        jcondat.SolverConfig(mode="sparse", n_scales=4), 0.02)
    assert isinstance(tau, float) and isinstance(sig, float)
    assert tau == pytest.approx(jtau, rel=1e-5)
    assert sig == pytest.approx(jsig, rel=1e-5)
    np.testing.assert_allclose(W.numpy(), np.asarray(jW), rtol=2e-5)
    # fixed steps in the config win, as in the JAX module
    fixed = condat.SolverConfig(tau=0.25, sigma_dual=0.125)
    assert condat.step_sizes(_t(Y), _t(P), fixed, 0.02, **dr)[:2] == \
        (0.25, 0.125)


def test_per_record_pieces_match_jax(small):
    Y, P, _ = small
    X = _draw(60, Y.shape, jnp.float32)
    kf = jpsf.psf_fft_pair(jnp.asarray(P))
    tkf = psf.psf_fft_pair(_t(P))
    HX = np.asarray(jpsf.H_fp(jnp.asarray(X), kf))
    np.testing.assert_allclose(
        condat.grad_from_HX(_t(HX), _t(Y), tkf).numpy(),
        np.asarray(jcondat.grad_from_HX(jnp.asarray(HX), jnp.asarray(Y), kf)),
        rtol=2e-5, atol=2e-5)
    assert float(condat.data_cost_from(_t(HX), _t(Y))) == pytest.approx(
        float(jcondat.data_cost_from(jnp.asarray(HX), jnp.asarray(Y))),
        rel=1e-5)
    CX = _draw(61, (4,) + Y.shape, jnp.float32)
    W = _draw(62, (4, Y.shape[0], 1, 1), jnp.float32, uniform=True)
    assert float(condat.sparse_reg_cost(_t(CX), _t(W))) == pytest.approx(
        float(jcondat.sparse_reg_cost(jnp.asarray(CX), jnp.asarray(W))),
        rel=1e-5)
    np.testing.assert_allclose(
        condat.sparse_dual_adjoint(_t(CX), 4).numpy(),
        np.asarray(jcondat.sparse_dual_adjoint(jnp.asarray(CX), 4)),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("cost_every", [1, 4])
def test_sequential_solve_matches_jax(small, cost_every):
    Y, P, dr = small
    cfg = condat.SolverConfig(mode="sparse", n_scales=4, max_iter=16)
    X, costs = condat.solve(Y, P, cfg, cost_every=cost_every, device="cpu",
                            **dr)
    jX, jcosts = jcondat.solve(
        jnp.asarray(Y), jnp.asarray(P),
        jcondat.SolverConfig(mode="sparse", n_scales=4, max_iter=16),
        cost_every=cost_every)
    jc = np.asarray(jcosts)
    assert costs.shape == jc.shape == (16,)
    np.testing.assert_allclose(costs.numpy(), jc, rtol=1e-4)
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=1e-4,
                               atol=1e-6)


def test_lowrank_step_sizes_match_jax(small):
    """Low-rank mode: L = I, so ||L|| = 1, no weights and no starlet
    norm or noise calibration; only the PSF power iteration draws."""
    Y, P, dr = small
    cfg = condat.SolverConfig(mode="lowrank", lam=0.05, rank=8)
    tau, sig, W = condat.step_sizes(_t(Y), _t(P), cfg, 0.02, u0=dr["u0"],
                                    v0=dr["v0"])
    jtau, jsig, jW = jcondat.step_sizes(
        jnp.asarray(Y), jnp.asarray(P),
        jcondat.SolverConfig(mode="lowrank", lam=0.05, rank=8), 0.02)
    assert W is None and jW is None
    assert sig == jsig == 0.5
    assert tau == pytest.approx(jtau, rel=1e-5)


@pytest.mark.parametrize("cost_every", [1, 4])
def test_sequential_lowrank_solve_matches_jax(small, cost_every):
    """The exact low-rank reference (SVT by a full SVD, the objective by
    the singular values) against JAX's, n = 8 stamps of 21 x 21."""
    Y, P, dr = small
    cfg = condat.SolverConfig(mode="lowrank", lam=0.05, rank=8, max_iter=12)
    X, costs = condat.solve(Y, P, cfg, cost_every=cost_every, device="cpu",
                            u0=dr["u0"], v0=dr["v0"])
    jX, jcosts = jcondat.solve(
        jnp.asarray(Y), jnp.asarray(P),
        jcondat.SolverConfig(mode="lowrank", lam=0.05, rank=8, max_iter=12),
        cost_every=cost_every)
    jc = np.asarray(jcosts)
    assert costs.shape == jc.shape == (12,)
    np.testing.assert_allclose(costs.numpy(), jc, rtol=1e-4)
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=1e-4,
                               atol=1e-6)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown mode 'dense'"):
        condat.solve(np.zeros((2, 9, 9), np.float32),
                     np.zeros((2, 9, 9), np.float32),
                     condat.SolverConfig(mode="dense"), device="cpu")
