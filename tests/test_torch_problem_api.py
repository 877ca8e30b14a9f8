"""The public names of the JAX package's ported modules in the port, held
against ``repro`` on the CPU (ROADMAP C1): the deprecated shims
``imaging.deconvolve.deconvolve`` and ``imaging.scdl.train``, the legacy
keyword arguments of ``IterativeDriver``, ``psf.H_f``/``Ht_f``,
``condat.grad_data``/``data_cost``/``SolverState`` and
``core.compat.make_mesh``.

The inputs are made from a numpy seed.  The deconvolution's random draws
(the operator norms' start vectors, the noise calibration) are the JAX
package's own, from its fixed keys, since ``repro``'s shim draws them
itself and the port takes them as arguments.  Tolerances: a shim against
the port's ``solve`` bit for bit; the port's shim against ``repro``'s at
rtol 1e-4 on costs and iterate, with equal ``iters_run``
(``tests/test_solve_many.py``); the operators at rtol 1e-5 (fp32 FFTs of
two libraries).
"""
import datetime
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core.bundle import Bundle as JBundle
from repro.core.driver import IterativeDriver as JDriver
from repro.core.driver import RunOptions as JOptions
from repro.imaging import condat as jcondat
from repro.imaging import deconvolve as jdeconv
from repro.imaging import psf as jpsf
from repro_torch.core import compat
from repro_torch.core.bundle import Bundle
from repro_torch.core.driver import IterativeDriver, RunOptions
from repro_torch.core.problem import solve
from repro_torch.imaging import condat, psf
from repro_torch.imaging.condat import SolverConfig
from repro_torch.imaging.deconvolve import DeconvolutionProblem, deconvolve
from repro_torch.imaging.scdl import SCDLConfig, SCDLProblem, train
from repro_torch.launch import mesh as launch_mesh

torch.set_num_threads(2)

N, S = 8, 21
COSTS = dict(rtol=1e-4)
ITERATE = dict(rtol=1e-4, atol=1e-6)
OPERATOR = dict(rtol=1e-5, atol=1e-6)


def _stamps(seed=11):
    """(Y, psfs, X): Gaussian PSFs of random width and orientation,
    positive sources, Y = H(X) plus noise, all from a numpy seed."""
    rng = np.random.default_rng(seed)
    g = np.arange(S) - S // 2
    yy, xx = np.meshgrid(g, g, indexing="ij")
    psfs = []
    for sx, sy, th in zip(rng.uniform(1.0, 2.5, N), rng.uniform(1.0, 2.5, N),
                          rng.uniform(0.0, np.pi, N)):
        u = np.cos(th) * xx + np.sin(th) * yy
        v = -np.sin(th) * xx + np.cos(th) * yy
        k = np.exp(-0.5 * ((u / sx) ** 2 + (v / sy) ** 2))
        psfs.append(k / k.sum())
    P = np.stack(psfs).astype(np.float32)
    X = np.zeros((N, S, S), np.float32)
    X[:, 7:14, 7:14] = rng.uniform(0.0, 1.0, (N, 7, 7))
    Y = psf.H(torch.from_numpy(X), torch.from_numpy(P)).numpy()
    Y = (Y + 0.02 * rng.standard_normal(Y.shape)).astype(np.float32)
    return Y, P, X


@pytest.fixture(scope="module")
def stamps():
    return _stamps()


@pytest.fixture(scope="module")
def jax_draws():
    """The JAX package's draws of ``step_sizes``, by its keys."""
    ku, kv = jax.random.split(jax.random.PRNGKey(0))
    return dict(
        u0=np.asarray(jax.random.normal(ku, (N, S, S))),
        v0=np.asarray(jax.random.normal(kv, (N, S, S))),
        x0=np.asarray(jax.random.normal(jax.random.PRNGKey(0), (S, S))),
        noise=np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                           (8, 41, 41))))


# ----------------------------------------------------- the shims
def test_deconvolve_shim_warns_and_matches_solve_and_jax(stamps, jax_draws):
    Y, P, _ = stamps
    cfg = SolverConfig(mode="sparse", n_scales=3)
    kw = dict(max_iter=12, tol=0, chunk=4)
    sol = solve(DeconvolutionProblem(cfg, **jax_draws), Y, P, device="cpu",
                **kw)
    with pytest.deprecated_call():
        X_old, log_old = deconvolve(Y, P, cfg, device="cpu", **kw,
                                    **jax_draws)
    # the shim routes through solve(): bit for bit, not merely close
    np.testing.assert_array_equal(sol.x, X_old)
    np.testing.assert_array_equal(sol.log.costs, log_old.costs)
    with pytest.deprecated_call():
        X_jax, log_jax = jdeconv.deconvolve(
            Y, P, jcondat.SolverConfig(mode="sparse", n_scales=3), **kw)
    assert log_old.iters_run == log_jax.iters_run == 12
    np.testing.assert_allclose(log_old.costs, log_jax.costs, **COSTS)
    np.testing.assert_allclose(X_old, np.asarray(X_jax), **ITERATE)


def _patches(seed=5, K=256, P=25, M=9, A=16):
    rng = np.random.default_rng(seed)
    S_l = rng.standard_normal((M, K)).astype(np.float32)
    S_h = (rng.standard_normal((P, M)) @ S_l / 3.0
           + 0.01 * rng.standard_normal((P, K))).astype(np.float32)
    return S_h, S_l, rng.choice(K, A, replace=False)


def test_train_shim_warns_and_matches_solve():
    S_h, S_l, idx = _patches()
    cfg = SCDLConfig(n_atoms=16, max_iter=6)
    sol = solve(SCDLProblem(cfg, idx=idx), S_h, S_l, device="cpu", chunk=4)
    with pytest.deprecated_call():
        Xh, Xl, log_old = train(S_h, S_l, cfg, idx=idx, chunk=4,
                                device="cpu")
    np.testing.assert_array_equal(sol.x[0], Xh)
    np.testing.assert_array_equal(sol.x[1], Xl)
    np.testing.assert_array_equal(sol.log.costs, log_old.costs)
    assert log_old.iters_run == 6


# ------------------------------------- IterativeDriver's legacy kwargs
def _ridge(rng_seed=3):
    """tests/test_problem_api.py's ridge toy in the port: gradient steps
    on 0.5 ||X w - y||^2, the weights in the broadcast state."""
    rng = np.random.default_rng(rng_seed)
    X = rng.standard_normal((64, 4)).astype(np.float32)
    y = X @ np.arange(1.0, 5.0, dtype=np.float32)
    bundle = Bundle.create({"X": X, "y": y},
                           replicated={"w": np.zeros(4, np.float32)},
                           device="cpu")

    def step(d, rep, axes):
        r = d["X"] @ rep["w"] - d["y"]
        grad = d["X"].T @ r / d["X"].shape[0]
        return d, {"cost": 0.5 * torch.sum(r ** 2),
                   "w": rep["w"] - 0.1 * grad}

    return bundle, step


def _keep_w(rep, out):
    return {"w": out["w"]}


def test_driver_legacy_kwargs_warn_and_match_options():
    bundle, step = _ridge()
    with pytest.deprecated_call():
        legacy = IterativeDriver(step, bundle, max_iter=8, tol=0, chunk=4,
                                 update_replicated=_keep_w)
    legacy_out = legacy.run()
    bundle2, step2 = _ridge()
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        opt = IterativeDriver(step2, bundle2, options=RunOptions(
            max_iter=8, tol=0, chunk=4, update_replicated=_keep_w))
    opt_out = opt.run()
    assert legacy.options == opt.options
    np.testing.assert_array_equal(legacy.log.costs, opt.log.costs)
    np.testing.assert_array_equal(legacy_out.replicated["w"].numpy(),
                                  opt_out.replicated["w"].numpy())
    assert legacy.log.costs[-1] < legacy.log.costs[0]


def test_driver_legacy_kwargs_match_jax():
    """The same toy in both packages through their legacy kwargs."""
    bundle, step = _ridge()
    with pytest.deprecated_call():
        got = IterativeDriver(step, bundle, max_iter=8, tol=0, chunk=4,
                              update_replicated=_keep_w)
    got.run()
    Xn, yn = (bundle.data[k].numpy() for k in ("X", "y"))
    jb = JBundle.create({"X": jnp.asarray(Xn), "y": jnp.asarray(yn)},
                        replicated={"w": jnp.zeros((4,))})

    def jstep(d, rep, axes):
        r = d["X"] @ rep["w"] - d["y"]
        return d, {"cost": 0.5 * jnp.sum(r ** 2),
                   "w": rep["w"] - 0.1 * (d["X"].T @ r / d["X"].shape[0])}

    with pytest.deprecated_call():
        want = JDriver(jstep, jb, max_iter=8, tol=0, chunk=4,
                       update_replicated=_keep_w)
    want.run()
    assert isinstance(want.options, JOptions)
    np.testing.assert_allclose(got.log.costs, want.log.costs, rtol=1e-5)


def test_driver_unknown_kwarg_raises():
    bundle, step = _ridge()
    with pytest.raises(TypeError, match="step_fm_light"):
        IterativeDriver(step, bundle, step_fm_light=lambda *a: None)


# ------------------------------------------------ operators and state
@pytest.fixture(scope="module")
def operands(stamps):
    Y, P, X = stamps
    kf = (psf.psf_fft(torch.from_numpy(P)),
          jpsf.psf_fft(jnp.asarray(P)))
    return X, Y, P, kf


@pytest.mark.parametrize("name", ["H_f", "Ht_f"])
def test_spectral_convolutions_match_jax(operands, name):
    X, _, _, (kf, jkf) = operands
    got = getattr(psf, name)(torch.from_numpy(X), kf).numpy()
    want = np.asarray(getattr(jpsf, name)(jnp.asarray(X), jkf))
    np.testing.assert_allclose(got, want, **OPERATOR)
    direct = psf.H if name == "H_f" else psf.Ht
    np.testing.assert_array_equal(
        got, direct(torch.from_numpy(X), torch.from_numpy(operands[2])).numpy())


@pytest.mark.parametrize("name", ["grad_data", "data_cost"])
def test_condat_helpers_match_jax(operands, name):
    X, Y, P, _ = operands
    got = getattr(condat, name)(*(torch.from_numpy(a) for a in (X, Y, P)))
    want = getattr(jcondat, name)(*(jnp.asarray(a) for a in (X, Y, P)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OPERATOR)


def test_solver_state_fields_match_jax():
    assert condat.SolverState._fields == jcondat.SolverState._fields
    s = condat.SolverState(*(torch.zeros(()) for _ in range(5)))
    assert s.cost is s[4]


# ---------------------------------------------------- compat.make_mesh
def test_compat_make_mesh_delegates(monkeypatch):
    seen = []
    monkeypatch.setattr(launch_mesh, "make_mesh",
                        lambda *a: seen.append(a) or "mesh")
    assert compat.make_mesh((2, 1), ("data", "model")) == "mesh"
    assert compat.make_mesh((1,), ("data",), "cpu") == "mesh"
    assert seen == [((2, 1), ("data", "model"), None),
                    ((1,), ("data",), "cpu")]


def test_compat_make_mesh_under_a_one_rank_group(tmp_path):
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "store"), 1),
                            timeout=datetime.timedelta(seconds=60))
    try:
        got = compat.make_mesh((1,), ("data",), device="cpu")
        want = launch_mesh.make_mesh((1,), ("data",), device="cpu")
        assert type(got) is type(want)
        assert got.mesh_dim_names == want.mesh_dim_names == ("data",)
        assert compat.is_mesh(got)
    finally:
        dist.destroy_process_group()
