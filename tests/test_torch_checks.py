"""The port's runtime contract checks (``solve(..., checks=True)`` /
``REPRO_CHECKS``) against ``tests/test_checks.py``.

Each test follows the JAX suite's test of the same name.  The two
``REPRO_FORCE_INTERPRET`` tests have no counterpart: the port has no
such override (a CUDA tensor launches its kernel or raises).  The carry
contract is found by running the step on ``meta`` tensors, where the
JAX package asks ``jax.eval_shape``; both do it before any dispatch.
The tiny averaging problem runs in both packages and its cost
trajectories agree at rtol 1e-6 (a sum of 32 squares in fp32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bundle import Bundle as JBundle
from repro.core.problem import Problem as JProblem
from repro.core.problem import solve as jsolve
from repro_torch.core import checks, engine
from repro_torch.core.bundle import Bundle
from repro_torch.core.checks import (CheckError, assert_all_finite,
                                     assert_costs_finite, checks_enabled)
from repro_torch.core.driver import IterativeDriver, RunOptions
from repro_torch.core.problem import Problem, solve, solve_many

torch.set_num_threads(2)


class Quad(Problem):
    """Tiny averaging iteration with injectable contract violations."""

    def __init__(self, bad=None):
        self.bad = bad

    def init_bundle(self, inputs, device):
        (y,) = inputs
        y = torch.as_tensor(np.asarray(y))
        x0 = torch.zeros_like(y)
        if self.bad == "init_nan":
            x0[0] = float("nan")
        return Bundle.create({"x": x0, "y": y}, device=device)

    def full_step(self, d, rep, axes):
        x = 0.5 * (d["x"] + d["y"])
        if self.bad == "nan":
            x = x * 0.0 / 0.0
        if self.bad == "dtype":
            x = x.to(torch.float16)     # carry dtype flip f32 -> f16
        cost = torch.sum((x - d["y"]) ** 2)
        return dict(d, x=x), cost


class JQuad(JProblem):
    """The same iteration in the JAX package."""

    def init_bundle(self, inputs, mesh):
        (y,) = inputs
        return JBundle.create({"x": jnp.zeros_like(y), "y": y}, mesh=mesh)

    def full_step(self, d, rep, axes):
        x = 0.5 * (d["x"] + d["y"])
        return dict(d, x=x), jnp.sum((x - d["y"]) ** 2)


@pytest.fixture(scope="module")
def y():
    return np.linspace(0.0, 1.0, 32).astype(np.float32)


def _solve(problem, y, **kw):
    return solve(problem, y, device="cpu", tol=0.0, **kw)


# ------------------------------------------------------------ clean run
@pytest.mark.parametrize("chunk", [1, 4])
def test_checks_clean_run_identical_trajectory(y, chunk):
    off = _solve(Quad(), y, max_iter=8, chunk=chunk)
    on = _solve(Quad(), y, max_iter=8, chunk=chunk, checks=True)
    assert off.costs == on.costs
    want = jsolve(JQuad(), jnp.asarray(y), max_iter=8, chunk=chunk, tol=0.0)
    np.testing.assert_allclose(on.costs, want.costs, rtol=1e-6)


# -------------------------------------------------------- finite guards
def test_checks_catch_injected_nan_chunked(y):
    with pytest.raises(CheckError, match="NaN"):
        _solve(Quad("nan"), y, max_iter=8, chunk=4, checks=True)


def test_checks_catch_injected_nan_per_step(y):
    with pytest.raises(CheckError, match="iteration 0"):
        _solve(Quad("nan"), y, max_iter=4, chunk=1, checks=True)


def test_checks_reject_nonfinite_init_bundle(y):
    with pytest.raises(CheckError, match="initial bundle state"):
        _solve(Quad("init_nan"), y, max_iter=4, chunk=4, checks=True)


def test_checks_off_is_silent(y):
    # the same poisoned run proceeds with checks off: the failure the
    # checks exist for
    sol = _solve(Quad("nan"), y, max_iter=4, chunk=2)
    assert np.isnan(sol.costs).any()


def test_checks_off_run_no_meta_pass(y, monkeypatch):
    """Off, the driver neither runs the step on meta tensors nor copies
    state to the host for a check."""
    def refuse(*a, **k):
        raise AssertionError("a check ran with checks off")

    for name in ("eval_step_spec", "assert_all_finite",
                 "assert_costs_finite", "assert_carry_stable"):
        monkeypatch.setattr(checks, name, refuse)
    monkeypatch.delenv("REPRO_CHECKS", raising=False)
    _solve(Quad(), y, max_iter=8, chunk=4)
    _solve(Quad(), y, max_iter=4, chunk=1)


# ------------------------------------------------- carry-contract guard
def test_checks_catch_carry_dtype_flip_chunked(y):
    # found on meta tensors, before any dispatch
    with pytest.raises(CheckError, match="before any dispatch"):
        _solve(Quad("dtype"), y, max_iter=8, chunk=4, checks=True)


def test_checks_catch_carry_dtype_flip_per_step(y):
    with pytest.raises(CheckError, match="dtype float32 -> float16"):
        _solve(Quad("dtype"), y, max_iter=4, chunk=1, checks=True)


def test_carry_check_dispatches_nothing(y, monkeypatch):
    """The pre-flight runs the step on meta tensors only: a dtype flip is
    refused before the step has seen a real tensor."""
    seen = []
    prob = Quad("dtype")
    real = prob.full_step

    def spy(d, rep, axes):
        seen.append(d["x"].device.type)
        return real(d, rep, axes)

    monkeypatch.setattr(prob, "full_step", spy)
    with pytest.raises(CheckError):
        _solve(prob, y, max_iter=8, chunk=4, checks=True)
    assert seen and set(seen) == {"meta"}


# ------------------------------------------------------- env force-mode
def test_repro_checks_env_force_enables(y, monkeypatch):
    monkeypatch.setenv("REPRO_CHECKS", "1")
    with pytest.raises(CheckError):
        _solve(Quad("nan"), y, max_iter=8, chunk=4)


def test_repro_checks_env_falsy_values_stay_off(monkeypatch):
    for val in ("", "0", "false", "no"):
        monkeypatch.setenv("REPRO_CHECKS", val)
        assert checks_enabled(False) is False
    monkeypatch.setenv("REPRO_CHECKS", "1")
    assert checks_enabled(False) is True
    monkeypatch.delenv("REPRO_CHECKS")
    assert checks_enabled(True) is True


# --------------------------------------------- hand-wired driver access
def test_checks_available_on_handwired_driver(y):
    prob = Quad("nan")
    bundle = prob.init_bundle((y,), torch.device("cpu"))
    driver = IterativeDriver(
        prob.full_step, bundle,
        options=RunOptions(max_iter=8, tol=0.0, chunk=4, checks=True))
    with pytest.raises(CheckError):
        driver.run()


# ------------------------------------------------------------ unit level
def test_assert_costs_finite_honors_inf_seed_convention():
    assert_costs_finite(np.array([np.inf, 1.0, 0.5]), "t")
    with pytest.raises(CheckError, match="NaN|nan"):
        assert_costs_finite(np.array([1.0, np.nan]), "t")
    with pytest.raises(CheckError):
        assert_costs_finite(np.array([-np.inf]), "t")


def test_assert_all_finite_names_the_leaf():
    tree = {"ok": torch.ones(3),
            "bad": {"inner": torch.tensor([1.0, float("inf")])},
            "ints": torch.arange(3)}          # int leaves are skipped
    with pytest.raises(CheckError, match="inner"):
        assert_all_finite(tree, "t")
    assert_all_finite({"a": torch.ones(2), "b": np.ones(2)}, "t")


def test_assert_carry_stable_names_shape_and_structure():
    a = {"x": torch.zeros(3), "y": torch.zeros(2)}
    checks.assert_carry_stable(a, checks.to_meta(a), "t")
    with pytest.raises(CheckError, match="shape"):
        checks.assert_carry_stable(a, dict(a, x=torch.zeros(4)), "t")
    with pytest.raises(CheckError, match="structure"):
        checks.assert_carry_stable(a, {"x": torch.zeros(3)}, "t")


# ------------------------------------------ the workloads, checks on
def _workloads():
    from repro_torch.data.synthetic import coupled_patches
    from repro_torch.imaging import psf
    from repro_torch.imaging.condat import SolverConfig
    from repro_torch.imaging.lowrank import CompletionConfig
    from repro_torch.imaging.scdl import SCDLConfig
    d = psf.simulate(4, torch.Generator().manual_seed(2), stamp=13,
                     device="cpu")
    S_h, S_l = coupled_patches(64, 25, 9, 8, torch.Generator().manual_seed(3),
                               device="cpu")
    rng = np.random.default_rng(4)
    A = (rng.normal(size=(12, 2)) @ rng.normal(size=(2, 9))).astype(
        np.float32)
    M = (rng.random(A.shape) < 0.6).astype(np.float32)
    return {
        "sparse": ("deconvolve", (d.Y, d.psfs),
                   SolverConfig(mode="sparse", n_scales=2)),
        "lowrank_deconvolve": ("deconvolve", (d.Y, d.psfs),
                               SolverConfig(mode="lowrank", rank=3)),
        "scdl": ("scdl", (S_h, S_l), SCDLConfig(n_atoms=8)),
        "completion": ("lowrank", (A, M), CompletionConfig(rank=3)),
    }


@pytest.mark.parametrize("name", ["sparse", "lowrank_deconvolve", "scdl",
                                  "completion"])
@pytest.mark.parametrize("chunk,cost_every", [(1, 1), (4, 3), (4, "chunk")])
def test_checks_on_workloads_run_clean(name, chunk, cost_every):
    """Every built-in workload passes every check, in every execution
    mode, and runs the same trajectory as with checks off."""
    key, inputs, cfg = _workloads()[name]
    kw = dict(cfg=cfg, device="cpu", max_iter=8, tol=0.0, chunk=chunk,
              cost_every=cost_every)
    off = solve(key, *inputs, **kw)
    on = solve(key, *inputs, checks=True, **kw)
    assert on.costs == off.costs


def test_checks_on_bucket(monkeypatch):
    """The batched driver checks its costs and state at every sync and
    refuses a poisoned bucket."""
    key, (Y, P), cfg = _workloads()["sparse"]
    insts = [(Y, P), (Y[:3], P[:3])]
    plain = solve_many(key, insts, cfg=cfg, device="cpu", max_iter=4,
                       chunk=2, tol=0.0)
    checked = solve_many(key, insts, cfg=cfg, device="cpu", max_iter=4,
                         chunk=2, tol=0.0, checks=True)
    assert [s.costs for s in plain] == [s.costs for s in checked]
    bad = [(Y * float("nan"), P)] + insts[1:]
    with pytest.raises(CheckError):
        solve_many(key, bad, cfg=cfg, device="cpu", max_iter=4, chunk=2,
                   tol=0.0, checks=True)


def test_meta_tensors_take_the_plain_versions():
    """Every kernel wrapper sends a meta tensor to its plain version,
    which computes only the output's shape and dtype."""
    from repro_torch.kernels.admm_elwise.ops import admm_elwise
    from repro_torch.kernels.condat_elwise.ops import (condat_dual,
                                                       condat_primal)
    from repro_torch.kernels.dict_outer.ops import dict_outer_pair
    from repro_torch.kernels.jacobi.ops import eigh, svd
    from repro_torch.kernels.starlet2d.ops import adjoint, forward

    def m(*shape):
        return torch.empty(shape, device="meta")

    assert forward(m(5, 13, 13), 3).shape == (3, 5, 13, 13)
    assert adjoint(m(3, 5, 13, 13), 3).shape == (5, 13, 13)
    assert condat_primal(m(5, 9, 9), m(5, 9, 9), m(5, 9, 9),
                         m()).device.type == "meta"
    assert condat_dual(m(2, 5, 9, 9), m(2, 5, 9, 9), m(2, 5, 9, 9),
                       m(2, 5, 1, 1), m()).shape == (2, 5, 9, 9)
    assert admm_elwise(m(7, 4), m(7, 4), m(5, 7, 4), c1=1, c2=1, c3=1,
                       t1=0.1, t2=0.1).shape == (5, 7, 4)
    outs = dict_outer_pair(m(7, 6), m(7, 3), m(7, 4), m(7, 4))
    assert [tuple(o.shape) for o in outs] == [(6, 4), (3, 4), (4, 4),
                                              (4, 4)]
    w, v = eigh(m(2, 6, 6))
    assert w.shape == (2, 6) and v.shape == (2, 6, 6)
    assert svd(m(6, 6))[1].shape == (6,)


def test_seed_off_the_grid_takes_the_step_structure():
    """A run starting off the cost grid seeds its carried output with
    +inf in the structure of the step's output, found on meta tensors."""
    def full(d, r, a):
        return d, {"cost": torch.sum(d["x"]), "aux": torch.ones(2)}

    seed = engine.init_out_like(full, {"x": torch.zeros(3)}, {})
    assert set(seed) == {"cost", "aux"}
    assert torch.isinf(seed["cost"]) and seed["aux"].shape == (2,)
    assert seed["cost"].device.type == "cpu"
