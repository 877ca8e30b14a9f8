"""The port's deconvolution slice end to end against the JAX package.

``repro_torch``'s ``solve("deconvolve", device="cpu")`` and ``repro``'s
``solve("deconvolve")`` run on the same stamps (the JAX ``simulate`` at
n = 8, S = 21) for every ``cost_every`` mode, and a JAX-built bundle is
carried into the port through ``repro_torch.convert``.  The JAX package
draws its operator-norm start vectors and calibration noise from fixed
PRNG keys; the port's Problem takes those draws as constructor arguments.

Tolerances: cost trajectories rtol 1e-4 (FFT libraries and reduction
orders differ); iterates rtol 1e-4 with atol 1e-6
(``tests/test_solve_many.py``).  ``iters_run`` and ``converged_at`` must
be equal: a wrong convergence stride stops at another iteration.
"""
import contextlib
import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core.bundle import gather as jgather
from repro.core.problem import solve as jsolve
from repro.imaging import deconvolve as jdeconv
from repro.imaging import psf as jpsf
from repro.imaging.condat import SolverConfig as JConfig
from repro_torch.convert import bundle_from_numpy, bundle_to_numpy
from repro_torch.core.problem import solve
from repro_torch.imaging import deconvolve
from repro_torch.imaging.condat import SolverConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.resilience.recovery import ResilienceConfig
from repro_torch.kernels.condat_elwise.kernel import (condat_dual_fwd,
                                                      condat_primal_fwd)
from repro_torch.kernels.starlet2d.kernel import smooth_fwd

torch.set_num_threads(2)

N, S, ITERS, CHUNK = 8, 21, 24, 8
COSTS = dict(rtol=1e-4)
ITERATE = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def case():
    d = jpsf.simulate(N, jax.random.PRNGKey(3), stamp=S)
    Y, P = np.asarray(d.Y), np.asarray(d.psfs)
    ku, kv = jax.random.split(jax.random.PRNGKey(0))
    draws = dict(
        u0=np.asarray(jax.random.normal(ku, P.shape)),
        v0=np.asarray(jax.random.normal(kv, P.shape)),
        x0=np.asarray(jax.random.normal(jax.random.PRNGKey(0), (S, S))),
        noise=np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                           (8, 41, 41))))
    return Y, P, draws


def _problem(draws, **cfg):
    return deconvolve.DeconvolutionProblem(
        SolverConfig(mode="sparse", n_scales=4, **cfg), **draws)


# (cost_every, tol, cost_window): each converges inside the 24 iterations,
# at a check chosen well away from the threshold
MODES = [(1, 1e-3, 3), (3, 5e-3, 3), ("chunk", 2e-3, 1)]


@pytest.mark.parametrize("cost_every,tol,window", MODES)
def test_solve_matches_jax(case, cost_every, tol, window):
    Y, P, draws = case
    kw = dict(max_iter=ITERS, tol=tol, chunk=CHUNK, cost_every=cost_every,
              cost_window=window)
    want = jsolve("deconvolve", Y, P,
                  cfg=JConfig(mode="sparse", n_scales=4), **kw)
    got = solve(_problem(draws), Y, P, device="cpu", **kw)
    assert got.log.iters_run == want.log.iters_run
    assert got.log.converged_at == want.log.converged_at
    assert got.log.converged_at is not None
    jc, tc = np.asarray(want.log.costs), np.asarray(got.log.costs)
    assert tc.shape == jc.shape
    fin = np.isfinite(jc)
    np.testing.assert_array_equal(np.isfinite(tc), fin)
    np.testing.assert_allclose(tc[fin], jc[fin], **COSTS)
    assert isinstance(got.x, np.ndarray)
    np.testing.assert_allclose(got.x, np.asarray(want.x), **ITERATE)


def test_build_bundle_matches_jax(case):
    """The port's bundle, taken back to the JAX layout, holds the JAX
    bundle's leaves and step sizes."""
    Y, P, draws = case
    jb, jsteps = jdeconv.build_bundle(Y, P, JConfig(mode="sparse",
                                                    n_scales=4))
    tb, steps = deconvolve.build_bundle(
        Y, P, SolverConfig(mode="sparse", n_scales=4), device="cpu",
        **draws)
    assert steps["tau"] == pytest.approx(jsteps["tau"], rel=1e-5)
    assert steps["sig"] == pytest.approx(jsteps["sig"], rel=1e-5)
    data, rep = bundle_to_numpy(tb)
    want = jgather(jb)
    assert sorted(data) == sorted(want)
    for k, v in want.items():
        assert data[k].shape == v.shape and data[k].dtype == v.dtype, k
        atol = 1e-6 * max(np.abs(v).max(), 1.0)
        np.testing.assert_allclose(data[k], v, rtol=1e-4, atol=atol,
                                   err_msg=k)
    for k in ("tau", "sig"):
        assert rep[k].shape == () and rep[k].dtype == np.float32
        np.testing.assert_allclose(rep[k], np.asarray(jb.replicated[k]),
                                   rtol=1e-5)
    # the port keeps the per-scale leaves scale-major and contiguous
    for k in deconvolve.SCALE_MAJOR:
        assert tb.data[k].shape[:2] == (4, N) and \
            tb.data[k].is_contiguous()


def test_carried_bundle_steps_match_jax(case):
    """A JAX-built bundle goes through numpy into the port; K light steps
    then run in both packages and the states agree."""
    Y, P, _ = case
    jcfg = JConfig(mode="sparse", n_scales=4)
    jb, _ = jdeconv.build_bundle(Y, P, jcfg)
    data = jgather(jb)
    rep = {k: np.asarray(v) for k, v in jb.replicated.items()}
    tb = bundle_from_numpy(data, rep, device="cpu")
    assert tb.data["psf_fp"].dtype == torch.complex64
    assert tb.replicated["tau"].shape == () and \
        tb.replicated["tau"].dtype == torch.float32

    jlight = jax.jit(lambda d, r: jdeconv.make_light_step_fn(jcfg)(d, r, ()))
    light = deconvolve.make_light_step_fn(SolverConfig(mode="sparse",
                                                       n_scales=4))
    jd, td = jb.data, tb.data
    for _ in range(3):
        jd = jlight(jd, jb.replicated)
        td = light(td, tb.replicated, ())
    got, _ = bundle_to_numpy(tb.with_data(td))
    for k, v in jd.items():
        v = np.asarray(v)
        np.testing.assert_allclose(got[k], v, rtol=1e-4,
                                   atol=1e-6 * max(np.abs(v).max(), 1.0),
                                   err_msg=k)
    # the caller's arrays were copied, not aliased
    assert np.array_equal(data["Xp"], jgather(jb)["Xp"])


def test_convert_round_trip_is_exact(case):
    Y, P, draws = case
    tb, _ = deconvolve.build_bundle(
        Y, P, SolverConfig(mode="sparse", n_scales=4), device="cpu",
        **draws)
    data, rep = bundle_to_numpy(tb)
    again = bundle_from_numpy(data, rep, device="cpu")
    for k, v in tb.data.items():
        assert torch.equal(again.data[k], v), k
    for k, v in tb.replicated.items():
        assert torch.equal(again.replicated[k], v), k


def test_chunk_is_clamped_to_max_iter(case):
    """A chunk longer than the run becomes the run: one chunk of 5, whose
    per-chunk objective fills the last slot."""
    Y, P, draws = case
    events = []
    sol = solve(_problem(draws), Y, P, device="cpu", max_iter=5, chunk=50,
                cost_every="chunk", tol=0.0, progress_fn=events.append)
    assert [e["iters"] for e in events] == [5]
    assert sol.log.iters_run == 5 and len(sol.log.costs) == 5
    assert np.all(np.isinf(sol.log.costs[:4]))
    assert np.isfinite(sol.log.costs[4])


def test_progress_fn_stop_halts_at_chunk_boundary(case):
    Y, P, draws = case
    seen = []

    def stop_after_two(event):
        seen.append(event)
        return {"stop": True} if len(seen) == 2 else None

    sol = solve(_problem(draws), Y, P, device="cpu", max_iter=ITERS,
                chunk=4, tol=0.0, progress_fn=stop_after_two)
    assert sol.log.iters_run == 8 and sol.log.cancelled_at == 7
    assert len(sol.log.costs) == 8
    assert [e["done"] for e in seen] == [4, 8]
    assert seen[-1]["cost"] == sol.log.costs[-1]


def test_cpu_solve_launches_no_kernel(case):
    Y, P, draws = case
    before = (smooth_fwd.launches, condat_primal_fwd.launches,
              condat_dual_fwd.launches)
    solve(_problem(draws), Y, P, device="cpu", max_iter=2, chunk=2)
    assert (smooth_fwd.launches, condat_primal_fwd.launches,
            condat_dual_fwd.launches) == before


def test_inputs_are_copied_not_aliased(case):
    Y, P, draws = case
    Yt = torch.tensor(Y)
    sol = solve(_problem(draws), Yt, P, device="cpu", max_iter=2, chunk=2)
    assert sol.bundle.data["Y"].data_ptr() != Yt.data_ptr()
    np.testing.assert_array_equal(Yt.numpy(), Y)


def test_solve_without_cuda_raises(case):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a card")
    Y, P, _ = case
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        solve("deconvolve", Y, P, cfg=SolverConfig(mode="sparse"),
              max_iter=1)


@contextlib.contextmanager
def one_rank_mesh(tmp_path):
    """A (data=1) gloo mesh over a one-rank process group of this
    process, torn down after use."""
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "store"), 1),
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield make_mesh((1,), ("data",), device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kwargs,item", [
    (dict(mesh=object()), "A13"),
    (dict(resilience=ResilienceConfig()), "A11"),
])
def test_later_slice_options_raise(case, kwargs, item, tmp_path):
    """A13 and A11 are in.  ``mesh=`` takes a mesh, so an arbitrary
    object raises ``TypeError``, and a one-rank gloo mesh runs the
    solve bit for bit as it runs without one; ``resilience=`` is
    accepted and its report comes back clean."""
    Y, P, draws = case
    if item == "A11":
        sol = solve("deconvolve", Y, P, device="cpu", max_iter=1, **kwargs)
        assert sol.recovery is not None and sol.recovery.faults == []
        return
    with pytest.raises(TypeError, match="DeviceMesh"):
        solve("deconvolve", Y, P, device="cpu", max_iter=1, **kwargs)
    kw = dict(device="cpu", max_iter=8, chunk=4, cost_every="chunk", tol=0)
    want = solve(_problem(draws), Y, P, **kw)
    with one_rank_mesh(tmp_path) as mesh:
        got = solve(_problem(draws), Y, P, mesh=mesh, **kw)
    assert got.bundle.n_partitions == 1
    np.testing.assert_array_equal(got.log.costs, want.log.costs)
    np.testing.assert_array_equal(got.x, want.x)


@pytest.mark.parametrize("kwargs,match", [
    (dict(checkpoint_dir="ckpt"), "checkpoint_every"),
    (dict(resume=True), "checkpoint_dir"),
    (dict(checkpoint_every=2), "checkpoint_dir"),
    (dict(checks=True), None),
])
def test_checkpoint_and_check_options(case, kwargs, match, tmp_path,
                                      monkeypatch):
    """The options of ROADMAP A9: a checkpoint directory with neither a
    cadence nor a resume, a resume or a cadence without a directory
    raise; ``checks=True`` runs clean and leaves the trajectory as it
    is."""
    monkeypatch.chdir(tmp_path)
    Y, P, draws = case
    if match is not None:
        with pytest.raises(ValueError, match=match):
            solve(_problem(draws), Y, P, device="cpu", max_iter=1, **kwargs)
        return
    off = solve(_problem(draws), Y, P, device="cpu", max_iter=4, chunk=2)
    on = solve(_problem(draws), Y, P, device="cpu", max_iter=4, chunk=2,
               **kwargs)
    assert on.log.costs == off.log.costs


def test_lowrank_workload_is_ported():
    """``"lowrank"`` (ROADMAP A8) resolves to the port's own Problem."""
    from repro_torch.core.problem import available, get
    from repro_torch.imaging.lowrank import LowRankCompletionProblem
    assert get("lowrank") is LowRankCompletionProblem
    assert set(available()) == {"deconvolve", "lowrank", "scdl"}


def test_scdl_workload_is_ported():
    """``"scdl"`` (ROADMAP A7) resolves to the port's own Problem."""
    from repro_torch.core.problem import available, get
    from repro_torch.imaging.scdl import SCDLProblem
    assert get("scdl") is SCDLProblem
    assert "scdl" in available()


def test_lowrank_mode_builds(case):
    """``mode="lowrank"`` builds its bundle: a record-major dual, no
    starlet leaves, the test matrix beside the step sizes."""
    Y, P, draws = case
    problem = deconvolve.DeconvolutionProblem(
        SolverConfig(mode="lowrank", rank=8), u0=draws["u0"], v0=draws["v0"])
    b = problem.init_bundle((Y, P), torch.device("cpu"))
    assert sorted(b.data) == ["HX", "Xd", "Xp", "Y", "psf_fp"]
    assert tuple(b.data["Xd"].shape) == (N, S, S) and b.record_axis("Xd") == 0
    assert tuple(b.replicated["omega"].shape) == (S * S, 16)
    assert problem.batch_axes().shared_in_batch == ("omega",)
