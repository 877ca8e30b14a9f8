"""``repro_torch.core.problem.solve_many``: buckets of instances, one
batched step per iteration for a whole bucket.

Follows ``tests/test_solve_many.py`` (its chaos drill is in
``tests/test_torch_resilience.py``).  Against the JAX package's
``solve_many``: the deconvolution at all three cadences on the reference's
own fixture, and SCDL, each instance carrying the JAX package's random
draws (it draws from fixed keys over each instance's own shape; the port
takes them as a trailing dict of the instance's inputs).  Tolerances:
costs rtol 1e-4, iterates rtol 1e-4 / atol 1e-6, equal ``iters_run``
(``tests/test_solve_many.py:42``).

Against the port's own single ``solve``: the batched completion (the
reference fails its own ``test_lowrank_parity``, ROADMAP C), the
low-rank deconvolution, the masked early exit, re-compaction and
``cancel_instances``; here the plain versions run the same operations
batched, so the tolerance is the same rtol 1e-4 / atol 1e-6; without
explicit draws an instance's step sizes equal its single solve's.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.core.problem import solve_many as jsolve_many
from repro.data.synthetic import coupled_patches as jpatches
from repro.imaging import psf as jpsf
from repro.imaging.condat import SolverConfig as JConfig
from repro.imaging.scdl import SCDLConfig as JSCDLConfig
from repro_torch.checkpoint import latest_step
from repro_torch.core.driver import RunOptions
from repro_torch.core.problem import Problem, Solution, solve, solve_many
from repro_torch.imaging import psf
from repro_torch.imaging.condat import SolverConfig
from repro_torch.imaging.lowrank import CompletionConfig
from repro_torch.imaging.scdl import SCDLConfig
from repro_torch.resilience.recovery import ResilienceConfig

torch.set_num_threads(2)

ITERS, CHUNK = 10, 4


def _draws(P, S):
    """The draws the JAX package's step sizes make for one instance."""
    ku, kv = jax.random.split(jax.random.PRNGKey(0))
    return dict(
        u0=np.asarray(jax.random.normal(ku, P.shape)),
        v0=np.asarray(jax.random.normal(kv, P.shape)),
        x0=np.asarray(jax.random.normal(jax.random.PRNGKey(0), (S, S))),
        noise=np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                           (8, 41, 41))))


@pytest.fixture(scope="module")
def psf_instances():
    """The reference's fixture: (Y, psfs) per instance, JAX-simulated."""
    out = []
    for (n, S, seed) in [(3, 16, 0), (5, 16, 1), (4, 16, 2), (3, 20, 3)]:
        d = jpsf.simulate(n, jax.random.PRNGKey(seed), stamp=S)
        out.append((np.asarray(d.Y), np.asarray(d.psfs)))
    return out


def _with_draws(insts):
    return [(Y, P, _draws(P, Y.shape[-1])) for Y, P in insts]


def _deconv_cfg(cls=SolverConfig, **kw):
    base = dict(mode="sparse", max_iter=ITERS, tol=0.0, n_scales=2)
    base.update(kw)
    return cls(**base)


def _assert_instance_parity(sol, ref, rtol=1e-4):
    want = np.asarray(ref.log.costs)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(sol.log.costs), fin)
    np.testing.assert_allclose(np.asarray(sol.log.costs)[fin], want[fin],
                               rtol=rtol)
    xs = sol.x if isinstance(sol.x, tuple) else (sol.x,)
    ys = ref.x if isinstance(ref.x, tuple) else (ref.x,)
    for a, b in zip(xs, ys):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=1e-6)


# =====================================================================
# Per-instance trajectory parity
# =====================================================================

@pytest.mark.parametrize("cost_every", [1, 3, "chunk"])
def test_deconvolve_parity_all_cadences(psf_instances, cost_every):
    """The port's buckets against the JAX package's, instance by
    instance."""
    sols = solve_many("deconvolve", _with_draws(psf_instances),
                      cfg=_deconv_cfg(), device="cpu", chunk=CHUNK,
                      cost_every=cost_every)
    want = jsolve_many("deconvolve", psf_instances,
                       cfg=_deconv_cfg(JConfig), chunk=CHUNK,
                       cost_every=cost_every)
    assert all(isinstance(s, Solution) for s in sols)
    for inst, sol, ref in zip(psf_instances, sols, want):
        assert sol.x.shape == inst[0].shape     # unpadded result
        assert sol.log.iters_run == ref.log.iters_run == ITERS
        _assert_instance_parity(sol, ref)


def test_lowrank_parity():
    """The batched completion against the port's single solve (the
    reference fails this comparison for itself, ROADMAP C)."""
    def make(n, p, seed):
        r = np.random.default_rng(seed)
        Y = (r.normal(size=(n, 3)) @ r.normal(size=(3, p))).astype(
            np.float32)
        M = (r.random((n, p)) < 0.6).astype(np.float32)
        return Y, M

    insts = [make(8, 10, 0), make(6, 10, 1), make(8, 12, 2),
             make(7, 10, 3)]
    cfg = CompletionConfig(rank=4, max_iter=ITERS, tol=0.0)
    for cost_every in (1, 3, "chunk"):
        sols = solve_many("lowrank", insts, cfg=cfg, device="cpu",
                          chunk=CHUNK, cost_every=cost_every)
        for inst, sol in zip(insts, sols):
            _assert_instance_parity(
                sol, solve("lowrank", *inst, cfg=cfg, device="cpu",
                           chunk=CHUNK, cost_every=cost_every))


def test_scdl_parity():
    """SCDL buckets (only equal K share one) against the JAX package's,
    each instance with the JAX atom choice for its own K."""
    def make(K, seed):
        r = np.random.default_rng(seed)
        return (r.normal(size=(25, K)).astype(np.float32),
                r.normal(size=(16, K)).astype(np.float32))

    A = 6
    insts = [make(20, 0), make(20, 1), make(24, 2)]
    own = [inst + ({"idx": np.array(jax.random.choice(
        jax.random.PRNGKey(3), inst[0].shape[1], (A,), replace=False))},)
        for inst in insts]
    cfg = dict(n_atoms=A, max_iter=ITERS, tol=0.0)
    for cost_every in (1, "chunk"):
        sols = solve_many("scdl", own, cfg=SCDLConfig(**cfg), device="cpu",
                          chunk=CHUNK, cost_every=cost_every)
        want = jsolve_many("scdl", insts, cfg=JSCDLConfig(**cfg),
                           chunk=CHUNK, cost_every=cost_every)
        for sol, ref in zip(sols, want):
            _assert_instance_parity(sol, ref)


def test_scdl_bucket_on_paper_shapes_matches_single_solves():
    """Two SCDL instances at the grayscale patch shape (P = 289, M = 81)
    share a bucket; each follows its single solve: costs at rtol 1e-4,
    and the dictionaries within twice the spread that a one-ulp nudge of
    S_h causes in the single solve itself (``tests/test_torch_scdl.py``'s
    rule: here 1e-6 to 1.1e-5 for 12 atoms from 300 samples, so an
    elementwise atol of 1e-6 would hold rounding to less than the
    problem's own conditioning); the spread must stay under 1e-3."""
    S = [jpatches(300, 289, 81, 12, seed=s) for s in (1, 2)]
    insts = [(np.asarray(a), np.asarray(b)) for a, b in S]
    cfg = SCDLConfig(n_atoms=12, max_iter=6, tol=0.0)
    kw = dict(cfg=cfg, device="cpu", chunk=3)
    sols = solve_many("scdl", insts, **kw)
    for (a, b), sol in zip(insts, sols):
        ref = solve("scdl", a, b, **kw)
        np.testing.assert_allclose(sol.log.costs, ref.log.costs, rtol=1e-4)
        nudged = solve("scdl", np.nextafter(a, np.float32(np.inf)), b, **kw)
        for got, want, moved in zip(sol.x, ref.x, nudged.x):
            spread = float(np.max(np.abs(moved - want)))
            assert spread < 1e-3
            assert float(np.max(np.abs(got - want))) <= 2 * spread + 1e-7


@pytest.mark.parametrize("cost_every", [1, "chunk"])
def test_lowrank_deconvolve_bucket(psf_instances, cost_every):
    """The low-rank deconvolution: one shared Omega, tau and sig per
    instance, the Jacobi factorizations over the (B, r, r) batch."""
    cfg = _deconv_cfg(mode="lowrank", rank=3, lam=0.05)
    insts = _with_draws(psf_instances[:3])
    sols = solve_many("deconvolve", insts, cfg=cfg, device="cpu",
                      chunk=CHUNK, cost_every=cost_every)
    for inst, sol in zip(insts, sols):
        _assert_instance_parity(sol, solve("deconvolve", *inst, cfg=cfg,
                                           device="cpu", chunk=CHUNK,
                                           cost_every=cost_every))


def test_default_draws_equal_the_single_solve(psf_instances):
    """Without explicit draws an instance draws as the single solve
    does: its step sizes are the single solve's, bit for bit, and its
    trajectory the single solve's (a padded FFT batch may round the
    last place differently)."""
    cfg = _deconv_cfg()
    sols = solve_many("deconvolve", psf_instances, cfg=cfg, device="cpu",
                      chunk=CHUNK)
    for inst, sol in zip(psf_instances, sols):
        ref = solve("deconvolve", *inst, cfg=cfg, device="cpu", chunk=CHUNK)
        for k in ("tau", "sig"):
            assert torch.equal(sol.bundle.replicated[k],
                               ref.bundle.replicated[k])
        _assert_instance_parity(sol, ref)


def test_instance_draws_are_checked(psf_instances):
    Y, P = psf_instances[0]
    with pytest.raises(ValueError, match="unknown draws"):
        solve_many("deconvolve", [(Y, P, {"seed": 1})], cfg=_deconv_cfg(),
                   device="cpu")


# =====================================================================
# Masked early exit, re-compaction, cancellation
# =====================================================================

def _psf(n, seed, S=16):
    d = psf.simulate(n, torch.Generator().manual_seed(seed), stamp=S,
                     device="cpu")
    return d.Y, d.psfs


def test_masked_early_exit_frees_converged_instance():
    Y, P = _psf(4, 9)
    live = (Y, P)
    settled = (torch.zeros_like(Y), P)        # converges at once
    cfg = _deconv_cfg(max_iter=40, tol=1e-6)
    sols = solve_many("deconvolve", [live, settled], cfg=cfg, device="cpu",
                      chunk=CHUNK, cost_every=1)
    assert sols[1].log.iters_run < sols[0].log.iters_run
    assert sols[1].log.converged_at is not None
    assert sols[1].log.converged_at + 1 == sols[1].log.iters_run
    np.testing.assert_array_equal(sols[1].x, 0.0)
    ref = solve("deconvolve", *live, cfg=cfg, device="cpu", chunk=CHUNK,
                cost_every=1)
    assert sols[0].log.iters_run == len(ref.log.costs)
    _assert_instance_parity(sols[0], ref)


def test_recompaction_retires_lanes_and_leaves_the_rest_alone():
    """Two of three lanes converge: the bucket re-compacts to the live
    one (its events then name one instance), the retired lanes' states
    come back from their spills, and every instance equals its single
    solve."""
    Y, P = _psf(4, 9)
    insts = [(torch.zeros_like(Y), P), (Y, P), (torch.zeros_like(Y), P)]
    cfg = _deconv_cfg(max_iter=24, tol=1e-6)
    seen = []
    sols = solve_many("deconvolve", insts, cfg=cfg, device="cpu",
                      chunk=CHUNK, progress_fn=lambda e: seen.append(
                          sorted(e["instances"])))
    assert seen[0] == [0, 1, 2] and seen[-1] == [1]
    for inst, sol in zip(insts, sols):
        _assert_instance_parity(sol, solve("deconvolve", *inst, cfg=cfg,
                                           device="cpu", chunk=CHUNK))
    np.testing.assert_array_equal(sols[0].x, 0.0)


def test_cancel_instances_freezes_only_the_named_lane():
    Y, P = _psf(4, 9)
    Y2, P2 = _psf(4, 10)
    insts = [(Y, P), (Y2, P2)]
    cfg = _deconv_cfg(max_iter=12)

    def cancel_first(event):
        if event["done"] == 4:
            return {"cancel_instances": [0]}
        return None

    sols = solve_many("deconvolve", insts, cfg=cfg, device="cpu",
                      chunk=CHUNK, progress_fn=cancel_first)
    assert sols[0].log.cancelled_at == 3 and sols[0].log.iters_run == 4
    assert sols[1].log.cancelled_at is None and sols[1].log.iters_run == 12
    ref0 = solve("deconvolve", *insts[0], cfg=_deconv_cfg(max_iter=4),
                 device="cpu", chunk=CHUNK)
    np.testing.assert_allclose(sols[0].x, ref0.x, rtol=1e-4, atol=1e-6)
    _assert_instance_parity(sols[1], solve("deconvolve", *insts[1], cfg=cfg,
                                           device="cpu", chunk=CHUNK))
    stopped = solve_many("deconvolve", insts, cfg=cfg, device="cpu",
                         chunk=CHUNK, progress_fn=lambda e: {"stop": True})
    assert [s.log.iters_run for s in stopped] == [4, 4]


def test_progress_fn_batched_per_instance():
    """Per-instance progress keyed by the caller's index."""
    Y, P = _psf(8, 2)
    Y2, P2 = _psf(3, 7)
    cfg = _deconv_cfg(max_iter=6)
    seen = {}
    sols = solve_many(
        "deconvolve", [(Y, P), (Y2, P2)], cfg=cfg, device="cpu", chunk=3,
        progress_fn=lambda e: [seen.setdefault(j, []).append(st)
                               for j, st in e["instances"].items()])
    assert sorted(seen) == [0, 1]
    for j, sol in enumerate(sols):
        assert seen[j][-1]["iters_run"] == sol.log.iters_run == 6
        assert seen[j][-1]["cost"] == pytest.approx(sol.log.costs[-1])


# =====================================================================
# Checkpoints
# =====================================================================

def test_bucket_checkpoint_resume_roundtrip(tmp_path, psf_instances):
    cfg = _deconv_cfg()
    ref = solve_many("deconvolve", psf_instances, cfg=cfg, device="cpu",
                     chunk=CHUNK, cost_every=1)
    solve_many("deconvolve", psf_instances, cfg=_deconv_cfg(max_iter=8),
               device="cpu", chunk=CHUNK, cost_every=1,
               checkpoint_dir=str(tmp_path), checkpoint_every=4)
    assert all(d.startswith("bucket_") for d in os.listdir(tmp_path))
    assert len(os.listdir(tmp_path)) >= 2      # mixed shapes: 2+ buckets
    res = solve_many("deconvolve", psf_instances, cfg=cfg, device="cpu",
                     chunk=CHUNK, cost_every=1,
                     checkpoint_dir=str(tmp_path), resume=True)
    for r, s in zip(ref, res):
        np.testing.assert_array_equal(r.x, s.x)
        assert s.log.iters_run == ITERS
        assert s.log.costs == r.log.costs[8:]


def test_bucket_checkpoint_after_recompaction_uses_the_full_layout(
        tmp_path):
    """A checkpoint written after re-compaction holds every lane (the
    retired ones from their spills), so the resume restores the whole
    bucket and finishes as the uninterrupted run does."""
    Y, P = _psf(4, 9)
    insts = [(torch.zeros_like(Y), P), (Y, P), (torch.zeros_like(Y), P)]
    kw = dict(device="cpu", chunk=CHUNK)
    ref = solve_many("deconvolve", insts, cfg=_deconv_cfg(max_iter=16,
                                                          tol=1e-6), **kw)
    solve_many("deconvolve", insts, cfg=_deconv_cfg(max_iter=12, tol=1e-6),
               checkpoint_dir=str(tmp_path), checkpoint_every=12, **kw)
    res = solve_many("deconvolve", insts,
                     cfg=_deconv_cfg(max_iter=16, tol=1e-6),
                     checkpoint_dir=str(tmp_path), resume=True, **kw)
    for r, s in zip(ref, res):
        np.testing.assert_array_equal(r.x, s.x)
        assert s.log.iters_run == r.log.iters_run
        assert s.log.converged_at == r.log.converged_at


def test_resume_requires_true_not_step(tmp_path, psf_instances):
    with pytest.raises(ValueError, match="resume=True"):
        solve_many("deconvolve", psf_instances, cfg=_deconv_cfg(),
                   device="cpu", checkpoint_dir=str(tmp_path), resume=4,
                   checkpoint_every=4)


def test_resume_without_any_bucket_checkpoints(tmp_path, psf_instances):
    with pytest.raises(ValueError, match="no bucket checkpoints"):
        solve_many("deconvolve", psf_instances, cfg=_deconv_cfg(),
                   device="cpu", checkpoint_dir=str(tmp_path), resume=True)


def test_checkpoint_every_clamped_to_max_iter(tmp_path, psf_instances):
    solve_many("deconvolve", psf_instances[:1], cfg=_deconv_cfg(),
               device="cpu", chunk=CHUNK, checkpoint_dir=str(tmp_path),
               checkpoint_every=10_000)
    bdirs = os.listdir(tmp_path)
    assert len(bdirs) == 1
    assert latest_step(tmp_path / bdirs[0]) == ITERS


# =====================================================================
# Option validation
# =====================================================================

@pytest.mark.parametrize("bad", [0, -1, -8])
def test_run_options_rejects_nonpositive_chunk(bad):
    with pytest.raises(ValueError, match="chunk"):
        RunOptions(max_iter=4, chunk=bad)


@pytest.mark.parametrize("bad", [0, -3])
def test_run_options_rejects_nonpositive_cost_every(bad):
    with pytest.raises(ValueError, match="cost_every"):
        RunOptions(max_iter=4, cost_every=bad)


def test_run_options_rejects_unknown_cost_every_string():
    with pytest.raises(ValueError, match="chunk"):
        RunOptions(max_iter=4, cost_every="sometimes")


@pytest.mark.parametrize("kwargs,item", [
    (dict(mesh=object()), "A13"),
    (dict(resilience=ResilienceConfig()), "A11")])
def test_later_slice_options_raise(psf_instances, kwargs, item):
    """``mesh=`` (A13) still raises; ``resilience=`` (A11) is accepted,
    every instance carrying its bucket's clean report."""
    if item == "A11":
        sols = solve_many("deconvolve", psf_instances, cfg=_deconv_cfg(),
                          device="cpu", chunk=CHUNK, **kwargs)
        assert all(s.recovery is not None and s.recovery.faults == []
                   for s in sols)
        return
    with pytest.raises(NotImplementedError, match=item):
        solve_many("deconvolve", psf_instances, cfg=_deconv_cfg(),
                   device="cpu", **kwargs)


def test_problem_without_batched_steps_is_refused(psf_instances):
    class Plain(Problem):
        pass

    with pytest.raises(TypeError, match="batched_steps"):
        solve_many(Plain(), psf_instances, device="cpu")


# =====================================================================
# Misc contracts
# =====================================================================

def test_empty_instance_list():
    assert solve_many("deconvolve", [], cfg=_deconv_cfg()) == []


def test_single_instance_bucket(psf_instances):
    cfg = _deconv_cfg()
    [sol] = solve_many("deconvolve", _with_draws(psf_instances[:1]),
                       cfg=cfg, device="cpu", chunk=CHUNK)
    [ref] = jsolve_many("deconvolve", psf_instances[:1],
                        cfg=_deconv_cfg(JConfig), chunk=CHUNK)
    _assert_instance_parity(sol, ref)
