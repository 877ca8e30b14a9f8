"""``repro_torch.resilience``: supervised solves against the JAX package.

Follows ``tests/test_resilience.py`` at its sizes (8 stamps, 12
iterations, chunk 4; SCDL 256 x (25, 9) with 16 atoms; completion
24 x 18).  Every faulted run must reproduce the JAX package's fault-free
``solve`` at rtol 1e-4 (its random draws passed to the port), and its
``RecoveryReport`` must count what the JAX package's own report counts
under the same chaos spec (one JAX chaos run per workload and fault
kind).  On the CPU a fault-free supervised run is also held bit for bit
to the port's unsupervised run, and a faulted one to the fault-free one.
SCDL's dictionaries are held to JAX's at ``tests/test_torch_scdl.py``'s
rtol 1e-3 / atol 1e-4 (its costs at rtol 1e-4).

Where the port differs by design (ROADMAP C): the ``kernel`` fault point
raises before the launch and the chunk is retried on the same kernel
(the JAX package degrades the family to a slower route), so
``kernel_fallbacks`` stays empty; the snapshot ring holds references to
the chunk-start tensors; ``torch.cuda.OutOfMemoryError`` and the
kernels' CUDA launch errors are fatal.
"""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.problem import solve as jsolve
from repro.core.problem import solve_many as jsolve_many
from repro.resilience import chaos as jchaos
from repro.resilience.recovery import RecoveryReport as JReport
from repro.resilience.recovery import ResilienceConfig as JResilience
from repro_torch.checkpoint import (Checkpointer, CheckpointCorruptError,
                                    CheckpointWriteError, latest_step,
                                    latest_valid_step, validate_checkpoint)
from repro_torch.core.problem import solve, solve_many
from repro_torch.resilience import chaos
from repro_torch.resilience.errors import (DivergenceError, InjectedFault,
                                           ResilienceExhausted, classify)
from repro_torch.resilience.recovery import RecoveryReport, ResilienceConfig
from repro_torch.resilience.supervisor import (finite_flag,
                                               host_costs_and_flag)

torch.set_num_threads(2)

ITERS, CHUNK = 12, 4        # 3 chunk dispatches: first / mid / last
COSTS = dict(rtol=1e-4)
ITERATE = dict(rtol=1e-4, atol=1e-6)
DICTS = dict(rtol=1e-3, atol=1e-4)


# ------------------------------------------------------------- data
@pytest.fixture(scope="module")
def data():
    """Each workload's inputs (made by the JAX package or numpy) and the
    JAX package's random draws for the port."""
    from repro.data.synthetic import coupled_patches as jpatches
    from repro.imaging import lowrank as jlr
    from repro.imaging import psf as jpsf
    d = jpsf.simulate(8, jax.random.PRNGKey(0))
    Y, P = np.asarray(d.Y), np.asarray(d.psfs)
    ku, kv = jax.random.split(jax.random.PRNGKey(0))
    S = Y.shape[-1]
    deconv_draws = dict(
        u0=np.asarray(jax.random.normal(ku, P.shape)),
        v0=np.asarray(jax.random.normal(kv, P.shape)),
        x0=np.asarray(jax.random.normal(jax.random.PRNGKey(0), (S, S))),
        noise=np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                           (8, 41, 41))))
    S_h, S_l = (np.asarray(a) for a in jpatches(256, 25, 9, 16, seed=0))
    idx = np.asarray(jax.random.choice(jax.random.PRNGKey(3), 256, (16,),
                                       replace=False))
    rng = np.random.default_rng(4)
    U = rng.normal(size=(24, 3)).astype(np.float32)
    V = rng.normal(size=(3, 18)).astype(np.float32)
    A = U @ V + 0.01 * rng.normal(size=(24, 18)).astype(np.float32)
    M = (rng.random((24, 18)) < 0.6).astype(np.float32)
    omega = np.asarray(jlr.make_test_matrix(18, 4))
    return {"deconvolve": ((Y, P), deconv_draws),
            "scdl": ((S_h, S_l), {"idx": idx}),
            "lowrank": ((A, M), {"omega": omega})}


def _port_problem(workload, draws):
    if workload == "deconvolve":
        from repro_torch.imaging.condat import SolverConfig
        from repro_torch.imaging.deconvolve import DeconvolutionProblem
        return DeconvolutionProblem(SolverConfig(mode="sparse", n_scales=3),
                                    **draws)
    if workload == "scdl":
        from repro_torch.imaging.scdl import SCDLConfig, SCDLProblem
        return SCDLProblem(SCDLConfig(n_atoms=16, max_iter=ITERS), **draws)
    from repro_torch.imaging.lowrank import (CompletionConfig,
                                             LowRankCompletionProblem)
    return LowRankCompletionProblem(CompletionConfig(rank=4,
                                                     max_iter=ITERS),
                                    **draws)


def _tsolve(workload, data, **kw):
    """The port's solve of ``workload`` on the CPU."""
    inputs, draws = data[workload]
    opts = dict(max_iter=ITERS, tol=0, chunk=CHUNK)
    opts.update(kw)
    return solve(_port_problem(workload, draws), *inputs, device="cpu",
                 **opts)


def _jsolve(workload, data, **kw):
    """The JAX package's solve of the same instance."""
    inputs, _ = data[workload]
    opts = dict(max_iter=ITERS, tol=0, chunk=CHUNK)
    opts.update(kw)
    if workload == "deconvolve":
        from repro.imaging.condat import SolverConfig
        cfg = SolverConfig(mode="sparse", n_scales=3)
    elif workload == "scdl":
        from repro.imaging.scdl import SCDLConfig
        cfg = SCDLConfig(n_atoms=16, max_iter=ITERS)
    else:
        from repro.imaging.lowrank import CompletionConfig
        cfg = CompletionConfig(rank=4, max_iter=ITERS)
    return jsolve(workload, *inputs, cfg=cfg, **opts)


def _leaves(x):
    return list(x) if isinstance(x, tuple) else [x]


def _assert_parity(sol, ref, workload="deconvolve"):
    """Costs rtol 1e-4, iterates rtol 1e-4 / atol 1e-6, against a JAX
    solution.  Two iterates keep the bounds their own parity tests hold
    them to: SCDL's dictionaries ``DICTS`` (``tests/test_torch_scdl.py``
    at 16 atoms), the completion's within 1e-4 of its largest entry
    (``tests/test_torch_lowrank.py``: the fp32 rounding the range finder
    magnifies, ROADMAP C)."""
    np.testing.assert_allclose(sol.log.costs, ref.log.costs, **COSTS)
    for a, b in zip(_leaves(sol.x), jax.tree.leaves(ref.x)):
        b = np.asarray(b)
        tol = {"scdl": DICTS,
               "lowrank": dict(rtol=1e-4, atol=1e-4 * np.abs(b).max())
               }.get(workload, ITERATE)
        np.testing.assert_allclose(np.asarray(a), b, **tol)


def _assert_same(sol, ref):
    """Bit for bit, against a port solution."""
    assert sol.log.costs == ref.log.costs
    for a, b in zip(_leaves(sol.x), _leaves(ref.x)):
        np.testing.assert_array_equal(a, b)


def _counts(rec):
    """What a report counts, and where its faults were."""
    return (rec.retries, rec.rollbacks, rec.checkpoint_restores,
            [(f["point"], f["step"]) for f in rec.faults],
            rec.kernel_fallbacks)


@pytest.fixture(scope="module")
def jax_refs(data):
    """The JAX package's fault-free runs."""
    return {w: _jsolve(w, data) for w in ("deconvolve", "scdl", "lowrank")}


@pytest.fixture(scope="module")
def port_refs(data):
    """The port's unsupervised fault-free runs."""
    return {w: _tsolve(w, data) for w in ("deconvolve", "scdl", "lowrank")}


_JAX_CHAOS = {}


def _jax_chaos_report(workload, point, pos, data):
    """The JAX package's report under the same spec, one run per
    workload and fault kind (at the middle chunk)."""
    key = (workload, point)
    if key not in _JAX_CHAOS:
        cc = jchaos.ChaosConfig.parse(f"{point}@{pos};seed=11")
        with jchaos.active_chaos(cc):
            _JAX_CHAOS[key] = _jsolve(workload, data,
                                      resilience=JResilience()).recovery
    return _JAX_CHAOS[key]


# ==================================================================
# The chaos matrix: three workloads x two fault kinds x chunk position
# ==================================================================

@pytest.mark.parametrize("pos", [0, 1, 2], ids=["first", "mid", "last"])
@pytest.mark.parametrize("point", ["dispatch", "carry_nan"])
@pytest.mark.parametrize("workload", ["deconvolve", "scdl", "lowrank"])
def test_chaos_matrix_auto_recovers(workload, point, pos, data, jax_refs,
                                    port_refs):
    cc = chaos.ChaosConfig.parse(f"{point}@{pos};seed=11")
    with chaos.active_chaos(cc) as st:
        sol = _tsolve(workload, data, resilience=ResilienceConfig())
    assert (point, pos) in st.fired
    _assert_parity(sol, jax_refs[workload], workload)
    _assert_same(sol, port_refs[workload])
    rec = sol.recovery
    assert isinstance(rec, RecoveryReport)
    if point == "dispatch":
        assert rec.retries == 1 and rec.rollbacks == 0
        assert rec.faults[0]["point"] == "dispatch"
        assert rec.faults[0]["step"] == pos * CHUNK
    else:
        assert rec.rollbacks == 1 and rec.retries == 0
        assert rec.checkpoint_restores == 0
        assert rec.faults[0]["point"] == "divergence"
        assert rec.faults[0]["step"] == (pos + 1) * CHUNK - 1
    assert rec.kernel_fallbacks == []
    assert rec.wall_time_lost_s >= 0.0
    if pos == 1:
        assert _counts(rec) == _counts(
            _jax_chaos_report(workload, point, pos, data))


@pytest.mark.parametrize("workload", ["deconvolve", "scdl", "lowrank"])
def test_fault_free_supervised_run_is_clean(workload, data, jax_refs,
                                            port_refs):
    """Supervision changes nothing when nothing fails: bit for bit the
    unsupervised run, and the JAX trajectory at rtol 1e-4."""
    sol = _tsolve(workload, data, resilience=ResilienceConfig())
    _assert_same(sol, port_refs[workload])
    _assert_parity(sol, jax_refs[workload], workload)
    rec = sol.recovery
    assert rec.retries == rec.rollbacks == rec.checkpoint_restores == 0
    assert rec.faults == [] and rec.kernel_fallbacks == []


def test_per_step_supervised_run_takes_the_chunked_loop(data, port_refs):
    """``chunk=1`` under supervision runs the chunked loop's one-step
    scan: the same trajectory as the unsupervised per-step loop."""
    want = _tsolve("deconvolve", data, chunk=1)
    cc = chaos.ChaosConfig.parse("carry_nan@5;seed=3")
    with chaos.active_chaos(cc):
        sol = _tsolve("deconvolve", data, chunk=1,
                      resilience=ResilienceConfig())
    assert sol.recovery.rollbacks == 1
    np.testing.assert_allclose(sol.log.costs, want.log.costs, rtol=1e-6)
    np.testing.assert_allclose(sol.x, want.x, rtol=1e-6, atol=1e-8)


def test_unsupervised_run_has_no_recovery(port_refs):
    assert port_refs["deconvolve"].recovery is None


@pytest.mark.parametrize("spec", ["dispatch@1", "kernel:condat_elwise@3"])
def test_unsupervised_chaos_fault_is_fatal(spec, data):
    cc = chaos.ChaosConfig.parse(spec)
    with chaos.active_chaos(cc):
        with pytest.raises(InjectedFault):
            _tsolve("deconvolve", data)


def test_unsupervised_per_step_faults(data):
    """The per-step loop keeps both fault points: ``dispatch`` ends the
    run, ``carry_nan`` poisons it silently (no checks, no supervisor)."""
    with chaos.active_chaos(chaos.ChaosConfig.parse("dispatch@2")):
        with pytest.raises(InjectedFault):
            _tsolve("deconvolve", data, chunk=1)
    with chaos.active_chaos(chaos.ChaosConfig.parse("carry_nan@2")):
        sol = _tsolve("deconvolve", data, chunk=1)
    assert np.isnan(sol.log.costs[-1])


def test_retry_budget_exhaustion_raises(data):
    cc = chaos.ChaosConfig.parse("dispatch@0,1,2,3,4,5")
    with chaos.active_chaos(cc):
        with pytest.raises(ResilienceExhausted) as ei:
            _tsolve("deconvolve", data,
                    resilience=ResilienceConfig(max_retries=2,
                                                backoff_s=1e-3))
    # the ledger rides the error (the serving quarantine reads it)
    assert ei.value.report.retries == 2
    assert len(ei.value.report.faults) == 3


# ==================================================================
# The kernel fault point: retried on the same kernel, never degraded
# ==================================================================

@pytest.mark.parametrize("workload,family", [
    ("deconvolve", "starlet2d"), ("deconvolve", "condat_elwise"),
    ("scdl", "admm_elwise"), ("scdl", "dict_outer"),
    ("lowrank", "jacobi")])
def test_kernel_fault_is_retried_on_the_same_kernel(workload, family,
                                                     data, port_refs):
    """The third call of the family's wrappers inside the loop fails
    (the setup's calls, the power iterations among them, come first and
    are not supervised)."""
    inputs, draws = data[workload]
    key = f"kernel:{family}"
    with chaos.active_chaos(chaos.ChaosConfig()) as st:
        _port_problem(workload, draws).init_bundle(inputs,
                                                   torch.device("cpu"))
    at = st.counts.get(key, 0) + 2
    cc = chaos.ChaosConfig.parse(f"{key}@{at};seed=11")
    with chaos.active_chaos(cc) as st:
        sol = _tsolve(workload, data, resilience=ResilienceConfig())
    assert (key, at) in st.fired
    rec = sol.recovery
    assert rec.retries == 1 and rec.rollbacks == 0
    assert rec.faults[0]["point"] == "dispatch"
    assert "InjectedFault" in rec.faults[0]["error"]
    assert family in rec.faults[0]["error"]
    assert rec.kernel_fallbacks == []
    _assert_same(sol, port_refs[workload])


def test_kernel_point_skips_meta_tensors():
    """A contract check on ``meta`` tensors computes nothing and does
    not count as a call of the kernel."""
    from repro_torch.kernels.condat_elwise.ops import condat_primal
    x = torch.empty((2, 4, 4), device="meta")
    with chaos.active_chaos(chaos.ChaosConfig.parse("kernel@0")) as st:
        condat_primal(x, x, x, 0.5)
        assert st.counts == {}
        with pytest.raises(InjectedFault, match="condat_elwise"):
            condat_primal(torch.zeros(2, 4, 4), torch.zeros(2, 4, 4),
                          torch.zeros(2, 4, 4), 0.5)


# ==================================================================
# Rollback sources: ring first, then the newest valid checkpoint
# ==================================================================

def test_repeated_divergence_falls_back_to_disk(tmp_path, data, jax_refs,
                                                port_refs):
    from repro.checkpoint import checkpointer as jckpt
    from repro.core import persistence as jpersist
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.core import persistence

    def checkpoint_fn(bundle, i):
        # synchronous: the disk fallback must find step i + 1
        ckpt.save(tmp_path / "port", i + 1, persistence.spill_bundle(bundle))

    def jcheckpoint_fn(bundle, i):
        jckpt.save(tmp_path / "jax", i + 1, jpersist.spill_bundle(bundle))

    # the chunk at i=4 diverges twice: rollback 1 takes the only ring
    # entry, rollback 2 finds that boundary already failed and restores
    # the step-4 checkpoint
    spec = "carry_nan@1,2;seed=5"
    with chaos.active_chaos(chaos.ChaosConfig.parse(spec)):
        sol = _tsolve("deconvolve", data, checkpoint_every=CHUNK,
                      checkpoint_fn=checkpoint_fn,
                      resilience=ResilienceConfig(
                          ring=1, checkpoint_dir=str(tmp_path / "port")))
    with jchaos.active_chaos(jchaos.ChaosConfig.parse(spec)):
        jsol = _jsolve("deconvolve", data, checkpoint_every=CHUNK,
                       checkpoint_fn=jcheckpoint_fn,
                       resilience=JResilience(
                           ring=1, checkpoint_dir=str(tmp_path / "jax")))
    assert sol.recovery.rollbacks == 2
    assert sol.recovery.checkpoint_restores == 1
    assert _counts(sol.recovery) == _counts(jsol.recovery)
    _assert_parity(sol, jax_refs["deconvolve"])
    _assert_same(sol, port_refs["deconvolve"])


def test_rollback_budget_exhaustion_raises(data):
    cc = chaos.ChaosConfig.parse(
        "carry_nan@" + ",".join(str(i) for i in range(32)))
    with chaos.active_chaos(cc):
        with pytest.raises(ResilienceExhausted):
            _tsolve("deconvolve", data,
                    resilience=ResilienceConfig(max_rollbacks=3))


def test_exhausted_ring_without_checkpoints_raises(data):
    cc = chaos.ChaosConfig.parse("carry_nan@1,2")
    with chaos.active_chaos(cc):
        with pytest.raises(ResilienceExhausted, match="no checkpoint_dir"):
            _tsolve("deconvolve", data,
                    resilience=ResilienceConfig(ring=1))


def test_solve_fills_the_rollback_directory(tmp_path, data, port_refs):
    """``solve(checkpoint_dir=...)`` points the disk fallback at its own
    checkpoints: the double divergence of the test above, through the
    built-in asynchronous writer."""
    cc = chaos.ChaosConfig.parse("carry_nan@2,3;seed=5")
    with chaos.active_chaos(cc):
        sol = _tsolve("deconvolve", data, checkpoint_dir=str(tmp_path),
                      checkpoint_every=CHUNK,
                      resilience=ResilienceConfig(ring=1))
    assert sol.recovery.checkpoint_restores == 1
    _assert_same(sol, port_refs["deconvolve"])


# ==================================================================
# Checkpoints: corruption, resume fallback, write failures
# ==================================================================

def _corrupt_leaf(directory, step):
    leaf = sorted((Path(directory) / f"step_{step:08d}")
                  .glob("leaf_*.npy"))[0]
    raw = leaf.read_bytes()
    leaf.write_bytes(raw[: len(raw) // 2])


def test_resume_falls_back_past_corrupt_newest(tmp_path, data, jax_refs):
    _tsolve("deconvolve", data, max_iter=8, checkpoint_dir=str(tmp_path),
            checkpoint_every=4)
    assert latest_step(tmp_path) == 8
    assert validate_checkpoint(tmp_path, 8) is None
    _corrupt_leaf(tmp_path, 8)
    assert validate_checkpoint(tmp_path, 8) is not None
    assert latest_valid_step(tmp_path) == (4, [8])
    with pytest.warns(RuntimeWarning, match="integrity"):
        sol = _tsolve("deconvolve", data, checkpoint_dir=str(tmp_path),
                      resume=True)
    assert len(sol.log.costs) == ITERS - 4
    np.testing.assert_allclose(sol.log.costs,
                               jax_refs["deconvolve"].log.costs[4:],
                               **COSTS)


def test_resume_explicit_corrupt_step_stays_loud(tmp_path, data):
    _tsolve("deconvolve", data, max_iter=8, checkpoint_dir=str(tmp_path),
            checkpoint_every=4)
    _corrupt_leaf(tmp_path, 8)
    with pytest.raises(CheckpointCorruptError, match="integrity"):
        _tsolve("deconvolve", data, checkpoint_dir=str(tmp_path), resume=8)


def test_chaos_ckpt_corrupt_injector(tmp_path, data):
    # the second save (step 8) is torn after its checksums are computed
    with chaos.active_chaos(chaos.ChaosConfig.parse("ckpt_corrupt@1")):
        _tsolve("deconvolve", data, max_iter=8,
                checkpoint_dir=str(tmp_path), checkpoint_every=4)
    assert latest_step(tmp_path) == 8
    assert validate_checkpoint(tmp_path, 4) is None
    assert validate_checkpoint(tmp_path, 8) is not None
    assert latest_valid_step(tmp_path) == (4, [8])


@pytest.mark.parametrize("where", ["wait", "next_save", "close"])
def test_async_write_failure_surfaces(tmp_path, where):
    tree = {"a": torch.arange(8, dtype=torch.float32)}
    with chaos.active_chaos(chaos.ChaosConfig.parse("ckpt_write@0")):
        w = Checkpointer(tmp_path)
        w.save_async(1, tree)
        with pytest.raises(CheckpointWriteError) as ei:
            {"wait": w.wait, "close": w.close,
             "next_save": lambda: w.save(2, tree)}[where]()
        assert isinstance(ei.value.__cause__, InjectedFault)
        # the failure is consumed: the next save lands and validates
        w.save_async(3, tree)
        w.close()
    assert latest_step(tmp_path) == 3
    assert validate_checkpoint(tmp_path, 3) is None


def test_solve_surfaces_async_checkpoint_failure(tmp_path, data):
    with chaos.active_chaos(chaos.ChaosConfig.parse("ckpt_write@0")):
        with pytest.raises(CheckpointWriteError):
            _tsolve("deconvolve", data, max_iter=8,
                    checkpoint_dir=str(tmp_path), checkpoint_every=4)


# ==================================================================
# Buckets (solve_many) under supervision
# ==================================================================

@pytest.fixture(scope="module")
def bucket():
    """tests/test_solve_many.py's instances, with the JAX draws."""
    from repro.imaging import psf as jpsf
    out = []
    for (n, S, seed) in [(3, 16, 0), (5, 16, 1), (4, 16, 2), (3, 20, 3)]:
        d = jpsf.simulate(n, jax.random.PRNGKey(seed), stamp=S)
        P = np.asarray(d.psfs)
        ku, kv = jax.random.split(jax.random.PRNGKey(0))
        draws = dict(
            u0=np.asarray(jax.random.normal(ku, P.shape)),
            v0=np.asarray(jax.random.normal(kv, P.shape)),
            x0=np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                            (S, S))),
            noise=np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                               (8, 41, 41))))
        out.append((np.asarray(d.Y), P, draws))
    return out


def _bucket_cfg(cls):
    return cls(mode="sparse", max_iter=10, tol=0.0, n_scales=2)


def test_solve_many_carry_nan_matches_fault_free_bucket(bucket):
    """A poisoned bucket rolls back as a whole: every instance ends bit
    for bit where the fault-free bucket does, and the reports count what
    the JAX package's count under the same spec."""
    from repro.imaging.condat import SolverConfig as JConfig
    from repro_torch.imaging.condat import SolverConfig
    kw = dict(chunk=4, cost_every=1)
    clean = solve_many("deconvolve", bucket, cfg=_bucket_cfg(SolverConfig),
                       device="cpu", **kw)
    spec = "carry_nan@2;seed=7"
    with chaos.active_chaos(chaos.ChaosConfig.parse(spec)) as st:
        sols = solve_many("deconvolve", bucket,
                          cfg=_bucket_cfg(SolverConfig), device="cpu",
                          resilience=ResilienceConfig(backoff_s=1e-3), **kw)
    assert ("carry_nan", 2) in st.fired
    jinsts = [(Y, P) for Y, P, _ in bucket]
    with jchaos.active_chaos(jchaos.ChaosConfig.parse(spec)):
        jsols = jsolve_many("deconvolve", jinsts, cfg=_bucket_cfg(JConfig),
                            resilience=JResilience(backoff_s=1e-3), **kw)
    for s, c, j in zip(sols, clean, jsols):
        _assert_same(s, c)
        _assert_parity(s, j)
        assert _counts(s.recovery) == _counts(j.recovery)
    assert sum(s.recovery.rollbacks for s in
               {id(s.recovery): s for s in sols}.values()) == 1


def test_chaos_drill_on_batched_run(tmp_path, bucket):
    """tests/test_solve_many.py's drill: a dispatch fault and a poisoned
    carry across the buckets, checkpoints on; every instance keeps its
    trajectory."""
    from repro_torch.imaging.condat import SolverConfig
    kw = dict(cfg=_bucket_cfg(SolverConfig), device="cpu", chunk=4,
              cost_every=1)
    ref = solve_many("deconvolve", bucket, **kw)
    cc = chaos.ChaosConfig.parse("dispatch@1;carry_nan@2;seed=7")
    with chaos.active_chaos(cc) as st:
        sols = solve_many("deconvolve", bucket,
                          checkpoint_dir=str(tmp_path), checkpoint_every=4,
                          resilience=ResilienceConfig(backoff_s=1e-3), **kw)
    assert ("dispatch", 1) in st.fired and ("carry_nan", 2) in st.fired
    assert any(s.recovery.retries or s.recovery.rollbacks for s in sols)
    for r, s in zip(ref, sols):
        _assert_same(s, r)


def test_bucket_rollback_from_disk(tmp_path, bucket):
    """The batched disk fallback: the full-bucket checkpoint payload is
    restored and every lane's log rewound to it."""
    from repro_torch.imaging.condat import SolverConfig
    insts = bucket[:3]                      # one bucket (stamp 16)
    kw = dict(cfg=_bucket_cfg(SolverConfig), device="cpu", chunk=4,
              cost_every=1)
    ref = solve_many("deconvolve", insts, **kw)
    cc = chaos.ChaosConfig.parse("carry_nan@1,2;seed=5")
    with chaos.active_chaos(cc):
        sols = solve_many("deconvolve", insts, checkpoint_dir=str(tmp_path),
                          checkpoint_every=4,
                          resilience=ResilienceConfig(ring=1), **kw)
    assert sols[0].recovery.rollbacks == 2
    assert sols[0].recovery.checkpoint_restores == 1
    for r, s in zip(ref, sols):
        _assert_same(s, r)


# ==================================================================
# Chaos plumbing, the taxonomy, the report
# ==================================================================

def test_chaos_spec_parsing():
    cc = chaos.ChaosConfig.parse("dispatch@1,3;carry_nan;seed=9")
    assert cc.seed == 9
    assert cc.faults == {"dispatch": (1, 3), "carry_nan": (0,)}
    assert cc == chaos.ChaosConfig(**vars(jchaos.ChaosConfig.parse(
        "dispatch@1,3;carry_nan;seed=9")))
    assert chaos.FAULT_POINTS == jchaos.FAULT_POINTS
    with pytest.raises(ValueError, match="unknown chaos fault point"):
        chaos.ChaosConfig.parse("warp_core@0")


def test_chaos_env_var_path(monkeypatch, data):
    monkeypatch.setenv(chaos.ENV_VAR, "dispatch@1;seed=3")
    assert not chaos.is_active()
    sol = _tsolve("deconvolve", data, resilience=ResilienceConfig())
    assert sol.recovery.retries == 1
    assert sol.recovery.faults[0]["point"] == "dispatch"
    assert not chaos.is_active()        # deactivated after the run


def test_poison_tree_is_out_of_place_and_seeded():
    tree = {"a": torch.zeros(4, 5), "b": {"c": torch.ones(3)},
            "i": torch.arange(3)}
    before = {k: v.clone() for k, v in (("a", tree["a"]),
                                        ("c", tree["b"]["c"]))}
    outs = []
    for _ in range(2):
        with chaos.active_chaos(chaos.ChaosConfig.parse(
                "carry_nan@0;seed=4")):
            outs.append(chaos.poison_tree("carry_nan", tree))
    for out in outs:
        nans = [int(torch.isnan(x).sum()) for x in
                (out["a"], out["b"]["c"])]
        assert sorted(nans) == [0, 1]
        assert out["i"] is tree["i"]
    for k in ("a",):
        assert torch.equal(outs[0][k].isnan(), outs[1][k].isnan())
    assert torch.equal(tree["a"], before["a"])
    assert torch.equal(tree["b"]["c"], before["c"])
    # inactive or not due: the same object back
    assert chaos.poison_tree("carry_nan", tree) is tree


def test_finite_flag_and_one_transfer():
    trace = {"cost": torch.tensor([3.0, 2.5, float("inf")])}
    good = {"x": torch.ones(3), "k": torch.ones(2, dtype=torch.complex64),
            "n": torch.arange(2)}
    costs, finite = host_costs_and_flag(trace, finite_flag(good))
    assert finite and costs.tolist() == [3.0, 2.5, float("inf")]
    bad = dict(good, k=torch.tensor([1.0, complex("nan")],
                                    dtype=torch.complex64))
    assert not host_costs_and_flag(trace, finite_flag(bad))[1]
    batched = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    costs, finite = host_costs_and_flag(batched, finite_flag(good))
    assert costs.shape == (3, 2) and finite
    assert finite_flag({"n": torch.arange(2)}) is None
    # every kind of non-finite value, in each kind of leaf
    for bad_value in (float("nan"), float("inf"), -float("inf")):
        x = torch.ones(4, 6).t()                     # non-contiguous
        x[2, 1] = bad_value
        assert not bool(finite_flag({"x": x, "e": torch.ones(0)}))
        b = torch.ones(3, dtype=torch.bfloat16)
        b[2] = bad_value
        assert not bool(finite_flag({"b": b}))
        k = torch.ones(3, dtype=torch.complex64)
        k[0] = complex(1.0, bad_value)
        assert not bool(finite_flag({"k": k}))


def test_classify_taxonomy():
    assert classify(InjectedFault("dispatch")) == "transient"
    assert classify(OSError("disk gone")) == "transient"
    assert classify(RuntimeError("UNAVAILABLE: worker lost")) \
        == "transient"
    assert classify(ValueError("bad shape")) == "fatal"
    assert classify(DivergenceError("nan", step=3)) == "fatal"
    assert classify(ResilienceExhausted("done")) == "fatal"

    class Custom(Exception):
        pass
    assert classify(Custom(), (Custom,)) == "transient"
    # the card's own failures are fatal, whatever their message says
    assert classify(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. ABORTED")) == "fatal"
    assert classify(RuntimeError(
        "condat_elwise.primal: CUDA error 700 (an illegal memory access "
        "was encountered)")) == "fatal"
    assert classify(RuntimeError("condat: CUDA error 2 (UNAVAILABLE)")) \
        == "fatal"


def test_recovery_report_json_schema():
    rep = RecoveryReport()
    rep.retries = 2
    rep.record_fault("dispatch", 8, InjectedFault("dispatch", step=8))
    out = rep.to_json()
    assert set(out) == set(JReport().to_json())
    assert out["retries"] == 2
    assert out["faults"][0]["point"] == "dispatch"
    assert out["faults"][0]["step"] == 8
    assert "retries=2" in str(rep)
    json.dumps(out)


def test_report_for_range_matches_jax():
    def fill(r, err):
        r.retries, r.rollbacks = 1, 1
        r.record_fault("dispatch", 4, err("dispatch", step=4))
        r.record_fault("divergence", 11, err("x", step=11))
        return r

    got = fill(RecoveryReport(), InjectedFault)
    from repro.resilience.errors import InjectedFault as JFault
    want = fill(JReport(), JFault)
    for last in (None, 3, 7, 11):
        assert got.for_range(last).to_json() == \
            want.for_range(last).to_json()


def test_resilience_config_fields_and_ring():
    from dataclasses import fields
    assert [f.name for f in fields(ResilienceConfig)] == \
        [f.name for f in fields(JResilience)]
    assert ResilienceConfig() == ResilienceConfig(**{
        f.name: getattr(JResilience(), f.name)
        for f in fields(JResilience)})
    with pytest.raises(ValueError, match="ring"):
        ResilienceConfig(ring=0)


def test_chaos_cli_on_the_cpu(capsys, tmp_path):
    report = tmp_path / "r.json"
    assert chaos._main(["--device", "cpu", "--n", "4", "--iters", "12",
                        "--report", str(report)]) == 0
    out = json.loads(report.read_text())
    assert out["retries"] == 1 and out["rollbacks"] == 1
    assert [f["point"] for f in out["chaos"]["fired"]] == \
        ["dispatch", "carry_nan"]
    assert np.isfinite(out["final_cost"])
    assert json.loads(capsys.readouterr().out)["retries"] == 1
