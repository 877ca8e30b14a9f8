"""Supervision and serving under a mesh: ``resilience=`` with ``mesh=``,
and ``serve_http(mesh=)`` on rank 0 with ``serve.follow`` on the others.

The worlds are four gloo ranks, each a subprocess of this file (``python
tests/test_torch_distributed_supervised.py rank <world> <rank> <size>
<dir>``) joined through a ``FileStore``, every rank on the CPU with the
same full inputs (``tests/test_torch_distributed.py``'s, made once with
the JAX package's draws).  The JAX package's supervised four-device runs
of the same inputs under the same fault plan happen in one more
subprocess (``... jax <dir>``, ``XLA_FLAGS=--xla_force_host_platform_
device_count=4``).  Every world is bounded: each rank's process group
times out after 120 s, each subprocess is killed after ``TIMEOUT``
seconds, and a vote waits ``supervisor.VOTE_TIMEOUT_S`` seconds.

- ``main``: the four workloads supervised under
  ``dispatch@1;carry_nan@1;seed=7`` on every rank against the same world
  unsupervised (bit for bit), the report the same on every rank and its
  counts those of the JAX package's run, the costs against JAX at
  ``tests/test_torch_distributed.py``'s tolerances; the NaN on one
  rank's shard; a dispatch fault on one rank only; the vote
  (``kernel:jacobi@2`` on every rank); a dry ring with the newest
  checkpoint torn on one rank's shard; a supervised bucket of three;
  the service on rank 0 with the followers (one bucket of four
  requests, a cancel and a deadline in a second bucket, the
  poison-bucket drill); last, a fault after a collective on one rank
  only (the ranks' process groups end there).
- ``resume``: a new four-rank world resumes that run from its sharded
  checkpoints.
"""
import datetime
import os
import pickle
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_distributed as base  # noqa: E402

from repro_torch.resilience import supervisor  # noqa: E402

ROOT = base.ROOT
TIMEOUT = 240
RANKS = base.RANKS
SPEC = "dispatch@1;carry_nan@1;seed=7"
NAMES = ("sparse", "lowrank_deconv", "completion", "scdl")
MANY_SIZES = ((12, 10), (16, 11), (10, 12))
# the fault after a collective: the low-rank path's 31st Jacobi call
# (the setup makes a few, then an eigh and an svd an iteration), in its
# fourth chunk, past the checkpoints at 4 and 8
LATE = "kernel:jacobi@30;seed=7"
LATE_ITERS = 16
SERVE_OPTIONS = dict(max_iter=base.ITERS, chunk=base.CHUNK, cost_every=1,
                     tol=0.0)


# =====================================================================
# Inputs and runs
# =====================================================================

def make_inputs():
    import jax

    from repro.imaging import psf as jpsf
    inp = base.make_inputs()
    many = []
    for n, seed in MANY_SIZES:
        d = jpsf.simulate(n, jax.random.PRNGKey(seed), stamp=16)
        many.append((np.asarray(d.Y), np.asarray(d.psfs)))
    inp["many3"] = many
    return inp


def _problem(name, inp):
    return {"sparse": base._sparse, "lowrank_deconv": base._lowrank_deconv,
            "completion": base._completion, "scdl": base._scdl}[name](inp)


def _args(name, inp):
    if name == "completion":
        return inp["A"], inp["M"]
    if name == "scdl":
        return inp["S_h"], inp["S_l"]
    return inp["Y"], inp["P"]


def _kw(name, mesh=None):
    if name == "scdl":
        return dict(device="cpu", mesh=mesh, tol=0, chunk=4,
                    max_iter=base.SCDL_ITERS)
    every = "chunk" if name == "lowrank_deconv" else 1
    return dict(device="cpu", mesh=mesh, tol=0, chunk=base.CHUNK,
                max_iter=base.ITERS, cost_every=every)


def _run(name, inp, mesh=None, spec=None, supervised=False, **extra):
    from repro_torch.core.problem import solve
    from repro_torch.resilience import chaos
    from repro_torch.resilience.recovery import ResilienceConfig
    kw = dict(_kw(name, mesh), **extra)
    if supervised:
        kw["resilience"] = ResilienceConfig()
    plan = chaos.ChaosConfig.parse(spec) if spec is not None else None
    with chaos.active_chaos(plan):
        return solve(_problem(name, inp), *_args(name, inp), **kw)


def _many(inp, mesh=None, spec=None, supervised=False):
    from repro_torch.core.problem import solve_many
    from repro_torch.resilience import chaos
    from repro_torch.resilience.recovery import ResilienceConfig
    extra = {"resilience": ResilienceConfig()} if supervised else {}
    plan = chaos.ChaosConfig.parse(spec) if spec is not None else None
    with chaos.active_chaos(plan):
        return solve_many("deconvolve", inp["many3"],
                          cfg=base._deconv_many_cfg(), device="cpu",
                          mesh=mesh, chunk=base.CHUNK, tol=0,
                          max_iter=base.ITERS, **extra)


def _keep(sol):
    return {"costs": list(sol.log.costs), "x": sol.x,
            "iters": sol.log.iters_run,
            "cancelled_at": sol.log.cancelled_at,
            "recovery": (sol.recovery.to_json()
                         if sol.recovery is not None else None)}


# =====================================================================
# What each rank runs
# =====================================================================

def _world_main(rank: int, size: int, out: Path) -> dict:
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.resilience.errors import MeshFaultError

    inp = pickle.loads((out / "inputs.pkl").read_bytes())
    mesh = make_mesh((size,), ("data",), device="cpu")
    res = {}

    # -- every workload, the plan on every rank
    for name in NAMES:
        res[name] = {"plain": _keep(_run(name, inp, mesh)),
                     "sup": _keep(_run(name, inp, mesh, SPEC, True))}

    # -- a dispatch fault on rank 1 alone, before any collective
    spec = "dispatch@2;seed=7" if rank == 1 else ""
    res["local_dispatch"] = _keep(_run("sparse", inp, mesh, spec, True))

    # -- the vote: a Jacobi fault on every rank at the same call
    res["vote"] = _keep(_run("lowrank_deconv", inp, mesh,
                             "kernel:jacobi@2;seed=7", True))

    # -- a dry ring, the newest checkpoint torn on rank 1's shard
    from repro_torch.resilience import chaos
    from repro_torch.resilience.recovery import ResilienceConfig
    starts = []
    spec = "carry_nan@2,3;seed=7" + (";ckpt_corrupt@1" if rank == 1
                                     else "")
    with chaos.active_chaos(chaos.ChaosConfig.parse(spec)):
        from repro_torch.core.problem import solve
        sol = solve(_problem("sparse", inp), inp["Y"], inp["P"],
                    resilience=ResilienceConfig(ring=1),
                    checkpoint_dir=out / "dry", checkpoint_every=4,
                    progress_fn=lambda e: starts.append(e["start"]),
                    **_kw("sparse", mesh))
    res["dry"] = dict(_keep(sol), starts=starts)

    # -- a supervised bucket of three
    res["many"] = {"plain": [_keep(s) for s in _many(inp, mesh)],
                   "sup": [_keep(s) for s in _many(inp, mesh, SPEC,
                                                   True)]}

    # -- serving
    res["serve"] = _serve(rank, inp, mesh, out)

    # -- last: a fault after a collective on rank 2 alone
    t0 = time.perf_counter()
    try:
        _run("lowrank_deconv", inp, mesh, LATE if rank == 2 else "", True,
             cost_every=1, max_iter=LATE_ITERS,
             checkpoint_dir=out / "late", checkpoint_every=4)
        res["late"] = {"error": None}
    except MeshFaultError as e:
        res["late"] = {"error": str(e), "type": "MeshFaultError"}
    except Exception as e:
        res["late"] = {"error": str(e), "type": type(e).__name__}
    res["late"]["seconds"] = time.perf_counter() - t0
    return res


def _serve(rank: int, inp, mesh, out: Path) -> dict:
    """Rank 0 serves over HTTP and the other ranks follow: four requests
    in one bucket; then a bucket whose lanes end by a cancel and by
    deadlines; then the poison-bucket drill.  Afterwards every rank runs
    the first bucket with ``solve_many(mesh=)`` in the served lane
    order."""
    from repro_torch.core import compat
    from repro_torch.core.problem import solve_many
    from repro_torch.serve import drill, follow
    ctl = compat.control_of(mesh)
    insts = [(inp["Y"][a:a + 4], inp["P"][a:a + 4]) for a in (0, 4, 8, 12)]
    got = {}
    if rank == 0:
        got = _serve_rank0(insts, mesh)
        got["drill"] = drill.drill_poison_bucket(device="cpu", mesh=mesh)
    else:
        got["calls"] = [_summary(kind, r) for _ in range(2)
                        for kind, r in follow(mesh, device="cpu")]
    order = ctl.broadcast(got.get("order"))
    direct = solve_many("deconvolve", [insts[j] for j in order],
                        cfg=base._deconv_many_cfg(), device="cpu",
                        mesh=mesh, **SERVE_OPTIONS)
    got["direct"] = [_keep(s) for s in direct]
    got["order"] = order
    return got


def _summary(kind, result):
    if isinstance(result, Exception):
        return (kind, type(result).__name__)
    logs = result if isinstance(result, list) else [result]
    return (kind, [(list(g.costs), g.iters_run, g.cancelled_at)
                   for g in logs])


def _serve_rank0(insts, mesh) -> dict:
    from dataclasses import asdict

    from repro_torch.serve.client import ServeClient
    from repro_torch.serve.server import ServeConfig, serve_http
    cfg = asdict(base._deconv_many_cfg())
    handle = serve_http(ServeConfig(max_batch=4, batch_window_s=30.0),
                        mesh=mesh, device="cpu")
    try:
        client = ServeClient(handle.url, timeout=120)
        svc = handle.runner.service
        ids = [None] * len(insts)

        def send(j):
            ids[j] = client.submit("deconvolve", insts[j], cfg=cfg,
                                   options=SERVE_OPTIONS)

        threads = [threading.Thread(target=send, args=(j,))
                   for j in range(len(insts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        results = [client.result(rid, include_x=True, timeout=120)
                   for rid in ids]
        order = sorted(range(len(ids)),
                       key=lambda j: svc.records[ids[j]]._token)
        # a second bucket: one lane cancelled, two past their deadlines
        # (the tightest deadline last: a member's deadline dispatches an
        # open bucket early, at half its remaining budget)
        long = dict(SERVE_OPTIONS, max_iter=100_000)
        ctl_ids = [client.submit("deconvolve", insts[j], cfg=cfg,
                                 options=long,
                                 deadline_s=None if j == 0 else 6.0 - j)
                   for j in range(4)]
        while not svc.records[ctl_ids[0]].events:
            time.sleep(0.01)
        cancelled = client.cancel(ctl_ids[0])
        while not all(svc.records[i].done.is_set() for i in ctl_ids):
            time.sleep(0.05)
        frozen = sorted((svc.records[i] for i in ctl_ids),
                        key=lambda r: r._token)
        metrics = client.metrics()
    finally:
        handle.close()
    return {
        "results": [{k: r[k] for k in ("costs", "iters_run", "x",
                                       "batch_size", "bucket_key")}
                    for r in results],
        "order": order, "cancelled": cancelled,
        "frozen": [(r.status, r.error, r.solution.log.cancelled_at,
                    r.solution.log.iters_run) for r in frozen],
        "broadcast_s": metrics.get("input_broadcast_s"),
        "batches": metrics["batch_occupancy"]["batches"]}


def _world_resume(rank: int, size: int, out: Path) -> dict:
    """A new world resumes the run the mesh fault ended, and runs it
    uninterrupted beside."""
    from repro_torch.launch.mesh import make_mesh
    inp = pickle.loads((out / "inputs.pkl").read_bytes())
    mesh = make_mesh((size,), ("data",), device="cpu")
    kw = dict(cost_every=1, max_iter=LATE_ITERS)
    whole = _run("lowrank_deconv", inp, mesh, **kw)
    resumed = _run("lowrank_deconv", inp, mesh, supervised=True,
                   checkpoint_dir=out / "late", resume=True, **kw)
    return {"whole": _keep(whole), "resumed": _keep(resumed)}


WORLDS = {"main": _world_main, "resume": _world_resume}


def _rank_entry(world: str, rank: int, size: int, out: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", rank=rank, world_size=size,
        store=dist.FileStore(str(out / f"store_{world}"), size),
        timeout=datetime.timedelta(seconds=120))
    try:
        res = WORLDS[world](rank, size, out)
        (out / f"{world}_{rank}.pkl").write_bytes(pickle.dumps(res))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _jax_entry(out: Path) -> None:
    """The JAX package's supervised four-device runs of the same inputs
    under ``SPEC``."""
    import jax
    import jax.numpy as jnp
    assert len(jax.devices()) == RANKS

    from repro.core.problem import solve, solve_many
    from repro.imaging.condat import SolverConfig
    from repro.imaging.lowrank import CompletionConfig
    from repro.imaging.scdl import SCDLConfig
    from repro.launch.mesh import make_mesh
    from repro.resilience import chaos
    from repro.resilience.recovery import ResilienceConfig

    inp = pickle.loads((out / "inputs.pkl").read_bytes())
    mesh = make_mesh((RANKS,), ("data",))
    kw = dict(mesh=mesh, tol=0, chunk=base.CHUNK, max_iter=base.ITERS,
              resilience=ResilienceConfig())
    Y, P = jnp.asarray(inp["Y"]), jnp.asarray(inp["P"])
    runs = {
        "sparse": lambda: solve("deconvolve", Y, P, cfg=SolverConfig(
            mode="sparse", n_scales=base.SCALES), cost_every=1, **kw),
        "lowrank_deconv": lambda: solve("deconvolve", Y, P,
                                        cfg=SolverConfig(
                                            mode="lowrank", lam=base.LR_LAM,
                                            rank=base.LR_RANK),
                                        cost_every="chunk", **kw),
        "completion": lambda: solve("lowrank", jnp.asarray(inp["A"]),
                                    jnp.asarray(inp["M"]),
                                    cfg=CompletionConfig(rank=6, lam=0.05),
                                    cost_every=1, **kw),
        "scdl": lambda: solve("scdl", jnp.asarray(inp["S_h"]),
                              jnp.asarray(inp["S_l"]),
                              cfg=SCDLConfig(n_atoms=base.SCDL_A,
                                             max_iter=base.SCDL_ITERS),
                              **dict(kw, chunk=4, max_iter=base.SCDL_ITERS)),
        "many": lambda: solve_many(
            "deconvolve", [tuple(jnp.asarray(a) for a in i)
                           for i in inp["many3"]],
            cfg=SolverConfig(mode="sparse", n_scales=2, max_iter=24,
                             tol=2e-3), **dict(kw, tol=0)),
    }
    res = {}
    for name, run in runs.items():
        with chaos.active_chaos(chaos.ChaosConfig.parse(SPEC)):
            sol = run()
        sols = sol if isinstance(sol, list) else [sol]
        res[name] = [(np.asarray(s.log.costs), s.recovery.retries,
                      s.recovery.rollbacks) for s in sols]
    (out / "jax.pkl").write_bytes(pickle.dumps(res))


# =====================================================================
# Spawning
# =====================================================================

def _start(args, env):
    return subprocess.Popen([sys.executable, str(Path(__file__)), *args],
                            env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(procs, what):
    outputs = []
    t0 = time.monotonic()
    try:
        for p in procs:
            left = max(TIMEOUT - (time.monotonic() - t0), 1.0)
            text, _ = p.communicate(timeout=left)
            outputs.append(text)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"{what}: timed out after {TIMEOUT} s")
    bad = [(i, p.returncode, t[-3000:]) for i, (p, t) in
           enumerate(zip(procs, outputs)) if p.returncode != 0]
    assert not bad, f"{what} failed: {bad}"


def _world(name, out):
    return [_start(["rank", name, str(r), str(RANKS), str(out)],
                   base._env(JAX_PLATFORMS="cpu"))
            for r in range(RANKS)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The main world and the JAX runs side by side, the meshless solves
    here meanwhile, then the resuming world."""
    out = tmp_path_factory.mktemp("supervised")
    inp = make_inputs()
    (out / "inputs.pkl").write_bytes(pickle.dumps(inp))
    flags = ("--xla_force_host_platform_device_count=4 "
             + os.environ.get("XLA_FLAGS", ""))
    jax_proc = _start(["jax", str(out)],
                      base._env(XLA_FLAGS=flags, JAX_PLATFORMS="cpu"))
    main = _world("main", out)
    torch.set_num_threads(2)
    plain = {"many": [_keep(s) for s in _many(inp)],
             "serve": [_keep(_run_serve_meshless(inp, j))
                       for j in range(4)]}
    _finish(main, "the four-rank world")
    resume = _world("resume", out)
    _finish([jax_proc], "the JAX mesh runs")
    _finish(resume, "the resuming world")
    return {"inp": inp, "plain": plain,
            "main": base._load(out, "main", RANKS),
            "resume": base._load(out, "resume", RANKS),
            "jax": pickle.loads((out / "jax.pkl").read_bytes())}


def _run_serve_meshless(inp, j):
    from repro_torch.core.problem import solve
    a = 4 * j
    return solve("deconvolve", inp["Y"][a:a + 4], inp["P"][a:a + 4],
                 cfg=base._deconv_many_cfg(), device="cpu",
                 **SERVE_OPTIONS)


# =====================================================================
# Tests
# =====================================================================

def _same(a, b):
    return a["costs"] == b["costs"] and all(
        np.array_equal(x, y) for x, y in zip(
            a["x"] if isinstance(a["x"], tuple) else [a["x"]],
            b["x"] if isinstance(b["x"], tuple) else [b["x"]]))


@pytest.mark.parametrize("name", NAMES)
def test_supervised_mesh_run_is_bit_identical_to_unsupervised(runs, name):
    """The plan fires on every rank: a retried dispatch and a NaN on one
    rank's shard, rolled back; costs and iterate bit-identical to the
    same world unsupervised, on every rank."""
    for res in runs["main"]:
        assert _same(res[name]["sup"], res[name]["plain"]), name


@pytest.mark.parametrize("name", NAMES)
def test_report_is_the_same_on_every_rank(runs, name):
    reports = [res[name]["sup"]["recovery"] for res in runs["main"]]
    assert all(r == reports[0] for r in reports[1:])
    assert reports[0]["kernel_fallbacks"] == []


@pytest.mark.parametrize("name", NAMES)
def test_report_counts_equal_the_jax_mesh_run(runs, name):
    """1 retry and 1 rollback, as the JAX package's supervised
    four-device run of the same spec reports."""
    rep = runs["main"][0][name]["sup"]["recovery"]
    (_, retries, rollbacks), = runs["jax"][name]
    assert (rep["retries"], rep["rollbacks"]) == (retries, rollbacks) \
        == (1, 1)


@pytest.mark.parametrize("name", NAMES)
def test_supervised_costs_against_the_jax_mesh_run(runs, name):
    """At ``tests/test_torch_distributed.py``'s tolerances."""
    got = np.asarray(runs["main"][0][name]["sup"]["costs"])
    want = runs["jax"][name][0][0]
    tol = {"scdl": base.SCDL_COSTS}.get(name, base.COSTS)
    np.testing.assert_allclose(got, want, **tol)


def test_nan_on_one_shard_rolls_every_rank_back(runs):
    """``carry_nan`` draws its element in the global leaf: one rank's
    shard holds it, the verdict summed over the ranks rolls all four
    back together, and the report names that rank alone."""
    rep = runs["main"][0]["sparse"]["sup"]["recovery"]
    div = [f for f in rep["faults"] if f["point"] == "divergence"]
    assert len(div) == 1 and rep["rollbacks"] == 1
    assert "non-finite" in div[0]["error"]
    ranks = [f"[{r}] of {RANKS}" in div[0]["error"] for r in range(RANKS)]
    assert sum(ranks) == 1, div[0]["error"]


def test_dispatch_fault_on_one_rank_is_retried_there(runs):
    """The plan active on rank 1 alone: the fault comes before the
    chunk's first collective, so rank 1 retries alone while the others
    wait; bit-identical, and every rank reports one retry naming rank
    1."""
    for res in runs["main"]:
        got = res["local_dispatch"]
        assert _same(got, res["sparse"]["plain"])
        rep = got["recovery"]
        assert rep == runs["main"][0]["local_dispatch"]["recovery"]
        assert rep["retries"] == 1 and rep["rollbacks"] == 0
        assert [(f["point"], f.get("rank")) for f in rep["faults"]] == \
            [("dispatch", 1)]


def test_fault_on_every_rank_after_a_collective_goes_to_the_vote(runs):
    """``kernel:jacobi@2`` fires on every rank past the chunk's first
    collective: all vote, all retry from the ring, bit-identical; the
    retry counts once."""
    for res in runs["main"]:
        got = res["vote"]
        assert _same(got, res["lowrank_deconv"]["plain"])
        rep = got["recovery"]
        assert rep["retries"] == 1
        assert [f.get("rank") for f in rep["faults"]] == [None]


def test_fault_on_one_rank_after_a_collective_raises_everywhere(runs):
    """Rank 2 alone meets the fault past a collective: its vote times
    out and it raises ``MeshFaultError``; the others raise it too, each
    within the vote's bound (not the process group's 120 s)."""
    for rank, res in enumerate(runs["main"]):
        late = res["late"]
        assert late["type"] == "MeshFaultError", late
        assert "rank 2" in late["error"]
        assert late["seconds"] < supervisor.VOTE_TIMEOUT_S + 30, late


def test_resume_after_a_mesh_fault_is_bit_identical(runs):
    """A new four-rank world resumes from the sharded checkpoints the
    faulted run left and ends bit-identical to the run uninterrupted."""
    for res in runs["resume"]:
        whole, resumed = res["whole"], res["resumed"]
        n = len(resumed["costs"])
        assert 0 < n < LATE_ITERS
        assert resumed["costs"] == whole["costs"][-n:]
        assert np.array_equal(resumed["x"], whole["x"])


def test_dry_ring_and_a_torn_shard_restore_the_same_older_step(runs):
    """A ring of one and two poisoned chunks in a row leave the disk;
    step 8 is torn on rank 1's shard alone, so every rank restores step
    4 (the chunk events restart there), bit-identical."""
    for res in runs["main"]:
        dry = res["dry"]
        assert dry["starts"] == [0, 4, 4, 8], dry["starts"]
        rep = dry["recovery"]
        assert rep["checkpoint_restores"] == 1 and rep["rollbacks"] == 2
        assert _same(dry, res["sparse"]["plain"])
        assert rep == runs["main"][0]["dry"]["recovery"]


def test_supervised_bucket_under_the_mesh(runs):
    """Three instances over four ranks (a filler lane): each
    bit-identical to the unsupervised bucket, each reporting (1 retry,
    1 rollback) as the JAX package's bucket does, on every rank."""
    jax_many = runs["jax"]["many"]
    for res in runs["main"]:
        for sup, plain, (_, retries, rollbacks) in zip(
                res["many"]["sup"], res["many"]["plain"], jax_many):
            assert _same(sup, plain)
            rep = sup["recovery"]
            assert (rep["retries"], rep["rollbacks"]) == \
                (retries, rollbacks) == (1, 1)
            assert rep == runs["main"][0]["many"]["sup"][0]["recovery"]
    for got, want in zip(runs["main"][0]["many"]["plain"],
                         runs["plain"]["many"]):
        np.testing.assert_allclose(got["costs"], want["costs"], **base.COSTS)


def test_served_bucket_equals_solve_many_under_the_mesh(runs):
    """Four HTTP requests to rank 0, the other ranks following: one
    bucket, each result bit-identical to ``solve_many(mesh=)`` in the
    same world on the same arrays in the served lane order."""
    s0 = runs["main"][0]["serve"]
    assert {r["batch_size"] for r in s0["results"]} == {4}
    assert len({r["bucket_key"] for r in s0["results"]}) == 1
    order = s0["order"]
    for pos, j in enumerate(order):
        got = {"costs": s0["results"][j]["costs"],
               "x": s0["results"][j]["x"]}
        assert _same(got, s0["direct"][pos]), j
    for res in runs["main"][1:]:
        assert res["serve"]["order"] == order
        kind, lanes = res["serve"]["calls"][0]
        assert kind == "solve_many"
        assert [c for c, _, _ in lanes] == [d["costs"]
                                            for d in s0["direct"]]
    assert len(s0["broadcast_s"]) >= 2 and \
        all(t >= 0 for t in s0["broadcast_s"])


def test_served_bucket_within_rtol_of_the_meshless_solve(runs):
    s0 = runs["main"][0]["serve"]
    for got, want in zip(s0["results"], runs["plain"]["serve"]):
        np.testing.assert_allclose(got["costs"], want["costs"], rtol=1e-4)
        np.testing.assert_allclose(got["x"], want["x"], **base.ITERATE)


def test_cancel_and_deadline_freeze_the_same_lane_on_every_rank(runs):
    """Rank 0 decides each chunk boundary's lane control and broadcasts
    it: the cancelled lane and the expired ones stop at the same
    iteration on every rank."""
    s0 = runs["main"][0]["serve"]
    assert s0["cancelled"]
    statuses = [st for st, _, _, _ in s0["frozen"]]
    assert statuses[0] == "cancelled"
    assert statuses[1:] == ["failed"] * 3
    stops = [(at, it) for _, _, at, it in s0["frozen"]]
    assert all(at is not None and it < 100_000 for at, it in stops)
    for res in runs["main"][1:]:
        kind, lanes = res["serve"]["calls"][1]
        assert kind == "solve_many"
        assert [(at, it) for _, it, at in lanes] == stops


def test_poison_bucket_drill_under_the_mesh(runs):
    """``serve_bucket_poison`` under the mesh: the bucket fails on every
    rank together, rank 0 quarantines it, each lane re-runs solo across
    the mesh and only the poisoned one fails."""
    drill = runs["main"][0]["serve"]["drill"]
    assert drill["counters"]["quarantined"] == 1
    assert drill["poisoned"]["recovery"]["rollbacks"] >= 1
    assert len(drill["siblings_done"]) == 2
    for res in runs["main"][1:]:
        kinds = [k for k, _ in res["serve"]["calls"][2:]]
        assert kinds == ["solve_many"] + ["quarantine"] * 3, kinds


# =====================================================================
# The control plane in one process (a one-rank gloo world)
# =====================================================================

@pytest.fixture
def one_rank(tmp_path):
    from repro_torch.core import compat
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "s"), 1),
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh((1,), ("data",), device="cpu")
        yield mesh, compat.control_of(mesh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_watch_of_a_peer_fault_ends_the_supervised_run(one_rank):
    """The watch an NCCL mesh runs (started here by hand on gloo, where
    there is no communicator to abort): a peer's tear-down sets this
    rank's watch key, the watch records the reason, and the supervised
    run raises ``MeshFaultError`` at its next chunk's end and tears the
    groups down."""
    from repro_torch.core import compat
    from repro_torch.core.problem import solve
    from repro_torch.imaging.condat import SolverConfig
    from repro_torch.imaging.psf import simulate
    from repro_torch.resilience.errors import MeshFaultError
    from repro_torch.resilience.recovery import ResilienceConfig
    mesh, ctl = one_rank
    ctl.watch = threading.Thread(target=compat._watch,
                                 args=(ctl, ctl.store.clone()), daemon=True)
    ctl.watch.start()
    d = simulate(8, torch.Generator().manual_seed(3), stamp=16,
                 device="cpu")
    starts = []

    def peer_faults(event):
        starts.append(event["start"])
        if len(starts) == 1:
            # what tear_down on another rank sets
            ctl.store.set(ctl.key("watch", ctl.rank), "rank 3: lost")
            t0 = time.monotonic()
            while ctl.aborted is None and time.monotonic() - t0 < 30:
                time.sleep(0.01)

    with pytest.raises(MeshFaultError, match="rank 3: lost"):
        solve("deconvolve", d.Y, d.psfs,
              cfg=SolverConfig(mode="sparse", n_scales=2), device="cpu",
              mesh=mesh, tol=0, chunk=4, max_iter=12,
              resilience=ResilienceConfig(), progress_fn=peer_faults)
    assert starts == [0]
    ctl.watch.join(timeout=30)
    assert not ctl.watch.is_alive()
    assert not dist.is_initialized()


def test_tear_down_wakes_a_follower_waiting_for_a_dispatch(one_rank):
    """A follower blocks in the store's own wait for the next dispatch
    (no polling); ``tear_down`` sets that key to its reason, so the
    follower raises ``MeshFaultError`` at once."""
    from repro_torch.core import compat
    from repro_torch.resilience.errors import MeshFaultError
    _, ctl = one_rank
    got = []

    def wait():
        try:
            ctl.await_dispatch()
            got.append(None)
        except MeshFaultError as e:
            got.append(str(e))

    follower = threading.Thread(target=wait, daemon=True)
    follower.start()
    time.sleep(0.2)
    assert not got
    t0 = time.monotonic()
    compat.tear_down("rank 0: gone")
    follower.join(timeout=30)
    assert got == ["rank 0: gone"]
    assert time.monotonic() - t0 < 10


if __name__ == "__main__":
    if sys.argv[1] == "rank":
        _rank_entry(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                    Path(sys.argv[5]))
    else:
        _jax_entry(Path(sys.argv[2]))
