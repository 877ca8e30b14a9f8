"""The port under a mesh, against its meshless solves and against the
JAX package's mesh runs: ``tests/test_distributed.py`` for
``repro_torch``.

Multi-rank runs are worlds of gloo ranks, each a subprocess of this
file (``python tests/test_torch_distributed.py rank <world> <rank>
<size> <dir>``) joined through a ``FileStore`` in the test's temporary
directory, every rank on the CPU with the same full inputs, as every
JAX shard sees the whole array.  The JAX package's own mesh runs happen
in one more subprocess with ``XLA_FLAGS=--xla_force_host_platform_
device_count=4`` (``python tests/test_torch_distributed.py jax
<dir>``), as ``tests/test_distributed.py::run_sub`` does.  Every world
is bounded: each rank's process group times out after 120 s and each
subprocess is killed after ``TIMEOUT`` seconds, so a hang fails the
test and never stops the suite.  The inputs are made once, from seeds,
with numpy and the JAX package's own draws (stamps, operator-norm start
vectors, the low-rank test matrices, SCDL's atom choice), and handed to
both packages.

Four ranks wherever the JAX test's mesh allows it: its (8,) data meshes
become (4,); its (4, 2) bundle mesh becomes (4, 1) and (2, 2)
``("data", "model")``; the collectives' (2, 4) ``("pod", "data")``
becomes (2, 2), and the pipeline's (4, 2) ``("stage", "data")`` (2, 2),
two stages of four layers (eight layers, as there).

Tolerances: deconvolution costs rtol 1e-4 (the JAX test's own 1e-3 is
only a ceiling) against the port's meshless solve and against JAX's
mesh solve; the sparse iterate rtol 1e-4 / atol 1e-6
(``tests/test_solve_many.py``).  The low-rank iterate is held within
5e-4 of its largest entry: the range finder's lambda^-1/2 magnifies the
rounding of a Gram summed in four parts, and the JAX package's own
four-device iterate lies 1.4e-6 from its one-device iterate (largest
entry 0.020).  The completion as ``tests/test_torch_lowrank.py`` holds
it (costs rtol 1e-4, the iterate within 1e-4 of its largest entry).
SCDL as the JAX test holds itself: costs rtol 5e-3 (atol 1e-3
ill-conditioned) and, well-conditioned, dictionaries rtol 1e-2 / atol
1e-3; the ill-conditioned dictionaries are held to nothing, as there:
the JAX package's own four-device dictionaries lie 0.050 from its
one-device ones.

Measured on the CPU (four ranks against meshless / against JAX's four
devices): sparse costs 8.6e-8 / 6.9e-7 relative, the iterate
bit-identical / 1.5e-8; low-rank costs 4.4e-7 / 9.6e-7, iterate
2.4e-6 / 7.1e-6; completion costs 3.3e-6 / 5.0e-6, iterate 8.3e-5 /
1.2e-4 (largest entry 5.0); SCDL costs 1.4e-4 / 3.9e-5 relative
(the JAX package's own four devices against one: 1.6e-4),
dictionaries 9.3e-5 / 3.2e-5; ill-conditioned costs 5.3e-4 / 8.2e-6
absolute (JAX's own: 3.7e-4).  The replicated state, the costs and
``Solution.x`` are the same bits on every rank.
"""
import datetime
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
RANKS = 4

N, S, SCALES, ITERS, CHUNK = 16, 21, 3, 12, 4
LR_RANK, LR_LAM = 8, 0.05
SCDL_K, SCDL_P, SCDL_M, SCDL_A, SCDL_ITERS = 256, 25, 9, 16, 8
COSTS = dict(rtol=1e-4)
ITERATE = dict(rtol=1e-4, atol=1e-6)
SCDL_COSTS = dict(rtol=5e-3)
SCDL_COSTS_ILL = dict(rtol=5e-3, atol=1e-3)
SCDL_DICTS = dict(rtol=1e-2, atol=1e-3)
LOWRANK_ITERATE = 5e-4            # of the iterate's largest entry


# =====================================================================
# Inputs (made in the test process, with the JAX package's draws)
# =====================================================================

def make_inputs():
    import jax
    import jax.numpy as jnp

    from repro.data.synthetic import coupled_patches
    from repro.imaging import lowrank as jlr
    from repro.imaging import psf as jpsf

    d = jpsf.simulate(N, jax.random.PRNGKey(2), stamp=S)
    Y, P = np.asarray(d.Y), np.asarray(d.psfs)
    ku, kv = jax.random.split(jax.random.PRNGKey(0))
    draws = dict(
        u0=np.asarray(jax.random.normal(ku, P.shape)),
        v0=np.asarray(jax.random.normal(kv, P.shape)),
        x0=np.asarray(jax.random.normal(jax.random.PRNGKey(0), (S, S))),
        noise=np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                           (8, 41, 41))))
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(9), 3)
    A = jax.random.normal(k1, (32, 3)) @ jax.random.normal(k2, (3, 24))
    M = (jax.random.uniform(k3, A.shape) < 0.7).astype(A.dtype)
    S_h, S_l = coupled_patches(SCDL_K, SCDL_P, SCDL_M, SCDL_A, seed=5)
    rng = np.random.RandomState(9)
    proto_h, proto_l = rng.randn(SCDL_P, 4), rng.randn(SCDL_M, 4)
    pick = rng.randint(0, 4, size=SCDL_K)
    amp = rng.rand(SCDL_K) + 0.5
    ill_h = np.asarray(jnp.asarray(proto_h[:, pick] * amp + 1e-3 *
                                   rng.randn(SCDL_P, SCDL_K), jnp.float32))
    ill_l = np.asarray(jnp.asarray(proto_l[:, pick] * amp + 1e-3 *
                                   rng.randn(SCDL_M, SCDL_K), jnp.float32))
    instances = []
    for n, seed in [(3, 10), (5, 11), (4, 12), (3, 13), (4, 14)]:
        di = jpsf.simulate(n, jax.random.PRNGKey(seed), stamp=16)
        instances.append((np.asarray(di.Y), np.asarray(di.psfs)))
    g = np.random.default_rng(0)
    return {
        "Y": Y, "P": P, "draws": draws,
        "omega": np.asarray(jlr.make_test_matrix(S * S, LR_RANK)),
        "A": np.asarray(A), "M": np.asarray(M),
        "omega_c": np.asarray(jlr.make_test_matrix(24, 6)),
        "S_h": np.asarray(S_h), "S_l": np.asarray(S_l),
        "ill_h": ill_h, "ill_l": ill_l,
        "idx": np.array(jax.random.choice(jax.random.PRNGKey(3), SCDL_K,
                                          (SCDL_A,), replace=False)),
        "instances": instances,
        "bundle": {"a": g.standard_normal((16, 5)).astype(np.float32),
                   "b": g.standard_normal((16, 3)).astype(np.float32)},
        "x_coll": g.standard_normal((16, 8)).astype(np.float32),
        "Ws": (g.standard_normal((2, 4, 16, 16)) * 0.3).astype(np.float32),
        "x_pipe": g.standard_normal((8, 16)).astype(np.float32),
    }


# =====================================================================
# The port's problems and runs (meshless here, under a mesh in a rank)
# =====================================================================

def _sparse(inp):
    from repro_torch.imaging.condat import SolverConfig
    from repro_torch.imaging.deconvolve import DeconvolutionProblem
    return DeconvolutionProblem(SolverConfig(mode="sparse",
                                             n_scales=SCALES),
                                **inp["draws"])


def _lowrank_deconv(inp):
    from repro_torch.imaging.condat import SolverConfig
    from repro_torch.imaging.deconvolve import DeconvolutionProblem
    return DeconvolutionProblem(
        SolverConfig(mode="lowrank", lam=LR_LAM, rank=LR_RANK),
        omega=inp["omega"], **inp["draws"])


def _completion(inp):
    from repro_torch.imaging.lowrank import (CompletionConfig,
                                             LowRankCompletionProblem)
    return LowRankCompletionProblem(
        CompletionConfig(rank=6, lam=0.05, max_iter=ITERS),
        omega=inp["omega_c"])


def _scdl(inp):
    from repro_torch.imaging.scdl import SCDLConfig, SCDLProblem
    return SCDLProblem(SCDLConfig(n_atoms=SCDL_A, max_iter=SCDL_ITERS),
                       idx=inp["idx"])


def _deconv_many_cfg():
    from repro_torch.imaging.condat import SolverConfig
    return SolverConfig(mode="sparse", n_scales=2, max_iter=24, tol=2e-3)


def port_runs(inp, mesh=None):
    """Every solve the tests compare, meshless or under ``mesh``:
    ``{name: (costs, x, iters_run)}``; SCDL's ``x`` is (Xh, Xl)."""
    from repro_torch.core.problem import solve, solve_many
    kw = dict(device="cpu", mesh=mesh, tol=0, chunk=CHUNK, max_iter=ITERS)
    out = {}

    def keep(name, sol):
        out[name] = (np.asarray(sol.log.costs), sol.x, sol.log.iters_run)
        return sol

    Y, P = inp["Y"], inp["P"]
    keep("sparse", solve(_sparse(inp), Y, P, cost_every=1, **kw))
    keep("sparse_chunk", solve(_sparse(inp), Y, P, cost_every="chunk", **kw))
    keep("lowrank_deconv", solve(_lowrank_deconv(inp), Y, P,
                                 cost_every="chunk", **kw))
    keep("completion", solve(_completion(inp), inp["A"], inp["M"],
                             cost_every=1, **kw))
    scdl_kw = dict(device="cpu", mesh=mesh, tol=0, chunk=4,
                   max_iter=SCDL_ITERS)
    sol = keep("scdl", solve(_scdl(inp), inp["S_h"], inp["S_l"], **scdl_kw))
    out["scdl_rep"] = {k: v.detach().cpu().numpy()
                       for k, v in _rep_leaves(sol.bundle.replicated)}
    keep("scdl_ill", solve(_scdl(inp), inp["ill_h"], inp["ill_l"],
                           **scdl_kw))
    lanes = []               # the instances still in the bucket, a chunk
    many = solve_many("deconvolve", inp["instances"], cfg=_deconv_many_cfg(),
                      device="cpu", mesh=mesh, chunk=4, cost_window=3,
                      recompact_below=0.9,
                      progress_fn=lambda e: lanes.append(len(e["instances"])))
    out["many"] = [(np.asarray(s.log.costs), s.x, s.log.iters_run,
                    s.log.converged_at) for s in many]
    out["many_lanes"] = lanes
    return out


def _rep_leaves(rep):
    for k in sorted(rep):
        v = rep[k]
        if isinstance(v, dict):
            yield from ((f"{k}.{kk}", v[kk]) for kk in sorted(v))
        else:
            yield k, v


# =====================================================================
# What each rank runs (a subprocess of this file)
# =====================================================================

def _world_main(rank: int, size: int, out: Path) -> dict:
    """Four ranks: every scenario of tests/test_distributed.py, the
    mesh solves, buckets, and a checkpoint written by four ranks."""
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.core import persistence
    from repro_torch.core.bundle import (Bundle, bundle_map,
                                         bundle_map_reduce, gather)
    from repro_torch.core.compat import axes_of
    from repro_torch.core.problem import solve
    from repro_torch.imaging.condat import SolverConfig
    from repro_torch.imaging.deconvolve import build_bundle
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    from repro_torch.parallel.collectives import (CompressedReducer,
                                                  hierarchical_psum_local)
    from repro_torch.parallel.pipeline import make_pipelined_forward

    inp = pickle.loads((out / "inputs.pkl").read_bytes())
    res = {}
    mesh = make_mesh((RANKS,), ("data",), device="cpu")

    # -- bundle: map and map-reduce against local, on (4, 1) and (2, 2)
    def f(d):
        return {"a": d["a"] * 2 + 1, "b": torch.tanh(d["b"])}

    def g(d):
        return {"gram": d["a"].T @ d["a"], "s": torch.sum(d["b"])}

    b_loc = Bundle.create(inp["bundle"], device="cpu")
    for shape in ((4, 1), (2, 2)):
        m = make_mesh(shape, ("data", "model"), device="cpu")
        b_dist = Bundle.create(inp["bundle"], device="cpu", mesh=m)
        res[f"bundle{shape}"] = {
            "parts": b_dist.n_partitions,
            "map": (gather(bundle_map(f, b_loc)),
                    gather(bundle_map(f, b_dist))),
            "reduce": ({k: v.numpy() for k, v in
                        bundle_map_reduce(g, b_loc).items()},
                       {k: v.numpy() for k, v in
                        bundle_map_reduce(g, b_dist).items()})}
    try:
        Bundle.create({"a": np.zeros((6, 2), np.float32)}, device="cpu",
                      mesh=mesh)
        res["indivisible"] = None
    except ValueError as e:
        res["indivisible"] = str(e)
    try:
        make_production_mesh(device="cpu")
        res["production"] = None
    except ValueError as e:
        res["production"] = str(e)

    # -- the scale-major leaves split on axis 1
    cfg = SolverConfig(mode="sparse", n_scales=SCALES)
    whole, _ = build_bundle(inp["Y"], inp["P"], cfg, device="cpu",
                            **inp["draws"])
    mine, _ = build_bundle(inp["Y"], inp["P"], cfg, device="cpu",
                           mesh=mesh, **inp["draws"])
    lo, hi = mine.record_range
    res["split"] = {
        "range": (lo, hi),
        "shapes": {k: tuple(v.shape) for k, v in mine.data.items()},
        "equal": all(torch.equal(
            v, whole.data[k].narrow(whole.record_axis(k), lo, hi - lo))
            for k, v in mine.data.items())}

    # -- the solves and the buckets
    res["runs"] = port_runs(inp, mesh)

    # -- collectives on (2, 2) ("pod", "data")
    m = make_mesh((2, 2), ("pod", "data"), device="cpu")
    part = axes_of(m, ("pod", "data"))
    x = torch.as_tensor(inp["x_coll"])
    xl = x.chunk(part.size)[part.rank]
    data, pod = axes_of(m, ("data",)), axes_of(m, ("pod",))
    from repro_torch.core.compat import pmean, psum
    flat = psum(psum(xl, data), pod)
    hier = hierarchical_psum_local(xl, m, pod_axis="pod", data_axis="data")
    red = CompressedReducer(m)
    mean, err = red.reduce_local({"g": xl}, red.init_error({"g": xl}))
    res["collectives"] = {"flat": flat.numpy(), "hier": hier.numpy(),
                          "exact": pmean(pmean(xl, data), pod).numpy(),
                          "approx": mean["g"].numpy(),
                          "error": err["g"].numpy()}

    # -- the pipeline on (2, 2) ("stage", "data")
    m = make_mesh((2, 2), ("stage", "data"), device="cpu")

    def layer_fn(wstack, h):
        for w in wstack:
            h = torch.tanh(h @ w)
        return h

    fwd = make_pipelined_forward(layer_fn, m, n_micro=4,
                                 data_axes=("data",))
    res["pipeline"] = fwd(torch.as_tensor(inp["Ws"]),
                          torch.as_tensor(inp["x_pipe"])).numpy()

    # -- checkpoints written by four ranks
    w = Bundle.create({"w": np.arange(64.0, dtype=np.float32).reshape(8, 8)},
                      device="cpu", mesh=mesh)
    ckpt.save(out / "elastic", 5, persistence.spill_bundle(w),
              shard=persistence.bundle_shard(w))
    solve(_sparse(inp), inp["Y"], inp["P"], device="cpu", mesh=mesh, tol=0,
          chunk=CHUNK, max_iter=8, cost_every=1,
          checkpoint_dir=out / "ckpt", checkpoint_every=4)
    return res


def _world_resume(rank: int, size: int, out: Path) -> dict:
    """Two ranks: the four-rank checkpoints restored, as records and as
    a resumed solve."""
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.core.problem import solve
    from repro_torch.launch.mesh import make_mesh

    inp = pickle.loads((out / "inputs.pkl").read_bytes())
    mesh = make_mesh((size,), ("data",), device="cpu")
    per = 8 // size
    like = {"data": {"w": torch.zeros(per, 8)}, "replicated": {}}
    block, _ = ckpt.restore(out / "elastic", 5, like,
                            records=(rank * per, (rank + 1) * per))
    sol = solve(_sparse(inp), inp["Y"], inp["P"], device="cpu", mesh=mesh,
                tol=0, chunk=CHUNK, max_iter=ITERS, cost_every=1,
                checkpoint_dir=out / "ckpt", resume=True)
    return {"block": block["data"]["w"].numpy(),
            "resumed": (np.asarray(sol.log.costs), sol.x,
                        sol.log.iters_run, sol.bundle.record_range)}


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
        dist.destroy_process_group()


def _jax_entry(out: Path) -> None:
    """The JAX package's mesh solves of the same inputs on four host
    devices."""
    import jax
    import jax.numpy as jnp
    assert len(jax.devices()) == RANKS

    from repro.core.problem import solve as jsolve
    from repro.imaging.condat import SolverConfig
    from repro.imaging.lowrank import CompletionConfig
    from repro.imaging.scdl import SCDLConfig
    from repro.launch.mesh import make_mesh

    inp = pickle.loads((out / "inputs.pkl").read_bytes())
    mesh = make_mesh((RANKS,), ("data",))
    kw = dict(mesh=mesh, tol=0, chunk=CHUNK, max_iter=ITERS)
    Y, P = jnp.asarray(inp["Y"]), jnp.asarray(inp["P"])
    res = {}

    def keep(name, sol):
        res[name] = (np.asarray(sol.log.costs), jax.tree.map(np.asarray,
                                                             sol.x))

    keep("sparse", jsolve("deconvolve", Y, P, cfg=SolverConfig(
        mode="sparse", n_scales=SCALES), cost_every=1, **kw))
    keep("sparse_chunk", jsolve("deconvolve", Y, P, cfg=SolverConfig(
        mode="sparse", n_scales=SCALES), cost_every="chunk", **kw))
    keep("lowrank_deconv", jsolve("deconvolve", Y, P, cfg=SolverConfig(
        mode="lowrank", lam=LR_LAM, rank=LR_RANK), cost_every="chunk",
        **kw))
    keep("completion", jsolve("lowrank", jnp.asarray(inp["A"]),
                              jnp.asarray(inp["M"]),
                              cfg=CompletionConfig(rank=6, lam=0.05),
                              cost_every=1, **kw))
    scdl_cfg = SCDLConfig(n_atoms=SCDL_A, max_iter=SCDL_ITERS)
    scdl_kw = dict(mesh=mesh, tol=0, chunk=4, max_iter=SCDL_ITERS)
    keep("scdl", jsolve("scdl", jnp.asarray(inp["S_h"]),
                        jnp.asarray(inp["S_l"]), cfg=scdl_cfg, **scdl_kw))
    keep("scdl_ill", jsolve("scdl", jnp.asarray(inp["ill_h"]),
                            jnp.asarray(inp["ill_l"]), cfg=scdl_cfg,
                            **scdl_kw))
    (out / "jax.pkl").write_bytes(pickle.dumps(res))


# =====================================================================
# Spawning (the test process)
# =====================================================================

def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra)
    env.pop("CUDA_VISIBLE_DEVICES", None)
    return env


def _start(args, env):
    return subprocess.Popen([sys.executable, str(Path(__file__)), *args],
                            env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(procs, what):
    """Wait for every process within ``TIMEOUT`` seconds in all; kill
    them all on a timeout or a failure."""
    outputs = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=TIMEOUT)
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


def _world(name, size, out):
    procs = [_start(["rank", name, str(r), str(size), str(out)],
                    _env(JAX_PLATFORMS="cpu"))
             for r in range(size)]
    return procs


def _load(out, name, size):
    return [pickle.loads((out / f"{name}_{r}.pkl").read_bytes())
            for r in range(size)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One four-rank world, the JAX mesh run beside it, then a two-rank
    world resuming the four ranks' checkpoints; the meshless solves of
    the same inputs run here meanwhile."""
    out = tmp_path_factory.mktemp("world")
    inp = make_inputs()
    (out / "inputs.pkl").write_bytes(pickle.dumps(inp))
    flags = ("--xla_force_host_platform_device_count=4 "
             + os.environ.get("XLA_FLAGS", ""))
    jax_proc = _start(["jax", str(out)],
                      _env(XLA_FLAGS=flags, JAX_PLATFORMS="cpu"))
    main = _world("main", RANKS, out)
    torch.set_num_threads(2)
    plain = port_runs(inp)
    _finish(main, "the four-rank world")
    resume = _world("resume", 2, out)
    _finish([jax_proc], "the JAX mesh run")
    _finish(resume, "the two-rank world")
    return {"inp": inp, "out": out, "plain": plain,
            "main": _load(out, "main", RANKS),
            "resume": _load(out, "resume", 2),
            "jax": pickle.loads((out / "jax.pkl").read_bytes())}


# =====================================================================
# Tests
# =====================================================================

@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_bundle_distributed_equals_local(runs, shape):
    """tests/test_distributed.py:34 on four ranks: ``bundle_map`` at rtol
    1e-6 and ``bundle_map_reduce`` at rtol 1e-5 against the meshless
    bundle, on every rank."""
    for res in runs["main"]:
        got = res[f"bundle{shape}"]
        assert got["parts"] == shape[0]
        out_l, out_d = got["map"]
        for k in out_l:
            np.testing.assert_allclose(out_d[k], out_l[k], rtol=1e-6)
        r_l, r_d = got["reduce"]
        np.testing.assert_allclose(r_d["gram"], r_l["gram"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r_d["s"], r_l["s"], rtol=1e-5)


def test_records_must_divide(runs):
    for res in runs["main"]:
        assert "not divisible into 4 partitions" in res["indivisible"]
        assert "needs 256 ranks" in res["production"]


def test_scale_major_leaves_split_on_their_record_axis(runs):
    """Each rank holds its quarter of the stamps: axis 0 of the
    record-major leaves, axis 1 of W, Xd and CX, equal to that block of
    the meshless bundle."""
    for rank, res in enumerate(runs["main"]):
        split = res["split"]
        per = N // RANKS
        assert split["range"] == (rank * per, (rank + 1) * per)
        assert split["equal"]
        for k in ("W", "Xd", "CX"):
            assert split["shapes"][k][:2] == (SCALES, per), k
        for k in ("Y", "Xp", "HX"):
            assert split["shapes"][k][:1] == (per,), k


def _close(got, want, rtol=1e-4):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _assert_deconv(name, got, want_costs, want_x):
    np.testing.assert_allclose(got[0], want_costs, **COSTS)
    if name == "lowrank_deconv":
        _close(got[1], want_x, LOWRANK_ITERATE)
    else:
        np.testing.assert_allclose(got[1], want_x, **ITERATE)


@pytest.mark.parametrize("name", ["sparse", "sparse_chunk",
                                  "lowrank_deconv"])
def test_psf_deconvolution_distributed_equals_sequential(runs, name):
    """tests/test_distributed.py:59 in both modes: the four-rank solve's
    costs and iterate against the meshless solve and against the JAX
    package's four-device solve, rtol 1e-4."""
    got = runs["main"][0]["runs"][name]
    plain = runs["plain"][name]
    assert got[2] == plain[2] == ITERS
    _assert_deconv(name, got, plain[0], plain[1])
    jc, jx = runs["jax"][name]
    _assert_deconv(name, got, jc, jx)


def test_completion_rows_split(runs):
    """``solve("lowrank", mesh=)``: the rows split over four ranks, the
    Gram and B = Q^T A summed; costs rtol 1e-4 and the iterate within
    1e-4 of its largest entry, against both."""
    got = runs["main"][0]["runs"]["completion"]
    for costs, x in (runs["plain"]["completion"][:2],
                     runs["jax"]["completion"]):
        np.testing.assert_allclose(got[0], costs, **COSTS)
        _close(got[1], np.asarray(x))


@pytest.mark.parametrize("name,costs_tol", [
    ("scdl", SCDL_COSTS), ("scdl_ill", SCDL_COSTS_ILL)])
def test_scdl_distributed_equals_sequential(runs, name, costs_tol):
    """tests/test_distributed.py:76, well- and ill-conditioned, against
    the meshless solve and the JAX package's four-device solve; the
    dictionaries where the reference holds them (well-conditioned)."""
    got = runs["main"][0]["runs"][name]
    for costs, dicts in (runs["plain"][name][:2], runs["jax"][name]):
        np.testing.assert_allclose(got[0], costs, **costs_tol)
        if name == "scdl":
            for g, w in zip(got[1], dicts):
                np.testing.assert_allclose(g, np.asarray(w), **SCDL_DICTS)


def test_replicated_state_is_the_same_bits_on_every_rank(runs):
    """Every rank factors the same all-reduced sums in the same
    deterministic operations: the SCDL dictionaries and solve factors,
    every cost trajectory and every gathered result agree bit for bit
    across the ranks."""
    first = runs["main"][0]["runs"]
    for res in runs["main"][1:]:
        other = res["runs"]
        for k, v in first["scdl_rep"].items():
            np.testing.assert_array_equal(other["scdl_rep"][k], v, err_msg=k)
        for name in ("sparse", "sparse_chunk", "lowrank_deconv",
                     "completion", "scdl", "scdl_ill"):
            np.testing.assert_array_equal(other[name][0], first[name][0])
            xs = other[name][1], first[name][1]
            for a, b in zip(*xs) if isinstance(xs[0], tuple) else [xs]:
                np.testing.assert_array_equal(a, b)


def test_solve_many_splits_instances_across_ranks(runs):
    """Five instances on four ranks (three filler lanes, never
    reported) against the meshless ``solve_many``: costs rtol 1e-4,
    equal ``iters_run`` and ``converged_at``; the lanes converge at
    different iterations, so the bucket re-compacts on the way."""
    got = runs["main"][0]["runs"]["many"]
    want = runs["plain"]["many"]
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g[2] == w[2] and g[3] == w[3]
        np.testing.assert_allclose(g[0], w[0], **COSTS)
        np.testing.assert_allclose(g[1], w[1], **ITERATE)
    assert len({w[2] for w in want}) > 1
    lanes = runs["main"][0]["runs"]["many_lanes"]
    assert lanes[0] == 5 and lanes[-1] < 5, lanes
    for res in runs["main"][1:]:
        for a, b in zip(res["runs"]["many"], got):
            np.testing.assert_array_equal(a[0], b[0])


def test_hierarchical_psum_and_compression(runs):
    """tests/test_distributed.py:107 on a (2, 2) ("pod", "data") mesh:
    the hierarchical schedule against the flat sum (rtol 1e-5), the
    compressed mean within 2 % of the exact mean."""
    for res in runs["main"]:
        c = res["collectives"]
        np.testing.assert_allclose(c["hier"], c["flat"], rtol=1e-5)
        err = np.abs(c["exact"] - c["approx"]).max()
        scale = np.abs(c["exact"]).max()
        assert err <= 0.02 * max(scale, 1e-6) + 1e-4, (err, scale)
    x = runs["inp"]["x_coll"]
    np.testing.assert_allclose(runs["main"][0]["collectives"]["flat"],
                               sum(x.reshape(4, 4, 8)), rtol=1e-5)


def test_pipeline_parallel_matches_sequential(runs):
    """tests/test_distributed.py:142 on a (2, 2) ("stage", "data") mesh:
    the pipelined forward of eight layers against the layers in
    sequence, rtol and atol 2e-4, on every rank."""
    inp = runs["inp"]
    ref = torch.as_tensor(inp["x_pipe"])
    for w in torch.as_tensor(inp["Ws"]).reshape(8, 16, 16):
        ref = torch.tanh(ref @ w)
    for res in runs["main"]:
        np.testing.assert_allclose(res["pipeline"], ref.numpy(), rtol=2e-4,
                                   atol=2e-4)


def test_elastic_checkpoint_restore_across_rank_counts(runs):
    """tests/test_distributed.py:172: a checkpoint written by four ranks
    restores whole in this process and block by block under two."""
    from repro_torch.checkpoint import checkpointer as ckpt
    want = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    out, _ = ckpt.restore(runs["out"] / "elastic", 5,
                          {"data": {"w": torch.zeros(8, 8)},
                           "replicated": {}})
    np.testing.assert_array_equal(out["data"]["w"].numpy(), want)
    np.testing.assert_array_equal(
        np.concatenate([r["block"] for r in runs["resume"]]), want)
    step = runs["out"] / "ckpt" / "step_00000008"
    assert sorted(p.name for p in step.iterdir()) == \
        [f"shard_{i:05d}" for i in range(RANKS)]


def test_resume_under_other_rank_counts(runs):
    """The four ranks' solve checkpointed at 8 iterations resumes to 12
    under two ranks and in this process alone; both equal the
    uninterrupted meshless run at rtol 1e-4."""
    from repro_torch.core.problem import solve
    inp = runs["inp"]
    want = runs["plain"]["sparse"]
    for res in runs["resume"]:
        costs, x, iters, _ = res["resumed"]
        assert iters == ITERS - 8
        np.testing.assert_allclose(costs, want[0][8:], **COSTS)
        np.testing.assert_allclose(x, want[1], **ITERATE)
    assert [r["resumed"][3] for r in runs["resume"]] == [(0, 8), (8, 16)]
    alone = solve(_sparse(inp), inp["Y"], inp["P"], device="cpu", tol=0,
                  chunk=CHUNK, max_iter=ITERS, cost_every=1,
                  checkpoint_dir=runs["out"] / "ckpt", resume=True)
    np.testing.assert_allclose(alone.log.costs, want[0][8:], **COSTS)
    np.testing.assert_allclose(alone.x, want[1], **ITERATE)


def test_make_mesh_needs_a_card_or_a_group():
    """``make_mesh`` without ``device=`` means the card and raises on a
    host without one; on the CPU it needs an initialized process group,
    and ``smallest_mesh`` is ``None`` without one."""
    from repro_torch.launch.mesh import make_mesh, smallest_mesh
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh((1,), ("data",))
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh((1,), ("data",), device="cpu")
    assert smallest_mesh(device="cpu") is None


def test_supervision_under_a_one_rank_mesh_is_the_meshless_run(tmp_path):
    """``resilience=`` with ``mesh=`` on a one-rank gloo mesh of this
    process, under a retried dispatch and a poisoned carry: the
    supervised solve and bucket equal their supervised runs without a
    mesh bit for bit, with the same report."""
    from repro_torch.core.problem import solve, solve_many
    from repro_torch.imaging.condat import SolverConfig
    from repro_torch.imaging.psf import simulate
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.resilience import chaos
    from repro_torch.resilience.recovery import ResilienceConfig
    d = simulate(8, torch.Generator().manual_seed(3), stamp=16,
                 device="cpu")
    insts = [(d.Y[:3], d.psfs[:3]), (d.Y[3:], d.psfs[3:])]
    kw = dict(cfg=SolverConfig(mode="sparse", n_scales=2), device="cpu",
              tol=0, chunk=CHUNK, max_iter=ITERS,
              resilience=ResilienceConfig())

    def both(mesh):
        plan = chaos.ChaosConfig.parse("dispatch@1;carry_nan@1;seed=7")
        with chaos.active_chaos(plan):
            one = solve("deconvolve", d.Y, d.psfs, mesh=mesh, **kw)
        with chaos.active_chaos(plan):
            many = solve_many("deconvolve", insts, mesh=mesh, **kw)
        return [one] + many

    want = both(None)
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "s"), 1),
                            timeout=datetime.timedelta(seconds=60))
    try:
        got = both(make_mesh((1,), ("data",), device="cpu"))
    finally:
        dist.destroy_process_group()
    for g, w in zip(got, want):
        assert g.log.costs == w.log.costs
        np.testing.assert_array_equal(g.x, w.x)
        assert g.recovery.to_json()["faults"] == \
            w.recovery.to_json()["faults"]
        assert (g.recovery.retries, g.recovery.rollbacks) == \
            (w.recovery.retries, w.recovery.rollbacks) == (1, 1)


if __name__ == "__main__":
    if sys.argv[1] == "rank":
        _rank_entry(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                    Path(sys.argv[5]))
    else:
        _jax_entry(Path(sys.argv[2]))
