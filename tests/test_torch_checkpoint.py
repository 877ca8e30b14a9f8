"""The port's checkpoints: ``solve(checkpoint_dir=, checkpoint_every=,
resume=)``, ``repro_torch.checkpoint`` and ``core.persistence``.

Mirrors ``tests/test_persistence_guards.py`` and the checkpoint tests of
``tests/test_problem_api.py`` (the round trips, the meta guards on
workload and config, the ``ValueError``s for arguments that would read or
write nothing), then adds what the port must show itself:

- a resume is bit-exact within the port for all three workloads,
  including SCDL's replicated carry (dictionaries and solve factors),
  the low-rank test matrix Omega in ``replicated``, and a resume off the
  cost grid (``cost_every=3``, resumed at 10, whose first evaluated cost
  is the +inf seed, as in the JAX package);
- a torn newest checkpoint falls back with a ``RuntimeWarning``;
- retention keeps three; a writer failure surfaces at the next sync;
- every workload's step writes out of place, which is what lets the
  checkpoint spill run behind the next chunk without a host sync;
- the write-ahead log.

Against the JAX package: a resumed deconvolution continues the JAX
package's own resumed trajectory at rtol 1e-4 (costs, as in
``tests/test_solve_many.py``), with the JAX draws handed to the port.
Within the port the tolerance is zero: a resume replays the same
operations on the same values.  A checkpoint written by one package need
not load in the other.
"""
import json
import os
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.problem import solve as jsolve
from repro.imaging import psf as jpsf
from repro.imaging.condat import SolverConfig as JConfig
from repro_torch.checkpoint import (Checkpointer, CheckpointCorruptError,
                                    CheckpointWriteError, WriteAheadLog,
                                    latest_step, latest_valid_step, restore,
                                    save, validate_checkpoint)
from repro_torch.core import persistence
from repro_torch.core.problem import solve
from repro_torch.data.synthetic import coupled_patches
from repro_torch.imaging import deconvolve
from repro_torch.imaging.condat import SolverConfig
from repro_torch.imaging.lowrank import CompletionConfig
from repro_torch.imaging.scdl import SCDLConfig

torch.set_num_threads(2)

N, S = 8, 21


@pytest.fixture(scope="module")
def psf_data():
    """JAX-simulated stamps and the draws JAX's step sizes make."""
    d = jpsf.simulate(N, jax.random.PRNGKey(11), stamp=S)
    Y, P = np.asarray(d.Y), np.asarray(d.psfs)
    ku, kv = jax.random.split(jax.random.PRNGKey(0))
    draws = dict(
        u0=np.asarray(jax.random.normal(ku, P.shape)),
        v0=np.asarray(jax.random.normal(kv, P.shape)),
        x0=np.asarray(jax.random.normal(jax.random.PRNGKey(0), (S, S))),
        noise=np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                           (8, 41, 41))))
    return Y, P, draws


@pytest.fixture(scope="module")
def scdl_data():
    return coupled_patches(256, 25, 9, 16, torch.Generator().manual_seed(13),
                           device="cpu")


def _deconv(draws, **cfg):
    base = dict(mode="sparse", n_scales=3)
    base.update(cfg)
    return deconvolve.DeconvolutionProblem(SolverConfig(**base), **draws)


def _write_deconv_ckpt(tmp_path, psf_data, name, **cfg):
    Y, P, draws = psf_data
    d = tmp_path / name
    solve(_deconv(draws, max_iter=4, **cfg), Y, P, device="cpu", chunk=4,
          tol=0, checkpoint_dir=d, checkpoint_every=4)
    return d


# ----------------------------------------------------- guards (both ways)
def test_deconvolve_checkpoint_refuses_scdl_resume(tmp_path, psf_data,
                                                   scdl_data):
    d = _write_deconv_ckpt(tmp_path, psf_data, "ckpt_rev_workload")
    S_h, S_l = scdl_data
    with pytest.raises(ValueError, match="meta"):
        solve("scdl", S_h, S_l, cfg=SCDLConfig(n_atoms=16, max_iter=6),
              device="cpu", chunk=4, tol=0, checkpoint_dir=d, resume=True)


def test_deconvolve_config_change_refused_on_resume(tmp_path, psf_data):
    Y, P, draws = psf_data
    d = _write_deconv_ckpt(tmp_path, psf_data, "ckpt_deconv_cfg")
    with pytest.raises(ValueError, match="meta"):
        solve(_deconv(draws, max_iter=8, lam=0.5), Y, P, device="cpu",
              chunk=4, tol=0, checkpoint_dir=d, resume=True)


def test_deconvolve_run_control_change_accepted_on_resume(tmp_path,
                                                          psf_data):
    Y, P, draws = psf_data
    d = _write_deconv_ckpt(tmp_path, psf_data, "ckpt_deconv_extend")
    rest = solve(_deconv(draws, max_iter=8, tol=1e-9), Y, P, device="cpu",
                 chunk=4, tol=0, checkpoint_dir=d, resume=True)
    assert len(rest.log.costs) == 4        # iterations 4..8 only


def test_scdl_config_change_refused_both_directions(tmp_path, scdl_data):
    S_h, S_l = scdl_data
    d = tmp_path / "ckpt_scdl_rev"
    solve("scdl", S_h, S_l, cfg=SCDLConfig(n_atoms=16, max_iter=4,
                                           lam_h=0.5),
          device="cpu", chunk=4, tol=0, checkpoint_dir=d,
          checkpoint_every=4)
    with pytest.raises(ValueError, match="meta"):
        solve("scdl", S_h, S_l, cfg=SCDLConfig(n_atoms=16, max_iter=8),
              device="cpu", chunk=4, tol=0, checkpoint_dir=d, resume=True)


def test_resumed_trajectory_continues_exactly(tmp_path, psf_data):
    """A resume continues the uninterrupted run's trajectory bit for bit,
    and the JAX package's resumed trajectory at rtol 1e-4."""
    Y, P, draws = psf_data
    full = solve(_deconv(draws, max_iter=8), Y, P, device="cpu", chunk=4,
                 tol=0)
    d = _write_deconv_ckpt(tmp_path, psf_data, "ckpt_traj")
    rest = solve(_deconv(draws, max_iter=8), Y, P, device="cpu", chunk=4,
                 tol=0, checkpoint_dir=d, resume=True)
    assert rest.log.costs == full.costs[4:]
    np.testing.assert_array_equal(rest.x, full.x)
    jcfg = JConfig(mode="sparse", n_scales=3, max_iter=8)
    jd = tmp_path / "jax_traj"
    jsolve("deconvolve", Y, P, cfg=JConfig(mode="sparse", n_scales=3,
                                           max_iter=4),
           chunk=4, tol=0, checkpoint_dir=jd, checkpoint_every=4)
    jrest = jsolve("deconvolve", Y, P, cfg=jcfg, chunk=4, tol=0,
                   checkpoint_dir=jd, resume=True)
    np.testing.assert_allclose(rest.log.costs, jrest.log.costs, rtol=1e-4)


# ------------------------------------------- round trips (problem_api)
def test_checkpoint_roundtrip_scdl(tmp_path, scdl_data):
    """The broadcast carry (dictionaries and solve factors) rides the
    checkpoint: the resumed run is the uninterrupted one, bit for bit."""
    S_h, S_l = scdl_data
    cfg = SCDLConfig(n_atoms=16, max_iter=12)
    full = solve("scdl", S_h, S_l, cfg=cfg, device="cpu", chunk=4, tol=0)
    d = tmp_path / "ckpt_scdl"
    part = solve("scdl", S_h, S_l, cfg=cfg, device="cpu", chunk=4, tol=0,
                 max_iter=8, checkpoint_dir=d, checkpoint_every=4)
    assert len(part.log.costs) == 8
    assert sorted(p.name for p in d.iterdir()) == [
        "step_00000004", "step_00000008"]
    rest = solve("scdl", S_h, S_l, cfg=cfg, device="cpu", chunk=4, tol=0,
                 max_iter=12, checkpoint_dir=d, resume=True)
    assert rest.log.costs == full.log.costs[8:]
    for a, b in zip(rest.x, full.x):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_roundtrip_deconvolve(tmp_path, psf_data):
    """A workload whose iterate is all data-side, resumed from an explicit
    step."""
    Y, P, draws = psf_data
    d = tmp_path / "ckpt_psf"
    full = solve(_deconv(draws), Y, P, device="cpu", max_iter=12, tol=0,
                 chunk=4)
    solve(_deconv(draws), Y, P, device="cpu", max_iter=8, tol=0, chunk=4,
          checkpoint_dir=d, checkpoint_every=8)
    rest = solve(_deconv(draws), Y, P, device="cpu", max_iter=12, tol=0,
                 chunk=4, checkpoint_dir=d, resume=8)
    assert rest.log.costs == full.log.costs[8:]
    np.testing.assert_array_equal(rest.x, full.x)


def test_checkpoint_meta_guards_workload(tmp_path, psf_data, scdl_data):
    Y, P, draws = psf_data
    S_h, S_l = scdl_data
    d = tmp_path / "ckpt_guard"
    solve("scdl", S_h, S_l, cfg=SCDLConfig(n_atoms=16, max_iter=4),
          device="cpu", chunk=4, tol=0, checkpoint_dir=d,
          checkpoint_every=4)
    with pytest.raises(ValueError, match="meta"):
        solve(_deconv(draws), Y, P, device="cpu", max_iter=6, tol=0,
              checkpoint_dir=d, resume=True)


def test_checkpoint_meta_guards_config(tmp_path, scdl_data):
    S_h, S_l = scdl_data
    d = tmp_path / "ckpt_cfg"
    solve("scdl", S_h, S_l, cfg=SCDLConfig(n_atoms=16, max_iter=4),
          device="cpu", chunk=4, tol=0, checkpoint_dir=d,
          checkpoint_every=4)
    with pytest.raises(ValueError, match="meta"):
        solve("scdl", S_h, S_l,
              cfg=SCDLConfig(n_atoms=16, max_iter=8, lam_h=0.5),
              device="cpu", chunk=4, tol=0, checkpoint_dir=d, resume=True)
    rest = solve("scdl", S_h, S_l, cfg=SCDLConfig(n_atoms=16, max_iter=6),
                 device="cpu", chunk=4, tol=0, checkpoint_dir=d,
                 resume=True)
    assert len(rest.log.costs) == 2  # iterations 4..6


def test_resume_missing_step_raises(tmp_path, scdl_data):
    S_h, S_l = scdl_data
    d = tmp_path / "ckpt_step"
    solve("scdl", S_h, S_l, cfg=SCDLConfig(n_atoms=16, max_iter=4),
          device="cpu", chunk=4, tol=0, checkpoint_dir=d,
          checkpoint_every=4)
    with pytest.raises(ValueError, match="latest saved step"):
        solve("scdl", S_h, S_l, cfg=SCDLConfig(n_atoms=16, max_iter=8),
              device="cpu", chunk=4, tol=0, checkpoint_dir=d, resume=12)


def test_resume_without_dir_raises(psf_data):
    Y, P, draws = psf_data
    with pytest.raises(ValueError, match="checkpoint_dir"):
        solve(_deconv(draws), Y, P, device="cpu", resume=True)


def test_resume_from_empty_dir_raises(tmp_path, psf_data):
    Y, P, draws = psf_data
    with pytest.raises(ValueError, match="no checkpoints"):
        solve(_deconv(draws), Y, P, device="cpu",
              checkpoint_dir=tmp_path / "nowhere", resume=True)


def test_checkpoint_every_without_dir_raises(psf_data):
    Y, P, draws = psf_data
    with pytest.raises(ValueError, match="checkpoint_dir"):
        solve(_deconv(draws), Y, P, device="cpu", max_iter=4,
              checkpoint_every=2)


def test_checkpoint_dir_without_cadence_or_resume_raises(tmp_path,
                                                         psf_data):
    Y, P, draws = psf_data
    with pytest.raises(ValueError, match="checkpoint_every"):
        solve(_deconv(draws), Y, P, device="cpu", max_iter=4,
              checkpoint_dir=tmp_path / "ckpt")


# --------------------------------- bit-exact resumes, every workload
def _workload(name):
    rng = np.random.default_rng(21)
    if name == "scdl":
        S_h, S_l = coupled_patches(128, 25, 9, 8,
                                   torch.Generator().manual_seed(5),
                                   device="cpu")
        return "scdl", (S_h, S_l), SCDLConfig(n_atoms=8)
    if name == "completion":
        A = (rng.normal(size=(24, 3)) @ rng.normal(size=(3, 16))).astype(
            np.float32)
        M = (rng.random(A.shape) < 0.6).astype(np.float32)
        return "lowrank", (A * M, M), CompletionConfig(rank=4, lam=0.1)
    from repro_torch.imaging import psf
    d = psf.simulate(6, torch.Generator().manual_seed(8), stamp=13,
                     device="cpu")
    mode = "lowrank" if name == "lowrank_deconvolve" else "sparse"
    return "deconvolve", (d.Y, d.psfs), SolverConfig(mode=mode, n_scales=2,
                                                     rank=3)


WORKLOADS = ["sparse", "lowrank_deconvolve", "scdl", "completion"]


@pytest.mark.parametrize("name", WORKLOADS)
@pytest.mark.parametrize("cost_every", [1, "chunk"])
def test_resume_is_bit_exact(tmp_path, name, cost_every):
    """Checkpoint at 8 of 16 and resume: the costs of iterations 8-15
    and the final iterate equal the uninterrupted run's, bit for bit.
    Under ``cost_every="chunk"`` the first resumed chunk repeats the
    carried objective in its first K - 1 slots, and a resume carries the
    +inf seed there (the JAX package's convention)."""
    key, inputs, cfg = _workload(name)
    kw = dict(cfg=cfg, device="cpu", tol=0.0, chunk=4,
              cost_every=cost_every)
    full = solve(key, *inputs, max_iter=16, **kw)
    solve(key, *inputs, max_iter=8, checkpoint_dir=tmp_path,
          checkpoint_every=8, **kw)
    rest = solve(key, *inputs, max_iter=16, checkpoint_dir=tmp_path,
                 resume=True, **kw)
    want = list(full.log.costs[8:])
    if cost_every == "chunk":
        want[:3] = [float("inf")] * 3
    assert rest.log.costs == want
    xs = rest.x if isinstance(rest.x, tuple) else (rest.x,)
    ys = full.x if isinstance(full.x, tuple) else (full.x,)
    for a, b in zip(xs, ys):
        np.testing.assert_array_equal(a, b)
    for k, v in full.bundle.replicated.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(rest.bundle.replicated[k], v), k


def test_resume_off_the_cost_grid(tmp_path):
    """``cost_every=3`` resumed at 10 (off the grid): the carried cost is
    seeded with +inf, which iterations 10 and 11 log, as the JAX package
    does; from 12 on the trajectory is the uninterrupted run's."""
    key, inputs, cfg = _workload("sparse")
    kw = dict(cfg=cfg, device="cpu", tol=0.0, cost_every=3)
    full = solve(key, *inputs, max_iter=16, chunk=4, **kw)
    solve(key, *inputs, max_iter=10, chunk=5, checkpoint_dir=tmp_path,
          checkpoint_every=5, **kw)
    assert latest_step(tmp_path) == 10
    rest = solve(key, *inputs, max_iter=16, chunk=4,
                 checkpoint_dir=tmp_path, resume=True, **kw)
    assert rest.log.costs[:2] == [float("inf")] * 2
    assert rest.log.costs[2:] == full.log.costs[12:]
    np.testing.assert_array_equal(rest.x, full.x)
    # chunks of one iteration log the seed the same way
    step1 = solve(key, *inputs, max_iter=16, chunk=1,
                  checkpoint_dir=tmp_path, resume=10, **kw)
    assert step1.log.costs[:2] == [float("inf")] * 2
    assert step1.log.costs[2:] == full.log.costs[12:]


def test_torn_newest_checkpoint_falls_back(tmp_path):
    key, inputs, cfg = _workload("sparse")
    kw = dict(cfg=cfg, device="cpu", tol=0.0, chunk=4)
    full = solve(key, *inputs, max_iter=12, **kw)
    solve(key, *inputs, max_iter=8, checkpoint_dir=tmp_path,
          checkpoint_every=4, **kw)
    leaf = tmp_path / "step_00000008" / "leaf_000000.npy"
    leaf.write_bytes(leaf.read_bytes()[:-16])      # a torn write
    assert "crc32" in validate_checkpoint(tmp_path, 8)
    assert latest_valid_step(tmp_path) == (4, [8])
    with pytest.warns(RuntimeWarning, match="resuming from step 4"):
        rest = solve(key, *inputs, max_iter=12, checkpoint_dir=tmp_path,
                     resume=True, **kw)
    assert rest.log.costs == full.log.costs[4:]
    # an explicit step is a contract: the torn one is refused
    with pytest.raises(CheckpointCorruptError):
        solve(key, *inputs, max_iter=12, checkpoint_dir=tmp_path,
              resume=8, **kw)


def test_checkpointer_keeps_three(tmp_path):
    key, inputs, cfg = _workload("completion")
    # a straggling chunk would add a checkpoint of its own: keep the
    # watchdog out of the count
    sol = solve(key, *inputs, cfg=cfg, device="cpu", tol=0.0, chunk=2,
                max_iter=12, checkpoint_dir=tmp_path, checkpoint_every=2,
                straggler_factor=1e9)
    assert sorted(os.listdir(tmp_path)) == [
        "step_00000008", "step_00000010", "step_00000012"]
    ck = sol.checkpointer
    assert ck.saved_steps == [2, 4, 6, 8, 10, 12]
    assert len(ck.spill_seconds) == len(ck.write_seconds) == 6


def test_checkpoint_every_clamped_to_max_iter(tmp_path):
    key, inputs, cfg = _workload("sparse")
    solve(key, *inputs, cfg=cfg, device="cpu", tol=0.0, chunk=4,
          max_iter=6, checkpoint_dir=tmp_path, checkpoint_every=1000)
    assert latest_step(tmp_path) == 6


def test_async_write_failure_surfaces_at_the_next_sync(tmp_path):
    ck = Checkpointer(tmp_path / "f")
    (tmp_path / "f").write_text("a file where a directory must go")
    ck.save_async(1, {"x": torch.ones(2)})
    with pytest.raises(CheckpointWriteError):
        ck.wait()
    ck.wait()                       # raised once, then clear


@pytest.mark.parametrize("name", WORKLOADS)
def test_steps_write_out_of_place(name):
    """No workload step writes into a tensor of the state it was given:
    a checkpoint spill queued before the next chunk reads the state it
    was asked for."""
    from repro_torch.core.problem import _as_problem
    key, inputs, cfg = _workload(name)
    prob = _as_problem(key, cfg)
    b = prob.init_bundle(inputs, torch.device("cpu"))
    before = {k: v.clone() for k, v in b.data.items()}
    d2, out = prob.full_step(b.data, b.replicated, ())
    persistence.assert_out_of_place(
        {"d": b.data, "r": b.replicated}, {"d": d2, "out": out}, name)
    for k, v in before.items():
        assert torch.equal(b.data[k], v), k


def test_assert_out_of_place_catches_an_in_place_step():
    old = {"x": torch.zeros(4)}
    new = {"x": old["x"].add_(1.0).view(4)}
    with pytest.raises(RuntimeError, match="storage"):
        persistence.assert_out_of_place(old, {"x": new["x"][:]}, "t")


# ------------------------------------------------ checkpointer and I/O
def test_save_restore_tree_with_bf16_and_numpy(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
                  "d": np.arange(3, dtype=np.int64)}}
    save(tmp_path, 3, tree, meta={"k": 1})
    like = {"a": torch.empty(2, 3, device="meta"),
            "b": {"c": torch.empty(2, dtype=torch.bfloat16, device="meta"),
                  "d": np.zeros(3, np.int64)}}
    got, manifest = restore(tmp_path, 3, like, device="cpu")
    assert torch.equal(got["a"], tree["a"])
    assert got["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(got["b"]["c"], tree["b"]["c"])
    np.testing.assert_array_equal(got["b"]["d"], tree["b"]["d"])
    assert manifest["meta"] == {"k": 1}
    assert [e["path"] for e in manifest["leaves"]] == [
        "['a']", "['b']['c']", "['b']['d']"]
    with pytest.raises(ValueError, match="meta"):
        restore(tmp_path, 3, like, device="cpu",
                expect_meta=lambda m: m.get("k") == 2)
    with pytest.raises(ValueError, match="leaves"):
        restore(tmp_path, 3, {"a": like["a"]}, device="cpu")


def test_validate_reports_missing_pieces(tmp_path):
    save(tmp_path, 1, {"x": torch.ones(3)})
    assert validate_checkpoint(tmp_path, 1) is None
    (tmp_path / "step_00000001" / "leaf_000000.npy").unlink()
    assert validate_checkpoint(tmp_path, 1) == "leaf 0 missing"
    (tmp_path / "step_00000001" / "manifest.json").unlink()
    assert validate_checkpoint(tmp_path, 1) == "manifest.json missing"
    assert latest_valid_step(tmp_path) == (None, [1])
    # a leftover .tmp is never a saved step
    (tmp_path / "step_00000002.tmp").mkdir()
    assert latest_step(tmp_path) == 1


def test_persistence_helpers_round_trip():
    """Spill, scatter, slice and set on a batched host state whose
    instance axis differs by leaf (a scale-major leaf carries it on 1)."""
    state = {"d": {"Y": torch.arange(12.).reshape(3, 4),
                   "W": torch.arange(24.).reshape(2, 3, 4)},
             "r": {"tau": torch.tensor([1., 2., 3.])}}
    axes = {"d": {"Y": 0, "W": 1}, "r": {"tau": 0}}
    host = persistence.to_host(state)
    assert host["d"]["W"].data_ptr() != state["d"]["W"].data_ptr()
    compact = persistence.map_with_axes(
        lambda x, a: x.index_select(a, torch.tensor([0, 2])), host, axes)
    full = persistence.scatter_batched(compact, [0, 2], 3, axes)
    lane1 = persistence.slice_instance(host, 1, axes)
    persistence.set_instance(full, 1, lane1, axes)
    for (_, a), (_, b) in zip(
            persistence.leaves_with_path(full),
            persistence.leaves_with_path(state)):
        assert torch.equal(a, b)
    spilled, event = persistence.spill_async(state)
    assert event is None and torch.equal(spilled["d"]["W"], state["d"]["W"])
    back = persistence.readmit_batched("cpu", spilled)
    assert torch.equal(back["r"]["tau"], state["r"]["tau"])


def test_wrap_step_is_the_step_under_both_policies():
    """Eager PyTorch under no_grad keeps no activations to rematerialise
    (ROADMAP C): both policies return the step itself."""
    def step(d, r, a):
        return d, 0.0

    for policy in persistence.Policy:
        assert persistence.wrap_step(step, policy) is step
    with pytest.raises(TypeError):
        persistence.wrap_step(step, "memory_only")


# ------------------------------------------------------------------ WAL
def test_wal_round_trip_and_torn_tail(tmp_path):
    path = tmp_path / "j" / "wal.log"
    with WriteAheadLog(path, fsync=True) as wal:
        for i in range(3):
            wal.append({"i": i, "s": "x" * i})
    with open(path, "ab") as f:
        f.write(b"0badc0de {\"torn\":")        # a crash mid-append
    records, skipped = WriteAheadLog.read(path)
    assert records == [{"i": 0, "s": ""}, {"i": 1, "s": "x"},
                       {"i": 2, "s": "xx"}]
    assert skipped == 1


def test_wal_checksum_and_missing_file(tmp_path):
    assert WriteAheadLog.read(tmp_path / "none.log") == ([], 0)
    path = tmp_path / "wal.log"
    with WriteAheadLog(path) as wal:
        wal.append({"a": 1})
        wal.append({"b": 2})
    lines = path.read_bytes().splitlines(keepends=True)
    bad = lines[0].replace(b'"a":1', b'"a":2')   # checksum now wrong
    path.write_bytes(bad + lines[1])
    records, skipped = WriteAheadLog.read(path)
    assert records == [{"b": 2}] and skipped == 1


def test_wal_matches_the_jax_package_format(tmp_path):
    """The port's log and the JAX package's write the same bytes, so
    either reads the other's journal."""
    from repro.checkpoint.wal import WriteAheadLog as JWal
    recs = [{"k": [1, 2], "v": "é"}, {"z": None}]
    for cls, name in ((WriteAheadLog, "port"), (JWal, "jax")):
        with cls(tmp_path / name) as wal:
            for r in recs:
                wal.append(r)
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()
    assert JWal.read(tmp_path / "port") == (recs, 0)


def test_manifest_is_self_describing(tmp_path):
    key, inputs, cfg = _workload("scdl")
    solve(key, *inputs, cfg=cfg, device="cpu", tol=0.0, chunk=4,
          max_iter=4, checkpoint_dir=tmp_path, checkpoint_every=4)
    manifest = json.loads(
        (Path(tmp_path) / "step_00000004" / "manifest.json").read_text())
    assert manifest["meta"]["problem"] == "scdl"
    assert manifest["meta"]["config"].startswith("SCDLConfig(")
    assert "max_iter" not in manifest["meta"]["config"]
    paths = [e["path"] for e in manifest["leaves"]]
    assert "['replicated']['Fh']['C']" in paths or \
        "['replicated']['Fh']['Gi']" in paths
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert validate_checkpoint(tmp_path, 4) is None
