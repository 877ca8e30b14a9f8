"""The port's engine and driver against the JAX package's, on a toy
problem that both can state in a few lines: x <- 0.8 x + 0.1, with
objective sum(x^2).

Every execution mode runs in both packages: one iteration a chunk and
several, plain and supervised, with integer ``cost_every`` (phased on
the global iteration index across chunk boundaries), the per-chunk
objective (``last`` repeated, +inf before the first evaluation), tail
chunks shorter than the rest, and convergence checks at their stride.  The arithmetic is the same fp32 in
both, so the traces agree to rtol 1e-6 and the iteration counts exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import problem as jproblem
from repro.core.bundle import Bundle as JBundle
from repro_torch.core import engine, problem
from repro_torch.core.bundle import Bundle
from repro_torch.core.driver import IterativeDriver, RunOptions
from repro_torch.resilience.recovery import ResilienceConfig

torch.set_num_threads(2)

X0 = np.linspace(1.0, 3.0, 16, dtype=np.float32)


class JaxToy(jproblem.Problem):
    def init_bundle(self, inputs, mesh):
        return JBundle.create({"x": jnp.asarray(inputs[0])}, mesh=mesh)

    def full_step(self, d, rep, axes):
        x = 0.8 * d["x"] + 0.1
        return {"x": x}, {"cost": jnp.sum(x * x)}

    def light_step(self, d, rep, axes):
        return {"x": 0.8 * d["x"] + 0.1}

    def cost(self, d, rep, axes):
        return {"cost": jnp.sum(d["x"] * d["x"])}


class TorchToy(problem.Problem):
    def init_bundle(self, inputs, device):
        return Bundle.create({"x": inputs[0]}, device=device)

    def full_step(self, d, rep, axes):
        x = 0.8 * d["x"] + 0.1
        return {"x": x}, {"cost": torch.sum(x * x)}

    def light_step(self, d, rep, axes):
        return {"x": 0.8 * d["x"] + 0.1}

    def cost(self, d, rep, axes):
        return {"cost": torch.sum(d["x"] * d["x"])}


# (max_iter, chunk, cost_every, tol, cost_window)
RUNS = [(20, 1, 1, 1e-3, 3), (20, 1, 3, 1e-3, 3), (6, 1, "chunk", 0.0, 3),
        (30, 4, 1, 1e-3, 3), (30, 4, 3, 1e-3, 3), (10, 4, 3, 0.0, 3),
        (30, 8, "chunk", 1e-2, 2), (7, 3, "chunk", 0.0, 3),
        (40, 5, 2, 1e-4, 2)]


@pytest.mark.parametrize("supervised", [False, True],
                         ids=["plain", "supervised"])
@pytest.mark.parametrize("max_iter,chunk,cost_every,tol,window", RUNS)
def test_driver_matches_jax(max_iter, chunk, cost_every, tol, window,
                            supervised):
    """Every mode through the one chunk loop; supervision without a
    fault takes the same trajectory."""
    kw = dict(max_iter=max_iter, chunk=chunk, cost_every=cost_every,
              tol=tol, cost_window=window)
    want = jproblem.solve(JaxToy(), X0, **kw)
    events = []
    sup = {"resilience": ResilienceConfig()} if supervised else {}
    got = problem.solve(TorchToy(), X0, device="cpu",
                        progress_fn=events.append, **kw, **sup)
    assert got.log.iters_run == want.log.iters_run
    assert got.log.converged_at == want.log.converged_at
    jc, tc = np.asarray(want.log.costs), np.asarray(got.log.costs)
    assert tc.shape == jc.shape
    np.testing.assert_array_equal(np.isinf(tc), np.isinf(jc))
    fin = np.isfinite(jc)
    np.testing.assert_allclose(tc[fin], jc[fin], rtol=1e-6)
    np.testing.assert_allclose(got.x["x"], np.asarray(want.x["x"]),
                               rtol=1e-6)
    assert sum(e["iters"] for e in events) == got.log.iters_run
    assert len(got.log.times) == got.log.iters_run


def test_chunk_cost_trace_layout():
    """``last`` fills the first K - 1 slots (+inf before any evaluation)
    and the fresh objective the last one."""
    step = engine.make_chunk_cost_step(
        lambda d, r, a: {"x": d["x"] + 1.0},
        lambda d, r, a: {"cost": torch.sum(d["x"])}, chunk=3)
    d, _, fresh, trace = step({"x": torch.zeros(2)}, {}, 0)
    assert trace["cost"].tolist() == [float("inf"), float("inf"), 6.0]
    _, _, _, trace = step(d, {}, 3, fresh)
    assert trace["cost"].tolist() == [6.0, 6.0, 12.0]


def test_scan_step_phases_cost_on_global_index():
    """With cost_every = 3 a chunk starting at iteration 4 evaluates at 6
    only, and carries the output of iteration 3 before it."""
    calls = []

    def full(d, r, a):
        calls.append("full")
        return d, {"cost": torch.tensor(float(len(calls)))}

    def light(d, r, a):
        calls.append("light")
        return d

    step = engine.make_scan_step(full, chunk=4, fn_light=light,
                                 cost_every=3)
    _, _, last, trace = step({}, {}, 4, {"cost": torch.tensor(-1.0)})
    assert calls == ["light", "light", "full", "light"]
    assert trace["cost"].tolist() == [-1.0, -1.0, 3.0, 3.0]
    assert float(last["cost"]) == 3.0


def test_run_options_validation():
    with pytest.raises(ValueError, match="cost_every"):
        RunOptions(cost_every=0)
    with pytest.raises(ValueError, match="cost_every"):
        RunOptions(cost_every="sometimes")
    with pytest.raises(ValueError, match="chunk"):
        RunOptions(chunk=0)
    # resilience (ROADMAP A11) is run control now; the ring must hold one
    # snapshot at least
    cfg = ResilienceConfig(max_retries=1)
    assert RunOptions(resilience=cfg).resilience is cfg
    with pytest.raises(ValueError, match="ring"):
        ResilienceConfig(ring=0)


@pytest.mark.parametrize("name,value", [("checkpoint_every", 5),
                                        ("checkpoint_fn", print),
                                        ("checks", True)])
def test_run_options_accept_checks_and_checkpoints(name, value):
    """The runtime checks and the checkpoint hook are run control now."""
    assert getattr(RunOptions(**{name: value}), name) == value


def test_driver_wiring_errors():
    b = Bundle.create({"x": X0}, device="cpu")
    with pytest.raises(ValueError, match="step_fn_cost"):
        IterativeDriver(lambda d, r, a: (d, 0.0), b,
                        options=RunOptions(cost_every="chunk"))
    class NoLight(problem.Problem):
        pass

    with pytest.raises(ValueError, match="light_step"):
        problem.derive_options(NoLight(), RunOptions(cost_every=2))
    with pytest.raises(TypeError, match="unexpected run options"):
        problem.solve(TorchToy(), X0, device="cpu", chunks=3)


def test_bundle_checks_records():
    with pytest.raises(ValueError, match="records"):
        Bundle.create({"a": np.zeros(3), "b": np.zeros(4)}, device="cpu")
    b = Bundle.create({"a": np.zeros((3, 2)), "b": np.zeros((5, 3))},
                      device="cpu", record_axes={"b": 1})
    assert b.n_records == 3


def test_bundle_without_cuda_needs_cpu_device():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Bundle.create({"a": np.zeros(3)})


def test_percentiles_summary():
    from repro_torch.core.driver import RunLog, percentiles
    assert percentiles([]) == {}
    p = percentiles([1.0, 2.0, 3.0, 4.0])
    assert p["p50"] == pytest.approx(2.5)
    log = RunLog(times=[0.5, 0.5])
    assert log.total_seconds == 1.0 and log.percentiles()["p99"] == 0.5


def test_problems_package_lists_the_reference_workloads():
    """``repro_torch.problems`` mirrors ``repro.problems``: ``list()``
    holds the JAX package's keys once imported, ``get`` returns the
    registered classes and ``solve`` is the entry point."""
    from repro import problems as jproblems
    from repro_torch import problems as tproblems
    from repro_torch.imaging.scdl import SCDLProblem
    assert tproblems.list() == jproblems.list() == \
        ("deconvolve", "lowrank", "scdl")
    assert tproblems.get("scdl") is SCDLProblem
    assert tproblems.solve is problem.solve
    assert tproblems.solve_many is problem.solve_many


def test_bundle_zip_and_map():
    """The paper's RDD.zip of two co-partitioned bundles (disjoint keys,
    equal records, record axes kept), and ``bundle_map`` /
    ``bundle_map_reduce`` without a mesh."""
    from repro_torch.core.bundle import bundle_map, bundle_map_reduce
    a = Bundle.create({"x": np.ones((3, 2), np.float32)}, device="cpu")
    b = Bundle.create({"w": np.ones((2, 3), np.float32)}, device="cpu",
                      record_axes={"w": 1})
    z = a.zip(b)
    assert sorted(z.data) == ["w", "x"] and z.record_axis("w") == 1
    assert z.n_records == 3 and z.n_partitions == 1
    with pytest.raises(ValueError, match="both bundles hold"):
        a.zip(a)
    with pytest.raises(ValueError, match="equal record counts"):
        a.zip(Bundle.create({"v": np.ones(4)}, device="cpu"))
    doubled = bundle_map(lambda d: {k: 2 * v for k, v in d.items()}, z)
    assert float(doubled.data["x"].sum()) == 12.0
    sums = bundle_map_reduce(lambda d: {"s": d["x"].sum()}, z)
    assert float(sums["s"]) == 6.0
