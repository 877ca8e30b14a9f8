"""The port's pad-and-bucket planner (``repro_torch.core.batching``)
against ``tests/test_batching.py`` and against the JAX package's planner.

The planning is bookkeeping, so its contracts are properties over
randomized populations: an exact partition, bounded padding, keys that
are deterministic and independent of order.  On the same numpy
population the port's plan has the JAX package's membership, capacities
and records (the keys are the port's own and need not match).

The end-to-end property the planner protects: a padded instance's
trajectory is its unpadded single solve's.  The reference holds this bit
for bit and fails its own test
(``tests/test_batching.py::test_padded_solve_matches_unpadded_bitforbit``,
ROADMAP C), so the port is held to rtol 1e-4 on costs and rtol 1e-4 /
atol 1e-6 on iterates, the tolerance of ``tests/test_solve_many.py``.
"""
import numpy as np
import pytest
import torch
from hypothesis import given
from hypothesis import strategies as st

from repro.core import batching as jbatching
from repro_torch.core.batching import (BatchAxes, OpenBucketPlanner,
                                       bucket_key, instance_records,
                                       pad_tree_records, plan_buckets,
                                       stack_trees, static_signature)

torch.set_num_threads(2)

AX = BatchAxes(record_axes=(0, 0))
JAX_AX = jbatching.BatchAxes(record_axes=(0, 0))


def _population(n, seed, shapes=((16, 16), (20, 20))):
    """n two-array instances with mixed trailing shapes + record counts."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        S = shapes[int(rng.integers(len(shapes)))]
        rec = int(rng.integers(1, 7))
        out.append((np.zeros((rec,) + S, np.float32),
                    np.zeros((rec,) + S, np.float32)))
    return out


def _plan_view(buckets):
    return sorted((b.indices, b.capacity, b.records) for b in buckets)


# ---------------------------------------------------------------------
# Partition / waste / determinism properties
# ---------------------------------------------------------------------

@given(n=st.integers(1, 24), seed=st.integers(0, 3))
def test_every_instance_in_exactly_one_bucket(n, seed):
    insts = _population(n, seed)
    buckets = plan_buckets(insts, AX)
    covered = [i for b in buckets for i in b.indices]
    assert sorted(covered) == list(range(n))
    assert _plan_view(buckets) == _plan_view(
        jbatching.plan_buckets(insts, JAX_AX))


@given(n=st.integers(1, 24), seed=st.integers(0, 3))
def test_padding_within_waste_budget(n, seed):
    insts = _population(n, seed)
    for budget in (0.0, 0.25, 0.5):
        buckets = plan_buckets(insts, AX, waste_budget=budget)
        for b in buckets:
            slack = sum(b.capacity - r for r in b.records)
            assert b.capacity == max(b.records)
            assert slack <= budget * b.capacity * len(b.indices)
            sigs = {static_signature(insts[i], AX) for i in b.indices}
            assert len(sigs) == 1
        assert _plan_view(buckets) == _plan_view(jbatching.plan_buckets(
            insts, JAX_AX, waste_budget=budget))


@given(n=st.integers(2, 16), seed=st.integers(0, 2))
def test_bucket_keys_deterministic_and_order_free(n, seed):
    insts = _population(n, seed)
    a = plan_buckets(insts, AX, salt="s")
    b = plan_buckets(list(insts), AX, salt="s")
    assert [x.key for x in a] == [x.key for x in b]
    c = plan_buckets(insts, AX, salt="other")
    assert {x.key for x in a}.isdisjoint({x.key for x in c})
    for x in a:
        members = list(zip(x.indices, x.records))
        assert all(instance_records(insts[i], AX) == r
                   for i, r in members)
        assert x.key == bucket_key("s", x.signature, x.capacity, members)


def test_bucket_keys_of_tensors_and_arrays_are_stable():
    """Tensors plan like arrays; a key depends on the inputs, not on the
    process (a fixed digest of the description)."""
    arrs = _population(6, 1)
    tens = [tuple(torch.from_numpy(a) for a in inst) for inst in arrs]
    assert _plan_view(plan_buckets(tens, AX)) == \
        _plan_view(plan_buckets(arrs, AX))
    again = [tuple(torch.from_numpy(a.copy()) for a in inst)
             for inst in arrs]
    assert [b.key for b in plan_buckets(tens, AX, salt="s")] == \
        [b.key for b in plan_buckets(again, AX, salt="s")]


def test_zero_waste_budget_buckets_by_exact_records():
    insts = _population(12, 0)
    for b in plan_buckets(insts, AX, waste_budget=0.0):
        assert len(set(b.records)) == 1


def test_no_pad_records_mode_never_mixes_record_counts():
    ax = BatchAxes(record_axes=(1, 1), pad_records=False)
    rng = np.random.default_rng(1)
    insts = [(np.zeros((5, int(k)), np.float32),
              np.zeros((3, int(k)), np.float32))
             for k in rng.integers(4, 8, size=10)]
    for b in plan_buckets(insts, ax):
        assert len(set(b.records)) == 1
        assert b.capacity == b.records[0]


def test_waste_budget_validation():
    insts = _population(2, 0)
    with pytest.raises(ValueError, match="waste_budget"):
        plan_buckets(insts, AX, waste_budget=1.0)
    with pytest.raises(ValueError, match="waste_budget"):
        plan_buckets(insts, AX, waste_budget=-0.1)


def test_pad_tree_records_contract():
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(3, 2),
            # a scale-major leaf: records on axis 1
            "b": torch.ones(2, 3, 4)}
    axes = {"b": 1}
    padded = pad_tree_records(tree, 5, axes)
    assert padded["a"].shape == (5, 2) and padded["b"].shape == (2, 5, 4)
    assert torch.equal(padded["a"][3:], torch.zeros(2, 2))
    assert torch.equal(padded["a"][:3], tree["a"])
    assert torch.equal(padded["b"][:, 3:], torch.zeros(2, 2, 4))
    with pytest.raises(ValueError):
        pad_tree_records(tree, 2, axes)
    stacked = stack_trees([padded, padded], axes)
    assert stacked["a"].shape == (2, 5, 2)
    assert stacked["b"].shape == (2, 2, 5, 4)      # (J, B, n, ...)
    nested = stack_trees([{"F": {"C": torch.ones(3)}}] * 4)
    assert nested["F"]["C"].shape == (4, 3)


def _inst(rec, S=16):
    return (np.zeros((rec, S, S), np.float32),
            np.zeros((rec, S, S), np.float32))


def test_bucket_key_stable_under_member_permutation():
    members = [(0, 5), (1, 3), (2, 5), (3, 1)]
    sig = static_signature(_inst(5), AX)
    want = bucket_key("s", sig, 5, members)
    for perm in ([members[i] for i in (2, 0, 3, 1)],
                 list(reversed(members)),
                 [members[i] for i in (1, 3, 0, 2)]):
        assert bucket_key("s", sig, 5, perm) == want
    assert bucket_key("s", sig, 5, members[:-1]) != want
    assert bucket_key("s", sig, 6, members) != want
    assert bucket_key("t", sig, 5, members) != want


def test_waste_budget_exact_boundary():
    at = plan_buckets([_inst(10), _inst(8)], AX, waste_budget=0.1)
    assert len(at) == 1 and at[0].capacity == 10
    over = plan_buckets([_inst(10), _inst(7)], AX, waste_budget=0.1)
    assert len(over) == 2
    assert sorted(b.capacity for b in over) == [7, 10]


def test_instance_draws_carry_no_records():
    """An instance's own draws ride as a trailing dict that
    ``record_axes`` marks ``None``: it joins the signature, not the
    record count."""
    ax = BatchAxes(record_axes=(0, 0, None))
    a = _inst(4) + ({"u0": np.zeros((4, 16, 16))},)
    assert instance_records(a, ax) == 4
    [b] = plan_buckets([a, _inst(3) + ({"u0": None},)], ax)
    assert b.capacity == 4
    with pytest.raises(ValueError, match="more"):
        instance_records(_inst(2) + ({},), AX)


# ---------------------------------------------------------------------
# Incremental (open-bucket) planning
# ---------------------------------------------------------------------

def test_open_bucket_waste_boundary_matches_offline():
    p = OpenBucketPlanner(AX, waste_budget=0.1)
    b1 = p.offer("a", _inst(8))
    assert p.offer("b", _inst(10)) is b1
    assert b1.capacity == 10
    p2 = OpenBucketPlanner(AX, waste_budget=0.1)
    b2 = p2.offer("a", _inst(7))
    assert p2.offer("b", _inst(10)) is not b2
    assert len(p2.open_buckets) == 2


def test_open_bucket_planner_keys_match_offline_planner():
    insts = [_inst(5), _inst(5), _inst(4)]
    offline = plan_buckets(insts, AX, waste_budget=0.25, salt="s")
    assert len(offline) == 1
    p = OpenBucketPlanner(AX, waste_budget=0.25, salt="s")
    buckets = {id(p.offer(i, inst)) for i, inst in enumerate(insts)}
    assert len(buckets) == 1
    closed = p.drain()
    assert [b.key for b in closed] == [offline[0].key]
    p2 = OpenBucketPlanner(AX, waste_budget=0.25, salt="s")
    for i in (2, 0, 1):
        p2.offer(i, insts[i])
    assert p2.drain()[0].key == offline[0].key


def test_open_bucket_signature_grouping_and_max_members():
    p = OpenBucketPlanner(AX, waste_budget=0.5, max_members=2)
    b16 = p.offer(0, _inst(3, S=16))
    assert p.offer(1, _inst(3, S=20)) is not b16
    assert p.offer(2, _inst(3, S=16)) is b16
    assert p.offer(3, _inst(3, S=16)) is not b16
    assert len(p.open_buckets) == 3


def test_open_bucket_discard_shrinks_capacity():
    p = OpenBucketPlanner(AX, waste_budget=0.5)
    b = p.offer(0, _inst(3))
    p.offer(1, _inst(6))
    assert b.capacity == 6
    p.discard(b, 1)
    assert b.capacity == 3
    p.discard(b, 0)
    assert len(p.open_buckets) == 0
    with pytest.raises(ValueError, match="waste_budget"):
        OpenBucketPlanner(AX, waste_budget=1.0)


def test_open_bucket_deadlines():
    p = OpenBucketPlanner(AX, waste_budget=0.5)
    b = p.offer(0, _inst(3), deadline=5.0)
    p.offer(1, _inst(3), deadline=2.0)
    assert b.earliest_deadline == 2.0
    p.discard(b, 1)
    assert b.earliest_deadline == 5.0 and len(b) == 1


# ---------------------------------------------------------------------
# The end-to-end property the planner exists to protect
# ---------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sparse", "lowrank"])
def test_padded_solve_matches_unpadded(mode):
    """A padded instance reproduces its unpadded single solve: zero
    records are inert and the derived state is built before padding.
    rtol 1e-4 / atol 1e-6 (module docstring: the reference misses its
    own bit-for-bit version of this test)."""
    from repro_torch.core.problem import solve, solve_many
    from repro_torch.imaging import psf
    from repro_torch.imaging.condat import SolverConfig

    cfg = SolverConfig(mode=mode, max_iter=6, tol=0.0, n_scales=2, rank=2)
    d3 = psf.simulate(3, torch.Generator().manual_seed(0), stamp=16,
                      device="cpu")
    d5 = psf.simulate(5, torch.Generator().manual_seed(1), stamp=16,
                      device="cpu")
    insts = [(d3.Y, d3.psfs), (d5.Y, d5.psfs)]
    assert len(plan_buckets(insts, BatchAxes(record_axes=(0, 0)))) == 1
    sols = solve_many("deconvolve", insts, cfg=cfg, device="cpu", chunk=3)
    for inst, sol in zip(insts, sols):
        ref = solve("deconvolve", *inst, cfg=cfg, device="cpu", chunk=3)
        assert sol.x.shape == ref.x.shape
        np.testing.assert_allclose(sol.log.costs, ref.log.costs, rtol=1e-4)
        np.testing.assert_allclose(sol.x, ref.x, rtol=1e-4, atol=1e-6)
