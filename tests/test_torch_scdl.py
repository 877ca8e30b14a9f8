"""The port's SCDL slice against ``repro.imaging.scdl``.

``repro_torch``'s ``solve("scdl", device="cpu")`` and ``repro``'s
``solve("scdl")`` run on the same coupled patches (the JAX
``coupled_patches(256, 25, 9, A, seed=5)``) for every ``cost_every``
mode and two chunk lengths; A = 16 and A = 64 between them reach all
three factor regimes of ``_solve_factor``.  JAX chooses the initial
atoms with ``PRNGKey(3)``, which torch cannot reproduce: the tests hand
JAX's choice to the port as ``idx``.  A JAX-built bundle is also carried
into the port through ``repro_torch.convert`` and stepped in both.

Tolerances:
- the factor-once solves, rtol/atol 2e-4 (``tests/test_imaging.py``);
- cost trajectories rtol 1e-4 (``tests/test_solve_many.py``), compared
  at equal cadence only (the reference's own cross-cadence comparison
  misses 1e-5);
- dictionaries rtol 1e-3 with atol 1e-4 (``tests/test_imaging.py``) at
  A = 16, where JAX's own dictionaries move by about 5e-5 when S_h
  moves by one ulp.  At A = 64 the problem is nearly degenerate (64
  atoms from 256 samples): the same nudge moves them by 4.5e-4 to
  5.1e-4 (``Xh``) and 2.7e-4 to 3.0e-4 (``Xl``) over the six cadences,
  so no implementation that rounds differently can be held to 1e-4
  there.  The A = 64 dictionaries are held to twice that sensitivity
  instead, measured in the test by nudging S_h, and the measured spread
  itself must stay under 1e-3 (:func:`_assert_dicts_close`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bundle import gather as jgather
from repro.core.problem import solve as jsolve
from repro.data.synthetic import coupled_patches as jpatches
from repro.imaging import scdl as jscdl
from repro_torch.convert import bundle_from_numpy, bundle_to_numpy
from repro_torch.core.bundle import Bundle
from repro_torch.core.problem import solve
from repro_torch.data.synthetic import coupled_patches
from repro_torch.imaging import scdl
from repro_torch.kernels.admm_elwise.kernel import admm_elwise_fwd
from repro_torch.kernels.dict_outer.kernel import (dict_outer_fwd,
                                                   dict_outer_pair_fwd)

torch.set_num_threads(2)

K, P, M, ITERS = 256, 25, 9, 24
COSTS = dict(rtol=1e-4)
DICTS = dict(rtol=1e-3, atol=1e-4)


def _jax_idx(A, n=K):
    return np.array(jax.random.choice(jax.random.PRNGKey(3), n, (A,),
                                      replace=False))


@pytest.fixture(scope="module", params=[16, 64], ids=["A16", "A64"])
def case(request):
    A = request.param
    S_h, S_l = (np.asarray(a) for a in jpatches(K, P, M, A, seed=5))
    return A, S_h, S_l, _jax_idx(A)


def _solve_both(A, S_h, S_l, idx, **kw):
    want = jsolve("scdl", S_h, S_l, cfg=jscdl.SCDLConfig(n_atoms=A), **kw)
    got = solve(scdl.SCDLProblem(scdl.SCDLConfig(n_atoms=A), idx=idx),
                S_h, S_l, device="cpu", **kw)
    return got, want


def _assert_dicts_close(A, got, want, nudged):
    """Dictionaries: ``DICTS`` at A = 16; at A = 64 within twice the
    distance JAX's own move under a one-ulp nudge of S_h (``nudged``,
    a thunk run only there)."""
    if A == 16:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), **DICTS)
        return
    for g, w, n in zip(got, want, nudged()):
        w = np.asarray(w)
        spread = np.abs(np.asarray(n) - w).max()
        assert 0 < spread < 1e-3
        assert np.abs(g - w).max() <= 2 * spread


# ------------------------------------------------------------- factors
@pytest.mark.parametrize("PA", [(81, 512), (289, 512), (25, 16)],
                         ids=["thin", "woodbury", "direct"])
def test_solve_factor_and_ridge_solve_match_jax(PA):
    """All three regimes, on an ill-conditioned dictionary
    (near-duplicate atoms + ridge), as ``tests/test_imaging.py`` builds
    it; same payload keys, same operators, same solves."""
    Pd, A = PA
    rng = np.random.default_rng(3)
    base = rng.standard_normal((Pd, max(A // 8, 2)))
    X = np.repeat(base, 8, axis=1)[:, :A] + 1e-3 * rng.standard_normal(
        (Pd, A))
    X = (X / np.maximum(np.linalg.norm(X, axis=0, keepdims=True),
                        1e-8)).astype(np.float32)
    S = rng.standard_normal((128, Pd)).astype(np.float32)
    Z = rng.standard_normal((128, A)).astype(np.float32)
    c = 1.2
    jF = jscdl._solve_factor(jnp.asarray(X), c)
    tF = scdl._solve_factor(torch.tensor(X), c)
    assert sorted(tF) == sorted(jF)
    assert ("C" in tF) == (2 * Pd < A) and ("Gi" in tF) == (2 * Pd >= A)
    for k in jF:
        np.testing.assert_allclose(tF[k].numpy(), np.asarray(jF[k]),
                                   rtol=2e-4, atol=2e-4, err_msg=k)
    got = scdl._ridge_solve(torch.tensor(S), torch.tensor(Z),
                            torch.tensor(X), tF, c)
    want = jscdl._ridge_solve(jnp.asarray(S), jnp.asarray(Z),
                              jnp.asarray(X), jF, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    G = 2.0 * X.T.astype(np.float64) @ X + c * np.eye(A)
    exact = np.linalg.solve(G, (2.0 * S @ X + Z).T.astype(np.float64)).T
    np.testing.assert_allclose(got.numpy(), exact, rtol=2e-4, atol=2e-4)


# ------------------------------------------------------- whole solves
@pytest.mark.parametrize("chunk", [4, 5])
@pytest.mark.parametrize("cost_every", [1, 3, "chunk"])
def test_solve_matches_jax(case, cost_every, chunk):
    A, S_h, S_l, idx = case
    got, want = _solve_both(A, S_h, S_l, idx, max_iter=ITERS, chunk=chunk,
                            cost_every=cost_every)
    assert got.log.iters_run == want.log.iters_run == ITERS
    jc, tc = np.asarray(want.log.costs), np.asarray(got.log.costs)
    assert tc.shape == jc.shape == (ITERS,)
    fin = np.isfinite(jc)
    np.testing.assert_array_equal(np.isfinite(tc), fin)
    np.testing.assert_allclose(tc[fin], jc[fin], **COSTS)
    Xh, Xl = got.x
    assert Xh.shape == (P, A) and Xl.shape == (M, A)
    _assert_dicts_close(A, got.x, want.x, lambda: jsolve(
        "scdl", np.nextafter(S_h, np.float32(np.inf)), S_l,
        cfg=jscdl.SCDLConfig(n_atoms=A), max_iter=ITERS, chunk=chunk,
        cost_every=cost_every).x)


def test_nrmse_falls(case):
    A, S_h, S_l, idx = case
    sol = solve(scdl.SCDLProblem(scdl.SCDLConfig(n_atoms=A), idx=idx),
                S_h, S_l, device="cpu", max_iter=12, chunk=4)
    assert sol.log.costs[-1] < 0.5 * sol.log.costs[0]
    norms = np.linalg.norm(sol.x[0], axis=0)
    assert (norms <= 1.0 + 1e-5).all()


# ------------------------------------------------------------- bundle
def test_build_bundle_matches_jax(case):
    A, S_h, S_l, idx = case
    jb = jscdl.build_bundle(S_h, S_l, jscdl.SCDLConfig(n_atoms=A))
    tb = scdl.build_bundle(S_h, S_l, scdl.SCDLConfig(n_atoms=A),
                           device="cpu", idx=idx)
    assert tuple(tb.data["YZ"].shape) == (5, K, A)
    assert tb.n_records == K and tb.record_axis("YZ") == 1
    data, rep = bundle_to_numpy(tb)
    want = jgather(jb)
    assert sorted(data) == sorted(want)
    for k, v in want.items():
        assert data[k].shape == v.shape and data[k].dtype == v.dtype, k
        np.testing.assert_array_equal(data[k], v, err_msg=k)
    jrep = jax.tree.map(np.asarray, jb.replicated)
    assert sorted(rep) == sorted(jrep)
    for k in ("Fh", "Fl"):
        assert sorted(rep[k]) == sorted(jrep[k])
    for k, v in jax.tree_util.tree_leaves_with_path(jrep):
        path = [p.key for p in k]
        mine = rep[path[0]] if len(path) == 1 else rep[path[0]][path[1]]
        np.testing.assert_allclose(mine, v, rtol=2e-4, atol=2e-5,
                                   err_msg=str(path))


def test_carried_bundle_step_matches_jax(case):
    """A JAX-built bundle goes through numpy into the port; one full
    step runs in both packages and agrees; the replicated refresh of
    JAX's new dictionaries builds the same solve factors in both."""
    A, S_h, S_l, _ = case
    jcfg = jscdl.SCDLConfig(n_atoms=A)
    cfg = scdl.SCDLConfig(n_atoms=A)
    jb = jscdl.build_bundle(S_h, S_l, jcfg)
    jrep = jax.tree.map(np.asarray, jb.replicated)
    tb = bundle_from_numpy(jgather(jb), jrep, device="cpu")
    assert isinstance(tb.replicated["Fh"], dict)
    assert tb.data["YZ"].is_contiguous()

    jstep = jax.jit(lambda d, r: jscdl.make_step_fn(jcfg)(d, r, ()))
    jd, jout = jstep(jb.data, jb.replicated)
    td, tout = scdl.make_step_fn(cfg)(tb.data, tb.replicated, ())
    for k in ("cost", "nrmse_h", "nrmse_l"):
        assert float(tout[k]) == pytest.approx(float(jout[k]), rel=1e-4), k
    got, _ = bundle_to_numpy(tb.with_data(td))
    for k, v in jd.items():
        v = np.asarray(v)
        np.testing.assert_allclose(got[k], v, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(v).max(), 1.0),
                                   err_msg=k)

    def nudged():
        nb = jscdl.build_bundle(np.nextafter(S_h, np.float32(np.inf)), S_l,
                                jcfg)
        out = jstep(nb.data, nb.replicated)[1]
        return out["Xh"], out["Xl"]

    _assert_dicts_close(A, (tout["Xh"].numpy(), tout["Xl"].numpy()),
                        (jout["Xh"], jout["Xl"]), nudged)
    jnew = jscdl.make_refresh_fn(jcfg)(jb.replicated, jout)
    tnew = scdl.make_refresh_fn(cfg)(tb.replicated, {
        k: torch.tensor(np.asarray(jout[k])) for k in ("Xh", "Xl")})
    _, rep = bundle_to_numpy(tb.with_data(td, tnew))
    for key in ("Fh", "Fl"):
        assert sorted(rep[key]) == sorted(jnew[key])
        for k, v in jnew[key].items():
            np.testing.assert_allclose(rep[key][k], np.asarray(v),
                                       rtol=2e-4, atol=2e-4,
                                       err_msg=f"{key}.{k}")


def test_convert_round_trip_is_exact(case):
    A, S_h, S_l, idx = case
    tb = scdl.build_bundle(S_h, S_l, scdl.SCDLConfig(n_atoms=A),
                           device="cpu", idx=idx)
    tb.data["YZ"] = torch.randn(tb.data["YZ"].shape)
    data, rep = bundle_to_numpy(tb)
    assert data["YZ"].shape == (K, 5, A)
    again = bundle_from_numpy(data, rep, device="cpu")
    for k, v in tb.data.items():
        assert torch.equal(again.data[k], v), k
    for k, v in tb.replicated.items():
        if isinstance(v, dict):
            assert sorted(again.replicated[k]) == sorted(v)
            assert all(torch.equal(again.replicated[k][kk], vv)
                       for kk, vv in v.items()), k
        else:
            assert torch.equal(again.replicated[k], v), k


def test_bundle_checks_nested_replicated_devices():
    b = Bundle.create({"x": np.zeros((3, 2), np.float32)},
                      replicated={"F": {"C": np.ones(2, np.float32)}},
                      device="cpu")
    b.validate()
    b.replicated["F"]["C"] = torch.ones(2, device="meta")
    with pytest.raises(ValueError, match="F.C"):
        b.validate()


# ---------------------------------------------------------- atom choice
def test_init_dicts_with_injected_idx_matches_jax(case):
    A, S_h, S_l, idx = case
    jXh, jXl = jscdl.init_dicts(jnp.asarray(S_h), jnp.asarray(S_l),
                                jscdl.SCDLConfig(n_atoms=A))
    Xh, Xl = scdl.init_dicts(torch.tensor(S_h), torch.tensor(S_l),
                             scdl.SCDLConfig(n_atoms=A), idx=idx)
    np.testing.assert_allclose(Xh.numpy(), np.asarray(jXh), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(Xl.numpy(), np.asarray(jXl), rtol=1e-6,
                               atol=1e-7)


def test_default_atom_choice_is_seeded_and_distinct():
    S_h = torch.randn((P, 100))
    S_l = torch.randn((M, 100))
    cfg = scdl.SCDLConfig(n_atoms=20)
    a = scdl.init_dicts(S_h, S_l, cfg)
    b = scdl.init_dicts(S_h, S_l, cfg)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # each chosen column is a distinct sample, normalised
    hits = (a[0].T @ (S_h / S_h.norm(dim=0))).isclose(torch.tensor(1.0))
    assert int(hits.any(dim=1).sum()) == 20
    assert torch.allclose(a[0].norm(dim=0), torch.ones(20))


@pytest.mark.parametrize("idx, A", [([0, 1, 2], 4), ([0, 1, 1, 2], 4),
                                    ([0, 1, 2, 100], 4), (None, 101)],
                         ids=["short", "repeated", "out-of-range",
                              "drawn-more-atoms-than-samples"])
def test_bad_idx_raises(idx, A):
    with pytest.raises(ValueError, match="idx|distinct columns"):
        scdl.init_dicts(torch.zeros((P, 100)), torch.zeros((M, 100)),
                        scdl.SCDLConfig(n_atoms=A), idx=idx)


# --------------------------------------------------------------- data
def test_coupled_patches_shapes_and_seed():
    def gen(seed):
        return torch.Generator().manual_seed(seed)

    S_h, S_l = coupled_patches(300, P, M, 16, gen(2), device="cpu")
    assert tuple(S_h.shape) == (P, 300) and tuple(S_l.shape) == (M, 300)
    assert S_h.dtype == S_l.dtype == torch.float32
    again = coupled_patches(300, P, M, 16, gen(2), device="cpu")
    assert torch.equal(S_h, again[0]) and torch.equal(S_l, again[1])
    other = coupled_patches(300, P, M, 16, gen(3), device="cpu")
    assert not torch.equal(S_h, other[0])
    default = coupled_patches(300, P, M, 16, device="cpu")
    assert torch.equal(default[0], coupled_patches(300, P, M, 16, gen(0),
                                                   device="cpu")[0])
    # same process as JAX's: matching scale of the HR and LR patches
    jh, jl = (np.asarray(a) for a in jpatches(300, P, M, 16, seed=2))
    for mine, theirs in ((S_h, jh), (S_l, jl)):
        ratio = float(mine.square().mean()) / float(np.mean(theirs ** 2))
        assert 0.5 < ratio < 2.0


# ------------------------------------------------------------- wiring
def test_cpu_solve_launches_no_kernel(case):
    A, S_h, S_l, idx = case
    counters = (admm_elwise_fwd, dict_outer_fwd, dict_outer_pair_fwd)
    before = [f.launches for f in counters]
    solve("scdl", S_h, S_l, cfg=scdl.SCDLConfig(n_atoms=A), device="cpu",
          max_iter=2, chunk=2)
    assert [f.launches for f in counters] == before


def test_solve_without_cuda_raises(case):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a card")
    A, S_h, S_l, _ = case
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        solve("scdl", S_h, S_l, cfg=scdl.SCDLConfig(n_atoms=A), max_iter=1)


def test_batch_axes_name_what_init_bundle_reads():
    ax = scdl.SCDLProblem().batch_axes()
    # the third entry: an instance's own atom choice carries no records
    assert ax.record_axes == (1, 1, None) and not ax.pad_records
    assert ax.instance_invariant == ("idx",)
