"""The port's low-rank paths against the JAX package: the nuclear-norm
operators (``imaging/lowrank.py``), the plain versions of the Jacobi
factorizations, the low-rank deconvolution (``mode="lowrank"``) and the
``"lowrank"`` completion workload.

Same inputs, made with numpy (or drawn by the JAX package and handed
over as numpy), go through ``repro`` on the CPU and through
``repro_torch`` with ``device="cpu"``, where the Jacobi wrappers take
their plain versions (``torch.linalg``): the same algebra as on the
card, where only the small factorizations run in the kernels.  The JAX
package draws the test matrix Omega from ``PRNGKey(7)`` and the PSF
power iteration's start from ``PRNGKey(0)``; the tests pass those draws
to the port (``omega=``, ``u0=``/``v0=``).

Tolerances:
- operators (SVT, randomized SVT, the range finder's nuclear norm):
  rtol 1e-5 on basis-invariant outputs, with an atol of 1e-5 of the
  largest entry for entries near zero; the port reduces B^T by QR before
  its SVD, the JAX package factors B itself, so they agree to rounding.
  Where the range finder's Gram has directions far below its largest
  (a low-rank signal under noise), rounding is magnified in both
  packages: there the port must stay within twice the JAX package's
  distance from the fp64 value of the same algebra;
- plain Jacobi versions: reconstruction and orthogonality within
  64 r eps (fp32) of the input's scale;
- solves: costs rtol 1e-4, iterates rtol 1e-4 / atol 1e-6
  (``tests/test_solve_many.py``), equal ``iters_run``.  The deconvolution
  runs n = 32 stamps of 21 x 21 at rank 8 (r = 16 < n, so the range
  finder's Gram has full rank and its 1e-6 clip never decides on
  rounding); the completion mirrors ``tests/test_problem_api.py``, and
  its iterate, whose fp32 rounding lies above an elementwise 1e-6, is
  held within 1e-4 of its largest entry and, against the fp64 value of
  the same algebra, within twice the JAX package's distance;
- bundles carried through ``repro_torch.convert``: leaves rtol 1e-4,
  round trips exact.
"""
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
from repro.imaging import lowrank as jlr
from repro.imaging import psf as jpsf
from repro.imaging.condat import SolverConfig as JConfig
from repro_torch.convert import bundle_from_numpy, bundle_to_numpy
from repro_torch.core.compat import axes_of
from repro_torch.core.problem import solve
from repro_torch.imaging import deconvolve, lowrank
from repro_torch.imaging.condat import SolverConfig
from repro_torch.kernels.condat_elwise.kernel import condat_primal_fwd
from repro_torch.kernels.jacobi import kernel as jk
from repro_torch.kernels.jacobi import ops as jops
from repro_torch.launch.mesh import make_mesh

torch.set_num_threads(2)

EPS32 = float(np.finfo(np.float32).eps)
COSTS = dict(rtol=1e-4)
ITERATE = dict(rtol=1e-4, atol=1e-6)
N, S, RANK, LAM = 32, 21, 8, 0.05


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _low_rank(seed, n, p, k, noise):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, k)) @ rng.standard_normal((k, p))
    return (a + noise * rng.standard_normal((n, p))).astype(np.float32)


# ------------------------------------------------------------ operators
@pytest.mark.parametrize("shape", [(40, 30), (30, 40)])
def test_svt_matches_jax(shape):
    a = _low_rank(1, *shape, 5, 0.1)
    t = float(np.linalg.svd(a, compute_uv=False)[3])
    _close(lowrank.svt(_t(a), t).numpy(), jlr.svt(jnp.asarray(a), t))


def _svt64(a, omega, t, eps=1e-6):
    """The randomized SVT's algebra in fp64 (numpy): the value both fp32
    implementations approximate."""
    a, omega = a.astype(np.float64), omega.astype(np.float64)
    y = a @ omega
    w, V = np.linalg.eigh(y.T @ y)
    scale = np.where(w > eps * w.max(), 1 / np.sqrt(np.maximum(w, 1e-30)),
                     0.0)
    q = y @ (V * scale)
    u, s, vt = np.linalg.svd(q.T @ a, full_matrices=False)
    return (q @ u) * np.maximum(s - t, 0.0) @ vt


SVT_CASES = [(200, 60, 8), (64, 48, 12), (500, 441, 16)]


@pytest.mark.parametrize("n,p,rank", SVT_CASES)
def test_randomized_svt_matches_jax(n, p, rank):
    """Same Omega (drawn by JAX), a Gaussian matrix: every Gram direction
    of the range finder is of the same order, so fp32 rounding is not
    magnified and the two packages agree to 1e-5."""
    a = (np.random.default_rng(2).standard_normal((n, p))
         / np.sqrt(p)).astype(np.float32)
    omega = np.asarray(jlr.make_test_matrix(p, rank))
    t = 0.5 * float(np.linalg.svd(a, compute_uv=False)[rank])
    got = lowrank.randomized_svt_local(_t(a), _t(omega), t)
    want = jlr.randomized_svt_local(jnp.asarray(a), jnp.asarray(omega), t)
    assert tuple(got.shape) == (n, p) and np.abs(want).max() > 0
    _close(got.numpy(), want)


@pytest.mark.parametrize("n,p,rank", SVT_CASES)
def test_randomized_svt_near_the_noise_floor(n, p, rank):
    """A rank-(rank / 2) signal under noise: the Gram's noise directions
    lie 1e-4 to 1e-5 below its largest, and the range finder scales each
    by lambda^-1/2, which magnifies fp32 rounding to about 1e-5 of the
    largest entry in either package.  The port must stay as close to the
    fp64 value of the same algebra as the JAX package does (within twice
    its distance)."""
    a = _low_rank(2, n, p, rank // 2, 0.05)
    omega = np.asarray(jlr.make_test_matrix(p, rank))
    t = float(np.linalg.svd(a, compute_uv=False)[rank // 4])
    exact = _svt64(a, omega, t)
    scale = np.abs(exact).max()
    got = lowrank.randomized_svt_local(_t(a), _t(omega), t).numpy()
    want = np.asarray(jlr.randomized_svt_local(jnp.asarray(a),
                                               jnp.asarray(omega), t))
    err_jax = np.abs(want - exact).max() / scale
    err_port = np.abs(got - exact).max() / scale
    assert err_port <= 2 * err_jax + 1e-6, (err_port, err_jax)


def test_randomized_svt_takes_a_tensor_threshold():
    """The solvers pass lam / sig as a 0-d tensor: the same result."""
    a = _low_rank(3, 100, 50, 4, 0.05)
    om = lowrank.make_test_matrix(50, 8)
    t = float(np.linalg.svd(a, compute_uv=False)[2])
    np.testing.assert_array_equal(
        lowrank.randomized_svt_local(_t(a), om, torch.tensor(t)).numpy(),
        lowrank.randomized_svt_local(_t(a), om, t).numpy())


def test_nuclear_norm_rf_matches_jax():
    """A Gaussian X, so the projection's Gram has full rank: the port and
    the JAX package agree to 1e-5.  When rank(X) < r the Gram's other
    eigenvalues are rounding, whose square roots add about 1e-4 of the
    norm, differently in each package: 1e-3 there."""
    x = np.random.default_rng(4).standard_normal((120, 80)).astype(
        np.float32)
    omega = np.asarray(jlr.make_test_matrix(80, 8))
    got = float(lowrank.nuclear_norm_rf(_t(x), _t(omega), None))
    want = float(jlr.nuclear_norm_rf(jnp.asarray(x), jnp.asarray(omega),
                                     None))
    assert got == pytest.approx(want, rel=1e-5)
    low = _low_rank(4, 120, 80, 6, 0.0)
    assert float(lowrank.nuclear_norm_rf(_t(low), _t(omega), None)) == \
        pytest.approx(float(jlr.nuclear_norm_rf(jnp.asarray(low),
                                                jnp.asarray(omega), None)),
                      rel=1e-3)


def test_make_test_matrix_shape_seed_and_scale():
    om = lowrank.make_test_matrix(1681, 16)
    assert tuple(om.shape) == jlr.make_test_matrix(1681, 16).shape \
        == (1681, 24)
    assert om.dtype == torch.float32 and om.device.type == "cpu"
    # seeded 7 by default, the same on every call
    assert torch.equal(om, lowrank.make_test_matrix(1681, 16))
    assert tuple(lowrank.make_test_matrix(50, 6, 12).shape) == (50, 18)
    g = torch.Generator().manual_seed(8)
    assert not torch.equal(om, lowrank.make_test_matrix(1681, 16,
                                                        generator=g))
    # entries N(0, 1/p), as the JAX draw
    assert float(om.std()) * 1681 ** 0.5 == pytest.approx(1.0, rel=0.05)


def test_injected_omega_is_checked():
    with pytest.raises(ValueError, match=r"omega must be \(50, 14\)"):
        lowrank.resolve_omega(np.zeros((50, 13)), 50, 6, 8, "cpu")
    om = lowrank.resolve_omega(np.ones((50, 14)), 50, 6, 8, "cpu")
    assert om.dtype == torch.float32 and tuple(om.shape) == (50, 14)


def test_axes_raise_until_multi_device(tmp_path):
    """A13 is in: the two products over the rows are summed over the
    ``Axes`` of a mesh.  Bare axis names carry no process group and
    raise ``TypeError``; on a one-rank gloo mesh both functions give
    their meshless results bit for bit."""
    g = torch.Generator().manual_seed(0)
    a, om = torch.randn(8, 6, generator=g), torch.randn(6, 4, generator=g)
    with pytest.raises(TypeError, match="Axes"):
        lowrank.randomized_svt_local(a, om, 0.1, axes=("data",))
    with pytest.raises(TypeError, match="Axes"):
        lowrank.nuclear_norm_rf(a, om, ("data",))
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "s"), 1),
                            timeout=datetime.timedelta(seconds=60))
    try:
        axes = axes_of(make_mesh((1,), ("data",), device="cpu"), ("data",))
        assert axes and axes.size == 1
        torch.testing.assert_close(
            lowrank.randomized_svt_local(a, om, 0.1, axes=axes),
            lowrank.randomized_svt_local(a, om, 0.1), rtol=0, atol=0)
        torch.testing.assert_close(lowrank.nuclear_norm_rf(a, om, axes),
                                   lowrank.nuclear_norm_rf(a, om, ()),
                                   rtol=0, atol=0)
    finally:
        dist.destroy_process_group()


# --------------------------------------------- Jacobi plain versions
def _sym(r, seed):
    a = np.random.default_rng(seed).standard_normal((r, r))
    return ((a + a.T) / 2).astype(np.float32)


@pytest.mark.parametrize("r", [1, 24, 40, 64])
def test_eigh_plain_conventions(r):
    """Ascending eigenvalues, eigenvectors as columns, the eigvalsh form
    giving eigh's values; a non-symmetric input is symmetrized, as
    jnp.linalg.eigh does."""
    A = _sym(r, r)
    w, V = jops.eigh(_t(A))
    assert bool((w[1:] >= w[:-1]).all())
    tol = 64 * r * EPS32
    scale = np.abs(A).max()
    np.testing.assert_allclose(((V * w) @ V.T).numpy(), A, atol=tol * scale)
    np.testing.assert_allclose((V.T @ V).numpy(), np.eye(r), atol=tol)
    np.testing.assert_allclose(jops.eigh(_t(A), compute_v=False).numpy(),
                               w.numpy(), atol=tol * scale)
    skew = np.triu(np.ones((r, r), np.float32), 1)
    wj = np.asarray(jnp.linalg.eigh(jnp.asarray(A + skew))[0])
    ws = jops.eigh(_t(A + skew), compute_v=False).numpy()
    np.testing.assert_allclose(ws, wj, atol=tol * (scale + 1))


@pytest.mark.parametrize("r", [1, 24, 40, 64])
def test_svd_plain_conventions(r):
    """Descending singular values and R = U diag(s) Vh."""
    R = np.random.default_rng(r).standard_normal((r, r)).astype(np.float32)
    U, s, Vh = jops.svd(_t(R))
    assert bool((s[1:] <= s[:-1]).all())
    np.testing.assert_allclose(((U * s) @ Vh).numpy(), R,
                               atol=64 * r * EPS32 * np.abs(R).max())
    np.testing.assert_allclose(s.numpy(), np.linalg.svd(R, compute_uv=False),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("r", [24, 40, 64])
def test_clip_count_on_grams_of_known_rank(r):
    """The randomized SVT keeps the Gram directions above 1e-6 of the
    largest eigenvalue: r / 2 of a rank-r/2 Gram, r of a full one, the
    same count as JAX's."""
    rng = np.random.default_rng(r)
    for rank in (r // 2, r):
        y = (rng.standard_normal((4 * r, rank))
             @ rng.standard_normal((rank, r))).astype(np.float32)
        G = y.T @ y
        w = jops.eigh(_t(G), compute_v=False).numpy()
        wj = np.asarray(jnp.linalg.eigvalsh(jnp.asarray(G)))
        assert (w > 1e-6 * w.max()).sum() == (wj > 1e-6 * wj.max()).sum() \
            == rank


def test_jacobi_wrappers_on_the_cpu():
    """A CPU tensor takes the plain version and launches nothing; the
    kernel route refuses CPU tensors, sides above 64 and other dtypes."""
    before = (jk.eigh_fwd.launches, jk.svd_fwd.launches)
    A = _t(_sym(8, 1))
    jops.eigh(A)
    jops.svd(A)
    assert (jk.eigh_fwd.launches, jk.svd_fwd.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        jops.eigh(A, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        jops.svd(A, use_kernel=True)
    with pytest.raises(ValueError, match="r = 65"):
        jk.eigh_fwd(torch.zeros(65, 65))
    with pytest.raises(ValueError, match="r = 65"):
        jk.svd_fwd(torch.zeros(65, 65))
    with pytest.raises(ValueError, match="float32"):
        # the wrapper's own dtype check rejects fp64
        jk.eigh_fwd(torch.zeros(8, 8, dtype=torch.float64))  # repro-lint: disable=RPL401
    with pytest.raises(ValueError, match="square"):
        jk.svd_fwd(torch.zeros(8, 6))
    assert (jk.eigh_fwd.launches, jk.svd_fwd.launches) == before


# ------------------------------------------- low-rank deconvolution
@pytest.fixture(scope="module")
def stamps():
    d = jpsf.simulate(N, jax.random.PRNGKey(3), stamp=S)
    Y, P = np.asarray(d.Y), np.asarray(d.psfs)
    ku, kv = jax.random.split(jax.random.PRNGKey(0))
    draws = dict(u0=np.asarray(jax.random.normal(ku, P.shape)),
                 v0=np.asarray(jax.random.normal(kv, P.shape)),
                 omega=np.asarray(jlr.make_test_matrix(S * S, RANK)))
    return Y, P, draws


def _cfgs():
    return (SolverConfig(mode="lowrank", lam=LAM, rank=RANK),
            JConfig(mode="lowrank", lam=LAM, rank=RANK))


# (cost_every, tol, cost_window): each converges inside 32 iterations (at
# 16, 24, 24) at a check where the relative change is 4x or more below
# tol, and 3.5x or more above it at the check before
MODES = [(1, 5e-5, 3), (3, 3e-5, 3), ("chunk", 1e-4, 1)]


@pytest.mark.parametrize("cost_every,tol,window", MODES)
def test_lowrank_deconvolution_matches_jax(stamps, cost_every, tol, window):
    Y, P, draws = stamps
    cfg, jcfg = _cfgs()
    kw = dict(max_iter=32, tol=tol, chunk=8, cost_every=cost_every,
              cost_window=window)
    want = jsolve("deconvolve", Y, P, cfg=jcfg, **kw)
    got = solve(deconvolve.DeconvolutionProblem(cfg, **draws), Y, P,
                device="cpu", **kw)
    assert got.log.iters_run == want.log.iters_run < 32
    assert got.log.converged_at == want.log.converged_at is not None
    jc, tc = np.asarray(want.log.costs), np.asarray(got.log.costs)
    assert tc.shape == jc.shape
    fin = np.isfinite(jc)
    np.testing.assert_array_equal(np.isfinite(tc), fin)
    np.testing.assert_allclose(tc[fin], jc[fin], **COSTS)
    np.testing.assert_allclose(got.x, np.asarray(want.x), **ITERATE)


def test_lowrank_build_bundle_matches_jax(stamps):
    Y, P, draws = stamps
    cfg, jcfg = _cfgs()
    jb, jsteps = jdeconv.build_bundle(Y, P, jcfg)
    tb, steps = deconvolve.build_bundle(Y, P, cfg, device="cpu", **draws)
    assert steps["tau"] == pytest.approx(jsteps["tau"], rel=1e-5)
    assert steps["sig"] == jsteps["sig"] == 0.5
    data, rep = bundle_to_numpy(tb)
    want = jgather(jb)
    assert sorted(data) == sorted(want) == ["HX", "Xd", "Xp", "Y", "psf_fp"]
    for k, v in want.items():
        assert data[k].shape == v.shape and data[k].dtype == v.dtype, k
        np.testing.assert_allclose(data[k], v, rtol=1e-4,
                                   atol=1e-6 * max(np.abs(v).max(), 1.0),
                                   err_msg=k)
    assert sorted(rep) == sorted(jb.replicated) == ["omega", "sig", "tau"]
    np.testing.assert_array_equal(rep["omega"],
                                  np.asarray(jb.replicated["omega"]))
    assert tb.record_axes == {}


def test_lowrank_bundle_through_convert(stamps):
    """A JAX low-rank bundle crosses into the port with its dual kept
    record-major (n, S, S); three light steps in each package agree; the
    numpy round trip is exact."""
    Y, P, _ = stamps
    cfg, jcfg = _cfgs()
    jb, _ = jdeconv.build_bundle(Y, P, jcfg)
    data = jgather(jb)
    rep = {k: np.asarray(v) for k, v in jb.replicated.items()}
    tb = bundle_from_numpy(data, rep, device="cpu")
    assert tuple(tb.data["Xd"].shape) == (N, S, S)
    assert tb.record_axis("Xd") == 0
    back, back_rep = bundle_to_numpy(tb)
    for k, v in data.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    for k, v in rep.items():
        np.testing.assert_array_equal(back_rep[k], v, err_msg=k)

    jlight = jax.jit(lambda d, r: jdeconv.make_light_step_fn(jcfg)(d, r, ()))
    light = deconvolve.make_light_step_fn(cfg)
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


def test_lowrank_deconvolution_launches_no_kernel_on_the_cpu(stamps):
    Y, P, draws = stamps
    before = (condat_primal_fwd.launches, jk.eigh_fwd.launches,
              jk.svd_fwd.launches)
    solve(deconvolve.DeconvolutionProblem(_cfgs()[0], **draws), Y, P,
          device="cpu", max_iter=2, chunk=2, cost_every="chunk")
    assert (condat_primal_fwd.launches, jk.eigh_fwd.launches,
            jk.svd_fwd.launches) == before


# ------------------------------------------------------- completion
@pytest.fixture(scope="module")
def completion():
    """tests/test_problem_api.py's chunked-parity data and config."""
    from repro.imaging.lowrank import CompletionConfig as JCC
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(9), 3)
    A = jax.random.normal(k1, (32, 3)) @ jax.random.normal(k2, (3, 24))
    M = (jax.random.uniform(k3, A.shape) < 0.7).astype(A.dtype)
    omega = np.asarray(jlr.make_test_matrix(24, 6))
    return (A, M, np.asarray(A), np.asarray(M), omega,
            JCC(rank=6, lam=0.05, max_iter=12))


def _completion64(A, M, omega, iters, lam, step, eps=1e-6):
    """The completion's iterate after ``iters`` steps, in fp64 (numpy)."""
    A, M = np.asarray(A, np.float64), np.asarray(M, np.float64)
    Y = A * M
    X = Y.copy()
    for _ in range(iters):
        X = _svt64(X - step * M * (X - Y), omega, lam * step, eps)
    return X


@pytest.mark.parametrize("cost_every", [1, 3, "chunk"])
@pytest.mark.parametrize("chunk", [1, 4, 5])
def test_completion_matches_jax(completion, cost_every, chunk):
    """Costs elementwise at rtol 1e-4.  The iterate (entries up to about
    5) within 1e-4 of its largest entry: an elementwise atol of 1e-6 lies
    below this workload's fp32 rounding, since the JAX package's own
    iterate is 2e-5 to 6e-5 from the fp64 value of the same algebra on
    such data; so the port is also held to its own distance from that
    value, within twice the JAX package's."""
    jA, jM, A, M, omega, jcfg = completion
    want = jsolve("lowrank", jA, jM, cfg=jcfg, tol=0, chunk=chunk,
                  cost_every=cost_every)
    problem = lowrank.LowRankCompletionProblem(
        lowrank.CompletionConfig(rank=6, lam=0.05, max_iter=12), omega=omega)
    got = solve(problem, A, M, device="cpu", tol=0, chunk=chunk,
                cost_every=cost_every)
    assert got.log.iters_run == want.log.iters_run == 12
    jc, tc = np.asarray(want.log.costs), np.asarray(got.log.costs)
    fin = np.isfinite(jc)
    np.testing.assert_array_equal(np.isfinite(tc), fin)
    np.testing.assert_allclose(tc[fin], jc[fin], **COSTS)
    jx = np.asarray(want.x)
    _close(got.x, jx, rtol=1e-4)
    exact = _completion64(A, M, omega.astype(np.float64), 12, 0.05, 1.0)
    err_jax = np.abs(jx - exact).max()
    assert np.abs(got.x - exact).max() <= 2 * err_jax + 1e-6


def test_completion_recovers():
    """tests/test_problem_api.py::test_lowrank_completion_recovers in the
    port: a rank-4 (64, 48) matrix from 60 % of its entries."""
    rng = np.random.default_rng(0)
    A = (rng.standard_normal((64, 4)) @ rng.standard_normal((4, 48))
         ).astype(np.float32)
    M = (rng.random(A.shape) < 0.6).astype(np.float32)
    cfg = lowrank.CompletionConfig(rank=12, oversample=12, lam=0.2, step=0.9,
                                   max_iter=300)
    sol = solve("lowrank", A, M, cfg=cfg, device="cpu", tol=0)
    err0 = np.linalg.norm(M * A - A) / np.linalg.norm(A)
    err = np.linalg.norm(sol.x - A) / np.linalg.norm(A)
    assert err < 0.1 * err0
    assert sol.log.costs[-1] < sol.log.costs[0]


def test_completion_bundle_round_trip(completion):
    """The completion's leaves keep the JAX layout through ``convert``."""
    jA, jM, A, M, omega, jcfg = completion
    jb = jlr.LowRankCompletionProblem(jcfg).init_bundle((jA, jM), None)
    data = jgather(jb)
    rep = {k: np.asarray(v) for k, v in jb.replicated.items()}
    tb = bundle_from_numpy(data, rep, device="cpu")
    assert tb.record_axes == {} and tuple(tb.data["X"].shape) == (32, 24)
    back, back_rep = bundle_to_numpy(tb)
    for k, v in data.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    np.testing.assert_array_equal(back_rep["omega"], rep["omega"])
    # and the port's own bundle holds the same leaves
    mine = lowrank.LowRankCompletionProblem(
        lowrank.CompletionConfig(rank=6, lam=0.05), omega=omega
    ).init_bundle((A, M), torch.device("cpu"))
    for k, v in data.items():
        np.testing.assert_allclose(mine.data[k].numpy(), v, rtol=1e-6,
                                   err_msg=k)


def test_completion_batch_axes_and_cpu_launches(completion):
    _, _, A, M, omega, _ = completion
    problem = lowrank.LowRankCompletionProblem(
        lowrank.CompletionConfig(rank=6, lam=0.05), omega=omega)
    ax = problem.batch_axes()
    assert ax.shared_in_batch == ("omega",)
    assert ax.instance_invariant == ("omega",)
    before = (jk.eigh_fwd.launches, jk.svd_fwd.launches)
    solve(problem, A, M, device="cpu", max_iter=2, chunk=2)
    assert (jk.eigh_fwd.launches, jk.svd_fwd.launches) == before


def test_completion_without_cuda_raises(completion):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a card")
    _, _, A, M, _, _ = completion
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        solve("lowrank", A, M, max_iter=1)
