"""The plain references against the port on the CPU at small sizes, and
the control: a lower precision put in the program's place fails the
comparison that decides ``correct``."""
import numpy as np
import pytest
import torch

from portbench import data, harness, seeds
from portbench.reference import compare, deconv_sparse, scdl
from portbench.traffic import catalogue_loop, training_loop

from repro_torch.core.problem import solve
from repro_torch.imaging.condat import SolverConfig
from repro_torch.imaging.deconvolve import DeconvolutionProblem
from repro_torch.imaging.scdl import SCDLConfig, SCDLProblem


def _ctx(cell, **params):
    spec = harness.workload(cell)
    spec["params"] = dict(spec["params"], **params)
    return harness.Run(cell, 2 ** 31 + 17, 0, False, device="cpu", spec=spec)


@pytest.fixture(scope="module")
def deconv_case():
    ctx = _ctx("deconv-sparse-10k")
    p, c = ctx.params, ctx.config
    Y, psfs = data.catalogue(256, seeds.generator(5, "stamps"))
    cfg = SolverConfig(mode="sparse", n_scales=c["n_scales"],
                       k_sigma=c["k_sigma"])
    sol = solve(DeconvolutionProblem(cfg, sigma_noise=c["sigma_noise"]), Y,
                psfs, device="cpu", max_iter=p["iterations"], tol=0.0,
                chunk=p["chunk"], cost_every=p["cost_every"])
    ref = catalogue_loop.reference(ctx, Y, psfs)
    return ctx, Y, psfs, sol, ref


def test_deconv_reference_matches_the_port(deconv_case):
    ctx, _, _, sol, ref = deconv_case
    g = catalogue_loop.gaps(sol.x, compare.chunk_costs(
        sol.log.costs, ctx.params["chunk"]), ref)
    limits = ctx.workload["limits"]
    assert set(g) == set(limits)
    for k, v in g.items():
        assert v <= limits[k] / 10, (k, v)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_deconv_lower_precision_output_fails(deconv_case, dtype):
    """The port's iterate and costs stored in a lower precision fail."""
    ctx, _, _, sol, ref = deconv_case
    x = torch.as_tensor(sol.x).to(dtype).float().numpy()
    costs = [float(torch.tensor(c).to(dtype)) for c in
             compare.chunk_costs(sol.log.costs, ctx.params["chunk"])]
    g = catalogue_loop.gaps(x, costs, ref)
    assert g["stamp_gap"] > ctx.workload["limits"]["stamp_gap"]


def test_deconv_control_fails(deconv_case):
    """The control: the reference with its state in bfloat16 in the
    program's place."""
    ctx, Y, psfs, _, ref = deconv_case
    X, costs = catalogue_loop.reference(ctx, Y, psfs,
                                        round_state=torch.bfloat16)
    g = catalogue_loop.gaps(X.numpy(), costs, ref)
    limits = ctx.workload["limits"]
    assert g["stamp_gap"] > 10 * limits["stamp_gap"]
    assert g["cost_gap"] > limits["cost_gap"]


def test_deconv_operators_are_adjoint():
    g = seeds.generator(3, "adjoint")
    x = torch.randn((6, 41, 41), generator=g)
    y = torch.randn((6, 41, 41), generator=g)
    _, psfs = data.catalogue(6, seeds.generator(4, "psf"))
    kf = deconv_sparse.psf_spectrum(psfs)
    lhs = torch.sum(deconv_sparse.convolve(x, kf) * y)
    rhs = torch.sum(x * deconv_sparse.convolve(y, kf, adjoint=True))
    assert float(abs(lhs - rhs)) <= 1e-4 * float(abs(lhs))
    w = torch.randn((4, 6, 41, 41), generator=g)
    lhs = torch.sum(deconv_sparse.phi(x, 4) * w)
    rhs = torch.sum(x * deconv_sparse.phi_adjoint(w, 4))
    assert float(abs(lhs - rhs)) <= 1e-4 * float(abs(lhs))


@pytest.fixture(scope="module")
def scdl_case():
    ctx = _ctx("scdl-40k", samples=2048)
    p, c = ctx.params, ctx.config
    S_h, S_l = data.patch_pairs(2048, c["p_dim"], c["m_dim"], 128,
                                seeds.generator(6, "patches"))
    cfg = SCDLConfig(n_atoms=128, lam_h=c["lam_h"], lam_l=c["lam_l"],
                     c1=c["c1"], c2=c["c2"], c3=c["c3"], delta=c["delta"])
    sol = solve(SCDLProblem(cfg), S_h, S_l, device="cpu",
                max_iter=p["iterations"], tol=0.0, chunk=p["chunk"],
                cost_every=p["cost_every"])
    kw = dict(n_atoms=128, lam_h=c["lam_h"], lam_l=c["lam_l"], c1=c["c1"],
              c2=c["c2"], c3=c["c3"], delta=c["delta"],
              iterations=p["iterations"], chunk=p["chunk"])
    return ctx, S_h, S_l, sol, kw, scdl.train(S_h, S_l, **kw)


def test_scdl_reference_matches_the_port(scdl_case):
    ctx, S_h, S_l, sol, _, ref = scdl_case
    Xh, Xl = sol.x
    g = training_loop.gaps(ctx, S_h, S_l, Xh, Xl, compare.chunk_costs(
        sol.log.costs, ctx.params["chunk"]), ref)
    limits = ctx.workload["limits"]
    assert set(g) == set(limits)
    for k, v in g.items():
        assert v <= limits[k], (k, v)
    # the initial atoms are the solver's default choice
    assert torch.equal(scdl.default_atoms(2048, 128),
                       torch.randperm(2048, generator=torch.Generator()
                                      .manual_seed(3))[:128])


def test_scdl_lower_precision_in_the_port_fails(scdl_case, monkeypatch):
    """The port's iteration with its state stored in bfloat16 (each
    step's output rounded) fails; rounding only the returned costs to
    bfloat16 (2^-9) would hide under the cost limit, which leaves room
    for the rounding differences of the first chunk."""
    ctx, S_h, S_l, _, kw, ref = scdl_case
    orig = SCDLProblem.light_step

    def light(self, d, rep, axes):
        d, out = orig(self, d, rep, axes)
        return ({k: v.to(torch.bfloat16).float() for k, v in d.items()},
                {k: v.to(torch.bfloat16).float() for k, v in out.items()})

    monkeypatch.setattr(SCDLProblem, "light_step", light)
    c, p = ctx.config, ctx.params
    cfg = SCDLConfig(n_atoms=128, lam_h=c["lam_h"], lam_l=c["lam_l"],
                     c1=c["c1"], c2=c["c2"], c3=c["c3"], delta=c["delta"])
    sol = solve(SCDLProblem(cfg), S_h, S_l, device="cpu",
                max_iter=p["iterations"], tol=0.0, chunk=p["chunk"],
                cost_every=p["cost_every"])
    Xh, Xl = sol.x
    g = training_loop.gaps(ctx, S_h, S_l, Xh, Xl, compare.chunk_costs(
        sol.log.costs, p["chunk"]), ref)
    limits = ctx.workload["limits"]
    assert any(g[k] > limits[k] for k in limits), g


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -12, 3.0], dtype=torch.float32)
    y = scdl.tf32(x)
    assert y.tolist() == [1.0 + 2 ** -10, 1.0, 3.0]
    z = np.frombuffer(scdl.tf32(torch.randn(1000)).numpy().tobytes(),
                      dtype=np.int32)
    assert np.all(z & 0x1FFF == 0)


@pytest.mark.card
@pytest.mark.parametrize("cell", ["deconv-sparse-10k", "scdl-40k"])
def test_control_fails_at_the_cells_size(card, cell):
    """On the chip, at the cell's own size: the control (the reference
    in the next lower precision) reads above the cell's limit."""
    ctx = harness.Run(cell, 2 ** 31 + 23, 0, False)
    r = harness.traffic(ctx.workload["traffic"]).readings(ctx)
    limits = ctx.workload["limits"]
    assert all(r["program"][k] <= limits[k] for k in limits), r
    assert any(r["control"][k] > limits[k] for k in limits), r
