"""Catalogues deconvolved one after another by one caller.

Parameters (``params``): ``stamps`` per catalogue, ``catalogues``
drawn from the seed in set-up and cycled, ``iterations``, ``chunk``,
``cost_every``.  Every catalogue goes through the port's
``solve("deconvolve", Y, psfs, ...)`` with the configuration's solver
settings and the solver's default draws, and its result is the
iterate returned to the caller (on the host).  One catalogue, drawn from
the seed among those that returned in the window, is compared with the
plain reference run on the same stamps."""
from __future__ import annotations

from portbench import data, harness, loop
from portbench.profiling import span
from portbench.reference import compare, deconv_sparse, float32_products


def reference(ctx, Y, psfs, round_state=None):
    """The plain reference's iterate and costs on one catalogue
    (``round_state``: the control's storage precision)."""
    import torch
    p, c = ctx.params, ctx.config
    with span("reference"), float32_products(), torch.no_grad():
        return deconv_sparse.solve(
            Y, psfs, n_scales=c["n_scales"], sigma_noise=c["sigma_noise"],
            k_sigma=c["k_sigma"], iterations=p["iterations"], chunk=p["chunk"],
            round_state=round_state)


def gaps(x, costs, ref) -> dict:
    """The numbers compared; ``costs`` one per chunk."""
    X_ref, ref_costs = ref
    return {"stamp_gap": compare.stamp_gap(x, X_ref),
            "cost_gap": compare.cost_gap(costs, ref_costs)}


def readings(ctx, faults: bool = False) -> dict:
    """For the limits: the program's gaps and the control's (the
    reference with its state in bfloat16) on the catalogue this seed
    judges, at the cell's size."""
    import torch

    from repro_torch.core.problem import solve
    from repro_torch.imaging.condat import SolverConfig
    from repro_torch.imaging.deconvolve import DeconvolutionProblem
    p, c = ctx.params, ctx.config
    k = int(ctx.uniform("judged") * p["catalogues"])
    Y, psfs = data.catalogue(p["stamps"], ctx.generator("catalogue", k),
                             stamp=c["stamp"], sigma=c["sigma_noise"])
    cfg = SolverConfig(mode=c["mode"], n_scales=c["n_scales"],
                       k_sigma=c["k_sigma"])
    sol = solve(DeconvolutionProblem(cfg, sigma_noise=c["sigma_noise"]), Y,
                psfs, device=ctx.device, max_iter=p["iterations"], tol=0.0,
                chunk=p["chunk"], cost_every=p["cost_every"])
    x, costs = sol.x, compare.chunk_costs(sol.log.costs, p["chunk"])
    del sol
    ref = reference(ctx, Y, psfs)
    ctl_x, ctl_costs = reference(ctx, Y, psfs, round_state=torch.bfloat16)
    return {"program": gaps(x, costs, ref),
            "control": gaps(ctl_x.cpu().numpy(), ctl_costs, ref)}


def run(ctx) -> harness.Outcome:
    import torch

    from repro_torch.core.problem import solve
    from repro_torch.imaging.condat import SolverConfig
    from repro_torch.imaging.deconvolve import DeconvolutionProblem

    p, c = ctx.params, ctx.config
    with span("inputs"):
        cats = [data.catalogue(p["stamps"], ctx.generator("catalogue", k),
                               stamp=c["stamp"], sigma=c["sigma_noise"])
                for k in range(p["catalogues"])]
    cfg = SolverConfig(mode=c["mode"], n_scales=c["n_scales"],
                       k_sigma=c["k_sigma"])

    def unit(k, progress):
        Y, psfs = cats[k]
        with span("solve"):
            sol = solve(DeconvolutionProblem(cfg, sigma_noise=c["sigma_noise"]),
                        Y, psfs, device=ctx.device,
                        max_iter=p["iterations"], tol=0.0, chunk=p["chunk"],
                        cost_every=p["cost_every"], progress_fn=progress)
        return (sol.x, list(sol.log.costs)), sol.log, Y.shape[0]

    work = harness.work(c["name"]).per_iteration(
        {"n": p["stamps"], "stamp": c["stamp"], "n_scales": c["n_scales"],
         "grid": deconv_sparse.fft_grid(c["stamp"])})
    record, attempted, failed, kept = loop.closed_loop(
        ctx, torch, unit, len(cats), p["chunk"], work)
    done = sorted(kept)

    def judge():
        if not done:
            return {}
        k = done[int(ctx.uniform("judged") * len(done))]
        x, costs = kept[k]
        return gaps(x, compare.chunk_costs(costs, p["chunk"]),
                    reference(ctx, *cats[k]))

    return harness.Outcome(
        record=record, attempted=attempted, failed=failed,
        memory_peak_bytes=record["memory_peak_bytes"], judge=judge,
        trace=record.get("trace"))
