"""Dictionary trainings run back to back by one caller, each from raw
patches.

Parameters (``params``): ``samples`` (K), ``sets`` of patch pairs drawn
from the seed in set-up and alternated, ``iterations``, ``chunk``,
``cost_every``.  Every training goes through the port's
``solve("scdl", S_h, S_l, ...)`` with the configuration's settings and
the solver's default atom choice; its result is the pair of dictionaries
returned to the caller.  One training, drawn from the seed among those
that returned in the window, is compared with the plain reference run on
the same patches."""
from __future__ import annotations

from portbench import data, harness, loop
from portbench.profiling import span
from portbench.reference import compare, float32_products, scdl


def scdl_config(c: dict):
    from repro_torch.imaging.scdl import SCDLConfig
    return SCDLConfig(n_atoms=c["n_atoms"], lam_h=c["lam_h"],
                      lam_l=c["lam_l"], c1=c["c1"], c2=c["c2"], c3=c["c3"],
                      delta=c["delta"])


def make_sets(ctx, device=None):
    p, c = ctx.params, ctx.config
    with span("inputs"):
        return [data.patch_pairs(p["samples"], c["p_dim"], c["m_dim"],
                                 c["n_atoms"],
                                 ctx.generator("patches", k, device=device),
                                 sparsity=c["assumed"]["sparsity"],
                                 noise=c["assumed"]["noise"])
                for k in range(p["sets"])]


def work_count(ctx) -> dict:
    p, c = ctx.params, ctx.config
    return harness.work(c["name"]).per_iteration(
        {"K": p["samples"], "p_dim": c["p_dim"], "m_dim": c["m_dim"],
         "n_atoms": c["n_atoms"]})


def reference(ctx, S_h, S_l, matmul="fp32"):
    """The plain reference's dictionaries and costs on one set of
    patches (``matmul="tf32"``: the control)."""
    import torch
    p, c = ctx.params, ctx.config
    with span("reference"), float32_products(), torch.no_grad():
        return scdl.train(
            S_h, S_l, n_atoms=c["n_atoms"], lam_h=c["lam_h"],
            lam_l=c["lam_l"], c1=c["c1"], c2=c["c2"], c3=c["c3"],
            delta=c["delta"], iterations=p["iterations"], chunk=p["chunk"],
            matmul=matmul)


def gaps(ctx, S_h, S_l, Xh, Xl, costs, ref) -> dict:
    """The numbers compared (``costs`` one per chunk): the objective's
    widest gap, and the gap of the returned dictionaries' fit to the
    patches (``scdl.fit``) from the reference dictionaries' fit."""
    import torch
    c = ctx.config
    Rh, Rl, ref_costs = ref

    def fit(h, l):
        with float32_products(), torch.no_grad():
            return scdl.fit(S_h, S_l, h, l, c_h=c["c1"] + c["c3"],
                            c_l=c["c2"] + c["c3"])

    ref_fit = fit(Rh, Rl)
    return {"cost_gap": compare.cost_gap(costs, ref_costs),
            "dict_fit_gap": compare.cost_gap([fit(Xh, Xl)], [ref_fit])}


def dict_gap(Xh, Xl, ref) -> float:
    """The dictionaries' widest entry gap (not compared: rounding moves
    the trained dictionaries by about as much as a lower precision)."""
    return max(compare.matrix_gap(Xh, ref[0]), compare.matrix_gap(Xl, ref[1]))


def reference_gaps(ctx, S_h, S_l, result) -> dict:
    """The trained dictionaries and costs against the plain reference's
    on the same patches."""
    (Xh, Xl), costs = result
    return gaps(ctx, S_h, S_l, Xh, Xl,
                compare.chunk_costs(costs, ctx.params["chunk"]),
                reference(ctx, S_h, S_l))


def readings(ctx, faults: bool = False) -> dict:
    """For the limits: the program's gaps and the control's (the
    reference with TF32 products) on the set this seed judges, at the
    cell's size; with ``faults``, also the program's under each fault of
    ``portbench.faults``."""
    from repro_torch.core.problem import solve
    from repro_torch.imaging.scdl import SCDLProblem
    p = ctx.params
    k = int(ctx.uniform("judged") * p["sets"])
    S_h, S_l = make_sets(ctx)[k]

    def program():
        sol = solve(SCDLProblem(scdl_config(ctx.config)), S_h, S_l,
                    device=ctx.device, max_iter=p["iterations"], tol=0.0,
                    chunk=p["chunk"], cost_every=p["cost_every"])
        return sol.x, compare.chunk_costs(sol.log.costs, p["chunk"])

    (Xh, Xl), costs = program()
    ref = reference(ctx, S_h, S_l)
    out = {}
    if faults:
        from portbench import faults as planted
        for name, target, hook, wrap in planted.scdl_faults():
            with planted.planted(target, hook, wrap):
                (fh, fl), fc = program()
            out[name] = gaps(ctx, S_h, S_l, fh, fl, fc, ref)
    Ch, Cl, ctl_costs = reference(ctx, S_h, S_l, matmul="tf32")
    return {**out, "program": gaps(ctx, S_h, S_l, Xh, Xl, costs, ref),
            "control": gaps(ctx, S_h, S_l, Ch, Cl, ctl_costs, ref),
            "dict_gap": {"program": dict_gap(Xh, Xl, ref),
                         "control": dict_gap(Ch, Cl, ref)}}


def run(ctx) -> harness.Outcome:
    import torch

    from repro_torch.core.problem import solve
    from repro_torch.imaging.scdl import SCDLProblem

    p = ctx.params
    sets = make_sets(ctx)
    cfg = scdl_config(ctx.config)

    def unit(k, progress):
        S_h, S_l = sets[k]
        with span("solve"):
            sol = solve(SCDLProblem(cfg), S_h, S_l, device=ctx.device,
                        max_iter=p["iterations"], tol=0.0, chunk=p["chunk"],
                        cost_every=p["cost_every"], progress_fn=progress)
        return (sol.x, list(sol.log.costs)), sol.log, S_h.shape[1]

    record, attempted, failed, kept = loop.closed_loop(
        ctx, torch, unit, len(sets), p["chunk"], work_count(ctx))
    done = sorted(kept)

    def judge():
        if not done:
            return {}
        k = done[int(ctx.uniform("judged") * len(done))]
        return reference_gaps(ctx, *sets[k], kept[k])

    return harness.Outcome(
        record=record, attempted=attempted, failed=failed,
        memory_peak_bytes=record["memory_peak_bytes"], judge=judge,
        trace=record.get("trace"))
