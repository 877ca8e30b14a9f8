"""Catalogues deconvolved in low-rank mode one after another by one
caller.

Parameters (``params``): ``stamps`` per catalogue, ``catalogues``
drawn from the seed in set-up and cycled, ``iterations``, ``chunk``,
``cost_every``.  Every catalogue goes through the port's
``solve(DeconvolutionProblem(SolverConfig(mode="lowrank", ...)), Y,
psfs, ...)`` with the configuration's ``lam`` and ``rank`` and the
solver's default draws, and its result is the iterate returned to the
caller (on the host).  One catalogue, drawn from the seed among those
that returned in the window, is compared with the plain reference
(``reference/deconv_lowrank.py``) run on the same stamps.

A traced run profiles one more catalogue after the window, as
``loop.closed_loop`` does, and adds to its record the program's spans
(``spans.trace_spans``) and the device time of the operations launched
under ``repro_torch.lowrank.svt`` (``launches.trace_launches``), beside
the work of one SVT (``work/galaxy_deconv_lowrank.svt``).

    python3 -m portbench.traffic.lowrank_loop --seeds 1 2 3

prints, for each seed, how far the range finder's iterate and costs lie
from the reference's with the exact SVT (``torch.linalg.svd``) on the
catalogue that seed judges: a reading for ``PERF.md``, not a limit.
"""
from __future__ import annotations

import math
import time

from portbench import data, harness, launches, loop, profiling, spans
from portbench.profiling import span
from portbench.reference import compare, deconv_lowrank, deconv_sparse

SVT_SPAN = "lowrank.svt"
#: the least scale of a stamp in ``stamp_gap``, as a share of the median
#: over the catalogue of the stamps' largest reference values
SCALE_FLOOR = 0.1


def solver_config(c: dict):
    from repro_torch.imaging.condat import SolverConfig
    return SolverConfig(mode=c["mode"], n_scales=c["n_scales"],
                        lam=c["lam"], rank=c["rank"])


def shapes(ctx) -> dict:
    p, c = ctx.params, ctx.config
    return {"n": p["stamps"], "stamp": c["stamp"],
            "grid": deconv_sparse.fft_grid(c["stamp"]),
            "columns": c["rank"] + deconv_lowrank.OVERSAMPLE}


def catalogues(ctx) -> list:
    p, c = ctx.params, ctx.config
    with span("inputs"):
        return [data.catalogue(p["stamps"], ctx.generator("catalogue", k),
                               stamp=c["stamp"], sigma=c["sigma_noise"])
                for k in range(p["catalogues"])]


def program(ctx, Y, psfs, progress=None):
    """The port's solve of one catalogue, as a user calls it."""
    from repro_torch.core.problem import solve
    from repro_torch.imaging.deconvolve import DeconvolutionProblem
    p, c = ctx.params, ctx.config
    with span("solve"):
        return solve(DeconvolutionProblem(solver_config(c),
                                          sigma_noise=c["sigma_noise"]),
                     Y, psfs, device=ctx.device, max_iter=p["iterations"],
                     tol=0.0, chunk=p["chunk"], cost_every=p["cost_every"],
                     progress_fn=progress)


def reference(ctx, Y, psfs, round_state=None, exact=False):
    """The plain reference's iterate and costs on one catalogue
    (``round_state``: the control's storage precision; ``exact``: the
    SVT by a full SVD)."""
    import torch
    p, c = ctx.params, ctx.config
    with span("reference"), torch.no_grad():
        return deconv_lowrank.solve(
            Y, psfs, lam=c["lam"], rank=c["rank"],
            iterations=p["iterations"], chunk=p["chunk"],
            round_state=round_state, exact=exact)


def stamp_gap(x, ref) -> float:
    """The widest gap of any stamp, as a share of that stamp's scale:
    its largest reference value, floored at ``SCALE_FLOOR`` of the
    median of those over the catalogue.  The iteration drives a few
    stamps of a catalogue toward zero (peaks 200 times under the median
    at 2 000 stamps), where a share of the stamp's own peak reads the
    rounding of float32 against float64 as a gap of several percent;
    ``compare.stamp_gap`` is the same without the floor."""
    import numpy as np
    x, ref = (np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                         else v, dtype=np.float64) for v in (x, ref))
    if x.shape != ref.shape:
        return math.inf
    n = ref.shape[0]
    d = np.abs(x - ref).reshape(n, -1).max(axis=1)
    peak = np.abs(ref).reshape(n, -1).max(axis=1)
    scale = np.maximum(peak, SCALE_FLOOR * np.median(peak))
    gap = d / np.maximum(scale, 1e-30)
    return float(np.max(gap)) if np.all(np.isfinite(gap)) else math.inf


def gaps(x, costs, ref) -> dict:
    """The numbers compared; ``costs`` one per chunk."""
    X_ref, ref_costs = ref
    return {"stamp_gap": stamp_gap(x, X_ref),
            "cost_gap": compare.cost_gap(costs, ref_costs)}


def faults():
    """``(name, target, hook, wrapper)`` of each fault a deconvolution
    can have (``portbench.faults``)."""
    from portbench import faults as f
    from repro_torch.imaging.deconvolve import DeconvolutionProblem as D
    return [("state_unchanged", D, "light_step", f.deconv_unchanged),
            ("half_batch", D, "light_step", f.deconv_half_batch),
            ("answer_altered", D, "finalize", f.deconv_altered)]


def readings(ctx, faults_too: bool = False) -> dict:
    """For the limits: the program's gaps and the control's (the
    reference with its state in bfloat16) on the catalogue this seed
    judges, at the cell's size; with ``faults_too``, also the program's
    under each fault of ``portbench.faults``."""
    import torch
    p = ctx.params
    k = int(ctx.uniform("judged") * p["catalogues"])
    Y, psfs = catalogues(ctx)[k]

    def run():
        sol = program(ctx, Y, psfs)
        return sol.x, compare.chunk_costs(sol.log.costs, p["chunk"])

    x, costs = run()
    ref = reference(ctx, Y, psfs)
    out = {}
    if faults_too:
        from portbench import faults as planted
        for name, target, hook, wrap in faults():
            with planted.planted(target, hook, wrap):
                out[name] = gaps(*run(), ref)
    ctl_x, ctl_costs = reference(ctx, Y, psfs, round_state=torch.bfloat16)
    ctl_x = ctl_x.cpu().numpy()
    return {**out, "program": gaps(x, costs, ref),
            "control": gaps(ctl_x, ctl_costs, ref),
            "unfloored": {"program": compare.stamp_gap(x, ref[0]),
                          "control": compare.stamp_gap(ctl_x, ref[0])}}


def traced_unit(ctx, torch, unit, k, chunk, work) -> dict:
    """One more unit under the profiler: ``loop.trace_entry``'s record
    with the program's spans and the SVT's launches added."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function(profiling.WINDOW_SPAN):
            unit(k, lambda event: profiling.mark())
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    tl = profiling.Timeline(prof, wall)
    out = loop.trace_entry(tl, chunk, work)
    extra = spans.trace_spans(tl)
    out["breakdown"]["idle_by_span"] = extra.pop("idle_by_span")
    out.update(extra)
    out.update(launches.trace_launches(events, tl, SVT_SPAN),
               svt_work=harness.work(ctx.config["name"]).svt(shapes(ctx)))
    return out


def run(ctx) -> harness.Outcome:
    import torch

    p, c = ctx.params, ctx.config
    cats = catalogues(ctx)

    def unit(k, progress):
        Y, psfs = cats[k]
        sol = program(ctx, Y, psfs, progress)
        return (sol.x, list(sol.log.costs)), sol.log, Y.shape[0]

    work = harness.work(c["name"]).per_iteration(shapes(ctx))
    # the window as loop.closed_loop runs it; the traced unit is ours
    traced, ctx.trace = ctx.trace, False
    try:
        record, attempted, failed, kept = loop.closed_loop(
            ctx, torch, unit, len(cats), p["chunk"], work)
    finally:
        ctx.trace = traced
    if traced and ctx.device == "cuda":
        record["trace"] = traced_unit(ctx, torch, unit,
                                      attempted % len(cats), p["chunk"],
                                      work)
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


# ---------------------------------------------------------------- run
def exact_svt_readings(ctx) -> dict:
    """The range finder's reference (as judged) against the exact-SVT
    reference on the catalogue this seed judges, and Eq. 3's own
    objective (the nuclear norm by singular values) at both iterates."""
    k = int(ctx.uniform("judged") * ctx.params["catalogues"])
    Y, psfs = catalogues(ctx)[k]
    t0 = time.perf_counter()
    exact = reference(ctx, Y, psfs, exact=True)
    t1 = time.perf_counter()
    rf = reference(ctx, Y, psfs)
    t2 = time.perf_counter()
    lam = ctx.config["lam"]
    return {"catalogue": k, **gaps(rf[0].cpu().numpy(), rf[1], exact),
            "costs_exact": exact[1], "costs_range_finder": rf[1],
            "eq3_exact": deconv_lowrank.eq3_objective(Y, psfs, exact[0], lam),
            "eq3_range_finder": deconv_lowrank.eq3_objective(Y, psfs, rf[0],
                                                             lam),
            "exact_s": t1 - t0, "range_finder_s": t2 - t1}


def main(argv=None) -> int:
    import argparse
    import json

    from portbench import run as _run  # noqa: F401 (paths and caches)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="deconv-lowrank-10k")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        ctx = harness.Run(args.workload, seed, 0, False, device=args.device)
        print(json.dumps(dict(seed=seed, **exact_svt_readings(ctx))),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
