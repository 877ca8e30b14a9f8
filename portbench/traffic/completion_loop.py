"""Matrices completed one after another by one caller.

Parameters (``params``): ``matrices`` drawn from the seed in set-up and
cycled, ``iterations``, ``chunk``, ``cost_every``; the configuration
gives the shape (``rows``, ``cols``), the truth's rank, the share
observed and the solver's ``rank``, ``oversample``, ``lam`` and
``step``.  Each matrix is the protocol of Cai, Candes & Shen 2010
(Sec. 5.1): a truth M_L M_R^T with standard Gaussian factors, observed
where a uniform draw falls under the share, zero elsewhere, made on the
card.  Every matrix goes through the port's ``solve("lowrank", Y, M,
cfg=CompletionConfig(...), ...)`` with the solver's default test matrix,
and its result is the iterate returned to the caller (on the host); its
work is its rows.  One matrix, drawn from the seed among those that
returned in the window, is compared with the plain reference
(``reference/completion.py``) run on the same entries.

A traced run profiles one more matrix after the window, as
``loop.closed_loop`` does, and adds to its record the program's spans
(``spans.trace_spans``) and the device time of the operations launched
under ``repro_torch.lowrank.svt`` (``launched``) and under
``repro_torch.completion.grad`` (``grad_launched``;
``launches.by_launch``), beside the work of one SVT and of one masked
step (``work/lowrank_completion.svt`` and ``.grad``).

    python3 -m portbench.traffic.completion_loop --seeds 1 2 3

prints, for each seed, how far the range finder's iterate and costs lie
from the reference's with the exact SVT (``torch.linalg.svd``) on the
matrix that seed judges, and each one's relative recovery error against
the truth beside the observed entries': a reading for ``PERF.md``, not
a limit.
"""
from __future__ import annotations

import time

from portbench import harness, launches, loop, profiling, spans
from portbench.profiling import span
from portbench.reference import compare, completion
from portbench.traffic.lowrank_loop import SVT_SPAN, stamp_gap

GRAD_SPAN = "completion.grad"


def completion_config(c: dict):
    from repro_torch.imaging.lowrank import CompletionConfig
    return CompletionConfig(rank=c["rank"], oversample=c["oversample"],
                            lam=c["lam"], step=c["step"])


def shapes(ctx) -> dict:
    c = ctx.config
    return {"n": c["rows"], "p": c["cols"],
            "columns": c["rank"] + c["oversample"]}


def draw(ctx, k: int):
    """The truth ``A`` and the mask ``M`` of matrix ``k``, float32 on the
    run's device."""
    import torch
    c = ctx.config
    gen = ctx.generator("matrix", k)
    dev = gen.device
    left = torch.randn((c["rows"], c["true_rank"]), generator=gen,
                       device=dev)
    right = torch.randn((c["true_rank"], c["cols"]), generator=gen,
                        device=dev)
    M = (torch.rand((c["rows"], c["cols"]), generator=gen, device=dev)
         < c["observed"]).to(torch.float32)
    return left @ right, M


def matrices(ctx) -> list:
    """``(Y, M)`` of each matrix: the observed entries, zero elsewhere,
    and the mask."""
    out = []
    with span("inputs"):
        for k in range(ctx.params["matrices"]):
            A, M = draw(ctx, k)
            out.append(((A * M).contiguous(), M))
    return out


def program(ctx, Y, M, progress=None):
    """The port's completion of one matrix, as a user calls it."""
    from repro_torch.core.problem import solve
    p = ctx.params
    with span("solve"):
        return solve("lowrank", Y, M, cfg=completion_config(ctx.config),
                     device=ctx.device, max_iter=p["iterations"], tol=0.0,
                     chunk=p["chunk"], cost_every=p["cost_every"],
                     progress_fn=progress)


def reference(ctx, Y, M, round_state=None, exact=False):
    """The plain reference's iterate and costs on one matrix
    (``round_state``: the control's storage precision; ``exact``: the
    SVT by a full SVD)."""
    import torch
    p, c = ctx.params, ctx.config
    with span("reference"), torch.no_grad():
        return completion.solve(
            Y, M, lam=c["lam"], step=c["step"], rank=c["rank"],
            oversample=c["oversample"], iterations=p["iterations"],
            chunk=p["chunk"], round_state=round_state, exact=exact)


def gaps(x, costs, ref) -> dict:
    """The numbers compared; ``costs`` one per chunk.  ``row_gap`` is
    ``lowrank_loop.stamp_gap`` over the matrix's rows: the widest gap in
    a row over that row's largest reference value, floored at a tenth
    of the median of those."""
    X_ref, ref_costs = ref
    return {"row_gap": stamp_gap(x, X_ref),
            "cost_gap": compare.cost_gap(costs, ref_costs)}


# ------------------------------------------------------------- faults
def half_rows(orig):
    """Half of the rows left out: their iterate stays as it was."""
    def step(self, d, rep, axes):
        import torch
        new = orig(self, d, rep, axes)
        h = d["X"].shape[-2] // 2
        X = torch.cat([new["X"][..., :h, :], d["X"][..., h:, :]], dim=-2)
        return dict(new, X=X)
    return step


def faults():
    """``(name, target, hook, wrapper)`` of each fault a completion can
    have (planted with ``portbench.faults.planted`` or ``.patched``): its
    step returning its state unchanged, half the rows left unstepped, and
    the first row of the answer altered by 1 % (the deconvolution's
    wrappers serve the first and the last)."""
    from portbench import faults as f
    from repro_torch.imaging.lowrank import LowRankCompletionProblem as P
    return [("state_unchanged", P, "_iterate", f.deconv_unchanged),
            ("half_batch", P, "_iterate", half_rows),
            ("answer_altered", P, "finalize", f.deconv_altered)]


def readings(ctx, faults_too: bool = False) -> dict:
    """For the limits: the program's gaps and the control's (the
    reference with its iterate in bfloat16) on the matrix this seed
    judges, at the cell's size; with ``faults_too``, also the program's
    under each fault of ``faults()``."""
    import torch
    p = ctx.params
    k = int(ctx.uniform("judged") * p["matrices"])
    Y, M = matrices(ctx)[k]

    def run():
        sol = program(ctx, Y, M)
        return sol.x, compare.chunk_costs(sol.log.costs, p["chunk"])

    x, costs = run()
    ref = reference(ctx, Y, M)
    out = {}
    if faults_too:
        from portbench import faults as planted
        for name, target, hook, wrap in faults():
            with planted.planted(target, hook, wrap):
                out[name] = gaps(*run(), ref)
    ctl = reference(ctx, Y, M, round_state=torch.bfloat16)
    return {**out, "program": gaps(x, costs, ref),
            "control": gaps(ctl[0].cpu().numpy(), ctl[1], ref)}


# -------------------------------------------------------------- runs
def traced_unit(ctx, torch, unit, k, chunk, work) -> dict:
    """One more unit under the profiler: ``loop.trace_entry``'s record
    with the program's spans, the SVT's launches and the masked step's
    added."""
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
    counts = harness.work(ctx.config["name"])
    out.update(launches.trace_launches(events, tl, SVT_SPAN),
               svt_work=counts.svt(shapes(ctx)),
               grad_work=counts.grad(shapes(ctx)))
    grad = launches.trace_launches(events, tl, GRAD_SPAN)
    if grad:
        out["grad_launched"] = grad["launched"]
    return out


def run(ctx) -> harness.Outcome:
    import torch

    p, c = ctx.params, ctx.config
    mats = matrices(ctx)

    def unit(k, progress):
        Y, M = mats[k]
        sol = program(ctx, Y, M, progress)
        return (sol.x, list(sol.log.costs)), sol.log, Y.shape[0]

    work = harness.work(c["name"]).per_iteration(shapes(ctx))
    # the window as loop.closed_loop runs it; the traced unit is ours
    traced, ctx.trace = ctx.trace, False
    try:
        record, attempted, failed, kept = loop.closed_loop(
            ctx, torch, unit, len(mats), p["chunk"], work)
    finally:
        ctx.trace = traced
    if traced and ctx.device == "cuda":
        record["trace"] = traced_unit(ctx, torch, unit,
                                      attempted % len(mats), p["chunk"],
                                      work)
    done = sorted(kept)

    def judge():
        if not done:
            return {}
        k = done[int(ctx.uniform("judged") * len(done))]
        x, costs = kept[k]
        return gaps(x, compare.chunk_costs(costs, p["chunk"]),
                    reference(ctx, *mats[k]))

    return harness.Outcome(
        record=record, attempted=attempted, failed=failed,
        memory_peak_bytes=record["memory_peak_bytes"], judge=judge,
        trace=record.get("trace"))


# ---------------------------------------------------------------- run
def exact_svt_readings(ctx) -> dict:
    """The range finder's reference (as judged) against the exact-SVT
    reference on the matrix this seed judges, and the relative recovery
    error ||X - A||_F / ||A||_F of each, beside the observed entries'
    (``M o A``)."""
    import torch
    k = int(ctx.uniform("judged") * ctx.params["matrices"])
    A, M = draw(ctx, k)
    Y = A * M
    t0 = time.perf_counter()
    exact = reference(ctx, Y, M, exact=True)
    t1 = time.perf_counter()
    rf = reference(ctx, Y, M)
    t2 = time.perf_counter()
    A64 = A.double()
    norm = float(torch.linalg.norm(A64))

    def error(X):
        return float(torch.linalg.norm(X.double() - A64)) / norm

    return {"matrix": k, **gaps(rf[0].cpu().numpy(), rf[1], exact),
            "costs_exact": exact[1], "costs_range_finder": rf[1],
            "recovery_exact": error(exact[0]),
            "recovery_range_finder": error(rf[0]),
            "recovery_observed": error(Y),
            "exact_s": t1 - t0, "range_finder_s": t2 - t1}


def main(argv=None) -> int:
    import argparse
    import json

    from portbench import run as _run  # noqa: F401 (paths and caches)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="completion-r64")
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
