"""Serve-level chaos drills: end-to-end serving resilience.  Port of
``repro.serve.drill``.

Three scenarios, each asserting the isolation contract against the real
solver stack on tiny deconvolution instances (the port's own
``psf.simulate``, seeded CPU generators), on ``--device`` (default
``"cuda"``):

- ``poison-bucket`` — a ``serve_bucket_poison`` fault NaN-poisons one
  lane of a coalesced dispatch; the bucket fails as a unit, quarantine
  re-dispatches every lane solo.  Assert: the poisoned request fails
  with a per-request recovery report attached; every sibling completes
  with rtol 1e-4 trajectory parity against its unfaulted direct run.
- ``deadline-storm`` — a burst of requests with deadlines too tight for
  their iteration budget, coalesced with undeadlined traffic.  Assert:
  the tight-deadline requests fail with the deadline error (frozen at a
  chunk boundary, i.e. before their full iteration count); the
  undeadlined siblings complete with trajectory parity.
- ``kill-and-restart`` — a journaled, checkpointed service takes a
  coalesced bucket plus an admitted-but-never-scheduled request
  (``serve_admit_drop``), then ``serve_crash`` kills it mid-bucket.
  A second service started over the same journal replays everything.
  Assert: every request completes (``replayed=True``), the resumed
  bucket's cost trajectory matches the reference suffix at rtol 1e-4,
  and final iterates match.

Run as a module::

    PYTHONPATH=src python -m repro_torch.serve.drill --scenario all \
        --report serve_drill.json [--device cpu]

Exit status is non-zero when any assertion fails; ``--report`` writes a
JSON artifact with per-scenario outcomes and the recovery reports the
drills produced.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

ITERS, CHUNK = 6, 2
RTOL = 1e-4


# ------------------------------------------------------------ fixtures
def _instances(specs=None, device=None):
    import torch

    from repro_torch.imaging import psf as psf_op
    out = []
    for seed, (n, stamp) in enumerate(specs or [(3, 16), (5, 16),
                                                (3, 20)]):
        d = psf_op.simulate(n, torch.Generator().manual_seed(seed),
                            stamp=stamp, device=device)
        out.append((d.Y, d.psfs))
    return out


def _cfg(max_iter: int = ITERS):
    from repro_torch.imaging.condat import SolverConfig
    return SolverConfig(mode="sparse", max_iter=max_iter, tol=0.0,
                        n_scales=2)


def _options():
    return dict(chunk=CHUNK, cost_every=1)


def _direct(inputs, device=None, max_iter: int = ITERS):
    from repro_torch.core.problem import solve
    return solve("deconvolve", *inputs, cfg=_cfg(max_iter), device=device,
                 **_options())


def _req(inputs, *, options=None, deadline_s=None, max_iter=ITERS):
    from repro_torch.serve import SolveRequest
    return SolveRequest("deconvolve", inputs, cfg=_cfg(max_iter),
                        options=options or _options(),
                        deadline_s=deadline_s)


def _assert_parity(rec, ref, *, what: str) -> None:
    """Full-trajectory parity: costs and final iterate."""
    assert rec.status == "done", \
        f"{what}: expected done, got {rec.status} ({rec.error})"
    got = np.asarray(rec.solution.log.costs)
    want = np.asarray(ref.log.costs)
    assert got.shape == want.shape, \
        f"{what}: trajectory length {got.shape} vs {want.shape}"
    np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=what)
    _assert_x_parity(rec.solution, ref, what=what)


def _assert_suffix_parity(rec, ref, *, what: str) -> None:
    """Resumed-run parity: the replayed bucket restores from a mid-run
    checkpoint, so its log covers only the post-resume iterations —
    they must match the reference trajectory's suffix."""
    assert rec.status == "done", \
        f"{what}: expected done, got {rec.status} ({rec.error})"
    got = np.asarray(rec.solution.log.costs)
    want = np.asarray(ref.log.costs)
    assert 0 < got.size <= want.size, \
        f"{what}: resumed trajectory length {got.size} vs {want.size}"
    np.testing.assert_allclose(got, want[-got.size:], rtol=RTOL,
                               err_msg=what)
    _assert_x_parity(rec.solution, ref, what=what)


def _assert_x_parity(sol, ref, *, what: str) -> None:
    np.testing.assert_allclose(np.asarray(sol.x), np.asarray(ref.x),
                               rtol=RTOL, atol=1e-6, err_msg=what)


def _recovery_json(rec) -> Optional[dict]:
    return rec.recovery.to_json() if rec.recovery is not None else None


# ------------------------------------------------------------ scenarios
def drill_poison_bucket(device=None) -> dict:
    from repro_torch.resilience.recovery import ResilienceConfig
    from repro_torch.serve import AsyncSolveService, ServeConfig

    # same stamp everywhere so all three lanes coalesce into ONE bucket
    insts = _instances([(3, 16), (5, 16), (4, 16)], device)
    refs = [_direct(i, device) for i in insts]
    # one lane of the coalesced bucket is poisoned; ring stays small so
    # the rollback loop exhausts fast (NaN is in the input, rollback
    # cannot cure it)
    res = ResilienceConfig(max_rollbacks=2, backoff_s=0.001, ring=2)

    async def run():
        cfg = ServeConfig(batch_window_s=0.5, max_batch=8,
                          chaos_spec="serve_bucket_poison@0;seed=7")
        svc = AsyncSolveService(cfg, device=device)
        await svc.start()
        opts = _options()
        opts["resilience"] = res
        recs = [await svc.submit(_req(i, options=dict(opts)))
                for i in insts]
        out = [await svc.result(r.id, timeout=600) for r in recs]
        metrics = svc.metrics.snapshot()
        await svc.close()
        return out, metrics

    out, metrics = asyncio.run(run())
    keys = {r.bucket_key for r in out}
    assert len(keys) == 1 and out[0].batch_size == len(out), \
        f"drill lanes did not coalesce into one bucket: {keys}"
    failed = [r for r in out if r.status == "failed"]
    assert len(failed) == 1, \
        f"exactly one lane should fail, got {len(failed)}"
    poisoned = failed[0]
    assert poisoned.quarantined, "poisoned lane not quarantined"
    assert poisoned.recovery is not None, \
        "poisoned lane has no per-request recovery report"
    assert poisoned.recovery.rollbacks >= 1, \
        "recovery report records no rollback attempts"
    siblings = [(r, ref) for r, ref in zip(out, refs)
                if r.id != poisoned.id]
    for rec, ref in siblings:
        assert rec.quarantined, "sibling missed the quarantine re-run"
        _assert_parity(rec, ref, what=f"quarantined sibling {rec.id}")
    assert metrics["counters"]["quarantined"] == 1
    return {
        "poisoned": {"id": poisoned.id, "status": poisoned.status,
                     "error": poisoned.error,
                     "recovery": _recovery_json(poisoned)},
        "siblings_done": [r.id for r, _ in siblings],
        "counters": metrics["counters"],
    }


def drill_deadline_storm(device=None) -> dict:
    from repro_torch.serve import AsyncSolveService, ServeConfig

    insts = _instances([(3, 16), (5, 16), (3, 20), (4, 20)], device)
    refs = [_direct(i, device) for i in insts[:2]]
    # far beyond what the deadline covers: the port runs an iteration of
    # these stamps in well under a millisecond (the JAX package's drill
    # gives 600), so only the deadline can end these requests
    long_iters = 1_000_000

    async def run():
        cfg = ServeConfig(batch_window_s=0.5, max_batch=8)
        svc = AsyncSolveService(cfg, device=device)
        await svc.start()
        # two undeadlined controls coalesce with two doomed requests
        # whose deadline cannot cover their iteration budget
        recs = [await svc.submit(_req(insts[0])),
                await svc.submit(_req(insts[1]))]
        doomed = [await svc.submit(_req(i, max_iter=long_iters,
                                        deadline_s=0.5))
                  for i in insts[2:]]
        out = [await svc.result(r.id, timeout=600)
               for r in recs + doomed]
        metrics = svc.metrics.snapshot()
        await svc.close()
        return out, metrics

    out, metrics = asyncio.run(run())
    controls, doomed = out[:2], out[2:]
    for rec, ref in zip(controls, refs):
        _assert_parity(rec, ref, what=f"deadline-storm control {rec.id}")
    for rec in doomed:
        assert rec.status == "failed" and "deadline" in rec.error, \
            f"doomed request: {rec.status} / {rec.error}"
        chunks = [e for e in rec.events if e.get("kind") == "chunk"]
        iters_seen = max((e["done"] for e in chunks), default=0)
        assert iters_seen < long_iters, \
            "expired lane ran to completion instead of freezing"
    assert metrics["counters"]["expired"] == len(doomed)
    return {
        "controls_done": [r.id for r in controls],
        "expired": [{"id": r.id, "error": r.error} for r in doomed],
        "counters": metrics["counters"],
    }


def drill_kill_and_restart(device=None, workdir: Optional[str] = None
                           ) -> dict:
    from repro_torch.serve import AsyncSolveService, ServeConfig

    base = Path(workdir or tempfile.mkdtemp(prefix="repro-drill-"))
    journal_dir = str(base / "journal")
    ckpt_dir = str(base / "ckpt")
    insts = _instances(device=device)
    refs = [_direct(i, device) for i in insts]

    def mk_cfg(chaos: Optional[str]) -> "ServeConfig":
        return ServeConfig(batch_window_s=0.5, max_batch=8,
                           journal_dir=journal_dir,
                           checkpoint_dir=ckpt_dir, checkpoint_every=2,
                           chaos_spec=chaos)

    async def phase1():
        # admit 2 coalescing requests; the 3rd is journaled but never
        # scheduled (serve_admit_drop); the crash lands mid-bucket
        svc = AsyncSolveService(
            mk_cfg("serve_admit_drop@2;serve_crash@1;seed=5"),
            device=device)
        await svc.start()
        ids = []
        for i in insts:
            rec = await svc.submit(_req(i))
            ids.append(rec.id)
        t0 = time.monotonic()
        while not svc.crashed and time.monotonic() - t0 < 120:
            await asyncio.sleep(0.05)
        crashed = svc.crashed
        await svc.abandon()
        return ids, crashed

    ids, crashed = asyncio.run(phase1())
    assert crashed, "serve_crash never fired — drill misconfigured"

    async def phase2():
        svc = AsyncSolveService(mk_cfg(None), device=device)
        await svc.start()
        out = [await svc.result(i, timeout=600) for i in ids]
        metrics = svc.metrics.snapshot()
        await svc.close()
        return out, metrics

    out, metrics = asyncio.run(phase2())
    resumed = 0
    for rec, ref in zip(out, refs):
        assert rec.replayed, f"request {rec.id} not replayed"
        if rec.solution is not None and \
                len(rec.solution.log.costs) < len(ref.log.costs):
            _assert_suffix_parity(rec, ref,
                                  what=f"resumed request {rec.id}")
            resumed += 1
        else:
            _assert_parity(rec, ref, what=f"replayed request {rec.id}")
    assert metrics["counters"]["replayed"] == len(ids)
    return {
        "replayed": [r.id for r in out],
        "resumed_from_checkpoint": resumed,
        "counters": metrics["counters"],
    }


SCENARIOS = {
    "poison-bucket": drill_poison_bucket,
    "deadline-storm": drill_deadline_storm,
    "kill-and-restart": drill_kill_and_restart,
}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="repro_torch.serve chaos drills")
    ap.add_argument("--scenario", default="all",
                    choices=["all"] + sorted(SCENARIOS))
    ap.add_argument("--device", default=None,
                    help='torch device (default "cuda")')
    ap.add_argument("--report", default=None,
                    help="write a JSON artifact of drill outcomes here")
    args = ap.parse_args(argv)

    names = sorted(SCENARIOS) if args.scenario == "all" \
        else [args.scenario]
    report, failed = {}, []
    for name in names:
        t0 = time.perf_counter()
        try:
            detail = SCENARIOS[name](device=args.device)
            report[name] = {"ok": True, "detail": detail}
            verdict = "ok"
        except AssertionError as e:
            report[name] = {"ok": False, "error": str(e)}
            failed.append(name)
            verdict = f"FAILED: {e}"
        report[name]["elapsed_s"] = round(time.perf_counter() - t0, 3)
        print(f"[drill] {name}: {verdict} "
              f"({report[name]['elapsed_s']}s)")
    if args.report:
        Path(args.report).write_text(json.dumps(report, indent=2))
        print(f"[drill] report -> {args.report}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
