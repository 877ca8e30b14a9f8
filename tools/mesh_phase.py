#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s multi-device phase alone, or its paths over
NCCL on several cards.

    python3 tools/mesh_phase.py             # one card: phase 21
    python3 tools/mesh_phase.py --cards 4   # four cards, one rank each
    python3 tools/mesh_phase.py --cards 4 --supervised   # the last part

Both run phases 1 and 2 of ``chip_smoke.py`` first (the card check and
the kernels' build).  Without ``--cards``: phase 21, the four paths
under a one-rank NCCL mesh against the same calls without one (bit for
bit, one host sync per chunk, the same launches), then four gloo ranks
sharing the card against the single process; about 80 s on an H100,
the build included.  With ``--cards N`` (N cards on one host): the four
paths (phases 4, 12, 8 and 14's, the completion at r = 64) on card 0
alone, then in N NCCL ranks, rank r on card r (subprocesses of
``chip_smoke.py``, a timeout on every one), each held against the
single process: the sparse deconvolution's costs and iterate at rtol
1e-4 with equal ``iters_run``, the low-rank deconvolution's costs at
rtol 1e-4, SCDL's costs at rtol 5e-3 (the reference's own bound), the
completion's gaps reported; the replicated state, costs and results
bit for bit across the ranks; each rank's ms per iteration and host
syncs per chunk.  Then the supervised paths of phase 22 over the same N
NCCL ranks: phase 4's stamps under ``dispatch@1;carry_nan@1;seed=7``
and the low-rank path under ``kernel:jacobi@2`` on every rank (the
vote), each bit-identical to the ranks' unsupervised run with the same
recovery report on every rank; supervision's cost without faults on the
sparse path (in turns with the unsupervised run, each chunk's parts
timed on the host, and one run of each under ``torch.profiler``); last,
a fault on rank 2 alone past a collective, on which every rank must
raise ``MeshFaultError`` within 30 s of rank 2 (the peers through the
mesh's fault watch, which aborts their NCCL communicators).
``--supervised`` runs only these supervised paths.  The log goes to
``chiprun_out/mesh_phase.log`` and the report to
``chiprun_out/mesh_phase.json``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=0,
                    help="run the paths over NCCL, one rank a card")
    ap.add_argument("--supervised", action="store_true",
                    help="with --cards: only the supervised paths")
    args = ap.parse_args()
    import torch
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    cs.LOG_FILE.append(open(out / "mesh_phase.log", "w"))
    cs.device_phase(torch)
    cs.build_phase()
    t0 = time.perf_counter()
    if args.cards:
        if torch.cuda.device_count() < args.cards:
            raise SystemExit(f"mesh_phase: {args.cards} cards asked, "
                             f"{torch.cuda.device_count()} found")
        import subprocess
        cs.log(subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
        report = {}
        if not args.supervised:
            cs.log(f"== {args.cards} NCCL ranks, one a card")
            plain = cs.mesh_plain(torch, cs.MESH_PATHS)
            report = cs.mesh_world_phase(torch, plain, "nccl", args.cards)
        cs.log(f"== {args.cards} NCCL ranks, supervised")
        report["supervised"], _ = cs.sup_world_phase(
            torch, cs.sup_world_start(torch, "nccl", args.cards))
    else:
        report, plain = cs.mesh_nccl_phase(torch)
        report["gloo"] = cs.mesh_gloo_phase(torch, plain)
    report["seconds"] = time.perf_counter() - t0
    cs.log(f"multi-device: {report['seconds']:.1f} s")
    (out / "mesh_phase.json").write_text(json.dumps(report, indent=1,
                                                    default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
