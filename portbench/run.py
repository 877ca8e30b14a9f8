"""Run one cell of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints one JSON line as the last line of
standard output (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, ``breakdown`` when traced, and ``checks`` last: each number
compared with the plain reference beside its limit), and the same
numbers as the last lines of standard error.  Exits 2 without a result
when the card or the cards the cell asks for are missing, and 3 when a
module of JAX or of the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the build and kernel caches stay inside the checkout, at fixed paths
CACHE = ROOT / "build" / "portbench"
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("CUDA_CACHE_PATH", str(CACHE / "nv"))
os.environ["USE_FLAX"] = "0"
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a cell on several cards (started by the cell's driver)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--spec", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    started = harness.process_started()
    wl = harness.workload(args.workload)
    import torch
    chips = int(wl["chips"])
    spec = json.loads(args.spec) if args.spec else None
    if args.rank and args.device != "cuda":
        # a rank of a CPU test's mesh (gloo)
        return harness.traffic(wl["traffic"]).follower(
            args.workload, args.seed, args.seconds, bool(args.trace),
            args.rank, args.port, args.device, spec)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell {args.workload} needs {chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if args.rank:
        return harness.traffic(wl["traffic"]).follower(
            args.workload, args.seed, args.seconds, bool(args.trace),
            args.rank, args.port, args.device, spec)
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), started=started)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the process loaded {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
