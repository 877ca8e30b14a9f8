"""Readings for the limits of ``correct``: for each seed, the gaps of
the program's output from the plain reference and of the control's (the
reference in the next lower precision) at the cell's own size, in one
process.  The benchmark's own runs never run this.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 [--faults] [--out file]

Prints one JSON line per seed; ``--out`` appends them to a file.
``--faults`` adds the program's gaps under each fault of
``portbench/faults.py`` that the cell's driver plants.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    wl = harness.workload(args.workload)
    drv = harness.traffic(wl.get("readings", wl["traffic"]))
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = harness.Run(args.workload, seed, 0, False, device=args.device)
        line = dict(cell=args.workload, seed=seed, **drv.readings(ctx, args.faults),
                    seconds=time.perf_counter() - t0)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
