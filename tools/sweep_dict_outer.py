#!/usr/bin/env python3
"""Time variants of the outer-product kernel's tiling on one card.

    python3 tools/sweep_dict_outer.py                    # the default sweep
    python3 tools/sweep_dict_outer.py 'wide:kWarpN=64'   # named variants

A variant is ``name:const=value,...``: each ``const`` is a ``constexpr
int`` at namespace scope in ``src/repro_torch/csrc/dict_outer.cu``
(kWarpM, kWarpN, kBK, kStages, kResident, kFold, ...) or ``ACC_ROWS`` of
``kernels/dict_outer/kernel.py``, and an empty list is the source as it
stands.  Each variant's copy of ``src/repro_torch`` goes to
``build/sweep/<name>/`` with those constants replaced, and runs in a
process of its own: it builds the library there (the compiler's
registers and spills for ``dict_outer_partial`` are reported), holds
``dict_outer_pair`` and ``dict_outer`` against their plain versions at
the SCDL main path's shape (K = 40 000, P = 289, M = 81, A = 512, fp32)
and at a ragged, unaligned one (K = 1001, A = 200), and times both
(CUDA events, median of 30, as ``chip_smoke.py`` phase 10) beside the
``torch.matmul`` products in fp32 in the same process, and the pair on
bf16 copies of the same inputs (one TF32 product where fp32 takes three)
and with P = 288, M = 80 (rows of a multiple of 16 bytes); then runs
``chip_smoke.py``'s phase 9 (the SCDL solve at K = 2048, A = 128 on the
card against the CPU) and reports its NRMSE gap.  One JSON line per
variant; the last line is the list of them.  Needs a card.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEFAULT = ("as-is:", "fold-every-step:kFold=1", "fold-every-4-steps:kFold=4",
           "64-row-stages:kBK=64")

CHILD = r"""
import json, sys, torch
sys.path.insert(0, {root!r})
import chip_smoke as c  # puts the checkout's src first on sys.path
sys.path.insert(0, {src!r})
from repro_torch.kernels import common
assert common.CSRC.parent.parent == __import__("pathlib").Path({src!r})
from repro_torch.kernels.dict_outer.ops import dict_outer, dict_outer_pair
torch.backends.cuda.matmul.allow_tf32 = False
path = common.build_library()
common.library()
log = open(str(path) + ".log").read().split("== dict_outer.cu")[1]
log = log.split("==")[0]
regs = [l.strip() for l in log.splitlines() if "registers" in l or "spill" in l]
g = torch.Generator(device="cuda").manual_seed(19)
out = {{"name": {name!r}, "consts": {consts!r}, "ptxas": regs}}
for K, P, M, A in ((c.SCDL_K, c.SCDL_P, c.SCDL_M, c.SCDL_A), (1001, 289, 81, 200)):
    Sh, Sl, Wh, Wl = (torch.randn((K, m), generator=g, device="cuda")
                      for m in (P, M, A, A))
    tol = c.outer_tol("float32", K)
    errs = [c.compare(f"pair K={{K}} A={{A}} {{i}}", o, r, tol) for i, (o, r) in
            enumerate(zip(dict_outer_pair(Sh, Sl, Wh, Wl),
                          dict_outer_pair(Sh, Sl, Wh, Wl, use_kernel=False)))]
    errs += [c.compare(f"single K={{K}} A={{A}} {{i}}", o, r, tol) for i, (o, r) in
             enumerate(zip(dict_outer(Sh, Wh), dict_outer(Sh, Wh, use_kernel=False)))]
    out[f"max_abs_err_K{{K}}"] = max(errs)
    if K == c.SCDL_K:
        out["pair_ms"] = c.time_ms(torch, lambda: dict_outer_pair(Sh, Sl, Wh, Wl))
        out["pair_library_ms"] = c.time_ms(torch, lambda: (
            Sh.T @ Wh, Sl.T @ Wl, Wh.T @ Wh, Wl.T @ Wl))
        out["single_ms"] = c.time_ms(torch, lambda: dict_outer(Sh, Wh))
        out["single_library_ms"] = c.time_ms(torch, lambda: (Sh.T @ Wh, Wh.T @ Wh))
        # bf16 takes one TF32 product where fp32 takes three
        b16 = [t.bfloat16() for t in (Sh, Sl, Wh, Wl)]
        out["pair_bf16_ms"] = c.time_ms(torch, lambda: dict_outer_pair(*b16))
        # S with rows of a multiple of 16 bytes: 16-byte copies throughout
        Sa, Sla = Sh[:, :P - 1].contiguous(), Sl[:, :M - 1].contiguous()
        out["pair_aligned_ms"] = c.time_ms(
            torch, lambda: dict_outer_pair(Sa, Sla, Wh, Wl))
        out["single_aligned_ms"] = c.time_ms(torch, lambda: dict_outer(Sa, Wh))
# the SCDL solve on the card against the CPU (phase 9 of chip_smoke.py)
try:
    out["scdl_parity"] = c.scdl_parity_phase(torch)["max_rel_cost_gap"]
except AssertionError as err:
    out["scdl_parity"] = str(err)
print("SWEEP " + json.dumps(out), flush=True)
"""


def variant_tree(name: str, consts: dict) -> Path:
    """A copy of the port with the kernel's constants replaced."""
    dest = ROOT / "build" / "sweep" / name
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dest / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = dest / "src" / "repro_torch" / "csrc" / "dict_outer.cu"
    text = cu.read_text()
    acc_rows = consts.pop("ACC_ROWS", None)
    for const, value in consts.items():
        text, n = re.subn(rf"(constexpr (?:int|long long) {const} = )[^;]+;",
                          rf"\g<1>{value};", text)
        if n != 1:
            raise SystemExit(f"{const}: not a constant of dict_outer.cu")
    cu.write_text(text)
    if acc_rows is not None:
        py = dest / "src" / "repro_torch" / "kernels" / "dict_outer" / "kernel.py"
        py.write_text(re.sub(r"ACC_ROWS = \d+", f"ACC_ROWS = {acc_rows}",
                             py.read_text()))
    return dest / "src"


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("sweep_dict_outer: CUDA is not available")
    results = []
    for spec in argv or DEFAULT:
        name, _, body = spec.partition(":")
        consts = dict(kv.split("=") for kv in body.split(",") if kv)
        src = variant_tree(name, dict(consts))
        proc = subprocess.run(
            [sys.executable, "-c", CHILD.format(src=str(src), root=str(ROOT),
                                                name=name, consts=consts)],
            capture_output=True, text=True)
        lines = [line[6:] for line in proc.stdout.splitlines()
                 if line.startswith("SWEEP ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], flush=True)
            results.append({"name": name, "consts": consts, "failed": True})
        else:
            results.append(json.loads(lines[0]))
        print(json.dumps(results[-1]), flush=True)
    print(json.dumps(results), flush=True)
    return 0 if all("failed" not in r for r in results) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
