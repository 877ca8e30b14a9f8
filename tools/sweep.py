#!/usr/bin/env python3
"""Time variants of a kernel's compile-time constants on one card.

    python3 tools/sweep.py starlet                         # its default sweep
    python3 tools/sweep.py starlet 'lean:kForwardBlocks=4' ...
    python3 tools/sweep.py dict_outer 'wide:kWarpN=64' ...
    python3 tools/sweep.py jacobi                          # its default sweep

A variant is ``name:const=value,...``: each ``const`` is a ``constexpr``
at namespace scope in one of the kernel's sources under
``src/repro_torch/csrc/`` (or one of the Python constants the kernel
lists below), and an empty list is the source as it stands.  Each
variant's copy of
``src/repro_torch`` goes to ``build/sweep/<kernel>/<name>/`` with those
constants replaced; the variants' libraries are built in parallel (each
build's seconds are reported), then each variant runs in a process of its
own, which reports the compiler's registers and spills and prints one
``SWEEP {json}`` line.  One JSON line per variant; the last line is the
list of them.  Needs a card.

``starlet`` (``csrc/starlet2d*``: kThreads, kMaxRegsSide,
kForwardBlocks, kAdjointBlocks, ...): holds ``forward`` and ``adjoint``
against their plain versions (``chip_smoke.py``'s tolerances) at the main
path's shape (10 000 x 41 x 41 fp32, J = 4), at 7 x 13 x 13 (J = 5) and
9 x 32 x 32 (J = 4), and times both (CUDA events, median of 30, as
``chip_smoke.py`` phase 6) at the main shape for J = 1 .. 4 and at
10 000 stamps of 13 x 13 and 32 x 32 (J = 4), beside the route composed of
single smoothings and a device-to-device copy of the (J, N, 41, 41) stack
(the card's achievable copy rate, read and write).  The default sweep
sets the source beside ``kMaxRegsSide=0``, which sends every shape to the
shared-memory kernels.

``dict_outer`` (``csrc/dict_outer.cu``: kWarpM, kWarpN, kBK, kStages,
kResident, kFold, ..., and ``ACC_ROWS`` of ``kernels/dict_outer/kernel.py``):
holds ``dict_outer_pair`` and ``dict_outer`` against their plain versions
at the SCDL main path's shape (K = 40 000, P = 289, M = 81, A = 512, fp32)
and at a ragged, unaligned one (K = 1001, A = 200), and times both (as
``chip_smoke.py`` phase 10) beside the ``torch.matmul`` products in fp32,
the pair on bf16 copies of the same inputs (one TF32 product where fp32
takes three) and with P = 288, M = 80 (rows of a multiple of 16 bytes);
then runs ``chip_smoke.py``'s phase 9 (the SCDL solve at K = 2048,
A = 128 on the card against the CPU) and reports its NRMSE gap.

``jacobi`` (``csrc/jacobi*``: kEighMaxWarps, kSvdLanes, kMaxSweeps): runs
``chip_smoke.py``'s phase 11 (the kernels against ``torch.linalg`` at
every side it checks, batches, the randomized SVT) and times
``jacobi.eigh`` (also without vectors, the eigvalsh form) and
``jacobi.svd`` as phase 15 (r = 24, 32, 40, 64), with microseconds per
dependent step.  The default sweep sets the source beside eigh's team
uncapped (one thread per 2 x 2 block at every side) and beside the SVD's
with eight lanes a pair.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

BUILD = r"""
import sys
sys.path.insert(0, {src!r})
from repro_torch.kernels import common
common.build_library()
"""

# every child: the variant's port first on sys.path, its library built
# and loaded, and `regs`, the -Xptxas -v lines of the kernel's source as
# "kernel<template arguments>: line"
PRELUDE = r"""
import json, re, sys, torch
sys.path.insert(0, {root!r})
import chip_smoke as c  # puts the checkout's src first on sys.path
sys.path.insert(0, {src!r})
from repro_torch.kernels import common
assert common.CSRC.parent.parent == __import__("pathlib").Path({src!r})
path = common.build_library()
common.library()
log = "".join(part for part in open(str(path) + ".log").read().split("== ")
              if part.startswith({prefix!r}))
regs, kernel = [], None
for line in log.splitlines():
    if "entry function" in line:
        mangled = line.split("'")[1]
        name = max(re.findall(r"[a-z][a-z0-9]*_[a-z0-9_]+", mangled), key=len)
        args = re.findall(r"Li(\d+)E", mangled)
        kernel = name + ("_bf16" if "bfloat16" in mangled else "") + (
            "<" + ",".join(args) + ">" if args else "")
    elif "registers" in line or "spill" in line:
        regs.append(f"{{kernel}}: {{line.strip()}}")
out = {{"name": {name!r}, "consts": {consts!r}}}
"""

STARLET = r"""
from repro_torch.kernels.starlet2d.ops import adjoint, forward
# the register kernels at the sides this sweep runs, and every other kernel
out["ptxas"] = [l for l in regs if not re.search(r"_regs\w*<", l)
                or re.search(r"<(13|32|41)>", l)]
g = torch.Generator(device="cuda").manual_seed(23)
for shape, J in (((c.MAIN_N, c.STAMP, c.STAMP), c.SCALES), ((7, 13, 13), 5),
                 ((9, 32, 32), 4)):
    x = torch.randn(shape, generator=g, device="cuda")
    u = torch.randn((J,) + shape, generator=g, device="cuda")
    out[f"max_abs_err_{{shape[-1]}}"] = max(
        c.compare(f"forward {{shape}}", forward(x, J),
                  forward(x, J, use_kernel=False), c.cascade_tol("float32", J)),
        c.compare(f"adjoint {{shape}}", adjoint(u, J),
                  adjoint(u, J, use_kernel=False),
                  c.cascade_tol("float32", 2 * J - 1)))
for S in (13, 32):
    x = torch.randn((c.MAIN_N, S, S), generator=g, device="cuda")
    u = torch.randn((c.SCALES,) + tuple(x.shape), generator=g, device="cuda")
    out[f"forward_ms_{{S}}"] = c.time_ms(torch, lambda: forward(x, c.SCALES))
    out[f"adjoint_ms_{{S}}"] = c.time_ms(torch, lambda: adjoint(u, c.SCALES))
x = torch.randn((c.MAIN_N, c.STAMP, c.STAMP), generator=g, device="cuda")
u = torch.randn((c.SCALES,) + tuple(x.shape), generator=g, device="cuda")
for J in range(1, c.SCALES + 1):
    out[f"forward_ms_J{{J}}"] = c.time_ms(torch, lambda: forward(x, J))
    out[f"adjoint_ms_J{{J}}"] = c.time_ms(torch, lambda: adjoint(u[:J], J))
out["forward_composed_ms"] = c.time_ms(
    torch, lambda: c.composed_forward(torch, x, c.SCALES))
out["adjoint_composed_ms"] = c.time_ms(
    torch, lambda: c.composed_adjoint(u, c.SCALES))
out["bound_ms"] = c.bound((1 + c.SCALES) * x.numel() * 4, 0)[0]
v = torch.empty_like(u)
ms = c.time_ms(torch, lambda: v.copy_(u))
out["copy_ms"] = ms
out["copy_TBps"] = 2 * u.numel() * 4 / ms / 1e9
print("SWEEP " + json.dumps(out), flush=True)
"""

DICT_OUTER = r"""
from repro_torch.kernels.dict_outer.ops import dict_outer, dict_outer_pair
torch.backends.cuda.matmul.allow_tf32 = False
out["ptxas"] = regs
g = torch.Generator(device="cuda").manual_seed(19)
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

JACOBI = r"""
from repro_torch.kernels.jacobi import kernel as jk
from repro_torch.kernels.jacobi.ops import eigh, svd
out["ptxas"] = [l for l in regs if re.search(r"<(24|32|40|64),", l)]
try:
    c.jacobi_phase(torch)
    out["phase_11"] = "passed"
except AssertionError as err:
    out["phase_11"] = str(err)
g = torch.Generator(device="cuda").manual_seed(41)
for r in c.JACOBI_TIMED_RS:
    y = torch.randn((c.MAIN_N, r), generator=g, device="cuda")
    G = y.T @ y
    Rt = torch.linalg.qr(torch.randn((c.STAMP * c.STAMP, r), generator=g,
                                     device="cuda")).R.T.contiguous()
    for name, fn, wrapper in (
            ("eigh", lambda: eigh(G), jk.eigh_fwd),
            ("eigvalsh", lambda: eigh(G, compute_v=False), jk.eigh_fwd),
            ("svd", lambda: svd(Rt), jk.svd_fwd)):
        fn()
        steps = int(wrapper.sweeps) * (r + (r & 1) - 1)
        ms = c.time_ms(torch, fn)
        out[f"{{name}}_ms_{{r}}"] = ms
        out[f"{{name}}_us_per_step_{{r}}"] = 1e3 * ms / steps
print("SWEEP " + json.dumps(out), flush=True)
"""

# kernel -> the prefix of its CUDA sources under csrc/, its Python
# constants (name -> file under src/repro_torch), default variants and
# child body
KERNELS = {
    "starlet": ("starlet2d", {}, ("as-is:", "shared:kMaxRegsSide=0"),
                STARLET),
    "dict_outer": ("dict_outer",
                   {"ACC_ROWS": "kernels/dict_outer/kernel.py"},
                   ("as-is:", "fold-every-step:kFold=1",
                    "fold-every-4-steps:kFold=4", "64-row-stages:kBK=64"),
                   DICT_OUTER),
    "jacobi": ("jacobi", {},
               ("as-is:", "wide:kEighMaxWarps=17", "narrow:kSvdLanes=8"),
               JACOBI),
}


def variant_tree(kernel: str, name: str, consts: dict) -> Path:
    """A copy of the port with the kernel's constants replaced."""
    prefix, py_consts, _, _ = KERNELS[kernel]
    dest = ROOT / "build" / "sweep" / kernel / name
    shutil.rmtree(dest, ignore_errors=True)
    port = dest / "src" / "repro_torch"
    shutil.copytree(ROOT / "src" / "repro_torch", port,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for const, value in consts.items():
        if const in py_consts:
            paths, pattern = [port / py_consts[const]], rf"({const} = )[^\n]+"
        else:
            paths = sorted((port / "csrc").glob(prefix + "*"))
            pattern = rf"(constexpr (?:int|long long|bool) {const} = )[^;]+"
        found = 0
        for path in paths:
            text, n = re.subn(pattern, rf"\g<1>{value}", path.read_text())
            found += n
            path.write_text(text)
        if found != 1:
            raise SystemExit(f"{const}: not a constant of {kernel}")
    return dest / "src"


def main(argv) -> int:
    import torch
    if not argv or argv[0] not in KERNELS:
        raise SystemExit(f"usage: sweep.py {{{','.join(KERNELS)}}} "
                         f"[name:const=value,...] ...")
    if not torch.cuda.is_available():
        raise SystemExit("sweep: CUDA is not available")
    kernel, specs = argv[0], argv[1:]
    prefix, _, default, body = KERNELS[kernel]
    variants = []
    for spec in specs or default:
        name, _, text = spec.partition(":")
        consts = dict(kv.split("=") for kv in text.split(",") if kv)
        variants.append((name, consts, variant_tree(kernel, name, consts)))
    start = time.perf_counter()
    builds = [subprocess.Popen([sys.executable, "-c",
                                BUILD.format(src=str(src))])
              for _, _, src in variants]
    build_s = []
    for b in builds:
        b.wait()
        build_s.append(time.perf_counter() - start)
    results = []
    for (name, consts, src), secs in zip(variants, build_s):
        child = (PRELUDE + body).format(src=str(src), root=str(ROOT),
                                        prefix=prefix, name=name,
                                        consts=consts)
        proc = subprocess.run([sys.executable, "-c", child],
                              capture_output=True, text=True)
        lines = [line[6:] for line in proc.stdout.splitlines()
                 if line.startswith("SWEEP ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], flush=True)
            results.append({"name": name, "consts": consts, "failed": True})
        else:
            results.append(json.loads(lines[0]))
        # builds run together: a variant's seconds end when it, or an
        # earlier one in the list, is done
        results[-1]["build_s"] = secs
        print(json.dumps(results[-1]), flush=True)
    print(json.dumps(results), flush=True)
    return 0 if all("failed" not in r for r in results) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
