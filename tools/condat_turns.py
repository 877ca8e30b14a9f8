#!/usr/bin/env python3
"""Time the Condat passes against an earlier version of their source, in
turns, on one card.

    python3 tools/condat_turns.py OLD_CONDAT_ELWISE_CU

``OLD_CONDAT_ELWISE_CU`` is ``csrc/condat_elwise.cu`` as it stood before
the passes took a step size per instance (one ``tau``/``sig`` each, the
entry points ``repro_condat_primal(x, ua, g, tau, xn, xb, n, dtype,
with_xbar, stream)`` and ``repro_condat_dual(u, cn, co, w, sig, out, n,
ss, dtype, stream)``), for instance ``git show
<commit>:src/repro_torch/csrc/condat_elwise.cu`` put in a directory that
git ignores.  It is built alone, with the port's nvcc flags, into
``build/condat_turns/`` and bound through ``ctypes`` beside the port's
library.  At the main path's shapes (10 000 stamps of 41 x 41; the dual
over J = 4 scales) both versions run one instance's primal pass, the
primal pass with X_bar and the dual pass, timed in turns, earlier,
current, current, earlier (CUDA events, median of 30 each, as
``chip_smoke.py`` phase 6), and must give bit-identical outputs.  Prints
one ``TURNS {json}`` line per pass and last the list of them, also
written to ``chiprun_out/condat_turns.json``.  Needs a card.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402  (puts the checkout's src first)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
OLD_SIGNATURES = {
    "repro_condat_primal": (_P, _P, _P, _P, _P, _P, _L, _I, _I, _P),
    "repro_condat_dual": (_P, _P, _P, _P, _P, _P, _L, _I, _I, _P),
}


def build_old(src: Path) -> ctypes.CDLL:
    from repro_torch.kernels import common
    out = common.BUILD_DIR.parent / "condat_turns" / "libcondat_old.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    build = subprocess.run(
        [common._nvcc(), *common.NVCC_FLAGS, "-I", str(common.CSRC),
         "-shared", "-o", str(out), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    Path(str(out) + ".log").write_text(build.stdout)
    if build.returncode != 0:
        raise SystemExit(f"nvcc failed on {src}:\n{build.stdout}")
    lib = ctypes.CDLL(str(out))
    for name, argtypes in OLD_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def main(argv) -> int:
    import torch

    from repro_torch.kernels import common
    from repro_torch.kernels.condat_elwise.ops import (condat_dual,
                                                       condat_primal)
    if len(argv) != 1:
        raise SystemExit("usage: condat_turns.py OLD_CONDAT_ELWISE_CU")
    if not torch.cuda.is_available():
        raise SystemExit("condat_turns: CUDA is not available")
    smi = c.device_phase(torch)
    common.library()
    old = build_old(Path(argv[0]).resolve())
    g = torch.Generator(device="cuda").manual_seed(43)
    shape = (c.MAIN_N, c.STAMP, c.STAMP)
    X, Ua, gr = (torch.randn(shape, generator=g, device="cuda")
                 for _ in range(3))
    U, Cn, Co = (torch.randn((c.SCALES,) + shape, generator=g,
                             device="cuda") for _ in range(3))
    W = torch.rand((c.SCALES, c.MAIN_N, 1, 1), generator=g, device="cuda")
    tau = torch.tensor(0.31, device="cuda")
    sig = torch.tensor(0.47, device="cuda")
    xn, xb, out = (torch.empty_like(X), torch.empty_like(X),
                   torch.empty_like(U))
    f32 = common.DTYPE_CODES[torch.float32]

    def old_primal(with_xbar):
        def run():
            common.check(old.repro_condat_primal(
                X.data_ptr(), Ua.data_ptr(), gr.data_ptr(), tau.data_ptr(),
                xn.data_ptr(), xb.data_ptr() if with_xbar else None,
                X.numel(), f32, int(with_xbar), common.stream_ptr(X)),
                "earlier condat primal")
            return (xn, xb) if with_xbar else (xn,)
        return run

    def old_dual():
        common.check(old.repro_condat_dual(
            U.data_ptr(), Cn.data_ptr(), Co.data_ptr(), W.data_ptr(),
            sig.data_ptr(), out.data_ptr(), U.numel(), c.STAMP * c.STAMP,
            f32, common.stream_ptr(U)), "earlier condat dual")
        return (out,)

    cases = (
        ("condat_elwise.primal", old_primal(False),
         lambda: (condat_primal(X, Ua, gr, tau),)),
        ("condat_elwise.primal_xbar", old_primal(True),
         lambda: condat_primal(X, Ua, gr, tau, with_xbar=True)),
        ("condat_elwise.dual", old_dual,
         lambda: (condat_dual(U, Cn, Co, W, sig),)))
    results = []
    for name, earlier, current in cases:
        same = all(torch.equal(a.clone(), b) for a, b in
                   zip(earlier(), current()))
        if not same:
            raise AssertionError(f"{name}: the two versions differ")
        times = {"earlier": [], "current": []}
        for who in ("earlier", "current", "current", "earlier"):
            times[who].append(c.time_ms(torch, earlier if who == "earlier"
                                        else current))
        res = {"kernel": name, "card": smi, "ms": times,
               "bit_identical": same,
               "current_over_earlier": min(times["current"])
               / min(times["earlier"])}
        print("TURNS " + json.dumps(res), flush=True)
        results.append(res)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "condat_turns.json").write_text(json.dumps(results, indent=1))
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
