#!/usr/bin/env python3
"""Time the Jacobi kernels against an earlier version of their source, in
turns, on one card.

    python3 tools/jacobi_turns.py OLD_JACOBI_CU [r ...]

``OLD_JACOBI_CU`` is a one-file version of ``csrc/jacobi.cu`` with the
same two C entry points, for instance the source at an earlier commit
(``git show <commit>:src/repro_torch/csrc/jacobi.cu``) put in a directory
that git ignores.  It is built alone, with the port's nvcc flags, into
``build/jacobi_turns/`` and bound through ``ctypes`` beside the port's
library.  For each r (default 24, 32, 40, 64) both versions factor
``chip_smoke.py`` phase 15's matrices (the Gram of an (n, r) projection
for eigh, R^T of the QR of a (1681, r) one for the SVD) and are timed in
turns, earlier, current, current, earlier (CUDA events, median of 30
each, as phase 15).  Prints one ``TURNS {json}`` line per r and kernel
(each version's two times, sweeps and microseconds per dependent step,
the largest gap between the two versions' values over the largest
value), and last the list of them, also written to
``chiprun_out/jacobi_turns.json``.  Needs a card.
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


def build_old(src: Path) -> ctypes.CDLL:
    from repro_torch.kernels import common
    out = common.BUILD_DIR.parent / "jacobi_turns" / "libjacobi_old.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    build = subprocess.run(
        [common._nvcc(), *common.NVCC_FLAGS, "-I", str(common.CSRC),
         "-shared", "-o", str(out), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    Path(str(out) + ".log").write_text(build.stdout)
    if build.returncode != 0:
        raise SystemExit(f"nvcc failed on {src}:\n{build.stdout}")
    lib = ctypes.CDLL(str(out))
    for name in ("repro_jacobi_eigh", "repro_jacobi_svd"):
        fn = getattr(lib, name)
        fn.argtypes = common._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def main(argv) -> int:
    import torch

    from repro_torch.kernels import common
    from repro_torch.kernels.jacobi import kernel as jk
    from repro_torch.kernels.jacobi.ops import eigh, svd
    if not argv:
        raise SystemExit("usage: jacobi_turns.py OLD_JACOBI_CU [r ...]")
    if not torch.cuda.is_available():
        raise SystemExit("jacobi_turns: CUDA is not available")
    smi = c.device_phase(torch)
    common.library()
    old = build_old(Path(argv[0]).resolve())
    rs = [int(a) for a in argv[1:]] or list(c.JACOBI_TIMED_RS)
    g = torch.Generator(device="cuda").manual_seed(41)
    results = []
    for r in rs:
        y = torch.randn((c.MAIN_N, r), generator=g, device="cuda")
        G = y.T @ y
        Rt = torch.linalg.qr(torch.randn((c.STAMP * c.STAMP, r), generator=g,
                                         device="cuda")).R.T.contiguous()
        sweeps = torch.empty(1, dtype=torch.int32, device="cuda")
        w, v = torch.empty(r, device="cuda"), torch.empty_like(G)
        u, s, vh = torch.empty_like(Rt), torch.empty(r, device="cuda"), \
            torch.empty_like(Rt)

        def old_eigh():
            common.check(old.repro_jacobi_eigh(
                G.data_ptr(), w.data_ptr(), v.data_ptr(), sweeps.data_ptr(),
                1, r, 1, common.stream_ptr(G)), "earlier jacobi.eigh")
            return w

        def old_svd():
            common.check(old.repro_jacobi_svd(
                Rt.data_ptr(), u.data_ptr(), s.data_ptr(), vh.data_ptr(),
                sweeps.data_ptr(), 1, r, common.stream_ptr(Rt)),
                "earlier jacobi.svd")
            return s

        for name, earlier, current, wrapper in (
                ("jacobi.eigh", old_eigh, lambda: eigh(G)[0], jk.eigh_fwd),
                ("jacobi.svd", old_svd, lambda: svd(Rt)[1], jk.svd_fwd)):
            gap = float((earlier() - current()).abs().max()
                        / current().abs().max())
            sw = {"earlier": int(sweeps), "current": int(wrapper.sweeps)}
            times = {"earlier": [], "current": []}
            for who in ("earlier", "current", "current", "earlier"):
                fn = earlier if who == "earlier" else current
                times[who].append(c.time_ms(torch, fn))
            steps = {k: n * (r + (r & 1) - 1) for k, n in sw.items()}
            out = {"kernel": name, "r": r, "card": smi, "ms": times,
                   "sweeps": sw, "dependent_steps": steps,
                   "us_per_step": {k: 1e3 * min(times[k]) / steps[k]
                                   for k in times},
                   "max_rel_value_gap": gap}
            print("TURNS " + json.dumps(out), flush=True)
            results.append(out)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "jacobi_turns.json").write_text(json.dumps(results, indent=1))
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
