#!/usr/bin/env python3
"""How accurately a batched product sums over the records, on one card.

    python3 tools/record_sums.py

The range finder of ``imaging/lowrank.py`` sums two products over the n
records of each matrix: the Gram Y^T Y and B = Q^T A.  For a bucket of
``solve_many`` they could run as one batched product over (B, n, .)
operands or as one 2-D product per matrix.  At ``chip_smoke.py`` phase
18's completion bucket (four matrices of 2400-2600 rows, zero-padded to
2600, by 1681 columns, Omega of rank 12 + oversample 52) this computes
both ways and prints each matrix's relative Frobenius distance from the
fp64 product of the same fp32 operands, and the device kernels each way
launched (``torch.profiler``), as one ``RECORDS {json}`` line, also
written to ``chiprun_out/record_sums.json``.  Needs a card.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402  (puts the checkout's src first)


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.imaging.lowrank import make_test_matrix
    if not torch.cuda.is_available():
        raise SystemExit("record_sums: CUDA is not available")
    smi = c.device_phase(torch)
    rows = c.COMP_BUCKET_ROWS
    omega = make_test_matrix(c.COMP_P, 12, 52, device="cuda")
    A = torch.zeros((len(rows), max(rows), c.COMP_P), device="cuda")
    for j, n in enumerate(rows):
        a, m = c.completion_data(torch, n, c.COMP_P, 51 + j, "cuda")
        A[j, :n] = a * m
    y = A @ omega
    q = torch.linalg.qr(y).Q
    ways = {
        "gram": (y, y),
        "qta": (q, A),
    }
    out = {"card": smi, "shape": list(A.shape), "r": omega.shape[1]}
    for name, (x, z) in ways.items():
        exact = x.double().mT @ z.double()
        batched = x.mT @ z
        per = torch.stack([xi.T @ zi for xi, zi in zip(x, z)])

        def dist(t):
            return [float((t[j].double() - exact[j]).norm()
                          / exact[j].norm()) for j in range(len(rows))]

        kernels = {}
        for way, fn in (("batched", lambda: x.mT @ z),
                        ("per_matrix", lambda: [xi.T @ zi for xi, zi
                                                in zip(x, z)])):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            kernels[way] = sorted({ev.key[:70] for ev in prof.key_averages()
                                   if ev.device_type == DeviceType.CUDA})
        out[name] = {"batched": dist(batched), "per_matrix": dist(per),
                     "kernels": kernels}
    print("RECORDS " + json.dumps(out), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "record_sums.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
