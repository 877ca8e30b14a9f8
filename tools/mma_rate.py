#!/usr/bin/env python3
"""The card's rate for ``mma.sync.aligned.m16n8k8`` TF32 products.

    python3 tools/mma_rate.py

Builds a kernel in which every warp runs independent
``mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`` products on
operands held in registers (no memory traffic in the loop), runs it with
4, 8 and 16 warps per SM on every SM, and prints the TFLOP/s that each
reaches (CUDA events, median of 10 launches), beside the 495 TFLOP/s
dense TF32 peak of the data sheet.  This is the ceiling of a kernel built
on ``mma.sync`` TF32 products, as ``csrc/dict_outer.cu`` is.  Needs a
card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SOURCE = r"""
#include <cuda_runtime.h>
constexpr int kChains = 8;  // independent accumulators a warp
__global__ void mma_rate(float* out, int iters) {
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(1e-3f * (i + 1));
  float acc[kChains][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.0f;
  for (int c = 0; c < kChains; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_rate_launch(void* out, int blocks, int threads, int iters,
                               void* stream) {
  mma_rate<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}
"""
CHAINS = 8
FLOPS_PER_MMA = 2 * 16 * 8 * 8


def main() -> int:
    import torch
    from repro_torch.kernels import common
    if not torch.cuda.is_available():
        raise SystemExit("mma_rate: CUDA is not available")
    build = ROOT / "build" / "mma_rate"
    build.mkdir(parents=True, exist_ok=True)
    (build / "mma_rate.cu").write_text(SOURCE)
    lib_path = build / "libmmarate.so"
    subprocess.run([common._nvcc(), *common.NVCC_FLAGS, "-shared", "-o",
                    str(lib_path), str(build / "mma_rate.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_rate_launch.argtypes = (ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    results = []
    for warps_per_sm in (4, 8, 16):
        blocks, threads = sms * warps_per_sm // 4, 128
        out = torch.empty(blocks * threads, device="cuda")

        def run():
            err = lib.mma_rate_launch(out.data_ptr(), blocks, threads, iters,
                                      torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"mma_rate: CUDA error {err}")

        for _ in range(3):
            run()
        times = []
        for _ in range(10):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            run()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        ms = statistics.median(times)
        flops = blocks * threads // 32 * iters * CHAINS * FLOPS_PER_MMA
        results.append({"warps_per_sm": warps_per_sm, "ms": ms,
                        "tflops": flops / ms / 1e9,
                        "share_of_495": flops / ms / 1e9 / 495})
        print(json.dumps(results[-1]), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "mma_rate": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
