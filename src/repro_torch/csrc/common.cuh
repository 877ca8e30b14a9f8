// Shared helpers of the port's kernels: fp32 loads and stores for the two
// element types the wrappers accept (dtype codes match
// repro_torch/kernels/common.py::DTYPE_CODES).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float load(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ void store(float* p, long long i, float v) {
  p[i] = v;
}
// round to nearest even, as torch's float -> bfloat16 cast does
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i,
                                      float v) {
  p[i] = __float2bfloat16(v);
}

// blocks for a grid-stride elementwise pass: enough to fill the card,
// capped so each thread walks several elements on large inputs
inline int elementwise_blocks(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  const long long cap = 132LL * 16;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : static_cast<int>(blocks);
}

}  // namespace repro
