// Fused SCDL ADMM elementwise tail (Algorithm 2, step 8), for sm_90a.
//
// Replaces: src/repro/kernels/admm_elwise/kernel.py, admm_elwise_fwd
// (Pallas body _admm_kernel).
//
//   Y1' = -c1 clip(Wh - Y1 / c1, -t1, t1)
//   Y2' = -c2 clip(Wl - Y2 / c2, -t2, t2)
//   Y3' = Y3 + c3 (Wh - Wl)
//   Z1  = (c1 Wh - Y1) + 2 Y1' - Y3' + c3 Wl
//   Z2  = (c2 Wl - Y2) + 2 Y2' + Y3'
//
// over (K, A), with the state YZ = [Y1, Y2, Y3, Z1, Z2] stored
// plane-major, (5, K, A): plane p of element e sits at p * n + e.
//
// Bound on the card: memory.  About 20 flops per element against 40
// bytes in fp32: five planes read (Wh, Wl, Y1, Y2, Y3 — the old Z1, Z2
// are not inputs) and five written.  At K = 40 000, A = 512 that is
// 10 x 81.9 MB = 819 MB, 0.245 ms at 3.35 TB/s; the TPU kernel, which
// reads the whole (K, 5, A) block, moves 983 MB.
//
// Design: one grid-stride pass with consecutive threads on consecutive
// elements of every plane, so all ten streams are coalesced; arithmetic
// in fp32 with a cast on the store.  The constants are static
// configuration in the reference, so they come in as plain float launch
// arguments.  Comparisons are written so a NaN input stays NaN, as
// jnp.clip keeps it.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
admm_elwise_kernel(const T* __restrict__ wh, const T* __restrict__ wl,
                   const T* __restrict__ yz, T* __restrict__ out,
                   long long n, float c1, float c2, float c3, float t1,
                   float t2) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < n; e += stride) {
    const float h = repro::load(wh, e);
    const float l = repro::load(wl, e);
    const float y1 = repro::load(yz, e);
    const float y2 = repro::load(yz, n + e);
    const float y3 = repro::load(yz, 2 * n + e);
    float v1 = h - y1 / c1;
    v1 = v1 < -t1 ? -t1 : v1;
    v1 = v1 > t1 ? t1 : v1;
    float v2 = l - y2 / c2;
    v2 = v2 < -t2 ? -t2 : v2;
    v2 = v2 > t2 ? t2 : v2;
    const float y1n = -c1 * v1;
    const float y2n = -c2 * v2;
    const float y3n = y3 + c3 * (h - l);
    repro::store(out, e, y1n);
    repro::store(out, n + e, y2n);
    repro::store(out, 2 * n + e, y3n);
    repro::store(out, 3 * n + e,
                 (c1 * h - y1) + 2.0f * y1n - y3n + c3 * l);
    repro::store(out, 4 * n + e, (c2 * l - y2) + 2.0f * y2n + y3n);
  }
}

template <typename T>
cudaError_t launch(const void* wh, const void* wl, const void* yz,
                   void* out, long long n, float c1, float c2, float c3,
                   float t1, float t2, cudaStream_t stream) {
  const int threads = 256;
  admm_elwise_kernel<T><<<repro::elementwise_blocks(n, threads), threads, 0,
                          stream>>>(
      static_cast<const T*>(wh), static_cast<const T*>(wl),
      static_cast<const T*>(yz), static_cast<T*>(out), n, c1, c2, c3, t1,
      t2);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_admm_elwise(const void* wh, const void* wl,
                                 const void* yz, void* out, long long n,
                                 float c1, float c2, float c3, float t1,
                                 float t2, int dtype, void* stream) {
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return launch<float>(wh, wl, yz, out, n, c1, c2, c3, t1, t2, s);
    case repro::kBFloat16:
      return launch<__nv_bfloat16>(wh, wl, yz, out, n, c1, c2, c3, t1, t2,
                                   s);
    default:
      return cudaErrorInvalidValue;
  }
}
