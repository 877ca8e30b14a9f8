// Fused Condat primal and dual elementwise passes, for sm_90a.
//
// Replaces: src/repro/kernels/condat_elwise/kernel.py, condat_primal_fwd
// (Pallas bodies _primal_kernel and _primal_xbar_kernel) and
// condat_dual_fwd (_dual_kernel).
//
//   primal:  X_new = max(X - tau grad - tau U_adj, 0)
//            [with_xbar: also X_bar = 2 X_new - X, from the same read of X]
//   dual:    U_new = clip(U + sig (2 C_new - C_old), -w, w),
//            one w per (S x S) row: w = W[e / (S * S)]
//
// Bound on the card: memory.  Each element costs a handful of flops
// against 16 bytes (primal: three reads, one write; 20 with X_bar) or
// 16 bytes plus the weight (dual).  At the main path's shapes the primal
// moves 4 x 67.2 MB (about 80 us at 3.35 TB/s) and the dual, over the
// J = 4 times larger dual stack, 4 x 269 MB (about 321 us).
//
// Design: grid-stride passes with consecutive threads on consecutive
// elements, so every load and store is coalesced; each operand is read
// once and each output written once, in fp32 with a cast on the store.
// The step sizes tau and sig are read inside the kernel from one-element
// fp32 device tensors, never passed as host floats, so the solver loop
// holds no host sync and a later CUDA graph can capture it.  NaN
// propagates (the comparisons are written so a NaN input stays NaN), as
// jnp.maximum and jnp.clip do in the reference.
#include "common.cuh"

namespace {

template <typename T, bool XBAR>
__global__ void __launch_bounds__(256)
condat_primal_kernel(const T* __restrict__ x, const T* __restrict__ ua,
                     const T* __restrict__ g, const float* __restrict__ tau,
                     T* __restrict__ xn, T* __restrict__ xb, long long n) {
  const float t = *tau;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < n; e += stride) {
    const float xv = repro::load(x, e);
    const float y = xv - t * repro::load(g, e) - t * repro::load(ua, e);
    const float v = y < 0.0f ? 0.0f : y;
    repro::store(xn, e, v);
    if (XBAR) repro::store(xb, e, 2.0f * v - xv);
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
condat_dual_kernel(const T* __restrict__ u, const T* __restrict__ cn,
                   const T* __restrict__ co, const T* __restrict__ w,
                   const float* __restrict__ sig, T* __restrict__ out,
                   long long n, int ss) {
  const float s = *sig;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < n; e += stride) {
    const float v = repro::load(u, e) +
                    s * (2.0f * repro::load(cn, e) - repro::load(co, e));
    const float wv = repro::load(w, e / ss);
    const float lo = v < -wv ? -wv : v;
    repro::store(out, e, lo > wv ? wv : lo);
  }
}

template <typename T>
cudaError_t launch_primal(const void* x, const void* ua, const void* g,
                          const void* tau, void* xn, void* xb, long long n,
                          bool with_xbar, cudaStream_t stream) {
  const int threads = 256;
  const int blocks = repro::elementwise_blocks(n, threads);
  const T* xp = static_cast<const T*>(x);
  const T* uap = static_cast<const T*>(ua);
  const T* gp = static_cast<const T*>(g);
  const float* tp = static_cast<const float*>(tau);
  if (with_xbar)
    condat_primal_kernel<T, true><<<blocks, threads, 0, stream>>>(
        xp, uap, gp, tp, static_cast<T*>(xn), static_cast<T*>(xb), n);
  else
    condat_primal_kernel<T, false><<<blocks, threads, 0, stream>>>(
        xp, uap, gp, tp, static_cast<T*>(xn), nullptr, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dual(const void* u, const void* cn, const void* co,
                        const void* w, const void* sig, void* out,
                        long long n, int ss, cudaStream_t stream) {
  const int threads = 256;
  condat_dual_kernel<T><<<repro::elementwise_blocks(n, threads), threads, 0,
                          stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(cn),
      static_cast<const T*>(co), static_cast<const T*>(w),
      static_cast<const float*>(sig), static_cast<T*>(out), n, ss);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_condat_primal(const void* x, const void* ua,
                                   const void* g, const void* tau, void* xn,
                                   void* xb, long long n, int dtype,
                                   int with_xbar, void* stream) {
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return launch_primal<float>(x, ua, g, tau, xn, xb, n, with_xbar, s);
    case repro::kBFloat16:
      return launch_primal<__nv_bfloat16>(x, ua, g, tau, xn, xb, n,
                                          with_xbar, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int repro_condat_dual(const void* u, const void* cn,
                                 const void* co, const void* w,
                                 const void* sig, void* out, long long n,
                                 int ss, int dtype, void* stream) {
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return launch_dual<float>(u, cn, co, w, sig, out, n, ss, s);
    case repro::kBFloat16:
      return launch_dual<__nv_bfloat16>(u, cn, co, w, sig, out, n, ss, s);
    default:
      return cudaErrorInvalidValue;
  }
}
