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
//   tau and sig: one per instance of a bucket (below)
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
// The step sizes tau and sig are read inside the kernel from fp32 device
// tensors, never passed as host floats, so the solver loop holds no host
// sync and a later CUDA graph can capture it.  NaN propagates (the
// comparisons are written so a NaN input stays NaN), as jnp.maximum and
// jnp.clip do in the reference.
//
// A step size per instance.  A bucket of solve_many carries one tau and
// one sig per instance (the JAX package gets that from jax.vmap, which
// adds a grid axis to the Pallas call).  The pass stays one flat
// grid-stride loop over all the elements, as for one instance, and each
// element finds its instance from the layout:
//   primal: the elements form `count` equal runs, one per instance:
//           instance = e / per;
//   dual:   the scale-major (J, count, run, S, S) stack of a bucket: rows
//           of ss = S * S elements (row = e / ss, also the weight's index)
//           in runs of `run` rows cycling through the instances:
//           instance = (row / run) % count.
// The divisions are by constants of the launch, done with the round-up
// multiply-high method (FastDiv below) on 32-bit indices, so the added
// work is a few integer operations an element; the step size comes from a
// cached load.  The instance on blockIdx.y, with one range of blocks
// for each run of the stack, was built first and measured half as slow
// again as one instance over the same stack (PERF.md, PR 17); the flat
// pass keeps one instance's access pattern.  One instance (count = 1)
// runs the loop without the lookup, as before.  Above 2^31 - 1 elements
// the index is 64-bit and the divisions plain.
#include <type_traits>

#include "common.cuh"

namespace {

// unsigned division by a launch constant d >= 1 for n < 2^31:
// q = (umulhi(n, m) + n) >> l, with l = ceil(log2 d) and
// m = floor(2^32 (2^l - d) / d) + 1 (exact for every such n; the sum
// cannot wrap since umulhi(n, m) <= n < 2^31)
struct FastDiv {
  unsigned d, m, l;
};

FastDiv make_div(unsigned d) {
  unsigned l = 0;
  while ((1ULL << l) < d) ++l;
  const unsigned long long m =
      ((1ULL << 32) * ((1ULL << l) - d)) / d + 1;
  return FastDiv{d, static_cast<unsigned>(m), l};
}

template <bool WIDE>
__device__ __forceinline__ auto quot(
    typename std::conditional<WIDE, long long, unsigned>::type n,
    const FastDiv& v) {
  if constexpr (WIDE) {
    return n / static_cast<long long>(v.d);
  } else {
    return (__umulhi(n, v.m) + n) >> v.l;
  }
}

template <typename T, bool XBAR, bool BATCHED, bool WIDE>
__global__ void __launch_bounds__(256)
condat_primal_kernel(const T* __restrict__ x, const T* __restrict__ ua,
                     const T* __restrict__ g, const float* __restrict__ tau,
                     T* __restrict__ xn, T* __restrict__ xb, long long n,
                     FastDiv per) {
  using I = typename std::conditional<WIDE, long long, unsigned>::type;
  const float t0 = *tau;
  const I stride = static_cast<I>(gridDim.x) * blockDim.x;
  const I end = static_cast<I>(n);
  for (I e = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x; e < end;
       e += stride) {
    const float t = BATCHED ? tau[quot<WIDE>(e, per)] : t0;
    const float xv = repro::load(x, e);
    const float y = xv - t * repro::load(g, e) - t * repro::load(ua, e);
    const float v = y < 0.0f ? 0.0f : y;
    repro::store(xn, e, v);
    if (XBAR) repro::store(xb, e, 2.0f * v - xv);
  }
}

template <typename T, bool BATCHED, bool WIDE>
__global__ void __launch_bounds__(256)
condat_dual_kernel(const T* __restrict__ u, const T* __restrict__ cn,
                   const T* __restrict__ co, const T* __restrict__ w,
                   const float* __restrict__ sig, T* __restrict__ out,
                   long long n, FastDiv ss, FastDiv run, FastDiv count) {
  using I = typename std::conditional<WIDE, long long, unsigned>::type;
  const float s0 = *sig;
  const I stride = static_cast<I>(gridDim.x) * blockDim.x;
  const I end = static_cast<I>(n);
  for (I e = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x; e < end;
       e += stride) {
    const I row = quot<WIDE>(e, ss);
    float s = s0;
    if (BATCHED) {
      const I r = quot<WIDE>(row, run);
      s = sig[r - quot<WIDE>(r, count) * count.d];
    }
    const float v = repro::load(u, e) +
                    s * (2.0f * repro::load(cn, e) - repro::load(co, e));
    const float wv = repro::load(w, row);
    const float lo = v < -wv ? -wv : v;
    repro::store(out, e, lo > wv ? wv : lo);
  }
}

// the 32-bit index holds e + stride below 2^32 for every e < 2^31
constexpr long long kMaxNarrow = (1LL << 31) - 1;

template <typename T, bool XBAR, bool BATCHED>
void primal_grid(const T* x, const T* ua, const T* g, const float* tau,
                 T* xn, T* xb, long long n, FastDiv per,
                 cudaStream_t stream) {
  const int threads = 256;
  const int blocks = repro::elementwise_blocks(n, threads);
  if (n <= kMaxNarrow)
    condat_primal_kernel<T, XBAR, BATCHED, false>
        <<<blocks, threads, 0, stream>>>(x, ua, g, tau, xn, xb, n, per);
  else
    condat_primal_kernel<T, XBAR, BATCHED, true>
        <<<blocks, threads, 0, stream>>>(x, ua, g, tau, xn, xb, n, per);
}

template <typename T>
cudaError_t launch_primal(const void* x, const void* ua, const void* g,
                          const void* tau, void* xn, void* xb, long long n,
                          int count, bool with_xbar, cudaStream_t stream) {
  if (count < 1 || n % count != 0 || (count > 1 && n > kMaxNarrow &&
                                      n / count > 0xFFFFFFFFLL))
    return cudaErrorInvalidValue;
  // one instance needs no divisor (the loop reads tau once)
  const FastDiv per =
      make_div(count > 1 ? static_cast<unsigned>(n / count) : 1u);
  const T* xp = static_cast<const T*>(x);
  const T* uap = static_cast<const T*>(ua);
  const T* gp = static_cast<const T*>(g);
  const float* tp = static_cast<const float*>(tau);
  T* xnp = static_cast<T*>(xn);
  T* xbp = static_cast<T*>(xb);
  if (with_xbar) {
    if (count > 1)
      primal_grid<T, true, true>(xp, uap, gp, tp, xnp, xbp, n, per, stream);
    else
      primal_grid<T, true, false>(xp, uap, gp, tp, xnp, xbp, n, per, stream);
  } else {
    if (count > 1)
      primal_grid<T, false, true>(xp, uap, gp, tp, xnp, xbp, n, per, stream);
    else
      primal_grid<T, false, false>(xp, uap, gp, tp, xnp, xbp, n, per,
                                   stream);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dual(const void* u, const void* cn, const void* co,
                        const void* w, const void* sig, void* out,
                        long long n, int ss, int run, int count,
                        cudaStream_t stream) {
  if (ss <= 0 || run <= 0 || count < 1 || n % ss != 0 ||
      (n / ss) % (static_cast<long long>(run) * count) != 0)
    return cudaErrorInvalidValue;
  const FastDiv fss = make_div(ss), frun = make_div(run),
                fcount = make_div(count);
  const int threads = 256;
  const int blocks = repro::elementwise_blocks(n, threads);
  const T* up = static_cast<const T*>(u);
  const T* cnp = static_cast<const T*>(cn);
  const T* cop = static_cast<const T*>(co);
  const T* wp = static_cast<const T*>(w);
  const float* sp = static_cast<const float*>(sig);
  T* op = static_cast<T*>(out);
  const bool wide = n > kMaxNarrow;
#define REPRO_DUAL(B, W)                                                  \
  condat_dual_kernel<T, B, W><<<blocks, threads, 0, stream>>>(           \
      up, cnp, cop, wp, sp, op, n, fss, frun, fcount)
  if (count > 1) {
    if (wide) REPRO_DUAL(true, true); else REPRO_DUAL(true, false);
  } else {
    if (wide) REPRO_DUAL(false, true); else REPRO_DUAL(false, false);
  }
#undef REPRO_DUAL
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_condat_primal(const void* x, const void* ua,
                                   const void* g, const void* tau, void* xn,
                                   void* xb, long long n, int count,
                                   int dtype, int with_xbar, void* stream) {
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return launch_primal<float>(x, ua, g, tau, xn, xb, n, count,
                                  with_xbar, s);
    case repro::kBFloat16:
      return launch_primal<__nv_bfloat16>(x, ua, g, tau, xn, xb, n, count,
                                          with_xbar, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int repro_condat_dual(const void* u, const void* cn,
                                 const void* co, const void* w,
                                 const void* sig, void* out, long long n,
                                 int ss, int run, int count, int dtype,
                                 void* stream) {
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return launch_dual<float>(u, cn, co, w, sig, out, n, ss, run, count,
                                s);
    case repro::kBFloat16:
      return launch_dual<__nv_bfloat16>(u, cn, co, w, sig, out, n, ss, run,
                                        count, s);
    default:
      return cudaErrorInvalidValue;
  }
}
