// The helpers of the starlet kernels and the register kernels of the fused
// transforms, shared by starlet2d.cu (which describes the design) and the
// parts starlet2d_regs_<p>.cu.
//
// One register kernel is built for each square side up to kMaxRegsSide,
// and the unrolled bodies of 41 sides take about 70 s to build in one
// nvcc process.  So the sides are split into kParts parts, each built from
// a source of its own by its own nvcc process (the build starts them all
// together): part p holds the sides kPartFirst[p] .. kPartFirst[p + 1] - 1,
// split so that the parts' sums of sides, the rows their kernels unroll,
// are about equal.  starlet2d.cu picks the part by the stamp's side.
#pragma once

#include "common.cuh"

namespace repro::starlet {

constexpr int kThreads = 128;   // threads of a forward / adjoint block
constexpr int kMaxScales = 8;   // the largest J of the transforms

__device__ __forceinline__ int wrap(int i, int n) {
  return ((i % n) + n) % n;
}

// i + off for i in [0, n) and off in [0, n], wrapped into [0, n)
__device__ __forceinline__ int add_wrapped(int i, int off, int n) {
  const int j = i + off;
  return j >= n ? j - n : j;
}

constexpr float k0 = 1.0f / 16, k1 = 4.0f / 16, k2 = 6.0f / 16;

// the value the composed path would hold after storing v as a T
template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kPending of this thread's copy groups are in flight;
// "memory" keeps the compiler from moving shared loads across the wait
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// --------------------------- square stamps up to 41 wide: columns in registers

constexpr int kMaxRegsSide = 41;   // the widest stamp of the register kernels
constexpr int kForwardBlocks = 4;  // blocks an SM must fit (registers)
constexpr int kAdjointBlocks = 3;

// stamps a block of the register kernels holds, one thread per column
__host__ __device__ constexpr int group(int S) { return kThreads / S; }

// Floats from one stamp's exchange buffer to the next: S * S rounded up to
// S modulo 32, so that the stamps of a block lie as if their rows ran on,
// and a warp's threads (consecutive columns, across stamps) hit 32 banks.
__host__ __device__ constexpr int stamp_stride(int S) {
  return S * S + ((S - S * S) % 32 + 32) % 32;
}

// The H pass of column t at hole 2^J0 (taps J0 known at compile time, so
// every index is a register): epi(r, value) for r = 0 .. S - 1.
template <int S, int J0, typename Epi>
__device__ __forceinline__ void h_regs(const float (&t)[S], Epi epi) {
  constexpr int o1 = (1 << J0) % S, o2 = (2 << J0) % S;
#pragma unroll
  for (int r = 0; r < S; ++r) {
    float acc = k2 * t[r];
    acc += k0 * t[(r + o2) % S];
    acc += k1 * t[(r + o1) % S];
    acc += k1 * t[(r + S - o1) % S];
    acc += k0 * t[(r + S - o2) % S];
    epi(r, acc);
  }
}

// h_regs at the runtime scale j < kMaxScales
template <int S, int J0 = 0, typename Epi>
__device__ __forceinline__ void h_regs_at(int j, const float (&t)[S],
                                          Epi epi) {
  if constexpr (J0 < kMaxScales) {
    if (j == J0)
      h_regs<S, J0>(t, epi);
    else
      h_regs_at<S, J0 + 1>(j, t, epi);
  }
}

// t = the W pass at hole 2^j of the plane in the exchange buffer ex (one
// stamp, row-major), for column c, whose own values come from centre(r)
template <int S, typename Centre>
__device__ __forceinline__ void w_regs(const float* ex, int c, int j,
                                       Centre centre, float (&t)[S]) {
  const int step = 1 << j;
  const float* p2 = ex + add_wrapped(c, wrap(2 * step, S), S);
  const float* p1 = ex + add_wrapped(c, wrap(step, S), S);
  const float* m1 = ex + add_wrapped(c, wrap(-step, S), S);
  const float* m2 = ex + add_wrapped(c, wrap(-2 * step, S), S);
#pragma unroll
  for (int r = 0; r < S; ++r) {
    float acc = k2 * centre(r);
    acc += k0 * p2[r * S];
    acc += k1 * p1[r * S];
    acc += k1 * m1[r * S];
    acc += k0 * m2[r * S];
    t[r] = acc;
  }
}

template <typename T, int S>
__device__ __forceinline__ void load_column(float (&v)[S], const T* src) {
#pragma unroll
  for (int r = 0; r < S; ++r) v[r] = repro::load(src, r * S);
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads, kForwardBlocks)
starlet_forward_regs(const T* __restrict__ x, T* __restrict__ out, int n,
                     int n_scales) {
  constexpr int kGroup = group(S);
  // two exchange buffers, alternating by scale: one barrier a scale
  __shared__ float ex[2][kGroup][stamp_stride(S)];
  const int g = threadIdx.x / S, c = threadIdx.x - g * S;
  const int stamp = blockIdx.x * kGroup + g;
  const bool active = g < kGroup && stamp < n;
  // this thread's column of its stamp, and the stride of a plane
  const long long base = static_cast<long long>(stamp) * (S * S) + c;
  const long long plane = static_cast<long long>(n) * (S * S);
  float v[S], t[S];
  if (active) load_column(v, x + base);
  for (int j = 0; j < n_scales; ++j) {
    if (active) {
      float* e = ex[j & 1][g];
#pragma unroll
      for (int r = 0; r < S; ++r) e[r * S + c] = v[r];
    }
    __syncthreads();
    if (active) {
      w_regs<S>(ex[j & 1][g], c, j, [&](int r) { return v[r]; }, t);
      T* detail = out + j * plane + base;
      h_regs_at<S>(j, t, [&](int r, float s) {
        const float next = rnd<T>(s);
        repro::store(detail, r * S, v[r] - next);
        v[r] = next;
      });
    }
  }
}

// Phi^T for fp32 stamps, columns in registers, by the identity
//   (w_j - H_j w_j) + H_j acc = w_j + H_j (acc - w_j),
// J smoothings instead of Horner's 2J - 1 (the same value; fp32 rounds the
// sums in another order).  acc stays in registers; w_j arrives in the
// thread's own column of `pre` by cp.async while scale j + 1 is smoothed.
template <int S>
__global__ void __launch_bounds__(kThreads, kAdjointBlocks)
starlet_adjoint_regs(const float* __restrict__ coeffs,
                     float* __restrict__ out, int n, int n_scales) {
  extern __shared__ float smem[];
  constexpr int kGroup = group(S), kStride = stamp_stride(S);
  const int g = threadIdx.x / S, c = threadIdx.x - g * S;
  const int stamp = blockIdx.x * kGroup + g;
  const bool active = g < kGroup && stamp < n;
  // two exchange buffers, alternating by scale, and the arriving column
  float* ex0 = smem + g * kStride;
  float* ex1 = smem + (kGroup + g) * kStride;
  float* pre = smem + (2 * kGroup + g) * kStride + c;
  const long long base = static_cast<long long>(stamp) * (S * S) + c;
  const long long plane = static_cast<long long>(n) * (S * S);
  const int top = n_scales - 1;
  float acc[S], w[S], t[S];

  auto prefetch = [&](int j) {  // w_j's column into pre
    if (j >= 0) {
      const float* src = coeffs + j * plane + base;
#pragma unroll
      for (int r = 0; r < S; ++r) cp_async4(pre + r * S, src + r * S);
    }
    cp_async_commit();
  };
  auto exchange = [&](float* e, const float (&v)[S]) {
#pragma unroll
    for (int r = 0; r < S; ++r) e[r * S + c] = v[r];
  };

  // acc = w_{J-1} - H_{J-1} w_{J-1}
  if (active) {
    load_column(w, coeffs + top * plane + base);
    exchange(ex0, w);
    prefetch(top - 1);
  }
  __syncthreads();
  if (active) {
    w_regs<S>(ex0, c, top, [&](int r) { return w[r]; }, t);
    h_regs_at<S>(top, t, [&](int r, float s) { acc[r] = w[r] - s; });
  }
  for (int j = top - 1; j >= 0; --j) {
    float* e = (top - j) & 1 ? ex1 : ex0;
    if (active) {
      cp_async_wait<0>();
#pragma unroll
      for (int r = 0; r < S; ++r) {
        w[r] = pre[r * S];
        acc[r] -= w[r];
      }
      exchange(e, acc);
      // after the exchange, which needs every read of pre done
      prefetch(j - 1);
    }
    __syncthreads();
    if (active) {
      w_regs<S>(e, c, j, [&](int r) { return acc[r]; }, t);
      h_regs_at<S>(j, t, [&](int r, float s) { acc[r] = w[r] + s; });
    }
  }
  if (active) {
#pragma unroll
    for (int r = 0; r < S; ++r) out[base + r * S] = acc[r];
  }
}

template <typename T>
cudaError_t launch_regs(void (*kernel)(const T*, T*, int, int), int group,
                        size_t smem, const void* in, void* out, int n,
                        int n_scales, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<(n + group - 1) / group, kThreads, smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), n, n_scales);
  return cudaGetLastError();
}

// Phi (or Phi^T) by the register kernel of the stamp's side, one of Lo .. Hi
// (found by counting down); bf16 Phi^T has no register kernel
template <int Lo, int Hi>
cudaError_t regs_sides(bool adjoint, int dtype, const void* in, void* out,
                       int n, int side, int n_scales, cudaStream_t stream) {
  if constexpr (Lo <= Hi) {
    if (side != Hi)
      return regs_sides<Lo, Hi - 1>(adjoint, dtype, in, out, n, side,
                                    n_scales, stream);
    if (adjoint)
      return dtype == kFloat32
                 ? launch_regs<float>(
                       starlet_adjoint_regs<Hi>, group(Hi),
                       3 * group(Hi) * stamp_stride(Hi) * sizeof(float), in,
                       out, n, n_scales, stream)
                 : cudaErrorInvalidValue;
    if (dtype == kFloat32)
      return launch_regs<float>(starlet_forward_regs<float, Hi>, group(Hi),
                                0, in, out, n, n_scales, stream);
    return launch_regs<__nv_bfloat16>(
        starlet_forward_regs<__nv_bfloat16, Hi>, group(Hi), 0, in, out, n,
        n_scales, stream);
  }
  return cudaErrorInvalidValue;
}

constexpr int kParts = 4;
constexpr int kPartFirst[kParts + 1] = {1, 21, 30, 36, kMaxRegsSide + 1};

template <int P>
cudaError_t regs_part(bool adjoint, int dtype, const void* in, void* out,
                      int n, int side, int n_scales, cudaStream_t stream) {
  constexpr int last = kPartFirst[P + 1] - 1;
  return regs_sides<kPartFirst[P], last < kMaxRegsSide ? last : kMaxRegsSide>(
      adjoint, dtype, in, out, n, side, n_scales, stream);
}

// each part is instantiated by its own source, starlet2d_regs_<p>.cu
extern template cudaError_t regs_part<0>(bool, int, const void*, void*, int,
                                         int, int, cudaStream_t);
extern template cudaError_t regs_part<1>(bool, int, const void*, void*, int,
                                         int, int, cudaStream_t);
extern template cudaError_t regs_part<2>(bool, int, const void*, void*, int,
                                         int, int, cudaStream_t);
extern template cudaError_t regs_part<3>(bool, int, const void*, void*, int,
                                         int, int, cudaStream_t);

}  // namespace repro::starlet
