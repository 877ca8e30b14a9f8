// Batched starlet (a-trous B3) smoothing and the two transforms built on
// it, for sm_90a.
//
// Replaces: src/repro/kernels/starlet2d/kernel.py, smooth_fwd (Pallas
// body _starlet_kernel), and the cascades that
// src/repro/kernels/starlet2d/ops.py composes from it (forward, adjoint).
// One smoothing at dyadic scale j is the separable 5-tap filter
// [1, 4, 6, 4, 1] / 16 with hole 2^j, first along W and then along H,
// with periodic boundaries.  Every entry point accumulates in fp32 and
// casts to the element type on the store.
//
// Periodic indices must wrap for any offset, because 2 * 2^j exceeds the
// stamp once 2^(j+1) >= S (13 x 13 at j = 3; jnp.roll in the reference
// wraps any shift): the tap offsets are reduced modulo the axis once,
// ((off % n) + n) % n, after which i + off lies in [0, 2n) and one
// conditional subtraction wraps it.  The inner loops hold no integer
// division or modulo, which would otherwise cost more than the memory
// traffic.  Shared memory is dynamic: above 48 KB a launch opts in to the
// larger limit.
//
// --- repro_starlet_smooth: one smoothing ----------------------------------
//
// Bound on the card: memory.  Each output element costs 18 flops and the
// stamp is read once and written once, so at the main path's shape
// (10 000 x 41 x 41 fp32) a call moves 2 x 67.2 MB, about 40 us at
// 3.35 TB/s, against about 5 us of fp32 arithmetic.  One thread block of
// 256 threads per stamp: the block loads the H x W stamp into shared
// memory with coalesced reads (6.7 KB at 41 x 41 fp32), runs the W pass
// into a second shared buffer, and runs the H pass from it straight to
// the output.  The thread's (row, column) advances by a constant step
// with one carry.
//
// --- repro_starlet_forward / repro_starlet_adjoint: Phi and Phi^T ----------
//
//   forward:  c_0 = x;  c_{j+1} = H_j c_j;  out[j] = c_j - c_{j+1},
//             j < J (the coarse scale c_J is never written)
//   adjoint:  acc = w_{J-1} - H_{J-1} w_{J-1};  then for j = J-2 .. 0:
//             acc = (w_j - H_j w_j) + H_j acc  (Horner, 2J - 1 smoothings)
//
// Bound on the card: memory.  Composed from single smoothings, Phi and
// Phi^T at J = 4 make 11 passes over device memory plus the subtractions,
// additions and the stack between them (about 63 planes of 67.2 MB an
// iteration).  Fused, each cascade reads and writes only what the solver
// carries: Phi reads X and writes J planes, Phi^T reads J planes and
// writes one, 5 x 67.2 MB each at the main shape, about 100 us.  Every
// intermediate scale stays on chip, and each transform is one launch.
// Taps are summed in smooth's order (centre, +2s, +s, -s, -2s).  For bf16
// the kernels round to bf16 wherever the composed path stores: each
// smoothing's output, each difference, each Horner sum.  Two designs,
// chosen by the entry points:
//
// Square stamps of side S <= kMaxRegsSide = 41 (Phi in fp32 and bf16,
// Phi^T in fp32): columns in registers.  The limit is the registers: a
// thread holds two S-float columns (three for Phi^T), which at S = 41 fill
// the 128 registers that four blocks an SM allow.  One instance per side
// is built, and the entry points pick it by the stamp's shape; the
// instances live in starlet2d.cuh and are built in four parts
// (starlet2d_regs_<p>.cu), one nvcc process each, since one process takes
// about 70 s for all of them.  A block of
// kThreads = 128 threads holds group(S) = 128 / S stamps, one thread per
// column (3 stamps, 123 threads busy at the survey's 41 x 41; 9 at 13 x
// 13).  The thread loads its column with S independent loads issued
// together (across a warp, 32 consecutive elements of a row each), and the
// H pass runs in its registers at compile-time offsets, one unrolled body
// per scale.  Only the W pass goes through shared memory: the block writes
// the plane to an exchange buffer and each thread reads its four tap
// columns at immediate row offsets, so an element costs one shared store
// and four shared loads a scale.  Two exchange buffers alternate by scale
// (one barrier a scale), and a block's stamps lie in them S * S rounded up
// to S modulo 32 floats apart (1705 at 41), so a warp that spans two
// stamps still hits 32 banks.  Phi^T uses the identity
//   (w_j - H_j w_j) + H_j acc = w_j + H_j (acc - w_j),
// J smoothings instead of Horner's 2J - 1 (fp32 rounds the sums in another
// order, well inside the tolerance against the composed path), with acc in
// registers and w_{j-1} arriving by 4-byte cp.async in the thread's own
// column of a third buffer while scale j is smoothed.  Registers bound the
// blocks per SM: kForwardBlocks = 4 (128 registers, no spills at 41) and
// kAdjointBlocks = 3 (three 41-float arrays).
//
// Any other stamp at most kThreads wide (not square, or wider than 41),
// and Phi^T in bf16: the stamp in shared memory.  One block of kThreads
// threads per stamp; the block keeps the stamp in shared memory for all J
// scales (Phi: the plane and the W pass; Phi^T: acc, w_j, the W pass and
// the arriving w_{j-1}; 13.4 / 26.9 KB at 41 x 41).  Thread t owns column c = t % W and the rows t / W + k R
// (R = blockDim / W row lanes, at most H), i.e. the elements t + k R W of
// the stamp: both passes use this one mapping, so each thread writes only
// its own elements, and consecutive threads touch consecutive addresses.
// In the W pass the thread's wrapped tap columns are fixed; in the H pass
// its four tap rows step by R with one wrap each.  The H pass reads the
// W-pass buffer only at other rows and the current plane only at the
// thread's own element, so it updates that plane in place.  Phi^T runs
// Horner's form.  Loads are issued together before first use: fp32 planes
// by 4-byte cp.async (any stamp alignment), Phi^T's w_{j-1} while scale j
// is smoothed; bf16 planes by plain loads, converted in shared memory.
//
// Limits (checked by the wrappers): W <= kThreads, J <= kMaxScales = 8, and
// the generic buffers fit a block's 227 KB: 8 H W bytes for Phi, 16 H W
// for Phi^T.
#include <type_traits>

#include "starlet2d.cuh"

namespace {

using namespace repro;
using namespace repro::starlet;

template <typename T>
__global__ void __launch_bounds__(256)
starlet_smooth_kernel(const T* __restrict__ x, T* __restrict__ out, int h,
                      int w, int step) {
  extern __shared__ float smem[];
  const int hw = h * w;
  float* a = smem;       // the stamp
  float* b = smem + hw;  // after the W pass
  const long long base = static_cast<long long>(blockIdx.x) * hw;
  // taps in the reference's order: centre, then +2s, +s, -s, -2s
  const int cp2 = wrap(2 * step, w), cp1 = wrap(step, w),
            cm1 = wrap(-step, w), cm2 = wrap(-2 * step, w);
  const int rp2 = wrap(2 * step, h), rp1 = wrap(step, h),
            rm1 = wrap(-step, h), rm2 = wrap(-2 * step, h);
  // element e = r * w + c advances by blockDim.x = dr * w + dc
  const int dr = blockDim.x / w, dc = blockDim.x - dr * w;
  const int r0 = threadIdx.x / w, c0 = threadIdx.x - r0 * w;

  for (int e = threadIdx.x; e < hw; e += blockDim.x)
    a[e] = repro::load(x, base + e);
  __syncthreads();

  int r = r0, c = c0;
  for (int e = threadIdx.x; e < hw; e += blockDim.x) {
    const float* row = a + r * w;
    float acc = k2 * row[c];
    acc += k0 * row[add_wrapped(c, cp2, w)];
    acc += k1 * row[add_wrapped(c, cp1, w)];
    acc += k1 * row[add_wrapped(c, cm1, w)];
    acc += k0 * row[add_wrapped(c, cm2, w)];
    b[e] = acc;
    c += dc;
    r += dr;
    if (c >= w) {
      c -= w;
      ++r;
    }
  }
  __syncthreads();

  r = r0;
  c = c0;
  for (int e = threadIdx.x; e < hw; e += blockDim.x) {
    float acc = k2 * b[e];
    acc += k0 * b[add_wrapped(r, rp2, h) * w + c];
    acc += k1 * b[add_wrapped(r, rp1, h) * w + c];
    acc += k1 * b[add_wrapped(r, rm1, h) * w + c];
    acc += k0 * b[add_wrapped(r, rm2, h) * w + c];
    repro::store(out, base + e, acc);
    c += dc;
    r += dr;
    if (c >= w) {
      c -= w;
      ++r;
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, int n, int h, int w, int step,
                   cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(h) * w * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        starlet_smooth_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  starlet_smooth_kernel<T><<<n, 256, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), h, w, step);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- cascades

// Start bringing one stamp (hw elements at src) into dst as fp32, as one
// copy group: fp32 by cp.async, which returns before the data lands; bf16
// by plain loads, unrolled so that several are in flight at once (the
// group is empty).
// The data may be read after cp_async_wait and a __syncthreads().
__device__ __forceinline__ void stage(float* dst, const float* src, int hw) {
  for (int e = threadIdx.x; e < hw; e += blockDim.x)
    cp_async4(dst + e, src + e);
  cp_async_commit();
}

__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src,
                                      int hw) {
#pragma unroll 8
  for (int e = threadIdx.x; e < hw; e += blockDim.x)
    dst[e] = __bfloat162float(src[e]);
  cp_async_commit();
}

// The thread's part of a stamp: column c and the rows rho + k R, i.e. the
// elements threadIdx.x + k R w.  Threads past R w sit out the passes.
struct Lanes {
  int c, rho, R, rw;
  bool active;
};

__device__ __forceinline__ Lanes lanes(int h, int w) {
  Lanes l;
  l.R = min(static_cast<int>(blockDim.x) / w, h);
  l.rw = l.R * w;
  l.active = static_cast<int>(threadIdx.x) < l.rw;
  l.rho = threadIdx.x / w;
  l.c = threadIdx.x - l.rho * w;
  return l;
}

// b = the W pass of src at hole `step`, over the thread's elements
__device__ __forceinline__ void w_pass(const float* src, float* b,
                                       const Lanes& l, int h, int w,
                                       int step) {
  if (!l.active) return;
  const int cp2 = add_wrapped(l.c, wrap(2 * step, w), w),
            cp1 = add_wrapped(l.c, wrap(step, w), w),
            cm1 = add_wrapped(l.c, wrap(-step, w), w),
            cm2 = add_wrapped(l.c, wrap(-2 * step, w), w);
  for (int r = l.rho, e = l.rho * w; r < h; r += l.R, e += l.rw) {
    const float* row = src + e;
    float acc = k2 * row[l.c];
    acc += k0 * row[cp2];
    acc += k1 * row[cp1];
    acc += k1 * row[cm1];
    acc += k0 * row[cm2];
    b[e + l.c] = acc;
  }
}

// The H pass of b at hole `step`: epi(e, smoothed value) for each of the
// thread's elements e, in order.
template <typename Epi>
__device__ __forceinline__ void h_pass(const float* b, const Lanes& l, int h,
                                       int w, int step, Epi epi) {
  if (!l.active) return;
  int rp2 = add_wrapped(l.rho, wrap(2 * step, h), h),
      rp1 = add_wrapped(l.rho, wrap(step, h), h),
      rm1 = add_wrapped(l.rho, wrap(-step, h), h),
      rm2 = add_wrapped(l.rho, wrap(-2 * step, h), h);
  const float* col = b + l.c;
  for (int r = l.rho; r < h; r += l.R) {
    float acc = k2 * col[r * w];
    acc += k0 * col[rp2 * w];
    acc += k1 * col[rp1 * w];
    acc += k1 * col[rm1 * w];
    acc += k0 * col[rm2 * w];
    epi(r * w + l.c, acc);
    rp2 = add_wrapped(rp2, l.R, h);
    rp1 = add_wrapped(rp1, l.R, h);
    rm1 = add_wrapped(rm1, l.R, h);
    rm2 = add_wrapped(rm2, l.R, h);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
starlet_forward_kernel(const T* __restrict__ x, T* __restrict__ out, int n,
                       int h, int w, int n_scales) {
  extern __shared__ float smem[];
  const int hw = h * w;
  float* c = smem;       // c_j, replaced in place by c_{j+1}
  float* b = smem + hw;  // the W pass
  const long long base = static_cast<long long>(blockIdx.x) * hw;
  const long long plane = static_cast<long long>(n) * hw;
  const Lanes l = lanes(h, w);
  stage(c, x + base, hw);
  cp_async_wait<0>();
  __syncthreads();
  for (int j = 0; j < n_scales; ++j) {
    const int step = 1 << j;
    w_pass(c, b, l, h, w, step);
    __syncthreads();
    T* detail = out + j * plane + base;
    const bool keep = j + 1 < n_scales;
    h_pass(b, l, h, w, step, [&](int e, float s) {
      const float next = rnd<T>(s);
      repro::store(detail, e, c[e] - next);
      if (keep) c[e] = next;
    });
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
starlet_adjoint_kernel(const T* __restrict__ coeffs, T* __restrict__ out,
                       int n, int h, int w, int n_scales) {
  extern __shared__ float smem[];
  const int hw = h * w;
  float* acc = smem;           // the Horner sum
  float* b = smem + hw;        // the W pass
  float* cur = smem + 2 * hw;  // w_j, replaced in place by v_j
  float* nxt = smem + 3 * hw;  // w_{j-1}, arriving
  const long long base = static_cast<long long>(blockIdx.x) * hw;
  const long long plane = static_cast<long long>(n) * hw;
  const Lanes l = lanes(h, w);
  const int top = n_scales - 1;

  stage(cur, coeffs + top * plane + base, hw);
  if (top > 0) {
    stage(nxt, coeffs + (top - 1) * plane + base, hw);
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
  w_pass(cur, b, l, h, w, 1 << top);
  __syncthreads();
  if (top == 0) {
    h_pass(b, l, h, w, 1, [&](int e, float s) {
      repro::store(out, base + e, cur[e] - rnd<T>(s));
    });
    return;
  }
  h_pass(b, l, h, w, 1 << top, [&](int e, float s) {
    acc[e] = rnd<T>(cur[e] - rnd<T>(s));
  });
  for (int j = top - 1; j >= 0; --j) {
    const int step = 1 << j;
    float* t = cur;
    cur = nxt;
    nxt = t;
    cp_async_wait<0>();
    __syncthreads();  // w_j has landed; the old w_{j+1} and b are free
    if (j > 0) stage(nxt, coeffs + (j - 1) * plane + base, hw);
    // v_j = w_j - H_j w_j, in place of w_j
    w_pass(cur, b, l, h, w, step);
    __syncthreads();
    h_pass(b, l, h, w, step, [&](int e, float s) {
      cur[e] = rnd<T>(cur[e] - rnd<T>(s));
    });
    __syncthreads();
    // acc = v_j + H_j acc
    w_pass(acc, b, l, h, w, step);
    __syncthreads();
    if (j > 0) {
      h_pass(b, l, h, w, step, [&](int e, float s) {
        acc[e] = rnd<T>(cur[e] + rnd<T>(s));
      });
    } else {
      h_pass(b, l, h, w, step, [&](int e, float s) {
        repro::store(out, base + e, cur[e] + rnd<T>(s));
      });
    }
  }
}

template <typename T>
cudaError_t launch_cascade(void (*kernel)(const T*, T*, int, int, int, int),
                           int buffers, const void* in, void* out, int n,
                           int h, int w, int n_scales, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(buffers) * h * w * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<n, kThreads, smem, stream>>>(static_cast<const T*>(in),
                                        static_cast<T*>(out), n, h, w,
                                        n_scales);
  return cudaGetLastError();
}

// Phi or Phi^T: square stamps up to kMaxRegsSide wide by the register
// kernel of their side (fp32 only for Phi^T), found in its part; any other
// stamp by the shared-memory kernel
template <typename T>
cudaError_t cascade(bool adjoint, const void* in, void* out, int n, int h,
                    int w, int n_scales, cudaStream_t stream) {
  const int dtype = std::is_same<T, float>::value ? kFloat32 : kBFloat16;
  if (h == w && h <= kMaxRegsSide && !(adjoint && dtype != kFloat32)) {
    int part = 0;
    while (h >= kPartFirst[part + 1]) ++part;
    switch (part) {
      case 0:
        return regs_part<0>(adjoint, dtype, in, out, n, h, n_scales, stream);
      case 1:
        return regs_part<1>(adjoint, dtype, in, out, n, h, n_scales, stream);
      case 2:
        return regs_part<2>(adjoint, dtype, in, out, n, h, n_scales, stream);
      default:
        return regs_part<3>(adjoint, dtype, in, out, n, h, n_scales, stream);
    }
  }
  if (adjoint)
    return launch_cascade<T>(starlet_adjoint_kernel<T>, 4, in, out, n, h, w,
                             n_scales, stream);
  return launch_cascade<T>(starlet_forward_kernel<T>, 2, in, out, n, h, w,
                           n_scales, stream);
}

}  // namespace

extern "C" int repro_starlet_smooth(const void* x, void* out, int n, int h,
                                    int w, int step, int dtype,
                                    void* stream) {
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return launch<float>(x, out, n, h, w, step, s);
    case repro::kBFloat16:
      return launch<__nv_bfloat16>(x, out, n, h, w, step, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int repro_starlet_forward(const void* x, void* out, int n, int h,
                                     int w, int n_scales, int dtype,
                                     void* stream) {
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return cascade<float>(false, x, out, n, h, w, n_scales, s);
    case repro::kBFloat16:
      return cascade<__nv_bfloat16>(false, x, out, n, h, w, n_scales,
                                     s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int repro_starlet_adjoint(const void* coeffs, void* out, int n,
                                     int h, int w, int n_scales, int dtype,
                                     void* stream) {
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return cascade<float>(true, coeffs, out, n, h, w, n_scales, s);
    case repro::kBFloat16:
      return cascade<__nv_bfloat16>(true, coeffs, out, n, h, w, n_scales,
                                     s);
    default:
      return cudaErrorInvalidValue;
  }
}
