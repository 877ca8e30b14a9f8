// Batched starlet (a-trous B3) smoothing of a stamp stack, for sm_90a.
//
// Replaces: src/repro/kernels/starlet2d/kernel.py, smooth_fwd (Pallas
// body _starlet_kernel).  One smoothing at dyadic scale j: the separable
// 5-tap filter [1, 4, 6, 4, 1] / 16 with hole 2^j, first along W and then
// along H, with periodic boundaries.  Accumulates in fp32 and casts to the
// element type on the store.
//
// Bound on the card: memory.  Each output element costs 18 flops and the
// stamp is read once and written once, so at the main path's shape
// (10 000 x 41 x 41 fp32) a call moves 2 x 67.2 MB, about 40 us at
// 3.35 TB/s, against about 5 us of fp32 arithmetic.
//
// Design: one thread block of 256 threads per stamp.  The block loads the
// H x W stamp into shared memory with coalesced reads (6.7 KB at 41 x 41
// fp32), runs the W pass into a second shared buffer, and runs the H pass
// from it straight to the output, so the intermediate never touches device
// memory.  Periodic indices must wrap for any offset, because 2 * 2^j
// exceeds the stamp once j = 3 and S < 16 (jnp.roll in the reference wraps
// any shift): each thread reduces the four tap offsets modulo the axis
// once, ((off % n) + n) % n, after which i + off lies in [0, 2n) and one
// conditional subtraction wraps it.  The thread's (row, column) advances by
// a constant step with one carry, so the inner loops hold no integer
// division or modulo, which would otherwise cost more than the memory
// traffic.  Shared memory is dynamic: above 48 KB the entry point opts in
// to the larger limit.
#include "common.cuh"

namespace {

__device__ __forceinline__ int wrap(int i, int n) {
  return ((i % n) + n) % n;
}

// i + off for i in [0, n) and off in [0, n), wrapped into [0, n)
__device__ __forceinline__ int add_wrapped(int i, int off, int n) {
  const int j = i + off;
  return j >= n ? j - n : j;
}

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
  const float k0 = 1.0f / 16, k1 = 4.0f / 16, k2 = 6.0f / 16;
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
