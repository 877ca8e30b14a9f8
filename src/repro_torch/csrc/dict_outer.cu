// Fused SCDL outer products (Algorithm 2, step 9), for sm_90a.
//
// Replaces: src/repro/kernels/dict_outer/kernel.py, dict_outer_pair_fwd
// (Pallas body _outer_pair_kernel) and dict_outer_fwd (_outer_kernel).
//
//   out_q = L_q^T R_q    for up to four products q, each L_q (K, m_q) and
//                        R_q (K, n) row-major, out_q (m_q, n) in fp32.
//
// The pair form is the four products Sh^T Wh (P, A), Sl^T Wl (M, A),
// Wh^T Wh and Wl^T Wl (A, A); the single form is S^T W and W^T W.
//
// Bound on the card: operations.  A product L^T R needs 2 K m n flops, a
// Gram W^T W only K n (n + 1) (it is symmetric): at K = 40 000, P = 289,
// M = 81, A = 512 the pair form needs 36.2 GFLOP, 0.540 ms at the
// 67 TFLOP/s fp32 (non-tensor-core) peak, against 0.067 ms for its bytes.
// This kernel computes both halves of each Gram (57.1 GFLOP).
// TF32 tensor cores would be faster but keep about three decimal digits;
// the dictionary update needs fp32, so this is a SIMT fp32 product.
//
// Design: a split-K GEMM over the stacked tile lists of all products.
// Pass 1: block (tile, split) owns one 128 x 128 output tile of one
// product and one slice of K.  It stages 8 rows of L and R at a time in
// shared memory (rows beyond the slice's end and columns beyond the
// product's edge load as zeros, so no padding of K or of the outputs is
// needed), keeps two such stages (it loads the next 8 rows from device
// memory while it computes on the current ones, then stores them into the
// other stage: one barrier per stage), and accumulates an 8 x 8 register
// tile per thread in fp32, with two blocks resident on each SM.  The
// thread's rows and columns are split in two halves 64 apart, so its
// float4 reads of shared memory are free of bank conflicts.  Each block
// writes its partial tile to a scratch buffer.  Pass 2 sums the partials
// of every output element over the splits in a fixed order and writes the
// masked result: no atomics, so the result is the same on every run.
// Unlike the TPU version, nothing holds a whole (A, A) accumulator, so
// any A runs (the paper's A = 2056 too).
#include "common.cuh"

namespace {

constexpr int kTile = 128;         // output tile edge
constexpr int kHalf = kTile / 2;   // a thread's two row/column groups
constexpr int kBK = 8;             // rows of K per shared-memory stage
constexpr int kThreads = 256;      // 16 x 16 threads, 8 x 8 outputs each
constexpr int kMaxProducts = 4;
constexpr long long kMinRows = 512;  // a slice of K is never shorter
constexpr int kBlocksPerSm = 4;      // blocks to aim for (two resident)

struct Product {
  const void* L;    // (K, m) row-major
  const void* R;    // (K, n) row-major
  float* out;       // (m, n) row-major
  int m;
  int tiles_n;      // tiles along n
  int tile_begin;   // index of the product's first tile in the stack
};

struct Products {
  Product p[kMaxProducts];
  int count;
  int n;            // columns of every R and out
  int tiles;        // tiles of all products
};

__device__ __forceinline__ int product_of(const Products& ps, int tile) {
  int q = 0;
  while (q + 1 < ps.count && tile >= ps.p[q + 1].tile_begin) ++q;
  return q;
}

// two blocks per SM (at most 128 registers a thread): one block of 8 warps
// alone does not hide the latency of its shared-memory and FMA chains
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
dict_outer_partial(const Products ps, long long K, long long rows_per_split,
                   float* __restrict__ partials) {
  // two stages: the block computes from one while it fills the other
  __shared__ __align__(16) float sL[2][kBK][kTile];
  __shared__ __align__(16) float sR[2][kBK][kTile];

  const int tile = blockIdx.x;
  const int split = blockIdx.y;
  const Product& pr = ps.p[product_of(ps, tile)];
  const int local = tile - pr.tile_begin;
  const int i0 = (local / pr.tiles_n) * kTile;
  const int j0 = (local % pr.tiles_n) * kTile;
  const int m = pr.m;
  const int n = ps.n;
  const T* __restrict__ L = static_cast<const T*>(pr.L);
  const T* __restrict__ R = static_cast<const T*>(pr.R);
  const long long k_begin = split * rows_per_split;
  const long long k_end =
      k_begin + rows_per_split < K ? k_begin + rows_per_split : K;

  // staging: thread t loads column t % 128 of rows t / 128 + 2 r, r < 4
  const int t = threadIdx.x;
  const int sc = t & (kTile - 1);
  const int sr = t >> 7;
  const bool l_in = i0 + sc < m;
  const bool r_in = j0 + sc < n;
  float regL[kBK / 2], regR[kBK / 2];
  auto fetch = [&](long long k0) {
#pragma unroll
    for (int r = 0; r < kBK / 2; ++r) {
      const long long k = k0 + sr + 2 * r;
      const bool row = k < k_end;
      regL[r] = row && l_in ? repro::load(L, k * m + i0 + sc) : 0.0f;
      regR[r] = row && r_in ? repro::load(R, k * n + j0 + sc) : 0.0f;
    }
  };

  // compute: thread (ty, tx) owns rows ty*4 + {0..3} and 64 + ty*4 + {0..3},
  // columns tx*4 + {0..3} and 64 + tx*4 + {0..3}
  const int tx = t & 15;
  const int ty = t >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  auto stage = [&](int buf) {
#pragma unroll
    for (int r = 0; r < kBK / 2; ++r) {
      sL[buf][sr + 2 * r][sc] = regL[r];
      sR[buf][sr + 2 * r][sc] = regR[r];
    }
  };

  if (k_begin < k_end) {
    fetch(k_begin);
    stage(0);
  }
  __syncthreads();
  int buf = 0;
  for (long long k0 = k_begin; k0 < k_end; k0 += kBK, buf ^= 1) {
    const bool more = k0 + kBK < k_end;
    // the next rows' global loads are in flight while this stage computes
    if (more) fetch(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(&sL[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&sL[buf][kk][kHalf + ty * 4]);
      const float4 b0 =
          *reinterpret_cast<const float4*>(&sR[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&sR[buf][kk][kHalf + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other stage was last read before the previous barrier, so it
    // can be filled now; one barrier per stage
    if (more) stage(buf ^ 1);
    __syncthreads();
  }

  float* dst = partials +
               (static_cast<long long>(split) * ps.tiles + tile) * kTile * kTile;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = (i < 4 ? 0 : kHalf) + ty * 4 + (i & 3);
    *reinterpret_cast<float4*>(&dst[row * kTile + tx * 4]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(&dst[row * kTile + kHalf + tx * 4]) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// Sum the splits' partial tiles in split order, masked to each product.
__global__ void __launch_bounds__(256)
dict_outer_reduce(const Products ps, int splits,
                  const float* __restrict__ partials) {
  const long long per_split = static_cast<long long>(ps.tiles) * kTile * kTile;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < per_split; e += stride) {
    const int tile = static_cast<int>(e / (kTile * kTile));
    const int r = static_cast<int>(e % (kTile * kTile));
    const Product& pr = ps.p[product_of(ps, tile)];
    const int local = tile - pr.tile_begin;
    const int i = (local / pr.tiles_n) * kTile + r / kTile;
    const int j = (local % pr.tiles_n) * kTile + r % kTile;
    if (i >= pr.m || j >= ps.n) continue;
    float s = 0.0f;
    for (int sp = 0; sp < splits; ++sp) s += partials[sp * per_split + e];
    pr.out[static_cast<long long>(i) * ps.n + j] = s;
  }
}

template <typename T>
cudaError_t launch(const Products& ps, long long K, int splits,
                   float* partials, cudaStream_t stream) {
  long long rows = (K + splits - 1) / splits;
  rows = (rows + kBK - 1) / kBK * kBK;
  dict_outer_partial<T><<<dim3(ps.tiles, splits), kThreads, 0, stream>>>(
      ps, K, rows, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long outs = static_cast<long long>(ps.tiles) * kTile * kTile;
  dict_outer_reduce<<<repro::elementwise_blocks(outs, 256), 256, 0,
                      stream>>>(ps, splits, partials);
  return cudaGetLastError();
}

int tiles_of(int count, const int* m, int n) {
  const int tiles_n = (n + kTile - 1) / kTile;
  int tiles = 0;
  for (int q = 0; q < count; ++q) tiles += (m[q] + kTile - 1) / kTile * tiles_n;
  return tiles;
}

bool valid(int count, const int* m, int n, long long K) {
  if (count < 1 || count > kMaxProducts || n < 1 || K < 1) return false;
  for (int q = 0; q < count; ++q)
    if (m[q] < 1) return false;
  return true;
}

}  // namespace

// The launch plan for count products q < 4, L[q] (K, m[q]) and R[q] (K, n),
// on a card with `sms` SMs: *splits slices of K (enough blocks to fill the
// card, no slice under kMinRows rows) and the *scratch floats that
// repro_dict_outer needs for its partial tiles.  Host only; no launch.
extern "C" int repro_dict_outer_plan(int count, const int* m, int n,
                                     long long K, int sms, int* splits,
                                     long long* scratch) {
  if (!valid(count, m, n, K) || sms < 1) return cudaErrorInvalidValue;
  const long long tiles = tiles_of(count, m, n);
  const long long want = (kBlocksPerSm * sms + tiles - 1) / tiles;
  const long long most = (K + kMinRows - 1) / kMinRows;
  long long s = want < most ? want : most;
  if (s < 1) s = 1;
  if (s > 65535) s = 65535;
  *splits = static_cast<int>(s);
  *scratch = s * tiles * kTile * kTile;
  return cudaSuccess;
}

// count products q < 4: L[q] (K, m[q]), R[q] (K, n), out[q] (m[q], n) fp32;
// `splits` and the size of `partials` as repro_dict_outer_plan gives them.
extern "C" int repro_dict_outer(int count, const void* const* L,
                                const void* const* R, void* const* out,
                                const int* m, int n, long long K, int splits,
                                void* partials, int dtype, void* stream) {
  if (!valid(count, m, n, K) || splits < 1 || splits > 65535)
    return cudaErrorInvalidValue;
  Products ps{};
  ps.count = count;
  ps.n = n;
  const int tiles_n = (n + kTile - 1) / kTile;
  int tiles = 0;
  for (int q = 0; q < count; ++q) {
    ps.p[q] = Product{L[q], R[q], static_cast<float*>(out[q]), m[q], tiles_n,
                      tiles};
    tiles += (m[q] + kTile - 1) / kTile * tiles_n;
  }
  ps.tiles = tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  switch (dtype) {
    case repro::kFloat32:
      return launch<float>(ps, K, splits, part, s);
    case repro::kBFloat16:
      return launch<__nv_bfloat16>(ps, K, splits, part, s);
    default:
      return cudaErrorInvalidValue;
  }
}
