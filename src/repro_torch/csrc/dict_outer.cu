// Fused SCDL outer products (Algorithm 2, step 9), for sm_90a.
//
// Replaces: src/repro/kernels/dict_outer/kernel.py:99, dict_outer_pair_fwd
// (Pallas body _outer_pair_kernel), and :49, dict_outer_fwd (_outer_kernel).
//
//   out_q = L_q^T R_q    for up to four products q, each L_q (K, m_q) and
//                        R_q (K, n) row-major, out_q (m_q, n) in fp32.
//
// The pair form is the four products Sh^T Wh (P, A), Sl^T Wl (M, A),
// Wh^T Wh and Wl^T Wl (A, A); the single form is S^T W and W^T W.
//
// Bounds on the card, for the pair at K = 40 000, P = 289, M = 81,
// A = 512: a product L^T R needs 2 K m n flops, a Gram W^T W only
// K n (n + 1) (it is symmetric), 36.2 GFLOP in all: 0.540 ms at the
// 67 TFLOP/s fp32 (SIMT) peak.  Taken as three TF32 products each (below),
// 108.5 GFLOP: 0.219 ms at the 495 TFLOP/s dense TF32 tensor-core peak.
// Its bytes: 226 MB, 0.067 ms at 3.35 TB/s.
//
// Design:
// - Tensor cores at fp32 accuracy (3xTF32).  The product runs on
//   mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.  Each fp32
//   operand x is split in registers into hi = cvt.rna.tf32(x) and
//   lo = cvt.rna.tf32(x - hi), and three MMAs a step of 8 rows go into a
//   fresh tensor-core accumulator for every kFold steps: lo.hi, hi.lo,
//   then hi.hi (lo.lo, below 2^-22 of the product, is dropped); its sum
//   is then added to the fp32 accumulator with round-to-nearest.  The
//   tensor cores add into their accumulator with truncation: over 2048
//   rows in one accumulator a Gram's diagonal, a sum of squares, came out
//   1.8e-5 low, and over 256 the SCDL solve still moved 2.7e-4 off its
//   fp32 reference (rtol 1e-4); over 16 rows, 1.9e-5.  A bf16 value is
//   already a TF32 value, so bf16 inputs take hi.hi alone (a template on
//   the dtype), into one accumulator over at most acc_rows rows.
// - mma.sync and not wgmma: wgmma takes TF32 operands only K-major, and
//   both operands here are M/N-major (L and R are (K, m) row-major, K the
//   slow axis), so every stage would have to be transposed in shared
//   memory, and hi and lo of B written back there.  mma.sync's fragments
//   are read straight from a [k][m] tile; its rows are padded to 128 + 8
//   elements, so the warp's fragment reads (k = lane % 4 (+4),
//   m = lane / 4 (+8)) of an aligned operand fall on 32 banks.  On this
//   card mma.sync reaches about 60 % of the dense TF32 rate
//   (tools/mma_rate.py), so it cannot reach the 0.219 ms above.
// - Only the upper triangle of a Gram: for a Gram product (L_q and R_q
//   one tensor) the blocks enumerate the tiles with tile_i <= tile_j;
//   the reduction pass writes an off-diagonal tile at (i, j) and
//   mirrored at (j, i).  At A = 512 the pair has 36 tiles of 128 x 128
//   instead of 48.  In a diagonal tile, a warp wholly below the diagonal
//   computes nothing and the reduction pass mirrors the upper half, as it
//   does for a warp whose rows all lie past a product's edge (the third
//   row of Sh^T Wh's tiles holds 33 of 128 rows): the output is exactly
//   symmetric.
// - A cp.async ring of kStages stages of kBK rows of both operands in
//   dynamic shared memory (above 48 KB, set once).  Every copy moves 16
//   aligned bytes: a row whose columns do not start on a 16-byte boundary
//   (the rows of Sh, 289 x 4 = 1156 bytes, and of Sl, 324 bytes, do not;
//   TMA, whose strides must be multiples of 16 bytes, cannot load them)
//   is read from the boundary before it and lands shifted in its staged
//   row, one copy longer; the fragment reads add the shift of their row,
//   which is the same for rows k and k + 8.  Rows past the slice's end
//   and columns past the product's edge are zero-filled (src-size), so
//   nothing is padded.
// - Deterministic split-K: block (tile, split) owns one 128 x 128 output
//   tile (8 warps of 64 x 32, one block per SM: 64 accumulators and
//   their step sums a thread) and one slice of K, and writes its partial
//   tile to a scratch buffer; the reduction pass sums the slices in a
//   fixed order: no atomics, the same bits on every run.  The plan caps
//   the rows of one slice (acc_rows, from kernels/dict_outer/kernel.py),
//   the longest sum a bf16 accumulator takes; the slices' sums are added
//   with round-to-nearest in the second pass.
// Unlike the TPU version, nothing holds a whole (A, A) accumulator, so any
// A runs (the paper's A = 2056 too).
#include "common.cuh"

namespace {

constexpr int kTile = 128;             // output tile edge
constexpr int kStride = kTile + 8;     // elements per staged row (padded)
constexpr int kBK = 32;                // rows of K per stage
constexpr int kStages = 3;             // depth of the cp.async ring
constexpr int kWarpM = 64;             // a warp's rows of the tile
constexpr int kWarpN = 32;             // a warp's columns of the tile
constexpr int kWarpsN = kTile / kWarpN;
constexpr int kThreads = 32 * (kTile / kWarpM) * kWarpsN;
constexpr int kMT = kWarpM / 16;       // m16n8k8 tiles along m, per warp
constexpr int kNT = kWarpN / 8;        // ... along n
constexpr int kFold = 2;               // 8-row steps a tensor-core sum takes
constexpr int kResident = 1;           // blocks per SM: up to 255 registers
constexpr int kMaxProducts = 4;
constexpr long long kMinRows = 256;    // a slice of K is never shorter
// the plan's cost model, in units of the time a block spends on one row:
// a block's fixed cost (ring fill, partial-tile store) and a split's
// share of the reduction pass
constexpr long long kBlockRows = 64;
constexpr long long kSplitRows = 8;

static_assert(kTile % kWarpM == 0 && kTile % kWarpN == 0 &&
                  kBK % (8 * kFold) == 0,
              "warps must cover the tile");

// An operand (K, ld) row-major, addressed from the 16-byte boundary at or
// before its first element, so that every copy reads 16 aligned bytes.
struct Operand {
  const void* base;
  int off;          // elements from base to the operand's first element
  int ld;           // elements a row
  int aligned;      // off == 0 and rows of a multiple of 16 bytes
};

struct Product {
  Operand L;        // (K, m)
  Operand R;        // (K, n)
  float* out;       // (m, n) row-major
  int m;
  int gram;         // L and R are one tensor (m == n): upper tiles only
  int tile_begin;   // index of the product's first tile in the stack
};

struct Products {
  Product p[kMaxProducts];
  int count;
  int n;            // columns of every R and out
  int tiles_n;      // tiles along n
  int tiles;        // tiles of all products
};

__host__ __device__ inline int tiles_of(int m, bool gram, int tiles_n) {
  return gram ? tiles_n * (tiles_n + 1) / 2
              : (m + kTile - 1) / kTile * tiles_n;
}

// The product and the tile (ti, tj) of stacked tile `tile`.
__device__ __forceinline__ int tile_of(const Products& ps, int tile, int* ti,
                                       int* tj) {
  int q = 0;
  while (q + 1 < ps.count && tile >= ps.p[q + 1].tile_begin) ++q;
  int local = tile - ps.p[q].tile_begin;
  if (ps.p[q].gram) {
    int i = 0;  // row i holds the tiles (i, i) .. (i, tiles_n - 1)
    while (local >= ps.tiles_n - i) {
      local -= ps.tiles_n - i;
      ++i;
    }
    *ti = i;
    *tj = i + local;
  } else {
    *ti = local / ps.tiles_n;
    *tj = local % ps.tiles_n;
  }
  return q;
}

template <typename T>
constexpr int smem_bytes() {
  return kStages * 2 * kBK * kStride * static_cast<int>(sizeof(T));
}

// ------------------------------------------------------------- staging

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// copies the first `bytes` of 16 aligned bytes and zero-fills the rest
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Elements of T in one 16-byte copy.
template <typename T>
__host__ __device__ constexpr int vec() {
  return 16 / static_cast<int>(sizeof(T));
}

// Where column c0 of row `row` of an operand sits in its staged row: its
// offset from the 16-byte boundary before it.  Rows k and k + 8 share it,
// so it is fixed for each row of an 8-row step.
template <typename T>
__device__ __forceinline__ int shift_of(const Operand& op, long long row,
                                        int c0) {
  constexpr int kVec = vec<T>();
  return static_cast<int>((op.off + row * op.ld + c0) & (kVec - 1));
}

// Copy q of staged row r: the 16 bytes from the boundary before column
// c0 of row r0 + r, plus q * 16, into dst[r][q * vec]; only the bytes up
// to column c0 + cols, and none past the slice's end (`rows`), are read.
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const Operand& op, int c0,
                                           int cols, long long r0, int rows,
                                           int r, int q) {
  constexpr int kVec = vec<T>();
  const long long e = op.off + (r0 + r) * op.ld + c0;
  const int shift = static_cast<int>(e & (kVec - 1));
  int n = cols + shift - q * kVec;  // elements to read (the first `shift`
  n = r >= rows || n < 0 ? 0 : n > kVec ? kVec : n;  // are never used)
  const T* src =
      static_cast<const T*>(op.base) + (n ? e - shift + q * kVec : 0);
  cp_async16(dst + r * kStride + q * kVec, src,
             n * static_cast<int>(sizeof(T)));
}

// Stage rows r0 .. r0 + kBK of columns c0 .. c0 + min(cols, kTile) of an
// operand into dst [kBK][kStride]: a row starts `shift` elements into its
// staged row and takes kTile / vec + 1 copies (kTile / vec when the
// operand is aligned, as W is at A = 512; the rows of Sh, 289 x 4 =
// 1156 bytes, and of Sl, 324 bytes, are not).  Elements past the edges
// are zeros.
template <typename T>
__device__ __forceinline__ void stage_operand(T* dst, const Operand& op,
                                              int c0, int cols, long long r0,
                                              int rows) {
  constexpr int kVec = vec<T>();
  constexpr int kPerRow = kTile / kVec;
  constexpr int kRowsPerPass = kThreads / kPerRow;
  static_assert(kThreads % kPerRow == 0 && kBK % kRowsPerPass == 0 &&
                    kBK <= kThreads,
                "copies split evenly");
  static_assert(kTile + kVec <= kStride, "a shifted row fits");
  cols = cols < kTile ? cols : kTile;
  const int q = threadIdx.x % kPerRow;
  const int r = threadIdx.x / kPerRow;
#pragma unroll
  for (int it = 0; it < kBK / kRowsPerPass; ++it)
    copy_chunk(dst, op, c0, cols, r0, rows, r + it * kRowsPerPass, q);
  if (!op.aligned && threadIdx.x < kBK)
    copy_chunk(dst, op, c0, cols, r0, rows, threadIdx.x, kPerRow);
}

// ------------------------------------------------------------- compute

// cvt.rna.tf32.f32 (round to nearest, ties away from zero) on the bit
// pattern: add half a TF32 ulp to the magnitude, then drop the 13 low
// bits.  The instruction itself lowers to two more instructions a value
// (a guard that passes inf and NaN through, which this form turns into a
// NaN product all the same), and the split is most of the kernel's
// non-tensor-core work.
__device__ __forceinline__ unsigned tf32_round(float x) {
  return __float_as_uint(x) + 0x1000u;
}
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return tf32_round(x) & 0xffffe000u;
}

__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ float as_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// hi = tf32(x), lo = tf32(x - hi); a bf16 value is its own hi (lo = 0).
// lo goes only to the tensor core, which reads the 19 bits of a TF32
// operand and ignores the 13 low ones, so it is rounded but not masked
// (as the compiler's own lowering of cvt.rna for an MMA operand does).
template <typename T>
__device__ __forceinline__ void split(T v, unsigned* hi, unsigned* lo) {
  const float x = as_float(v);
  if constexpr (sizeof(T) == 2) {
    *hi = __float_as_uint(x);
  } else {
    *hi = tf32_rna(x);
    *lo = tf32_round(x - __uint_as_float(*hi));
  }
}

// c += a b
__device__ __forceinline__ void mma_tf32(float* c, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c = a b
__device__ __forceinline__ void mma_tf32_first(float* c, const unsigned* a,
                                               const unsigned* b) {
  const float z = 0.0f;
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(z));
}

// The thread's fragment rows of a staged stage: row t and row t + 4 of
// each 8-row step, each with its shift; g = lane / 4, t = lane % 4.
struct Frag {
  int lo;  // offset of row t, column 0 of the warp's block
  int hi;  // the same for row t + 4
};

// acc += (rows kk .. kk + 8 kFold of sA)^T (the same rows of sB), for the
// first kRows groups of 16 rows of the warp's kWarpM x kWarpN block of the
// tile.  fp32: the 3 kFold MMAs of each 16 x 8 block go into a fresh
// tensor-core accumulator, whose sum is added to the fp32 one with
// round-to-nearest; bf16: one MMA a step, straight into it.
template <typename T, int kRows>
__device__ __forceinline__ void mma_step(const T* sA, const T* sB, int kk,
                                         Frag fa, Frag fb,
                                         float (&acc)[kMT][kNT][4]) {
  constexpr bool kThree = sizeof(T) == 4;  // 3xTF32 for fp32 inputs
  const T* a0 = sA + kk * kStride + fa.lo;
  const T* a1 = sA + kk * kStride + fa.hi;
  const T* b0 = sB + kk * kStride + fb.lo;
  const T* b1 = sB + kk * kStride + fb.hi;
  // B fragment: (k = t, n = g), (t + 4, g)
  unsigned bh[kFold][kNT][2], bl[kFold][kNT][2];
#pragma unroll
  for (int s = 0; s < kFold; ++s)
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      split(b0[s * 8 * kStride + j * 8], &bh[s][j][0], &bl[s][j][0]);
      split(b1[s * 8 * kStride + j * 8], &bh[s][j][1], &bl[s][j][1]);
    }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    // A fragment: (m = g, k = t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
    unsigned ah[kFold][4], al[kFold][4];
#pragma unroll
    for (int s = 0; s < kFold; ++s) {
      const int o = s * 8 * kStride + i * 16;
      split(a0[o], &ah[s][0], &al[s][0]);
      split(a0[o + 8], &ah[s][1], &al[s][1]);
      split(a1[o], &ah[s][2], &al[s][2]);
      split(a1[o + 8], &ah[s][3], &al[s][3]);
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if constexpr (kThree) {
        float sum[4];
        mma_tf32_first(sum, al[0], bh[0][j]);
        mma_tf32(sum, ah[0], bl[0][j]);
        mma_tf32(sum, ah[0], bh[0][j]);
#pragma unroll
        for (int s = 1; s < kFold; ++s) {
          mma_tf32(sum, al[s], bh[s][j]);
          mma_tf32(sum, ah[s], bl[s][j]);
          mma_tf32(sum, ah[s], bh[s][j]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += sum[e];
      } else {
#pragma unroll
        for (int s = 0; s < kFold; ++s) mma_tf32(acc[i][j], ah[s], bh[s][j]);
      }
    }
  }
}

// One stage (kBK rows) for a warp whose first `rows` groups of 16 rows hold
// outputs: a straight-line body for each count, chosen once per stage.
template <typename T, int kRows>
__device__ __forceinline__ void mma_stage(const T* sA, const T* sB, int rows,
                                          Frag fa, Frag fb,
                                          float (&acc)[kMT][kNT][4]) {
  if constexpr (kRows > 0) {
    if (rows == kRows) {
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 8 * kFold)
        mma_step<T, kRows>(sA, sB, kk, fa, fb, acc);
      return;
    }
    mma_stage<T, kRows - 1>(sA, sB, rows, fa, fb, acc);
  }
}

// Pass 1: block (tile, split) computes one slice of K of one output tile.
template <typename T>
__global__ void __launch_bounds__(kThreads, kResident)
dict_outer_partial(const Products ps, long long K, long long rows_per_split,
                   float* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // [kStages][2][kBK][kStride]

  const int tile = blockIdx.x;
  const int split = blockIdx.y;
  int ti, tj;
  const Product& pr = ps.p[tile_of(ps, tile, &ti, &tj)];
  const int i0 = ti * kTile;
  const int j0 = tj * kTile;
  const int n = ps.n;
  // a diagonal tile of a Gram stages its one operand once
  const bool diag = pr.gram && ti == tj;
  const long long k_begin = split * rows_per_split;
  const long long k_end =
      k_begin + rows_per_split < K ? k_begin + rows_per_split : K;
  const int nk =
      k_begin < k_end ? static_cast<int>((k_end - k_begin + kBK - 1) / kBK)
                      : 0;

  auto load = [&](int kt) {
    T* sA = ring + (kt % kStages) * 2 * kBK * kStride;
    const long long r0 = k_begin + static_cast<long long>(kt) * kBK;
    const int rows = static_cast<int>(k_end - r0 < kBK ? k_end - r0 : kBK);
    stage_operand(sA, pr.L, i0, pr.m - i0, r0, rows);
    if (!diag) stage_operand(sA + kBK * kStride, pr.R, j0, n - j0, r0, rows);
  };

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = (warp / kWarpsN) * kWarpM;
  const int wn = (warp % kWarpsN) * kWarpN;
  const int g = lane >> 2;
  const int t = lane & 3;
  // 8-row steps start on rows k_begin + a multiple of 8
  const Frag fa{t * kStride + shift_of<T>(pr.L, k_begin + t, i0) + wm + g,
                (t + 4) * kStride + shift_of<T>(pr.L, k_begin + t + 4, i0) +
                    wm + g};
  const Frag fb{t * kStride + shift_of<T>(pr.R, k_begin + t, j0) + wn + g,
                (t + 4) * kStride + shift_of<T>(pr.R, k_begin + t + 4, j0) +
                    wn + g};
  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  // the warp's groups of 16 rows that hold outputs: those inside the
  // product, and none for a warp wholly below the diagonal of a Gram's
  // diagonal tile (the reduction pass takes that part from the upper half)
  int rows = (pr.m - i0 - wm + 15) / 16;
  rows = rows < 0 ? 0 : rows > kMT ? kMT : rows;
  if (diag && wm >= wn + kWarpN) rows = 0;

  // the ring: stage kt is in flight kStages - 1 steps before it is used;
  // one barrier per stage (stage kt + kStages - 1 refills the buffer that
  // step kt - 1 read, which every thread has left at the barrier)
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < nk) load(kt + kStages - 1);
    cp_async_commit();
    const T* sA = ring + (kt % kStages) * 2 * kBK * kStride;
    const T* sB = diag ? sA : sA + kBK * kStride;
    mma_stage<T, kMT>(sA, sB, rows, fa, fb, acc);
  }
  cp_async_wait<0>();

  // C fragment: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
  float* dst = partials +
               (static_cast<long long>(split) * ps.tiles + tile) * kTile * kTile;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int row = wm + i * 16 + g;
      const int col = wn + j * 8 + 2 * t;
      *reinterpret_cast<float2*>(&dst[row * kTile + col]) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(&dst[(row + 8) * kTile + col]) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
}

// Pass 2: block (tile, 32 x 32 sub-tile) sums the splits' partials in
// split order and writes them masked to the product.  An off-diagonal
// tile of a Gram is written again at the mirrored place; in a diagonal
// tile the sub-tiles below the diagonal, and the elements below the
// diagonal of a diagonal sub-tile, are written from the upper ones (pass 1
// skips warps wholly below it), so a Gram comes out exactly symmetric.  Transposed writes go through shared memory, so that every
// write is coalesced.
constexpr int kSub = 32;
constexpr int kSubsRow = kTile / kSub;
constexpr int kSubs = kSubsRow * kSubsRow;

__global__ void __launch_bounds__(256)
dict_outer_reduce(const Products ps, int splits,
                  const float* __restrict__ partials) {
  __shared__ float sum[kSub][kSub + 1];
  const int tile = blockIdx.x / kSubs;
  const int sr = (blockIdx.x % kSubs) / kSubsRow;
  const int sc = (blockIdx.x % kSubs) % kSubsRow;
  int ti, tj;
  const Product& pr = ps.p[tile_of(ps, tile, &ti, &tj)];
  const bool diag = pr.gram && ti == tj;
  if (diag && sr > sc) return;  // written by sub-tile (sc, sr)
  const int gi = ti * kTile + sr * kSub;  // the sub-tile's place in out
  const int gj = tj * kTile + sc * kSub;
  const int m = pr.m;
  const int n = ps.n;
  float* out = pr.out;
  const int tx = threadIdx.x % kSub;
  const int ty = threadIdx.x / kSub;
  constexpr int kRows = 256 / kSub;
  const long long per_split = static_cast<long long>(ps.tiles) * kTile * kTile;
  const float* src = partials + static_cast<long long>(tile) * kTile * kTile +
                     (sr * kSub) * kTile + sc * kSub;
  for (int y = ty; y < kSub; y += kRows) {
    float s = 0.0f;
    for (int sp = 0; sp < splits; ++sp) s += src[sp * per_split + y * kTile + tx];
    sum[y][tx] = s;
  }
  __syncthreads();
  // (y, x) -> out[gi + y][gj + x]; the diagonal sub-tile's lower half
  // from its upper half
  const bool on_diag = diag && sr == sc;
  for (int y = ty; y < kSub; y += kRows)
    if (gi + y < m && gj + tx < n)
      out[static_cast<long long>(gi + y) * n + gj + tx] =
          on_diag && y > tx ? sum[tx][y] : sum[y][tx];
  if (!pr.gram || on_diag) return;
  // the mirror: out[gj + y][gi + x] = sum[x][y]
  for (int y = ty; y < kSub; y += kRows)
    if (gj + y < n && gi + tx < m)
      out[static_cast<long long>(gj + y) * n + gi + tx] = sum[tx][y];
}

template <typename T>
cudaError_t launch(const Products& ps, long long K, int splits,
                   float* partials, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory only on request, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      dict_outer_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<T>());
  if (attr != cudaSuccess) return attr;
  long long rows = (K + splits - 1) / splits;
  rows = (rows + kBK - 1) / kBK * kBK;
  dict_outer_partial<T>
      <<<dim3(ps.tiles, splits), kThreads, smem_bytes<T>(), stream>>>(
          ps, K, rows, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dict_outer_reduce<<<ps.tiles * kSubs, 256, 0, stream>>>(ps, splits,
                                                          partials);
  return cudaGetLastError();
}

bool valid(int count, const int* m, const int* gram, int n, long long K) {
  if (count < 1 || count > kMaxProducts || n < 1 || K < 1) return false;
  for (int q = 0; q < count; ++q)
    if (m[q] < 1 || (gram[q] && m[q] != n)) return false;
  return true;
}

long long stacked_tiles(int count, const int* m, const int* gram, int n) {
  const int tiles_n = (n + kTile - 1) / kTile;
  long long tiles = 0;
  for (int q = 0; q < count; ++q) tiles += tiles_of(m[q], gram[q], tiles_n);
  return tiles;
}

Operand operand_of(const void* p, int ld, int elem) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(p);
  Operand op{reinterpret_cast<const void*>(a & ~15ull),
             static_cast<int>((a & 15) / elem), ld, 0};
  op.aligned = op.off == 0 && static_cast<long long>(ld) * elem % 16 == 0;
  return op;
}

}  // namespace

// The launch plan for count products q < 4, L[q] (K, m[q]) and R[q] (K, n)
// (gram[q]: L[q] and R[q] are one tensor), on a card with `sms` SMs:
// *splits slices of K, each of at most acc_rows rows (the longest sum one
// tensor-core accumulator takes) and at least 256 unless that cap needs
// more, chosen so that the blocks fill whole waves
// of the card; and the *scratch floats that repro_dict_outer needs for
// its partial tiles.  Host only; no launch.
extern "C" int repro_dict_outer_plan(int count, const int* m, const int* gram,
                                     int n, long long K, int sms,
                                     int acc_rows, int* splits,
                                     long long* scratch) {
  if (!valid(count, m, gram, n, K) || sms < 1 || acc_rows < kBK)
    return cudaErrorInvalidValue;
  const long long cap = acc_rows / kBK * kBK;  // whole stages
  const long long tiles = stacked_tiles(count, m, gram, n);
  const long long slots = static_cast<long long>(kResident) * sms;
  const long long least = (K + cap - 1) / cap;
  long long most = (K + kMinRows - 1) / kMinRows;
  if (most < least) most = least;
  long long best = least, best_cost = -1;
  for (long long s = least; s <= most && s <= 65535; ++s) {
    long long rows = (K + s - 1) / s;
    rows = (rows + kBK - 1) / kBK * kBK;
    const long long used = (K + rows - 1) / rows;  // slices that get rows
    const long long waves = (tiles * used + slots - 1) / slots;
    const long long cost = waves * (rows + kBlockRows) + used * kSplitRows;
    if (best_cost < 0 || cost < best_cost) {
      best = used;
      best_cost = cost;
    }
  }
  if (best > 65535) return cudaErrorInvalidValue;
  *splits = static_cast<int>(best);
  *scratch = best * tiles * kTile * kTile;
  return cudaSuccess;
}

// count products q < 4: L[q] (K, m[q]), R[q] (K, n), out[q] (m[q], n) fp32,
// gram[q] as for the plan (L[q] == R[q]); `splits` and the `scratch` floats
// at `partials` as repro_dict_outer_plan gives them.
extern "C" int repro_dict_outer(int count, const void* const* L,
                                const void* const* R, void* const* out,
                                const int* m, const int* gram, int n,
                                long long K, int splits, void* partials,
                                long long scratch, int dtype, void* stream) {
  if (!valid(count, m, gram, n, K) || splits < 1 || splits > 65535)
    return cudaErrorInvalidValue;
  const long long tiles = stacked_tiles(count, m, gram, n);
  if (tiles * splits * kTile * kTile > scratch || tiles > 0x7fffffff / kSubs)
    return cudaErrorInvalidValue;
  int elem;
  switch (dtype) {
    case repro::kFloat32: elem = 4; break;
    case repro::kBFloat16: elem = 2; break;
    default: return cudaErrorInvalidValue;
  }
  Products ps{};
  ps.count = count;
  ps.n = n;
  ps.tiles_n = (n + kTile - 1) / kTile;
  int begin = 0;
  for (int q = 0; q < count; ++q) {
    if (gram[q] && L[q] != R[q]) return cudaErrorInvalidValue;
    ps.p[q] = Product{operand_of(L[q], m[q], elem), operand_of(R[q], n, elem),
                      static_cast<float*>(out[q]), m[q], gram[q] ? 1 : 0,
                      begin};
    begin += tiles_of(m[q], gram[q], ps.tiles_n);
  }
  ps.tiles = begin;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  if (dtype == repro::kFloat32) return launch<float>(ps, K, splits, part, s);
  return launch<__nv_bfloat16>(ps, K, splits, part, s);
}
