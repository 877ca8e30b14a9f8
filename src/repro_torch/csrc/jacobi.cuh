// The Jacobi kernels' templates (the design is in the note at the top of
// jacobi.cu): one block per matrix, one instance per even side M = r
// rounded up to even.  The instances are spread over the parts
// jacobi_<p>.cu, one nvcc process each.
#pragma once

#include <cfloat>

#include "common.cuh"

namespace repro::jacobi {

constexpr int kMaxR = 64;
constexpr int kMaxSweeps = 30;
constexpr double kEps = FLT_EPSILON;
// a pair whose off-diagonal entry is under this is left alone, so the
// rotation's power-of-two scaling stays normal; an fp32 input's entries
// and their rotations stay hundreds of orders of magnitude above it
constexpr double kTiny = 0x1p-1000;
constexpr unsigned kFull = 0xffffffffu;

// the team of a matrix, whole warps: eigh one thread per 2 x 2 block of
// the upper triangle (K (K + 1) / 2 of them, K = M / 2 pairs) up to
// kEighMaxWarps warps, past which more warps cost more than they share
// (every warp computes all of a step's rotations); the SVD kSvdLanes
// lanes a pair
constexpr int kEighMaxWarps = 9;
constexpr int kSvdLanes = 16;

__host__ __device__ constexpr int eigh_threads(int M) {
  const int warps = (M / 2 * (M / 2 + 1) / 2 + 31) / 32;
  return 32 * (warps < kEighMaxWarps ? warps : kEighMaxWarps);
}
__host__ __device__ constexpr int svd_threads(int M) {
  return 32 * ((kSvdLanes * (M / 2) + 31) / 32);
}
// the SVD's lanes per pair: the largest power of two that fits K of them
// in T threads, at most a warp
__host__ __device__ constexpr int svd_group(int M, int T) {
  int L = 1;
  while (L < 32 && 2 * L * (M / 2) <= T) L *= 2;
  return L;
}
// doubles of shared memory a matrix: eigh two planes of A (read one,
// write the other) and V, M x (M + 1) each; the SVD M columns of G over
// W, 2M + 1 each, and the M column norms
__host__ __device__ constexpr int eigh_doubles(int M, bool vectors) {
  return (vectors ? 3 : 2) * M * (M + 1);
}
__host__ __device__ constexpr int svd_doubles(int M) {
  return M * (2 * M + 1) + M;
}

// The pair (p < q) rotated by pair k at step `step` of a sweep: the circle
// method over M players keeps player M - 1 fixed and turns the others, so
// the M / 2 pairs of a step are disjoint and every pair meets once in
// M - 1 steps.  For odd r, player r = M - 1 is a zero row and column that
// never rotates.
template <int M>
__device__ __forceinline__ void pair_of(int step, int k, int& p, int& q) {
  int a = M - 1, b = step;
  if (k != 0) {
    a = step + k;
    if (a >= M - 1) a -= M - 1;
    b = step - k;
    if (b < 0) b += M - 1;
  }
  p = min(a, b);
  q = max(a, b);
}

// 1 / sqrt(w) for w in fp32's normal range: an fp32 seed (rsqrtf, within
// 2 ulp) and one fp64 step of the series y (1 - e)^(-1/2) = y (1 + e / 2 +
// 3 e^2 / 8 + ...), e = 1 - w y^2, cut after e^2: from |e| < 2^-21 the
// error is 5/16 |e|^3 < 2^-64, so the result carries fp64 rounding alone.
// y has 24 bits, so y * y is exact and e one rounding of its exact value.
__device__ __forceinline__ double rsqrt_refined(double w) {
  const double y = static_cast<double>(rsqrtf(static_cast<float>(w)));
  const double e = fma(-w, y * y, 1.0);
  return fma(y * e, fma(0.375, e, 0.5), y);
}

struct Rotation {
  double c, s, t;  // t = s / c; the identity (1, 0, 0) when not rotated
};

// The rotation that zeroes z in [[x, z], [z, y]] (Golub and Van Loan's
// sym.schur2: t = sign(d) 2z / (|d| + sqrt(d^2 + 4z^2)), d = y - x), or the
// identity when the pair meets the stopping test |z| <= eps sqrt(|x| |y|),
// tested squared.  Without a division or an IEEE square root: d and z are
// scaled by the power of two that brings max(|d|, 2|z|) into [1, 2)
// (exact), so with h = sqrt(d^2 + 4z^2) (= u rsqrt(u)) and g = |d| + h,
// g^2 + 4z^2 = 2hg and rho = rsqrt(2hg) give c = g rho, s = sign(d) 2z rho
// and t = s / c = sign(d) 4z h rho^2; both reciprocal square roots take
// arguments in [1, 32).  c^2 + s^2 = 1 to a few fp64 ulps.
__device__ __forceinline__ Rotation rotation(double x, double y, double z) {
  Rotation rot{1.0, 0.0, 0.0};
  if (!(z * z > kEps * kEps * fabs(x) * fabs(y)) || !(fabs(z) > kTiny))
    return rot;
  const double d = y - x;
  const double big = fmax(fabs(d), 2.0 * fabs(z));
  const double scale =
      __hiloint2double((2046 - (__double2hiint(big) >> 20)) << 20, 0);
  const double dn = fabs(d) * scale;
  const double zn = signbit(d) ? -z * scale : z * scale;
  const double u = fma(dn, dn, 4.0 * zn * zn);
  const double h = u * rsqrt_refined(u);
  const double g = dn + h;
  const double rho = rsqrt_refined(2.0 * h * g);
  rot.c = g * rho;
  rot.s = 2.0 * zn * rho;
  rot.t = 4.0 * zn * h * (rho * rho);
  return rot;
}

// y strictly before x: ascending (descending with `desc`), NaN last
__device__ __forceinline__ bool before(double y, double x, bool desc) {
  if (isnan(x)) return !isnan(y);
  if (isnan(y)) return false;
  return desc ? y > x : y < x;
}

// the rank of vals[j * stride] among the r values vals[k * stride], ties
// broken by index, so the ranks of 0 .. r - 1 are a permutation
__device__ __forceinline__ int rank_of(const double* vals, int stride, int r,
                                       int j, bool desc) {
  const double x = vals[j * stride];
  int rank = 0;
  for (int k = 0; k < r; ++k) {
    const double y = vals[k * stride];
    rank += before(y, x, desc) || (k < j && !before(x, y, desc));
  }
  return rank;
}

// Two-sided Jacobi on symmetric A (M x M, the odd r's last row and column
// zero).  Every warp computes all M / 2 rotations of a step (lane k, pair
// k) from the plane it reads, so every thread knows each rotation and
// whether the step rotated anything, without a barrier; a thread then
// sets its 2 x 2 blocks J_k^T A_kl J_l of the other plane and its rows of
// V <- V J, and the step ends in one barrier (none when nothing rotated).
template <int M, int T, bool kVectors>
__global__ void __launch_bounds__(T, 1)
    eigh_kernel(const float* __restrict__ a, float* __restrict__ w,
                float* __restrict__ v, int* __restrict__ sweeps, int r) {
  constexpr int K = M / 2, LD = M + 1;
  constexpr int kBlocks = K * (K + 1) / 2;  // k <= l
  constexpr int kItems = (kBlocks + T - 1) / T;
  constexpr int kGroups = T / K;  // V: threads per pair, rows strided
  constexpr int kRowsV = (M + kGroups - 1) / kGroups;
  extern __shared__ double smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const long long mat = blockIdx.x;
  double* cur = smem;
  double* nxt = cur + M * LD;
  double* V = nxt + M * LD;
  const long long base = mat * r * r;
  for (int e = tid; e < M * M; e += T) {
    const int i = e / M, j = e - i * M;
    double x = 0.0;
    if (i < r && j < r)
      x = 0.5 * (static_cast<double>(a[base + i * r + j]) +
                 a[base + j * r + i]);
    cur[i * LD + j] = x;
    if (kVectors) V[i * LD + j] = i == j && i < r ? 1.0 : 0.0;
  }
  // this thread's blocks (k, l) of the upper triangle, fixed for the run
  int ik[kItems], il[kItems];
#pragma unroll
  for (int n = 0; n < kItems; ++n) {
    int e = tid + n * T, k = 0;
    if (e < kBlocks)
      while (e >= K - k) e -= K - k++;
    ik[n] = e < kBlocks ? k : -1;
    il[n] = e < kBlocks ? k + e : 0;
  }
  const int vl = tid % K, v_row = tid / K;  // V: pair vl, rows v_row + ..
  __syncthreads();
  int sweep = 0;
  bool more = true;
  while (more && sweep < kMaxSweeps) {
    more = false;
    for (int step = 0; step < M - 1; ++step) {
      Rotation rot{1.0, 0.0, 0.0};
      int pq = 0;
      if (lane < K) {
        int p, q;
        pair_of<M>(step, lane, p, q);
        pq = p | q << 8;
        rot = rotation(cur[p * LD + p], cur[q * LD + q], cur[p * LD + q]);
      }
      if (!__any_sync(kFull, rot.t != 0.0)) continue;  // nothing to write
      more = true;
      // the step's shuffles and loads first, so that they are all in
      // flight together; then the arithmetic, then the stores
      double ck[kItems], sk[kItems], tk[kItems], cl[kItems], sl[kItems];
      double b[kItems][4];
      int pk[kItems], qk[kItems], pl[kItems], ql[kItems];
#pragma unroll
      for (int n = 0; n < kItems; ++n) {
        const int k = max(ik[n], 0), l = il[n];
        ck[n] = __shfl_sync(kFull, rot.c, k);
        sk[n] = __shfl_sync(kFull, rot.s, k);
        tk[n] = __shfl_sync(kFull, rot.t, k);
        cl[n] = __shfl_sync(kFull, rot.c, l);
        sl[n] = __shfl_sync(kFull, rot.s, l);
        const int pqk = __shfl_sync(kFull, pq, k);
        const int pql = __shfl_sync(kFull, pq, l);
        pk[n] = pqk & 255;
        qk[n] = pqk >> 8;
        pl[n] = pql & 255;
        ql[n] = pql >> 8;
        if (ik[n] >= 0) {
          b[n][0] = cur[pk[n] * LD + pl[n]];
          b[n][1] = cur[pk[n] * LD + ql[n]];
          b[n][2] = cur[qk[n] * LD + pl[n]];
          b[n][3] = cur[qk[n] * LD + ql[n]];
        }
      }
      [[maybe_unused]] double vc, vs, vp[kRowsV], vq[kRowsV];
      [[maybe_unused]] int vpi = 0, vqi = 0;
      if constexpr (kVectors) {
        vc = __shfl_sync(kFull, rot.c, vl);
        vs = __shfl_sync(kFull, rot.s, vl);
        const int pql = __shfl_sync(kFull, pq, vl);
        vpi = pql & 255;
        vqi = pql >> 8;
        if (v_row < kGroups && vs != 0.0) {
#pragma unroll
          for (int j = 0; j < kRowsV; ++j) {
            const int i = v_row + j * kGroups;
            if (i < r) {
              vp[j] = V[i * LD + vpi];
              vq[j] = V[i * LD + vqi];
            }
          }
        }
      }
#pragma unroll
      for (int n = 0; n < kItems; ++n) {
        if (ik[n] < 0) continue;
        double b00 = b[n][0], b01 = b[n][1], b10 = b[n][2], b11 = b[n][3];
        if (ik[n] == il[n]) {
          // the pivot block from the rotation's own formulas
          if (tk[n] != 0.0) {
            b00 = b00 - tk[n] * b01;
            b11 = b11 + tk[n] * b01;
            b01 = b10 = 0.0;
          }
        } else {
          if (sk[n] != 0.0) {  // J_k^T B: rows
            const double r00 = ck[n] * b00 - sk[n] * b10;
            const double r01 = ck[n] * b01 - sk[n] * b11;
            b10 = sk[n] * b00 + ck[n] * b10;
            b11 = sk[n] * b01 + ck[n] * b11;
            b00 = r00;
            b01 = r01;
          }
          if (sl[n] != 0.0) {  // (J_k^T B) J_l: columns
            const double c00 = cl[n] * b00 - sl[n] * b01;
            const double c10 = cl[n] * b10 - sl[n] * b11;
            b01 = sl[n] * b00 + cl[n] * b01;
            b11 = sl[n] * b10 + cl[n] * b11;
            b00 = c00;
            b10 = c10;
          }
          nxt[pl[n] * LD + pk[n]] = b00;
          nxt[ql[n] * LD + pk[n]] = b01;
          nxt[pl[n] * LD + qk[n]] = b10;
          nxt[ql[n] * LD + qk[n]] = b11;
        }
        nxt[pk[n] * LD + pl[n]] = b00;
        nxt[pk[n] * LD + ql[n]] = b01;
        nxt[qk[n] * LD + pl[n]] = b10;
        nxt[qk[n] * LD + ql[n]] = b11;
      }
      if constexpr (kVectors) {
        if (v_row < kGroups && vs != 0.0) {
#pragma unroll
          for (int j = 0; j < kRowsV; ++j) {
            const int i = v_row + j * kGroups;
            if (i < r) {
              V[i * LD + vpi] = vc * vp[j] - vs * vq[j];
              V[i * LD + vqi] = vs * vp[j] + vc * vq[j];
            }
          }
        }
      }
      __syncthreads();
      double* const done = nxt;
      nxt = cur;
      cur = done;
    }
    ++sweep;
  }
  for (int j = tid; j < r; j += T) {
    const int rank = rank_of(cur, LD + 1, r, j, false);
    w[mat * r + rank] = static_cast<float>(cur[j * LD + j]);
    if (kVectors)
      for (int i = 0; i < r; ++i)
        v[base + i * r + rank] = static_cast<float>(V[i * LD + j]);
  }
  if (tid == 0) sweeps[mat] = sweep;
}

// One-sided (Hestenes) Jacobi on the columns of R (r x r): G = R W, each
// column of G over the same column of W in shared memory (2M rows, the
// rows from r on zero).  L lanes a pair: each sums its rows of the pair's
// 2 x 2 Gram, a butterfly over the L lanes gives every lane the same sums
// in the same order, every lane of the pair computes the rotation and
// rotates its rows of both columns; one barrier a step, which also tells
// whether any pair rotated.
template <int M, int T>
__global__ void __launch_bounds__(T, 1)
    svd_kernel(const float* __restrict__ a, float* __restrict__ u,
               float* __restrict__ s_out, float* __restrict__ vh,
               int* __restrict__ sweeps, int r) {
  constexpr int K = M / 2, LDC = 2 * M + 1;
  constexpr int L = svd_group(M, T);
  constexpr int kRotRows = (2 * M + L - 1) / L;
  extern __shared__ double smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const long long mat = blockIdx.x;
  double* C = smem;  // column j at C + j * LDC
  double* norms = C + M * LDC;
  const long long base = mat * r * r;
  for (int e = tid; e < M * M; e += T) {
    const int i = e / M, j = e - i * M;
    C[j * LDC + i] = i < r && j < r ? a[base + i * r + j] : 0.0;
    C[j * LDC + M + i] = i == j && i < r ? 1.0 : 0.0;
  }
  // (eps ||R||_F)^2: every warp sums the same squares in the same order
  double ss = 0.0;
  for (int e = lane; e < r * r; e += 32) {
    const double x = a[base + e];
    ss += x * x;
  }
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(kFull, ss, off);
  const double negligible = kEps * kEps * ss;
  const int g = tid / L, j = tid % L;
  const bool active = g < K;  // lanes past the last pair mirror it
  __syncthreads();
  int sweep = 0;
  bool more = true;
  while (more && sweep < kMaxSweeps) {
    more = false;
    for (int step = 0; step < M - 1; ++step) {
      int p, q;
      pair_of<M>(step, min(g, K - 1), p, q);
      double* cp = C + p * LDC;
      double* cq = C + q * LDC;
      // this lane's rows of both columns (G over W), loaded together
      double xp[kRotRows], xq[kRotRows];
#pragma unroll
      for (int n = 0; n < kRotRows; ++n) {
        const int i = j + n * L;
        if (i < 2 * M) {
          xp[n] = cp[i];
          xq[n] = cq[i];
        }
      }
      double alpha = 0.0, beta = 0.0, gamma = 0.0;
#pragma unroll
      for (int n = 0; n < kRotRows; ++n) {
        if (j + n * L < M) {
          alpha += xp[n] * xp[n];
          beta += xq[n] * xq[n];
          gamma += xp[n] * xq[n];
        }
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1) {
        alpha += __shfl_xor_sync(kFull, alpha, off);
        beta += __shfl_xor_sync(kFull, beta, off);
        gamma += __shfl_xor_sync(kFull, gamma, off);
      }
      // a column of norm at most eps ||R||_F is numerically zero: see the
      // note at the top of jacobi.cu
      Rotation rot{1.0, 0.0, 0.0};
      if (fmin(alpha, beta) > negligible) rot = rotation(alpha, beta, gamma);
      const bool rotated = active && rot.t != 0.0;
      if (rotated) {
#pragma unroll
        for (int n = 0; n < kRotRows; ++n) {
          const int i = j + n * L;
          if (i < 2 * M) {
            cp[i] = rot.c * xp[n] - rot.s * xq[n];
            cq[i] = rot.s * xp[n] + rot.c * xq[n];
          }
        }
      }
      more |= __syncthreads_or(rotated) != 0;
    }
    ++sweep;
  }
  for (int c = tid; c < r; c += T) {
    double n2 = 0.0;
    for (int i = 0; i < r; ++i) n2 += C[c * LDC + i] * C[c * LDC + i];
    norms[c] = sqrt(n2);
  }
  __syncthreads();
  for (int c = tid; c < r; c += T) {
    const int rank = rank_of(norms, 1, r, c, true);
    const double nc = norms[c];
    s_out[mat * r + rank] = static_cast<float>(nc);
    // a zero column has no direction: its U column is zero (it multiplies
    // a zero singular value)
    const double inv = nc > 0.0 ? 1.0 / nc : 0.0;
    for (int i = 0; i < r; ++i) {
      u[base + i * r + rank] = static_cast<float>(C[c * LDC + i] * inv);
      vh[base + rank * r + i] = static_cast<float>(C[c * LDC + M + i]);
    }
  }
  if (tid == 0) sweeps[mat] = sweep;
}

// a launch above the default 48 KB of dynamic shared memory must opt in
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int M, bool kVectors>
cudaError_t launch_eigh(const float* a, float* w, float* v, int* sweeps,
                        int batch, int r, cudaStream_t stream) {
  constexpr int T = eigh_threads(M);
  constexpr size_t smem = sizeof(double) * eigh_doubles(M, kVectors);
  const cudaError_t err = allow_smem(eigh_kernel<M, T, kVectors>, smem);
  if (err != cudaSuccess) return err;
  eigh_kernel<M, T, kVectors><<<batch, T, smem, stream>>>(a, w, v, sweeps, r);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_svd(const float* a, float* u, float* s, float* vh,
                       int* sweeps, int batch, int r, cudaStream_t stream) {
  constexpr int T = svd_threads(M);
  constexpr size_t smem = sizeof(double) * svd_doubles(M);
  const cudaError_t err = allow_smem(svd_kernel<M, T>, smem);
  if (err != cudaSuccess) return err;
  svd_kernel<M, T><<<batch, T, smem, stream>>>(a, u, s, vh, sweeps, r);
  return cudaGetLastError();
}

// The arguments of one call; `vectors` only for eigh.
struct Call {
  const float* a;
  float *out0, *out1, *out2;  // eigh: w, v; svd: u, s, vh
  int* sweeps;
  int batch, r;
  bool svd, vectors;
  cudaStream_t stream;
};

// the instance of even side M among Lo .. Hi (found by counting down)
template <int Lo, int Hi>
cudaError_t launch_side(int M, const Call& c) {
  if constexpr (Lo <= Hi) {
    if (M != Hi) return launch_side<Lo, Hi - 2>(M, c);
    if (c.svd)
      return launch_svd<Hi>(c.a, c.out0, c.out1, c.out2, c.sweeps, c.batch,
                            c.r, c.stream);
    return c.vectors ? launch_eigh<Hi, true>(c.a, c.out0, c.out1, c.sweeps,
                                             c.batch, c.r, c.stream)
                     : launch_eigh<Hi, false>(c.a, c.out0, c.out1, c.sweeps,
                                              c.batch, c.r, c.stream);
  }
  return cudaErrorInvalidValue;
}

constexpr int kParts = 4;
// the even sides of part p: kPartFirst[p] .. kPartFirst[p + 1] - 2
constexpr int kPartFirst[kParts + 1] = {2, 18, 34, 50, kMaxR + 2};

template <int P>
cudaError_t launch_part(int M, const Call& c) {
  return launch_side<kPartFirst[P], kPartFirst[P + 1] - 2>(M, c);
}

// each part is instantiated by its own source, jacobi_<p>.cu
extern template cudaError_t launch_part<0>(int, const Call&);
extern template cudaError_t launch_part<1>(int, const Call&);
extern template cudaError_t launch_part<2>(int, const Call&);
extern template cudaError_t launch_part<3>(int, const Call&);

}  // namespace repro::jacobi
