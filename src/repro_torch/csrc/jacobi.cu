// Jacobi eigensolver and SVD of small fp32 matrices, one block per matrix,
// for sm_90a.
//
// Replaces no TPU kernel: on the low-rank paths the JAX package leaves
// jnp.linalg.eigh (src/repro/imaging/lowrank.py:59), eigvalsh (:107) and
// svd (:66) to XLA, which runs them on the device.  PyTorch's
// torch.linalg.eigh / eigvalsh / svd check their result on the host, so on
// the card each call waits for the device; these kernels keep the
// factorizations of a low-rank iteration on the device, so a chunk of
// iterations holds one host sync.
//
//   repro_jacobi_eigh: A = V diag(w) V^T for symmetric A (r x r), r <= 64,
//     by cyclic two-sided Jacobi; w ascending, eigenvectors as columns
//     (the conventions of jnp.linalg.eigh).  The input is symmetrized,
//     (A + A^T) / 2, as jnp.linalg.eigh does.
//   repro_jacobi_svd: R = U diag(s) Vh for square R (r x r), r <= 64, by
//     one-sided (Hestenes) Jacobi on the columns; s descending.
//
// Both take a batch of matrices, one block each, the matrix and the
// accumulated rotations in shared memory (2 r (r + 1) doubles: 65 KB at
// r = 64, above the 48 KB a launch gets without opting in).  A sweep is m - 1 steps of the round-robin (circle) ordering,
// m = r rounded up to even; each step applies m / 2 disjoint rotations at
// once, one warp per rotation.  A pair is rotated only while
// |a_pq| > eps sqrt(|a_pp|) sqrt(|a_qq|) (eigh; for the SVD the same test
// on the 2 x 2 Gram of the column pair), eps = FLT_EPSILON, so the
// factorization stops, on the device, after the first sweep that rotates
// nothing, or after kMaxSweeps.  The SVD also leaves alone a pair with a
// column of norm at most eps ||R||_F: such a column is numerically zero
// (its singular value is as accurate as an fp32 SVD's), and without that
// test an exactly rank-deficient R, which the low-rank paths give it once
// their iterate's rank falls below r, never converges: its null columns
// shrink by orders of magnitude a sweep and stay far from orthogonal to
// each other in relative terms.  The rotations are computed and
// accumulated in fp64, from the fp32 input to the fp32 outputs: each entry
// takes 7-17 sweeps x (r - 1) rotations, whose rounding in fp32 left the
// factors several times further from their exact values than LAPACK's
// fp32 ones, and the low-rank range finder, which scales each Gram
// direction by lambda^-1/2, magnifies that; in fp64 the outputs carry the
// final rounding alone.  The stopping test stays at FLT_EPSILON, the
// outputs' precision.  That relative test gives small
// eigenvalues of a positive semidefinite Gram to high relative accuracy,
// which matters where the low-rank solver clips its Gram at
// 1e-6 lambda_max.  Each block writes its number of sweeps to a device int,
// read only by checks.
//
// Bound on the card: neither bytes nor operations but the chain of
// dependent steps.  At r = 24 one matrix is 2.3 KB and a sweep about 9 r^3
// = 0.12 MFLOP, nanoseconds at the card's rates, while the 7-10 sweeps x
// 23 steps each end in block barriers (two a step for eigh, one for the
// SVD) after a chain of fp64 divisions and square roots.  A simple, correct kernel comes first; its speed is later work.
//
// Determinism: no atomics, fixed reduction orders (butterfly shuffles), so
// two calls on the same input give the same bits.  A NaN input fails the
// rotation test and so stops the sweeps; it propagates to the output.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kMaxR = 64;
constexpr int kMaxSweeps = 30;
constexpr double kEps = FLT_EPSILON;

// The pair (p < q) that warp k rotates at step `step` of a sweep: the
// circle method over m players keeps player m - 1 fixed and turns the
// others, so the m / 2 pairs of a step are disjoint and every pair meets
// once in m - 1 steps.  q >= r (the odd r's extra player) means no pair.
__device__ __forceinline__ void pair_of(int step, int k, int m, int& p,
                                        int& q) {
  int a, b;
  if (k == 0) {
    a = m - 1;
    b = step;
  } else {
    a = (step + k) % (m - 1);
    b = (step - k + m - 1) % (m - 1);
  }
  p = min(a, b);
  q = max(a, b);
}

// tan of the rotation that zeroes z in [[x, z], [z, y]], or 0 when the
// pair meets the stopping test |z| <= eps sqrt(|x| |y|), tested squared.
// Golub and Van Loan's sym.schur2, t = sign(theta) / (|theta| +
// sqrt(1 + theta^2)) with theta = (y - x) / (2 z), multiplied through by
// |2 z|: one square root and one division, the costly fp64 operations of a
// step.  Squares of values that came from fp32 stay far inside fp64's range.
__device__ __forceinline__ double rotation_tan(double x, double y,
                                               double z) {
  if (!(z * z > kEps * kEps * fabs(x) * fabs(y))) return 0.0;
  const double d = y - x;
  return copysign(1.0, d) * (2.0 * z) /
         (fabs(d) + sqrt(d * d + 4.0 * z * z));
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

// rotate the columns p, q of M (rows 0 .. r - 1, leading dimension ld)
__device__ __forceinline__ void rotate_cols(double* M, int ld, int r, int p,
                                            int q, double c, double s,
                                            int lane) {
  for (int i = lane; i < r; i += 32) {
    const double mp = M[i * ld + p], mq = M[i * ld + q];
    M[i * ld + p] = c * mp - s * mq;
    M[i * ld + q] = s * mp + c * mq;
  }
}

template <bool kVectors>
__global__ void __launch_bounds__(1024)
jacobi_eigh_kernel(const float* __restrict__ a, float* __restrict__ w,
                   float* __restrict__ v, int* __restrict__ sweeps, int r) {
  extern __shared__ double smem[];
  __shared__ int rotated;
  const int m = r + (r & 1), ld = m + 1;  // odd ld: no bank conflicts
  double* A = smem;
  double* V = smem + r * ld;
  const long long base = static_cast<long long>(blockIdx.x) * r * r;
  for (int e = threadIdx.x; e < r * r; e += blockDim.x) {
    const int i = e / r, j = e - i * r;
    A[i * ld + j] = 0.5 * (static_cast<double>(a[base + i * r + j]) +
                           a[base + j * r + i]);
    if (kVectors) V[i * ld + j] = i == j ? 1.0 : 0.0;
  }
  const int k = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int sweep = 0;
  bool more = true;
  while (more && sweep < kMaxSweeps) {
    __syncthreads();  // the loads, or every thread's read of `rotated`
    if (threadIdx.x == 0) rotated = 0;
    __syncthreads();
    for (int step = 0; step < m - 1; ++step) {
      int p, q;
      pair_of(step, k, m, p, q);
      double t = 0.0, app = 0.0, aqq = 0.0, apq = 0.0;
      if (q < r) {
        app = A[p * ld + p];
        aqq = A[q * ld + q];
        apq = A[p * ld + q];
        t = rotation_tan(app, aqq, apq);
      }
      const double c = rsqrt(1.0 + t * t), s = t * c;
      __syncwarp();  // every lane has read the pivots before rows change
      // A <- J^T A: rows p and q (no other warp touches them this step)
      if (t != 0.0) {
        for (int j = lane; j < r; j += 32) {
          const double ap = A[p * ld + j], aq = A[q * ld + j];
          A[p * ld + j] = c * ap - s * aq;
          A[q * ld + j] = s * ap + c * aq;
        }
      }
      __syncthreads();
      // A <- A J: columns p and q; the 2 x 2 pivot block is set from the
      // rotation's own formulas (zero off the diagonal, a_pp - t a_pq and
      // a_qq + t a_pq on it)
      if (t != 0.0) {
        for (int i = lane; i < r; i += 32) {
          const double ap = A[i * ld + p], aq = A[i * ld + q];
          double np = c * ap - s * aq, nq = s * ap + c * aq;
          if (i == p) {
            np = app - t * apq;
            nq = 0.0;
          } else if (i == q) {
            np = 0.0;
            nq = aqq + t * apq;
          }
          A[i * ld + p] = np;
          A[i * ld + q] = nq;
        }
        if (kVectors) rotate_cols(V, ld, r, p, q, c, s, lane);
        if (lane == 0) rotated = 1;
      }
      __syncthreads();
    }
    ++sweep;
    more = rotated != 0;
  }
  for (int j = threadIdx.x; j < r; j += blockDim.x) {
    const int rank = rank_of(A, ld + 1, r, j, false);
    w[blockIdx.x * static_cast<long long>(r) + rank] =
        static_cast<float>(A[j * ld + j]);
    if (kVectors)
      for (int i = 0; i < r; ++i)
        v[base + i * r + rank] = static_cast<float>(V[i * ld + j]);
  }
  if (threadIdx.x == 0) sweeps[blockIdx.x] = sweep;
}

__global__ void __launch_bounds__(1024)
jacobi_svd_kernel(const float* __restrict__ a, float* __restrict__ u,
                  float* __restrict__ s_out, float* __restrict__ vh,
                  int* __restrict__ sweeps, int r) {
  extern __shared__ double smem[];
  __shared__ int rotated;
  __shared__ double norms[kMaxR];
  __shared__ double negligible;  // (eps ||R||_F)^2
  const int m = r + (r & 1), ld = m + 1;
  double* G = smem;           // the columns being orthogonalized: G = R W
  double* W = smem + r * ld;  // the accumulated rotations
  const long long base = static_cast<long long>(blockIdx.x) * r * r;
  for (int e = threadIdx.x; e < r * r; e += blockDim.x) {
    const int i = e / r, j = e - i * r;
    G[i * ld + j] = a[base + e];
    W[i * ld + j] = i == j ? 1.0 : 0.0;
  }
  if (threadIdx.x < 32) {  // ||R||_F^2 by the first warp, in a fixed order
    double ss = 0.0;
    for (int e = threadIdx.x; e < r * r; e += 32) {
      const double x = a[base + e];
      ss += x * x;
    }
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (threadIdx.x == 0) negligible = kEps * kEps * ss;
  }
  const int k = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int sweep = 0;
  bool more = true;
  while (more && sweep < kMaxSweeps) {
    __syncthreads();
    if (threadIdx.x == 0) rotated = 0;
    __syncthreads();
    for (int step = 0; step < m - 1; ++step) {
      int p, q;
      pair_of(step, k, m, p, q);
      if (q < r) {
        // the 2 x 2 Gram of columns p, q, reduced across the warp (every
        // lane ends with the same sums, in the same order)
        double alpha = 0.0, beta = 0.0, gamma = 0.0;
        for (int i = lane; i < r; i += 32) {
          const double gp = G[i * ld + p], gq = G[i * ld + q];
          alpha += gp * gp;
          beta += gq * gq;
          gamma += gp * gq;
        }
        for (int off = 16; off > 0; off >>= 1) {
          alpha += __shfl_xor_sync(0xffffffffu, alpha, off);
          beta += __shfl_xor_sync(0xffffffffu, beta, off);
          gamma += __shfl_xor_sync(0xffffffffu, gamma, off);
        }
        const double t = fmin(alpha, beta) > negligible
                             ? rotation_tan(alpha, beta, gamma)
                             : 0.0;
        if (t != 0.0) {
          const double c = rsqrt(1.0 + t * t), s = t * c;
          rotate_cols(G, ld, r, p, q, c, s, lane);
          rotate_cols(W, ld, r, p, q, c, s, lane);
          if (lane == 0) rotated = 1;
        }
      }
      __syncthreads();
    }
    ++sweep;
    more = rotated != 0;
  }
  for (int j = threadIdx.x; j < r; j += blockDim.x) {
    double ss = 0.0;
    for (int i = 0; i < r; ++i) ss += G[i * ld + j] * G[i * ld + j];
    norms[j] = sqrt(ss);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < r; j += blockDim.x) {
    const int rank = rank_of(norms, 1, r, j, true);
    const double nj = norms[j];
    s_out[blockIdx.x * static_cast<long long>(r) + rank] =
        static_cast<float>(nj);
    // a zero column has no direction: its U column is zero (it multiplies
    // a zero singular value)
    const double inv = nj > 0.0 ? 1.0 / nj : 0.0;
    for (int i = 0; i < r; ++i) {
      u[base + i * r + rank] = static_cast<float>(G[i * ld + j] * inv);
      vh[base + rank * r + i] = static_cast<float>(W[i * ld + j]);
    }
  }
  if (threadIdx.x == 0) sweeps[blockIdx.x] = sweep;
}

inline int threads_for(int r) { return 32 * ((r + (r & 1)) / 2); }
inline size_t smem_for(int r, int planes) {
  return sizeof(double) * planes * r * (r + (r & 1) + 1);
}

// a launch above the default 48 KB of dynamic shared memory must opt in
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" int repro_jacobi_eigh(const void* a, void* w, void* v,
                                 void* sweeps, int batch, int r,
                                 int compute_v, void* stream) {
  if (r < 1 || r > kMaxR || batch < 0) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_for(r, compute_v ? 2 : 1);
  cudaError_t err = compute_v ? allow_smem(jacobi_eigh_kernel<true>, smem)
                              : allow_smem(jacobi_eigh_kernel<false>, smem);
  if (err != cudaSuccess) return err;
  if (compute_v)
    jacobi_eigh_kernel<true><<<batch, threads_for(r), smem, st>>>(
        static_cast<const float*>(a), static_cast<float*>(w),
        static_cast<float*>(v), static_cast<int*>(sweeps), r);
  else
    jacobi_eigh_kernel<false><<<batch, threads_for(r), smem, st>>>(
        static_cast<const float*>(a), static_cast<float*>(w), nullptr,
        static_cast<int*>(sweeps), r);
  return cudaGetLastError();
}

extern "C" int repro_jacobi_svd(const void* a, void* u, void* s, void* vh,
                                void* sweeps, int batch, int r,
                                void* stream) {
  if (r < 1 || r > kMaxR || batch < 0) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  const size_t smem = smem_for(r, 2);
  const cudaError_t err = allow_smem(jacobi_svd_kernel, smem);
  if (err != cudaSuccess) return err;
  jacobi_svd_kernel<<<batch, threads_for(r), smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(u),
      static_cast<float*>(s), static_cast<float*>(vh),
      static_cast<int*>(sweeps), r);
  return cudaGetLastError();
}
