// Jacobi eigensolver and SVD of small fp32 matrices, for sm_90a.
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
// The function.  A sweep is M - 1 steps of the round-robin (circle)
// ordering, M = r rounded up to even (odd r adds a zero row and column
// that never rotates); each step applies M / 2 disjoint rotations at once.
// A pair is rotated only while |a_pq| > eps sqrt(|a_pp|) sqrt(|a_qq|)
// (eigh; for the SVD the same test on the 2 x 2 Gram of the column pair),
// eps = FLT_EPSILON, tested squared, so the factorization stops, on the
// device, after the first sweep that rotates nothing, or after kMaxSweeps.
// The SVD also leaves alone a pair with a column of norm at most
// eps ||R||_F: such a column is numerically zero (its singular value is as
// accurate as an fp32 SVD's), and without that test an exactly
// rank-deficient R, which the low-rank paths give it once their iterate's
// rank falls below r, never converges: its null columns shrink by orders
// of magnitude a sweep and stay far from orthogonal to each other in
// relative terms.  The rotations are computed and accumulated in fp64,
// from the fp32 input to the fp32 outputs: each entry takes 7-17 sweeps x
// (r - 1) rotations, whose rounding in fp32 left the factors several times
// further from their exact values than LAPACK's fp32 ones, and the
// low-rank range finder, which scales each Gram direction by lambda^-1/2,
// magnifies that; in fp64 the outputs carry the final rounding alone.  The
// relative stopping test gives small eigenvalues of a positive
// semidefinite Gram to high relative accuracy, which matters where the
// low-rank solver clips its Gram at 1e-6 lambda_max.  Each matrix's sweeps
// go to a device int, read only by checks.
//
// What bounds it on the card: neither bytes nor operations but the chain
// of dependent steps.  At r = 24 one matrix is 2.3 KB and a sweep about
// 9 r^3 = 0.12 MFLOP, nanoseconds at the card's rates, while 7-10 sweeps x
// 23 steps follow one another, each waiting for the last.  A step's time
// is its latency: read the pivots, compute the rotations, apply them, and
// make the result visible to the threads that read it next.  The design:
//
// - One block per matrix (a batch is one launch of one block each), its
//   team sized to the side: eigh one thread per 2 x 2 block of the upper
//   triangle up to nine warps (96 threads at r = 24, 288 at r = 64), the
//   SVD 16 lanes per pair.  The matrix and the accumulated rotations stay
//   in shared memory in fp64 (eigh 3 M (M + 1) doubles, 100 KB at r = 64,
//   opted in above 48 KB).
// - One barrier per step.  eigh: every warp computes all M / 2 rotations
//   (lane k, pair k) from the plane of A that it reads, each thread sets
//   its 2 x 2 blocks J_k^T A_kl J_l of the other plane (ping-pong) and its
//   rows of V <- V J, taking each rotation from its own warp (__shfl_sync);
//   every warp also learns whether the step rotated anything
//   (__any_sync), so a step that rotates nothing writes nothing and skips
//   its barrier: the last sweep, which only confirms convergence, costs its
//   pivot reads and stopping tests.  The SVD: each lane loads its rows of
//   the pair's two columns once, sums its share of their 2 x 2 Gram, a
//   butterfly over the pair's lanes completes it, and the step's barrier
//   also says whether any pair rotated (__syncthreads_or).
// - The rotation has no division and no IEEE square root, whose fp64
//   forms are software sequences: two fp32 rsqrtf seeds, each refined by
//   one fp64 step (rotation() in jacobi.cuh).
// - One warp per matrix, with several matrices a block and no block
//   barrier, was built and measured first for r <= 32 (the matrix in
//   shared memory: the round-robin pairs and each lane's pivots move every
//   step, so registers would need all M - 1 steps unrolled or whole
//   columns shuffled each step).  On one matrix, the paths' case, it was
//   slower: a lone warp issues in order and waits out every latency of the
//   step, where a block spreads the step's blocks and rows over several
//   warps for one barrier (PERF.md).
//
// Measured on the card (PERF.md): a step takes 0.5-0.75 us up to r = 40
// and 1.05-1.3 us at r = 64, where its shared-memory traffic, which grows
// as r^2 (A's blocks read and written, V's rows), is the larger part;
// without vectors an eigh step is about 30 % shorter.
//
// The instances, one per even side (jacobi.cuh), are spread over
// jacobi_<p>.cu, one nvcc process each.
//
// Determinism: no atomics, fixed reduction orders (butterfly shuffles), so
// two calls on the same input give the same bits, and a matrix gives the
// same bits alone and in a batch.  A NaN input fails the rotation test
// and so stops the sweeps; it propagates to the output.
#include "jacobi.cuh"

namespace {

using repro::jacobi::Call;
using repro::jacobi::kMaxR;
using repro::jacobi::kPartFirst;
using repro::jacobi::launch_part;

int launch(const Call& c) {
  if (c.r < 1 || c.r > kMaxR || c.batch < 0) return cudaErrorInvalidValue;
  if (c.batch == 0) return cudaSuccess;
  const int m = c.r + (c.r & 1);
  if (m < kPartFirst[1]) return launch_part<0>(m, c);
  if (m < kPartFirst[2]) return launch_part<1>(m, c);
  if (m < kPartFirst[3]) return launch_part<2>(m, c);
  return launch_part<3>(m, c);
}

}  // namespace

extern "C" int repro_jacobi_eigh(const void* a, void* w, void* v,
                                 void* sweeps, int batch, int r,
                                 int compute_v, void* stream) {
  return launch(Call{static_cast<const float*>(a), static_cast<float*>(w),
                     static_cast<float*>(v), nullptr,
                     static_cast<int*>(sweeps), batch, r, false,
                     compute_v != 0, static_cast<cudaStream_t>(stream)});
}

extern "C" int repro_jacobi_svd(const void* a, void* u, void* s, void* vh,
                                void* sweeps, int batch, int r,
                                void* stream) {
  return launch(Call{static_cast<const float*>(a), static_cast<float*>(u),
                     static_cast<float*>(s), static_cast<float*>(vh),
                     static_cast<int*>(sweeps), batch, r, true, false,
                     static_cast<cudaStream_t>(stream)});
}
