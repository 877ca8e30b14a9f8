// The PSF convolution kernel's templates (the design is in the note at the
// top of psf_conv.cu): one instance per FFT grid G, a 5-smooth size up to
// kMaxGrid.  The instances are spread over the parts psf_conv_<p>.cu, one
// nvcc process each.
#pragma once

#include <utility>

#include "common.cuh"

namespace repro::psfconv {

// ------------------------------------------------------------------------
// Compile-time roots of unity: cos and sin of 2 pi e / n in double, from
// an exact integer reduction to an angle in [0, pi / 4] and a Taylor
// series there, rounded once to float (so each twiddle of a small DFT is
// an immediate operand, not a load).

__host__ __device__ constexpr double taylor_sin(double t) {
  double term = t, sum = t;
  for (int k = 1; k < 12; ++k) {
    term *= -t * t / ((2.0 * k) * (2.0 * k + 1.0));
    sum += term;
  }
  return sum;
}

__host__ __device__ constexpr double taylor_cos(double t) {
  double term = 1.0, sum = 1.0;
  for (int k = 1; k < 12; ++k) {
    term *= -t * t / ((2.0 * k - 1.0) * (2.0 * k));
    sum += term;
  }
  return sum;
}

struct CosSin {
  double c, s;
};

__host__ __device__ constexpr CosSin cos_sin(long long e, long long n) {
  // the angle in eighths of a turn: octant o, then the offset phi into it
  // measured from the nearer multiple of pi / 4 that is a multiple of
  // pi / 2 (so phi lies in [0, pi / 4])
  const long long u = ((e % n) + n) % n * 8;
  const int o = static_cast<int>(u / n);
  const long long rem = u - o * n;
  const double phi = static_cast<double>(o & 1 ? n - rem : rem) /
                     static_cast<double>(n) *
                     0.78539816339744830961566084581988;
  const double c = taylor_cos(phi), s = taylor_sin(phi);
  switch (o) {
    case 0: return {c, s};
    case 1: return {s, c};
    case 2: return {-s, c};
    case 3: return {-c, s};
    case 4: return {-c, -s};
    case 5: return {-s, -c};
    case 6: return {s, -c};
    default: return {c, -s};
  }
}

// exp(-2 pi i E / N), the forward transform's root, as floats
template <int N, int E>
struct Root {
  static constexpr float re = static_cast<float>(cos_sin(E, N).c);
  static constexpr float im = static_cast<float>(-cos_sin(E, N).s);
};

// ------------------------------------------------------------------------
// Unrolling with compile-time indices: f(std::integral_constant<int, i>)
// for i = 0 .. N - 1, so register arrays stay in registers and each
// twiddle's exponent is a template argument.

template <typename F, int... I>
__device__ __forceinline__ void static_for_impl(
    F&& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}

template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_impl(f, std::make_integer_sequence<int, N>{});
}

#define REPRO_CI(v) decltype(v)::value

// ------------------------------------------------------------------------
// Complex arithmetic on float2 (x real, y imaginary).

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// a times conj(b)
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}
// a times DIR i (DIR = -1: the forward direction, +1: the inverse)
template <int DIR>
__device__ __forceinline__ float2 mul_i(float2 a) {
  return DIR > 0 ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

// a times w^E, w = exp(DIR 2 pi i / N): the trivial roots by sign and
// swap, the others by two immediates
template <int N, int E, int DIR>
__device__ __forceinline__ float2 rot(float2 a) {
  constexpr int e = E % N;
  if constexpr (e == 0) {
    return a;
  } else if constexpr (2 * e == N) {
    return make_float2(-a.x, -a.y);
  } else if constexpr (4 * e == N) {
    return mul_i<DIR>(a);
  } else if constexpr (4 * e == 3 * N) {
    return mul_i<-DIR>(a);
  } else {
    constexpr float c = Root<N, e>::re;
    constexpr float s = DIR < 0 ? Root<N, e>::im : -Root<N, e>::im;
    return make_float2(a.x * c - a.y * s, a.x * s + a.y * c);
  }
}

// ------------------------------------------------------------------------
// Small DFTs in registers, natural order in and out:
// v[k] <- sum_n v[n] exp(DIR 2 pi i n k / N).  Radix 2, 3, 4 and 5 by
// hand; any other 5-smooth N as N = P M (Cooley-Tukey, decimation in
// time: P transforms of length M, twiddles, M transforms of length P).

__host__ __device__ constexpr int first_factor(int n) {
  return n % 4 == 0 ? 4 : n % 3 == 0 ? 3 : n % 5 == 0 ? 5
                                          : n % 2 == 0 ? 2 : n;
}

template <int N, int DIR>
struct Dft {
  static constexpr int P = first_factor(N);
  static constexpr int M = N / P;
  static_assert(P < N, "a DFT length with a prime factor above 5");

  __device__ __forceinline__ static void run(float2 (&v)[N]) {
    float2 t[N];
    // the outer index is read through its type (REPRO_CI) inside the
    // inner lambdas, so it stays a constant expression there
    static_for<P>([&](auto p_) {
      float2 a[M];
      static_for<M>([&](auto m_) {
        a[REPRO_CI(m_)] = v[P * REPRO_CI(m_) + REPRO_CI(p_)];
      });
      Dft<M, DIR>::run(a);
      static_for<M>([&](auto k_) {
        t[REPRO_CI(p_) * M + REPRO_CI(k_)] =
            rot<N, REPRO_CI(p_) * REPRO_CI(k_), DIR>(a[REPRO_CI(k_)]);
      });
    });
    static_for<M>([&](auto k_) {
      float2 b[P];
      static_for<P>([&](auto p_) {
        b[REPRO_CI(p_)] = t[REPRO_CI(p_) * M + REPRO_CI(k_)];
      });
      Dft<P, DIR>::run(b);
      static_for<P>([&](auto q_) {
        v[REPRO_CI(k_) + M * REPRO_CI(q_)] = b[REPRO_CI(q_)];
      });
    });
  }
};

template <int DIR>
struct Dft<1, DIR> {
  __device__ __forceinline__ static void run(float2 (&)[1]) {}
};

template <int DIR>
struct Dft<2, DIR> {
  __device__ __forceinline__ static void run(float2 (&v)[2]) {
    const float2 a = v[0], b = v[1];
    v[0] = cadd(a, b);
    v[1] = csub(a, b);
  }
};

template <int DIR>
struct Dft<3, DIR> {
  __device__ __forceinline__ static void run(float2 (&v)[3]) {
    constexpr float s = DIR * 0.86602540378443864676f;   // DIR sin(2 pi / 3)
    const float2 a = v[0], sum = cadd(v[1], v[2]), dif = csub(v[1], v[2]);
    const float2 t = make_float2(a.x - 0.5f * sum.x, a.y - 0.5f * sum.y);
    v[0] = cadd(a, sum);
    v[1] = make_float2(t.x - s * dif.y, t.y + s * dif.x);
    v[2] = make_float2(t.x + s * dif.y, t.y - s * dif.x);
  }
};

template <int DIR>
struct Dft<4, DIR> {
  __device__ __forceinline__ static void run(float2 (&v)[4]) {
    const float2 s02 = cadd(v[0], v[2]), d02 = csub(v[0], v[2]);
    const float2 s13 = cadd(v[1], v[3]);
    const float2 d13 = mul_i<DIR>(csub(v[1], v[3]));
    v[0] = cadd(s02, s13);
    v[1] = cadd(d02, d13);
    v[2] = csub(s02, s13);
    v[3] = csub(d02, d13);
  }
};

template <int DIR>
struct Dft<5, DIR> {
  __device__ __forceinline__ static void run(float2 (&v)[5]) {
    constexpr float c1 = 0.30901699437494742410f;    // cos(2 pi / 5)
    constexpr float c2 = -0.80901699437494742410f;   // cos(4 pi / 5)
    constexpr float s1 = DIR * 0.95105651629515357212f;   // DIR sin(2 pi / 5)
    constexpr float s2 = DIR * 0.58778525229247312917f;   // DIR sin(4 pi / 5)
    const float2 a = v[0];
    const float2 b1 = cadd(v[1], v[4]), d1 = csub(v[1], v[4]);
    const float2 b2 = cadd(v[2], v[3]), d2 = csub(v[2], v[3]);
    const float2 t1 = make_float2(a.x + c1 * b1.x + c2 * b2.x,
                                  a.y + c1 * b1.y + c2 * b2.y);
    const float2 t2 = make_float2(a.x + c2 * b1.x + c1 * b2.x,
                                  a.y + c2 * b1.y + c1 * b2.y);
    // u1 = s1 d1 + s2 d2 and u2 = s2 d1 - s1 d2, times i
    const float2 u1 = make_float2(s1 * d1.x + s2 * d2.x, s1 * d1.y + s2 * d2.y);
    const float2 u2 = make_float2(s2 * d1.x - s1 * d2.x, s2 * d1.y - s1 * d2.y);
    v[0] = make_float2(a.x + b1.x + b2.x, a.y + b1.y + b2.y);
    v[1] = make_float2(t1.x - u1.y, t1.y + u1.x);
    v[4] = make_float2(t1.x + u1.y, t1.y - u1.x);
    v[2] = make_float2(t2.x - u2.y, t2.y + u2.x);
    v[3] = make_float2(t2.x + u2.y, t2.y - u2.x);
  }
};

// ------------------------------------------------------------------------
// The block's plan for grid G: G = P M with P the largest divisor of G
// not above sqrt(G) (81 = 9 x 9, 64 = 8 x 8, 36 = 6 x 6, 45 = 5 x 9).
// A transform of length G over shared memory is then one register DFT of
// length M per thread over a stride-P comb, a twiddle, and one register
// DFT of length P per thread over a contiguous run.

constexpr int kMaxGrid = 128;
// a block's shared memory on sm_90 (227 KB)
constexpr int kMaxSmem = 232448;
constexpr int kMaxThreads = 256;

// the grids with an instance: every 5-smooth size up to kMaxGrid, the
// sizes psf.pad_for gives for stamps and PSFs up to 64 wide
constexpr int kGrids[] = {1,  2,  3,  4,  5,  6,   8,   9,   10,  12,
                          15, 16, 18, 20, 24, 25,  27,  30,  32,  36,
                          40, 45, 48, 50, 54, 60,  64,  72,  75,  80,
                          81, 90, 96, 100, 108, 120, 125, 128};
constexpr int kGridCount = sizeof(kGrids) / sizeof(kGrids[0]);

__host__ __device__ constexpr int block_factor(int g) {
  int best = 1;
  for (int d = 1; d * d <= g; ++d)
    if (g % d == 0) best = d;
  return best;
}

// the stride from one row pair's buffer to the next: at least `least`
// and equal to p modulo 16 float2 (so the stride-P combs of neighbouring
// pairs fall on other banks)
__host__ __device__ constexpr int pair_stride(int least, int p) {
  int l = least;
  while ((l - p) % 16 != 0) ++l;
  return l;
}

template <int G>
struct Plan {
  static constexpr int P = block_factor(G);
  static constexpr int M = G / P;
  static constexpr int H = G / 2 + 1;        // the half spectrum's columns
  static constexpr int Ps = P | 1;           // odd row stride of [M][P]
  static constexpr int L = pair_stride(M * Ps, P);
};

// shared memory of a block (float2): the G twiddles, the G x H spectrum
// plane, and one [M][Ps] buffer a pair of stamp rows
__host__ __device__ constexpr long long smem_bytes(int g, int stamp) {
  const int p = block_factor(g), m = g / p;
  const long long pairs = (stamp + 1) / 2;
  return 8LL * (g + static_cast<long long>(g) * (g / 2 + 1) +
                pairs * pair_stride(m * (p | 1), p));
}

// threads of a block: the largest pass (the spectrum plane's, H columns
// times max(P, M) tasks) in as few rounds of at most kMaxThreads as it
// takes, evened out and rounded up to whole warps
__host__ __device__ constexpr int block_threads(int g, int stamp) {
  const int p = block_factor(g), m = g / p, mx = p > m ? p : m;
  const int h = g / 2 + 1, pairs = (stamp + 1) / 2;
  const int tasks = (h > pairs ? h : pairs) * mx;
  const int rounds = (tasks + kMaxThreads - 1) / kMaxThreads;
  const int per = (tasks + rounds - 1) / rounds;
  return (per + 31) / 32 * 32;
}

// One launch: `ops` operands of n stamps each (1, or 2 for the pair);
// block b is stamp b / ops, operand b % ops (so a stamp's two operands run
// side by side and share its spectrum through L2).  `minus` (one operand
// only) is subtracted from x[0] on load.  Stamp i's spectrum for operand
// k starts at spec[k] + i * spec_stride complex entries (stride 0: one
// spectrum for every stamp); conj[k] conjugates it on the fly.  The power
// iteration's step: `scale` (a device scalar, or null) divides every
// operand entry as it is read, and `sumsq` (or null) receives each
// block's sum of its output's squares, summed in a fixed order, at
// sumsq[k * n + i] for operand k of stamp i.
struct Args {
  const float* x[2];
  const float* minus;
  const float2* spec[2];
  long long spec_stride;
  float* out[2];
  const float* scale;
  float* sumsq;
  int conj[2];
  int stamp;
  int ops;
};

template <int G>
__global__ void __launch_bounds__(kMaxThreads)
    psf_conv_kernel(const Args a) {
  using Pl = Plan<G>;
  constexpr int P = Pl::P, M = Pl::M, H = Pl::H, Ps = Pl::Ps, L = Pl::L;
  constexpr float kScale = 1.0f / static_cast<float>(G * G);
  extern __shared__ float2 smem[];
  float2* tw = smem;            // tw[e] = exp(-2 pi i e / G)
  float2* W = tw + G;           // the spectrum plane, row-major (G, H)
  float2* rb = W + G * H;       // the row pairs' buffers, L apart

  const int S = a.stamp;
  const int R = (S + 1) / 2;
  // the operand by selection, not by a runtime index into the parameter
  // arrays (which would copy them to local memory)
  const bool second = blockIdx.x % a.ops != 0;
  const long long stamp = blockIdx.x / a.ops;
  const long long base = stamp * S * S;
  const float* __restrict__ x = (second ? a.x[1] : a.x[0]) + base;
  const float* __restrict__ xm = a.minus ? a.minus + base : nullptr;
  float* __restrict__ out = (second ? a.out[1] : a.out[0]) + base;
  const float2* __restrict__ kf =
      (second ? a.spec[1] : a.spec[0]) + stamp * a.spec_stride;
  const float conj_sign = (second ? a.conj[1] : a.conj[0]) ? -1.0f : 1.0f;
  const float div = a.scale ? __ldg(a.scale) : 1.0f;

  for (int e = threadIdx.x; e < G; e += blockDim.x) {
    double s, c;
    sincospi(2.0 * e / G, &s, &c);
    tw[e] = make_float2(static_cast<float>(c), static_cast<float>(-s));
  }
  __syncthreads();

  // 1. rows, forward, first half: pair j packs rows 2j and 2j + 1 as the
  //    real and imaginary parts of one complex row (zero past the stamp:
  //    the padding is never stored); thread (j, p) transforms the comb
  //    c = P m + p and twiddles it into slot (k, p) of the pair's [M][Ps]
  //    buffer
  for (int t = threadIdx.x; t < R * P; t += blockDim.x) {
    const int j = t / P, p = t - j * P;
    const bool odd = 2 * j + 1 < S;
    const float* x0 = x + 2 * j * S;
    const float* m0 = xm ? xm + 2 * j * S : nullptr;
    float2 v[M];
    static_for<M>([&](auto m_) {
      constexpr int m = REPRO_CI(m_);
      const int c = P * m + p;
      float re = 0.0f, im = 0.0f;
      if (c < S) {
        re = __ldg(x0 + c);
        if (odd) im = __ldg(x0 + S + c);
        if (m0) {
          re -= __ldg(m0 + c);
          if (odd) im -= __ldg(m0 + S + c);
        }
        if (a.scale) {
          re /= div;
          im /= div;
        }
      }
      v[m] = make_float2(re, im);
    });
    Dft<M, -1>::run(v);
    float2* row = rb + j * L + p;
    static_for<M>([&](auto k_) {
      constexpr int k = REPRO_CI(k_);
      if constexpr (k == 0)
        row[0] = v[0];
      else
        row[k * Ps] = cmul(v[k], tw[p * k]);
    });
  }
  __syncthreads();

  // 2. rows, forward, second half: thread (j, k) transforms slot row k of
  //    pair j; frequency f = k + M q lands in slot (k, q)
  for (int t = threadIdx.x; t < R * M; t += blockDim.x) {
    const int j = t / M, k = t - j * M;
    float2* row = rb + j * L + k * Ps;
    float2 v[P];
    static_for<P>([&](auto p_) {
      constexpr int p = REPRO_CI(p_);
      v[p] = row[p];
    });
    Dft<P, -1>::run(v);
    static_for<P>([&](auto q_) {
      constexpr int q = REPRO_CI(q_);
      row[q] = v[q];
    });
  }
  __syncthreads();

  // 3. columns, forward, first half, with the rows' split: thread (p, kc)
  //    takes the comb of stamp rows r = P m + p at half-spectrum column kc,
  //    each row's spectrum split off its pair's packed one,
  //      A[k] = (Z[k] + conj Z[-k]) / 2,  B[k] = (Z[k] - conj Z[-k]) / 2i,
  //    and writes the twiddled transform to plane rows P k + p
  for (int t = threadIdx.x; t < H * P; t += blockDim.x) {
    const int p = t / H, kc = t - p * H;
    const int km = kc == 0 ? 0 : G - kc;
    const int sa = (kc % M) * Ps + kc / M, sb = (km % M) * Ps + km / M;
    float2 v[M];
    static_for<M>([&](auto m_) {
      constexpr int m = REPRO_CI(m_);
      const int r = P * m + p;
      float2 f = make_float2(0.0f, 0.0f);
      if (r < S) {
        const float2* row = rb + (r >> 1) * L;
        const float2 z = row[sa], zm = row[sb];
        f = (r & 1) ? make_float2(0.5f * (z.y + zm.y), 0.5f * (zm.x - z.x))
                    : make_float2(0.5f * (z.x + zm.x), 0.5f * (z.y - zm.y));
      }
      v[m] = f;
    });
    Dft<M, -1>::run(v);
    static_for<M>([&](auto k_) {
      constexpr int k = REPRO_CI(k_);
      if constexpr (k == 0)
        W[p * H + kc] = v[0];
      else
        W[(P * k + p) * H + kc] = cmul(v[k], tw[p * k]);
    });
  }
  __syncthreads();

  // 4. columns: the forward second half, the product with the spectrum and
  //    the inverse first half in registers.  Thread (k, kc) holds plane
  //    rows P k .. P k + P - 1 of column kc, whose transform gives
  //    frequencies f = k + M q, exactly the ones the inverse's first half
  //    of that slot row needs; the spectrum is read once, coalesced along
  //    kc
  for (int t = threadIdx.x; t < H * M; t += blockDim.x) {
    const int k = t / H, kc = t - k * H;
    float2 s[P];
    static_for<P>([&](auto q_) {
      constexpr int q = REPRO_CI(q_);
      const float2 w = __ldg(kf + (k + M * q) * H + kc);
      s[q] = make_float2(w.x, conj_sign * w.y);
    });
    float2* col = W + P * k * H + kc;
    float2 v[P];
    static_for<P>([&](auto p_) {
      constexpr int p = REPRO_CI(p_);
      v[p] = col[p * H];
    });
    Dft<P, -1>::run(v);
    static_for<P>([&](auto q_) {
      constexpr int q = REPRO_CI(q_);
      v[q] = cmul(v[q], s[q]);
    });
    Dft<P, 1>::run(v);
    static_for<P>([&](auto p_) {
      constexpr int p = REPRO_CI(p_);
      if constexpr (p == 0)
        col[0] = v[0];
      else
        col[p * H] = cmulc(v[p], tw[p * k]);
    });
  }
  __syncthreads();

  // 5. columns, inverse, second half: thread (p, kc) transforms the comb
  //    of plane rows P k + p and keeps stamp rows r = P m + p < S only
  for (int t = threadIdx.x; t < H * P; t += blockDim.x) {
    const int p = t / H, kc = t - p * H;
    float2 v[M];
    static_for<M>([&](auto k_) {
      constexpr int k = REPRO_CI(k_);
      v[k] = W[(P * k + p) * H + kc];
    });
    Dft<M, 1>::run(v);
    static_for<M>([&](auto m_) {
      constexpr int m = REPRO_CI(m_);
      const int r = P * m + p;
      if (r < S) W[r * H + kc] = v[m];
    });
  }
  __syncthreads();

  // 6. rows, inverse, first half: pair j's packed spectrum
  //    C[f] = A[f] + i B[f] over the full row, A and B extended from their
  //    half spectra by conjugate symmetry (the imaginary parts of the
  //    zero and, for even G, the Nyquist bins dropped, as a c2r transform
  //    does); thread (j, k) builds frequencies f = k + M q, transforms
  //    them and twiddles into slot row k
  for (int t = threadIdx.x; t < R * M; t += blockDim.x) {
    const int j = t / M, k = t - j * M;
    const bool odd = 2 * j + 1 < S;
    const float2* qa = W + 2 * j * H;
    const float2* qb = qa + H;
    float2 v[P];
    static_for<P>([&](auto q_) {
      constexpr int q = REPRO_CI(q_);
      const int f = k + M * q;
      const bool upper = 2 * f > G;
      const int fh = upper ? G - f : f;
      float2 A = qa[fh];
      float2 B = odd ? qb[fh] : make_float2(0.0f, 0.0f);
      if (upper) {
        A.y = -A.y;
        B.y = -B.y;
      }
      if (f == 0 || 2 * f == G) {
        A.y = 0.0f;
        B.y = 0.0f;
      }
      v[q] = make_float2(A.x - B.y, A.y + B.x);
    });
    Dft<P, 1>::run(v);
    float2* row = rb + j * L + k * Ps;
    static_for<P>([&](auto p_) {
      constexpr int p = REPRO_CI(p_);
      if constexpr (p == 0)
        row[0] = v[0];
      else
        row[p] = cmulc(v[p], tw[p * k]);
    });
  }
  __syncthreads();

  // 7. rows, inverse, second half: thread (j, p) transforms slot column p
  //    of pair j; sample c = P m + p of rows 2j (real part) and 2j + 1
  //    (imaginary part), scaled by 1 / G^2, for c < S only
  float sq = 0.0f;
  for (int t = threadIdx.x; t < R * P; t += blockDim.x) {
    const int j = t / P, p = t - j * P;
    const bool odd = 2 * j + 1 < S;
    const float2* row = rb + j * L + p;
    float2 v[M];
    static_for<M>([&](auto k_) {
      constexpr int k = REPRO_CI(k_);
      v[k] = row[k * Ps];
    });
    Dft<M, 1>::run(v);
    float* o0 = out + 2 * j * S;
    static_for<M>([&](auto m_) {
      constexpr int m = REPRO_CI(m_);
      const int c = P * m + p;
      if (c < S) {
        const float lo = v[m].x * kScale;
        o0[c] = lo;
        sq = fmaf(lo, lo, sq);
        if (odd) {
          const float hi = v[m].y * kScale;
          o0[S + c] = hi;
          sq = fmaf(hi, hi, sq);
        }
      }
    });
  }

  // the block's sum of squares: each thread's in its task order, then
  // the warps' by a fixed shuffle tree, then warp by warp
  if (a.sumsq) {
    __shared__ float warp_sq[kMaxThreads / 32];
    for (int off = 16; off > 0; off >>= 1)
      sq += __shfl_down_sync(0xffffffffu, sq, off);
    if ((threadIdx.x & 31) == 0) warp_sq[threadIdx.x >> 5] = sq;
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = 0.0f;
      for (int w = 0; w < static_cast<int>((blockDim.x + 31) >> 5); ++w)
        total += warp_sq[w];
      a.sumsq[(second ? gridDim.x / a.ops : 0) + stamp] = total;
    }
  }
}

template <int G>
cudaError_t launch_grid(const Args& a, long long blocks,
                        cudaStream_t stream) {
  const long long smem = smem_bytes(G, a.stamp);
  if (a.stamp < 1 || a.stamp > G || smem > kMaxSmem)
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        psf_conv_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  psf_conv_kernel<G><<<static_cast<unsigned>(blocks),
                       block_threads(G, a.stamp), smem, stream>>>(a);
  return cudaGetLastError();
}

template <int I, int End>
cudaError_t launch_from(int grid, const Args& a, long long blocks,
                        cudaStream_t stream) {
  if constexpr (I < End) {
    if (grid == kGrids[I]) return launch_grid<kGrids[I]>(a, blocks, stream);
    return launch_from<I + 1, End>(grid, a, blocks, stream);
  }
  return cudaErrorInvalidValue;
}

// the grids of part p: kGrids[kPartFirst[p]] .. kGrids[kPartFirst[p+1] - 1]
// (the larger grids' instances are the longer to compile, so the later
// parts hold fewer)
constexpr int kParts = 4;
constexpr int kPartFirst[kParts + 1] = {0, 18, 28, 34, kGridCount};

template <int Part>
cudaError_t launch_part(int grid, const Args& a, long long blocks,
                        cudaStream_t stream) {
  return launch_from<kPartFirst[Part], kPartFirst[Part + 1]>(grid, a, blocks,
                                                              stream);
}

// each part is instantiated by its own source, psf_conv_<p>.cu
extern template cudaError_t launch_part<0>(int, const Args&, long long,
                                           cudaStream_t);
extern template cudaError_t launch_part<1>(int, const Args&, long long,
                                           cudaStream_t);
extern template cudaError_t launch_part<2>(int, const Args&, long long,
                                           cudaStream_t);
extern template cudaError_t launch_part<3>(int, const Args&, long long,
                                           cudaStream_t);

}  // namespace repro::psfconv
