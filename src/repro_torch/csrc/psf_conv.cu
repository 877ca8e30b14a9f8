// The 'same' convolution of stamps with a carried PSF spectrum, or its
// adjoint, in one launch, for sm_90a:
//
//   out = irfft2(rfft2(x [- minus], s=(G, G)) * kf, s=(G, G))[:S, :S]
//
// with kf one stamp's (G, G / 2 + 1) complex64 half spectrum (conjugated
// on the fly for the adjoint), fp32 throughout.
//
// Replaces: no TPU kernel.  The JAX package leaves the FFT to XLA
// (src/repro/imaging/psf.py, jnp.fft); the port ran cuFFT with PyTorch
// around it: rfft2 of the zero-padded (G, G) grid, the complex product,
// irfft2, the crop's copy, torch.stack for the pair and a separate pass
// for HX - Y, about seven launches a convolution with the padded grid,
// the full spectrum and the uncropped inverse each going through device
// memory.
//
// Bound on the card: bytes.  At the survey's shapes (n = 10 000 stamps of
// 41 x 41, G = 81) a convolution must read the operand (67.2 MB) and the
// spectrum slab (81 x 41 complex64 a stamp, 265.7 MB) and write the crop
// (67.2 MB): 400 MB, 0.119 ms at 3.35 TB/s; 467 MB (0.139 ms) when HX - Y
// is formed on load; the pair of two operands 800 MB (0.239 ms) counting
// both slabs.  The arithmetic, about 0.4 MFLOP a stamp, is under 0.1 ms
// at the card's fp32 rate.
//
// Design: one block per stamp (per stamp and operand for the pair; the two
// blocks of a stamp are neighbours, so the second read of its spectrum
// hits L2), the whole 2-D transform in shared memory.  Only the operand,
// the spectrum and the cropped output touch device memory; the zero
// padding is never written anywhere.
//   - Rows, forward: stamp rows 2j and 2j + 1 are packed as the real and
//     imaginary parts of one complex row, so S real rows take (S + 1) / 2
//     complex transforms; only the S non-zero rows are transformed.
//   - Columns: the G / 2 + 1 half-spectrum columns, each row's spectrum
//     split off its pair's packed one on the way in; the product with the
//     spectrum sits between the forward transform's second half and the
//     inverse's first half in registers (those cover the same
//     frequencies), so the spectrum plane is read and written once less;
//     the inverse keeps output rows 0 .. S - 1 only.
//   - Rows, inverse: two rows' half spectra packed into one full complex
//     row by conjugate symmetry; only output columns 0 .. S - 1 are
//     stored, scaled by 1 / G^2.
//   - Each transform of length G = P M (81 = 9 x 9) is two register DFTs
//     (lengths M and P, built from radix 2, 3, 4 and 5 butterflies with
//     compile-time twiddles) around one exchange through shared memory
//     and a twiddle from a per-block table.  Shared memory holds the
//     twiddles, the (G, G / 2 + 1) spectrum plane and the row pairs'
//     buffers: 42 168 bytes at S = 41, G = 81 (five blocks an SM).
//   - The plane is laid out with the spectrum column fastest and the
//     threads of a pass run along it, so its reads and writes, and the
//     spectrum's loads from device memory, are contiguous across a warp.
//   - The power iteration's step (psf.spectral_norm) runs as the pair with
//     its two extra parts inside the launch: the operands divided by the
//     last norm as they are read (x / nrm first, then the transform, as
//     before), and each block's sum of its output's squares, summed in a
//     fixed order, for the next norm; the separate passes over the
//     operands and outputs go.
// Each stamp's arithmetic is fixed by its own data and the grid, so a
// stamp gives the same bits whichever stamps share its launch.  One
// instance per grid: every 5-smooth G up to 128 (psf.pad_for of stamps and
// PSFs up to 64 wide), each with its own P and M; any other grid is
// refused.
#include <climits>

#include "psf_conv.cuh"

using repro::psfconv::Args;
using repro::psfconv::kGridCount;
using repro::psfconv::kGrids;
using repro::psfconv::kPartFirst;
using repro::psfconv::launch_part;

// ops operands (1, or 2 for the pair) of n stamps of S x S fp32: x0/x1,
// outputs out0/out1; minus (ops == 1 only) is subtracted from x0 on load;
// spec0/spec1 (complex64, (G, G / 2 + 1) a stamp, spec_stride complex
// entries from one stamp to the next, 0 for one spectrum for all), each
// conjugated when conj0/conj1 is set; scale (a device float, or null)
// divides the operands as they are read, and sumsq (ops * n floats, or
// null) receives each output's sum of squares.
extern "C" int repro_psf_conv(const void* x0, const void* x1,
                              const void* minus, const void* spec0,
                              const void* spec1, long long spec_stride,
                              int conj0, int conj1, void* out0, void* out1,
                              const void* scale, void* sumsq, long long n,
                              int stamp, int grid, int ops, void* stream) {
  if (n == 0) return cudaSuccess;
  if (ops < 1 || ops > 2 || (ops == 2 && minus) || n < 0 ||
      n * ops > INT_MAX || stamp < 1 || stamp > grid)
    return cudaErrorInvalidValue;
  int index = 0;
  while (index < kGridCount && kGrids[index] != grid) ++index;
  if (index == kGridCount) return cudaErrorInvalidValue;
  Args a{};
  a.x[0] = static_cast<const float*>(x0);
  a.x[1] = static_cast<const float*>(x1);
  a.minus = static_cast<const float*>(minus);
  a.spec[0] = static_cast<const float2*>(spec0);
  a.spec[1] = static_cast<const float2*>(spec1);
  a.spec_stride = spec_stride;
  a.out[0] = static_cast<float*>(out0);
  a.out[1] = static_cast<float*>(out1);
  a.scale = static_cast<const float*>(scale);
  a.sumsq = static_cast<float*>(sumsq);
  a.conj[0] = conj0;
  a.conj[1] = conj1;
  a.stamp = stamp;
  a.ops = ops;
  const long long blocks = n * ops;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (index < kPartFirst[1]) return launch_part<0>(grid, a, blocks, s);
  if (index < kPartFirst[2]) return launch_part<1>(grid, a, blocks, s);
  if (index < kPartFirst[3]) return launch_part<2>(grid, a, blocks, s);
  return launch_part<3>(grid, a, blocks, s);
}
