// Part 2 of the PSF convolution kernel's instances: the grids
// kGrids[kPartFirst[2]] .. kGrids[kPartFirst[3] - 1] (see psf_conv.cuh).
#include "psf_conv.cuh"

template cudaError_t repro::psfconv::launch_part<2>(
    int, const repro::psfconv::Args&, long long, cudaStream_t);
