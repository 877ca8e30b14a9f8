// Part 0 of the PSF convolution kernel's instances: the grids
// kGrids[kPartFirst[0]] .. kGrids[kPartFirst[1] - 1] (see psf_conv.cuh).
#include "psf_conv.cuh"

template cudaError_t repro::psfconv::launch_part<0>(
    int, const repro::psfconv::Args&, long long, cudaStream_t);
