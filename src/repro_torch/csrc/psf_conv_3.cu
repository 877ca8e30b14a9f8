// Part 3 of the PSF convolution kernel's instances: the grids
// kGrids[kPartFirst[3]] .. kGrids[kPartFirst[4] - 1] (see psf_conv.cuh).
#include "psf_conv.cuh"

template cudaError_t repro::psfconv::launch_part<3>(
    int, const repro::psfconv::Args&, long long, cudaStream_t);
