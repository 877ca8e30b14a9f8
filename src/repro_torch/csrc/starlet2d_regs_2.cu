// Part 2 of the register kernels of the fused starlet transforms: the
// square sides kPartFirst[2] .. kPartFirst[3] - 1 (see starlet2d.cuh).
#include "starlet2d.cuh"

template cudaError_t repro::starlet::regs_part<2>(bool, int, const void*,
                                                     void*, int, int, int,
                                                     cudaStream_t);
