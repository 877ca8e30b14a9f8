// Part 1 of the register kernels of the fused starlet transforms: the
// square sides kPartFirst[1] .. kPartFirst[2] - 1 (see starlet2d.cuh).
#include "starlet2d.cuh"

template cudaError_t repro::starlet::regs_part<1>(bool, int, const void*,
                                                     void*, int, int, int,
                                                     cudaStream_t);
