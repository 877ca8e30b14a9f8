// Part 2 of the Jacobi kernels: the even sides kPartFirst[2] ..
// kPartFirst[3] - 2 (see jacobi.cuh).
#include "jacobi.cuh"

template cudaError_t repro::jacobi::launch_part<2>(
    int, const repro::jacobi::Call&);
