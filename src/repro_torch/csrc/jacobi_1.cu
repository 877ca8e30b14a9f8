// Part 1 of the Jacobi kernels: the even sides kPartFirst[1] ..
// kPartFirst[2] - 2 (see jacobi.cuh).
#include "jacobi.cuh"

template cudaError_t repro::jacobi::launch_part<1>(
    int, const repro::jacobi::Call&);
