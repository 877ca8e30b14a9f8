// Part 0 of the Jacobi kernels: the even sides kPartFirst[0] ..
// kPartFirst[1] - 2 (see jacobi.cuh).
#include "jacobi.cuh"

template cudaError_t repro::jacobi::launch_part<0>(
    int, const repro::jacobi::Call&);
