// Part 3 of the Jacobi kernels: the even sides kPartFirst[3] ..
// kPartFirst[4] - 2 (see jacobi.cuh).
#include "jacobi.cuh"

template cudaError_t repro::jacobi::launch_part<3>(
    int, const repro::jacobi::Call&);
