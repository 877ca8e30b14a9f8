"""Small-matrix Jacobi eigensolver and SVD: CUDA kernels, plain
versions, wrappers."""
