"""Fused Condat primal/dual elementwise passes: CUDA kernels, plain
versions, wrappers."""
