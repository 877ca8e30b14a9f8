"""Batched starlet smoothing: CUDA kernel, plain version, wrappers."""
