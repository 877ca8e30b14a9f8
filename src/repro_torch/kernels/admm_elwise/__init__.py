"""Fused SCDL ADMM elementwise tail: CUDA kernel, plain version,
wrapper."""
