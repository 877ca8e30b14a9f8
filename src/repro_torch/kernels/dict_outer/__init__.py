"""Fused SCDL outer products: CUDA kernel, plain versions, wrappers."""
