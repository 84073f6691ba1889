"""Tensor ops: geometry, point sampling, and the wrappers of the CUDA kernels."""
