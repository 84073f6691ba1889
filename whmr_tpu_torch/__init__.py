"""whmr_tpu_torch: the W-HMR system on PyTorch and CUDA for an NVIDIA H100.

The port of `whmr_tpu` (JAX/Pallas on a TPU), which stays beside it as the
reference. This package imports torch and numpy, never JAX and nothing of
whmr_tpu. Its TPU kernels become hand-written CUDA kernels under `csrc/`,
built at first use by `ops/cuda_build.py`. Entry point: `models.whmr.build_model`.
"""
