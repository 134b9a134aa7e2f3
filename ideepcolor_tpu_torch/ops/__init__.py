"""Tensor ops of the port: colorspace, hints, resize, and the CUDA kernels."""
