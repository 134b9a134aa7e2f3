"""Tensor ops of the port: colorspace, hints, resize, the CUDA kernels, and
the native host runtime (``host``)."""
