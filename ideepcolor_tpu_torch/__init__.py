"""PyTorch/CUDA port of ideepcolor_tpu, for one NVIDIA H100 (Hopper).

A package of its own beside the JAX package, which stays the reference it is
held against. It imports torch and numpy, never jax, and nothing of
``ideepcolor_tpu``. Module layout mirrors the JAX package:

  api/       ColorizeImageTorch (the ColorizeImageBase contract)
  engine/    the click and full-res programs
  models/    the SIGGRAPH U-Net as an nn.Module + weight conversion
  ops/       colorspace, hints, resize; ops/cuda holds the hand-written
             kernels (sources in csrc/), counterparts of ops/pallas

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
