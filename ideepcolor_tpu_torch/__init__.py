"""PyTorch/CUDA port of ideepcolor_tpu, for one NVIDIA H100 (Hopper).

A package of its own beside the JAX package, which stays the reference it is
held against. It imports torch and numpy, never jax, and nothing of
``ideepcolor_tpu``. Module layout mirrors the JAX package:

  api/       ColorizeImageTorch and ColorizeImageTorchDist (the
             ColorizeImageBase contract)
  data/      the ab bin tables; the host-facing gamut helpers (no Qt)
  engine/    the click, window, suggestion and full-res programs
             (pipeline), their form on the card as captured CUDA graphs
             (graphs), and the interactive, streaming and batch engines
  models/    the SIGGRAPH U-Net as an nn.Module, regression and
             distribution heads, f32, bf16 and TF32 modes, + weight
             conversion
  ops/       colorspace, hints, resize, quantize, kmeans, gamut; ops/cuda
             holds the hand-written kernels (sources in csrc/),
             counterparts of ops/pallas

Not ported yet: the ``abq`` and ``*_host`` click variants with the
packed-row click+suggest program (they wait for the native host ops), the
Caffe family, the sharded (``mesh=``), global-histogram and batched-suggest
forms of the batch engine, training and the apps.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
