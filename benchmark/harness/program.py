"""The program's builds, made as a step of their own at the start of
set-up, so that a run reports them apart: every hand-written CUDA kernel
under ``ideepcolor_tpu_torch/ops/cuda`` (one ``nvcc`` each) and the native
host library (``g++``), into ``build/`` inside the checkout, where the
program puts them. In a checkout that has them already, this only loads
them."""

from __future__ import annotations

import importlib
import pkgutil


def build() -> bool:
    """Builds (where missing) and loads the program's kernels and host
    library. Returns whether anything was compiled."""
    import ideepcolor_tpu_torch.ops.cuda as cuda_ops
    from ideepcolor_tpu_torch.ops import host
    from ideepcolor_tpu_torch.ops.cuda import build as kernels

    # each kernel module registers its entries when it is imported
    for m in pkgutil.iter_modules(cuda_ops.__path__):
        importlib.import_module(f"{cuda_ops.__name__}.{m.name}")
    dirs = (kernels.BUILD_DIR, host.BUILD_DIR)

    def built() -> set:
        return {p for d in dirs if d.exists() for p in d.glob("*.so")}

    before = built()
    kernels.build_all(kernels.KERNELS)
    host.get_lib()
    return built() != before
