"""Framework configuration: one dataclass for every runtime knob.

Counterpart of ``ideepcolor_tpu/config.py``, with the same fields and
defaults: net variant, resolution, temperatures, serving precision.
:func:`make_backend` builds one of the five API classes of the port from it,
on the card unless the caller passes ``device="cpu"``.

``enable_persistent_compile_cache`` has no counterpart: nothing here is
compiled ahead of time. The kernels are built from source on first use
(``ops/cuda/build.py``) and a click's CUDA graph is captured from its first
run (``engine/graphs.py``); neither is kept across processes.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class ColorizeConfig:
    # model selection
    backend: str = "siggraph"          # 'siggraph' | 'caffe'
    variant: str = "main"              # caffe graph: 'main'|'dist'|'global'
    dist: bool = False                 # distribution head (siggraph)
    maskcent: bool = False             # subtract 0.5 from the hint mask
    checkpoint: str = ""               # .pth / .npz

    # resolution (the reference's Xd=256 and full-res cap 10000)
    Xd: int = 256
    Xfullres_max: int = 10000

    # distribution temperatures: scale_S of the suggestion softmax, scale_T
    # of the annealed-mean estimate. Suggestion-sampling K/N are per-call
    # arguments of get_ab_reccs, as in the reference.
    temp_suggest: float = 0.2
    temp_point: float = 2.6

    # execution
    serve_dtype: str = "float32"       # 'float32' | 'bfloat16'

    def validate(self) -> "ColorizeConfig":
        """Raise ValueError on a field out of range (the JAX class asserts;
        an assert is gone under ``python -O``)."""
        if self.backend not in ("siggraph", "caffe"):
            raise ValueError(f"backend must be 'siggraph' or 'caffe', got "
                             f"{self.backend!r}")
        if self.variant not in ("main", "dist", "global"):
            raise ValueError(f"variant must be 'main', 'dist' or 'global', "
                             f"got {self.variant!r}")
        if self.serve_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"serve_dtype must be 'float32' or 'bfloat16', "
                             f"got {self.serve_dtype!r}")
        if self.Xd % 8 != 0:
            raise ValueError(f"Xd must be divisible by 8 (3 subsamples), got "
                             f"{self.Xd}")
        return self


def make_backend(cfg: ColorizeConfig, device=None):
    """Instantiate the API backend described by a config, on ``device`` (the
    card unless ``"cpu"`` is asked for)."""
    from . import api
    cfg.validate()
    dtype = None if cfg.serve_dtype == "float32" else cfg.serve_dtype
    if cfg.backend == "siggraph":
        cls = (api.ColorizeImageTorchDist if cfg.dist
               else api.ColorizeImageTorch)
        m = cls(Xd=cfg.Xd, maskcent=cfg.maskcent, device=device)
        m.prep_net(path=cfg.checkpoint, dtype=dtype)
    else:
        cls = {"main": api.ColorizeImageTorchCaffe,
               "dist": api.ColorizeImageTorchCaffeDist,
               "global": api.ColorizeImageTorchCaffeGlobDist}[cfg.variant]
        m = cls(Xd=cfg.Xd, device=device)
        if cfg.variant == "dist":
            m.prep_net(None, caffemodel_path=cfg.checkpoint,
                       S=cfg.temp_suggest, dtype=dtype)
            m.net.scale_T.scale.fill_(cfg.temp_point)
        else:
            m.prep_net(None, caffemodel_path=cfg.checkpoint, dtype=dtype)
    m.Xfullres_max = cfg.Xfullres_max
    return m


def bundled_weights(name: str = "teacher") -> str:
    """Path of a committed demo checkpoint (``weights/<name>.npz`` at the
    repository root, see weights/README.md) or '' when absent. The server's
    entry point takes these as its defaults, so an unconfigured server
    colorizes instead of running random weights."""
    p = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "weights", f"{name}.npz")
    return p if os.path.exists(p) else ""
