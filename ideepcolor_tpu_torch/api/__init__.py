"""ColorizeImageBase-compatible API of the port."""

from .colorize import (ColorizeImageBase, ColorizeImageTorch,
                       ColorizeImageTorchDist)

__all__ = ["ColorizeImageBase", "ColorizeImageTorch",
           "ColorizeImageTorchDist"]
