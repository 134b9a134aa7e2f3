"""ColorizeImageBase-compatible API of the port."""

from .colorize import (ColorizeImageBase, ColorizeImageCaffe,
                       ColorizeImageCaffeDist, ColorizeImageCaffeGlobDist,
                       ColorizeImageTorch, ColorizeImageTorchCaffe,
                       ColorizeImageTorchCaffeDist,
                       ColorizeImageTorchCaffeGlobDist,
                       ColorizeImageTorchDist)

__all__ = ["ColorizeImageBase", "ColorizeImageTorch",
           "ColorizeImageTorchDist", "ColorizeImageTorchCaffe",
           "ColorizeImageTorchCaffeDist", "ColorizeImageTorchCaffeGlobDist",
           "ColorizeImageCaffe", "ColorizeImageCaffeDist",
           "ColorizeImageCaffeGlobDist"]
