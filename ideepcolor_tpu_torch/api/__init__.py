"""ColorizeImageBase-compatible API of the port."""

from .colorize import ColorizeImageBase, ColorizeImageTorch

__all__ = ["ColorizeImageBase", "ColorizeImageTorch"]
