"""The reference's ``data.colorize_image`` on the port.

Counterpart of the repository root's ``data/colorize_image.py``, which
re-exports the JAX package's classes: the same names, over
``ideepcolor_tpu_torch.api``. The classes with a ``prep_net`` take no
device in their constructor: ``prep_net(gpu_id, ...)`` builds the port's
model on the device the id names (-1 the CPU, ``None`` the current card,
any other id ``cuda:<id>``) and makes it the drop-in root's device. Until
then the instance holds only its constructor's arguments.
"""

from __future__ import annotations

from ideepcolor_tpu_torch import api
from ideepcolor_tpu_torch.api import colorize as _colorize
from ideepcolor_tpu_torch.api.colorize import ColorizeImageBase  # noqa: F401
from ideepcolor_tpu_torch.compat import (device_for, root_device,
                                         set_root_device)
from ideepcolor_tpu_torch.utils.session import (  # noqa: F401
    create_temp_directory)


class _DeviceAtPrepNet:
    """Defers the port's ``__init__`` to ``prep_net``, whose ``gpu_id``
    chooses the device. A later ``prep_net`` on another device builds the
    model anew there (the image must then be loaded again)."""

    def __init__(self, *args, **kwargs):
        self._ctor = (args, kwargs)
        self._ctor_device = None

    def prep_net(self, gpu_id=None, *args, **kwargs):
        dev = device_for(gpu_id)
        if dev != self._ctor_device:
            ctor_args, ctor_kwargs = self._ctor
            super().__init__(*ctor_args, device=dev, **ctor_kwargs)
            self._ctor_device = dev
        set_root_device(dev)
        return super().prep_net(gpu_id, *args, **kwargs)

    def __getattr__(self, name):
        # reached only for an attribute the instance lacks
        if self.__dict__.get("_ctor_device") is None:
            raise AttributeError(
                f"{type(self).__name__} has no {name!r} before prep_net: the "
                f"drop-in builds its model in prep_net(gpu_id, ...), where "
                f"the reference chooses its device")
        raise AttributeError(name)


class ColorizeImageTorch(_DeviceAtPrepNet, api.ColorizeImageTorch):
    pass


class ColorizeImageTorchDist(ColorizeImageTorch, api.ColorizeImageTorchDist):
    pass


class ColorizeImageCaffe(_DeviceAtPrepNet, api.ColorizeImageTorchCaffe):
    pass


class ColorizeImageCaffeDist(ColorizeImageCaffe,
                             api.ColorizeImageTorchCaffeDist):
    pass


class ColorizeImageCaffeGlobDist(ColorizeImageCaffe,
                                 api.ColorizeImageTorchCaffeGlobDist):
    pass


def rgb2lab_transpose(img_rgb):
    """(H,W,3) RGB -> (3,H,W) Lab, on the drop-in root's device."""
    return _colorize.rgb2lab_transpose(img_rgb, root_device())


def lab2rgb_transpose(img_l, img_ab):
    """(1,H,W) L + (2,H,W) ab -> (H,W,3) uint8, on the drop-in root's
    device."""
    return _colorize.lab2rgb_transpose(img_l, img_ab, root_device())
