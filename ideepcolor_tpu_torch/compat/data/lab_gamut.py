"""The reference's ``data.lab_gamut`` on the port.

Counterpart of the repository root's ``data/lab_gamut.py``: the
reference's signatures over ``ideepcolor_tpu_torch/data/lab_gamut.py``,
run on the drop-in root's device (the one the last ``prep_net`` chose; the
card before any).
"""

from __future__ import annotations

from ideepcolor_tpu_torch.compat import root_device
from ideepcolor_tpu_torch.data import lab_gamut as _gamut


def rgb2lab_1d(in_rgb):
    return _gamut.rgb2lab_1d(in_rgb, root_device())


def lab2rgb_1d(in_lab, clip=True, dtype="uint8"):
    return _gamut.lab2rgb_1d(in_lab, clip, dtype, root_device())


def qcolor2lab_1d(qc):
    return _gamut.qcolor2lab_1d(qc, root_device())


def snap_ab(input_l, input_rgb, return_type="rgb"):
    return _gamut.snap_ab(input_l, input_rgb, return_type, root_device())


class abGrid(_gamut.abGrid):
    def __init__(self, gamut_size=110, D=1):
        super().__init__(gamut_size, D, root_device())
