"""The port's drop-in root: code written for the reference runs on the port.

The reference's code imports its modules by top-level names::

    from data import colorize_image as CI
    from data import lab_gamut
    import caffe

This directory holds those names (``data/colorize_image.py``,
``data/lab_gamut.py``, ``caffe.py``) over the port. Put it first on
``sys.path``, ahead of the repository root, whose own ``data/`` and
``caffe.py`` are the JAX package's drop-ins::

    import sys
    sys.path.insert(0, "ideepcolor_tpu_torch/compat")   # or PYTHONPATH

and run the reference's code as it is. Nothing here imports JAX or the JAX
package.

The device: reference code passes no ``device=``; it chooses its device with
``prep_net(gpu_id, ...)``, the first call after the constructor. The drop-in
classes build the port's model there, on

- the CPU for ``gpu_id=-1`` (the reference's Caffe contract, for every
  class);
- ``cuda:<gpu_id>`` for any other id, and the current card for ``None``.

So the card stays the default, and without a card any id but -1 raises.
``prep_net`` also sets the root's device, as the reference's Caffe classes
set Caffe's mode: the helpers that take no ``gpu_id`` (``lab_gamut``, the
two transposes and ``caffe.Net``) run there, as do
``caffe.set_mode_cpu`` / ``set_mode_gpu`` / ``set_device``. Before either,
it is the card.
"""

from __future__ import annotations

import torch

from ..device import resolve_device

_root = {"device": None}       # None: the current card, resolved at use


def device_for(gpu_id) -> torch.device:
    """The reference's ``gpu_id`` -> the port's device: -1 the CPU, None the
    current card, any other id ``cuda:<id>``. Raises without a card unless
    the id is -1."""
    if gpu_id is not None and int(gpu_id) == -1:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"gpu_id={gpu_id} asks for a CUDA device and none is available; "
            f"pass gpu_id=-1 to run on the CPU")
    return resolve_device(None if gpu_id is None else f"cuda:{int(gpu_id)}")


def set_root_device(device: torch.device) -> None:
    """Where the drop-in helpers without a ``gpu_id`` run from now on."""
    _root["device"] = device


def root_device() -> torch.device:
    """The device the last ``prep_net`` or ``caffe.set_mode_*`` chose; the
    current card before either (raising without one)."""
    dev = _root["device"]
    if dev is None and not torch.cuda.is_available():
        raise RuntimeError(
            "the drop-in root runs on the card until prep_net(-1, ...) or "
            "caffe.set_mode_cpu() chooses the CPU, and no CUDA device is "
            "available")
    return device_for(None) if dev is None else dev
