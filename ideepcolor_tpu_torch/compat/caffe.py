"""The reference's ``caffe`` module on the port, as far as reference code
drives it.

Counterpart of the repository root's ``caffe.py``. The reference's
global-histogram notebook runs a weightless Caffe graph through the raw
blob interface: ``caffe.Net(global_stats.prototxt, ...)``, the image
written into ``img_bgr``, ``net.forward()``, the histogram read from
``gt_glob_ab_313_drop``. :class:`Net` emulates that graph, and only that
one, over ``ideepcolor_tpu_torch/models/global_stats.extract``, on the drop-in
root's device, which ``set_mode_cpu`` / ``set_mode_gpu`` / ``set_device``
choose as Caffe's own do (and the drop-in classes' ``prep_net``, as the
reference's Caffe classes set Caffe's mode). Colorization itself goes
through ``data.colorize_image``.

``io`` reads images with the port's codec (PNG natively; other formats
through OpenCV where it is installed) and resizes them with OpenCV's float
arithmetic written in numpy, so the card's machine needs no OpenCV.
"""

from __future__ import annotations

import numpy as np
import torch

from ideepcolor_tpu_torch.compat import (device_for, root_device,
                                         set_root_device)

TEST = 1
TRAIN = 0


def set_mode_cpu():
    set_root_device(torch.device("cpu"))


def set_mode_gpu():
    """The card ``set_device`` chose, else the current one."""
    dev = root_device()
    set_root_device(dev if dev.type == "cuda" else device_for(None))


def set_device(gpu_id):
    set_root_device(device_for(gpu_id))


class _Blob:
    def __init__(self, shape):
        self.data = np.zeros(shape, np.float32)


class Net:
    """Blob-interface emulation of the reference's global_stats graph
    (ref models/global_model/global_stats.prototxt)."""

    def __init__(self, prototxt_path, *args, **kwargs):
        if "global_stats" not in str(prototxt_path):
            raise NotImplementedError(
                "this module emulates only the global_stats graph; "
                "colorize with data.colorize_image (ColorizeImageCaffe*) or "
                "ideepcolor_tpu_torch.api")
        size = 256
        self.blobs = {
            "img_bgr": _Blob((1, 3, size, size)),
            "gt_glob_ab_313_drop": _Blob((1, 314, 1, 1)),
            "s_avg_drop": _Blob((1, 2, 1, 1)),
            "b_avg_drop": _Blob((1, 2, 1, 1)),
            "g_avg_drop": _Blob((1, 2, 1, 1)),
            "r_avg_drop": _Blob((1, 2, 1, 1)),
        }

    def forward(self):
        from ideepcolor_tpu_torch.models import global_stats
        bgr = self.blobs["img_bgr"].data[0]          # (3, H, W) BGR
        rgb = bgr[::-1].transpose(1, 2, 0)
        if rgb.max() > 1.5:                          # uint8-scale input
            rgb = rgb / 255.0
        stats = global_stats.extract(
            np.ascontiguousarray(rgb, np.float32), root_device())
        glob = stats["glob_ab_313"].cpu().numpy()
        self.blobs["gt_glob_ab_313_drop"].data[0, :-1, 0, 0] = glob
        self.blobs["gt_glob_ab_313_drop"].data[0, -1, 0, 0] = 1.0
        self.blobs["s_avg_drop"].data[0, :, 0, 0] = [
            float(stats["s_avg"]), 1.0]
        bgr_avg = stats["bgr_avg"].cpu().numpy()
        for i, name in enumerate(("b_avg_drop", "g_avg_drop",
                                  "r_avg_drop")):
            self.blobs[name].data[0, :, 0, 0] = [float(bgr_avg[i]), 1.0]
        return {}


class io:
    """caffe.io.load_image / resize_image equivalents (float RGB [0,1])."""

    @staticmethod
    def load_image(path):
        from ideepcolor_tpu_torch.utils.imageio import read_image
        return read_image(str(path)).astype(np.float64) / 255.0

    @staticmethod
    def resize_image(im, new_dims, interp_order=1):
        """``cv2.resize`` of ``im`` as float32 to ``new_dims`` (h, w), in
        OpenCV's own float arithmetic (:func:`_resize_linear_f32`), or
        nearest for ``interp_order`` 0 (``floor(x * in / out)``); float64
        out, a single channel as 2-D, as cv2 gives it."""
        src = np.asarray(im, np.float32)
        if src.ndim == 2:
            src = src[..., None]
        h, w = int(new_dims[0]), int(new_dims[1])
        if interp_order == 1:
            out = _resize_linear_f32(src, h, w)
        else:
            H, W = src.shape[:2]
            rows = np.minimum(np.floor(np.arange(h) * (H / h)), H - 1)
            cols = np.minimum(np.floor(np.arange(w) * (W / w)), W - 1)
            out = src[rows.astype(np.int64)][:, cols.astype(np.int64)]
        return (out[..., 0] if out.shape[-1] == 1 else out).astype(
            np.float64)


def _linear_taps_f32(n_in: int, n_out: int, clamp_weight: bool):
    """OpenCV's float INTER_LINEAR taps: the half-pixel coordinate in
    float32, its floor and fraction; columns (``clamp_weight``) put the
    whole weight on the edge pixel outside the image, rows only clamp the
    indices."""
    f = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp_weight:
        f[(s < 0) | (s >= n_in - 1)] = 0
    return (np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1),
            np.float32(1) - f, f)


def _resize_linear_f32(src: np.ndarray, h: int, w: int) -> np.ndarray:
    """(H, W, C) float32, C in 1-4 -> (h, w, C): ``cv2.resize`` with
    INTER_LINEAR as OpenCV computes it without IPP, bit for bit (the IPP
    build's default path differs in the last bit on about a third of the
    values): a horizontal pass ``s0 * a0 + s1 * a1`` into float32 rows,
    then ``r0 * b0 + r1 * b1``, each product rounded (no fused
    multiply-add); an exact 2x shrink is OpenCV's 2x2 box average, summed
    in the order its code takes for the channel count."""
    H, W, C = src.shape
    if not 1 <= C <= 4:
        raise ValueError(f"resize_image takes 1 to 4 channels, got {C}")
    if (H, W) == (2 * h, 2 * w):
        s00, s01 = src[0::2, 0::2], src[0::2, 1::2]
        s10, s11 = src[1::2, 0::2], src[1::2, 1::2]
        total = ((s00 + s01) + (s10 + s11) if C in (1, 4)
                 else ((s00 + s01) + s10) + s11)
        return total * np.float32(0.25)
    c0, c1, a0, a1 = _linear_taps_f32(W, w, clamp_weight=True)
    r0, r1, b0, b1 = _linear_taps_f32(H, h, clamp_weight=False)
    rows = src[:, c0] * a0[:, None] + src[:, c1] * a1[:, None]
    return rows[r0] * b0[:, None, None] + rows[r1] * b1[:, None, None]
