"""Batched engines: full-res fusion throughput and batch colorization.

Counterpart of the single-device forms of ``ideepcolor_tpu/engine/batch.py``:
the batched full-res fusion, the batched hint-conditioned forwards (dense
planes or per-image hint tables) and the multi-frame streaming window. They
keep the JAX package's channel-last layouts at their boundary and run the
U-Net at ``precision_name="default"`` (TF32 on the card), as the JAX
functions run at ``Precision.DEFAULT``. They take the module or a state dict
(``models.siggraph.as_module``) where the JAX functions take ``params``.

The batched rasterize (``jax.vmap(rasterize_hints)`` there) is kernel K1's
batched entry, one launch for N tables; the batched compose is kernel K2's,
one launch for N frames.

Not carried: the ``mesh=`` argument and the sharded forms (they wait for the
port of ``parallel/mesh.py``), ``batch_forward_frames_global`` /
``colorize_batch_global`` (the Caffe family) and ``batch_suggest_table`` /
``suggest_batch_table``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.siggraph import as_module
from ..ops import colorspace as cs
from ..ops.cuda import colorspace_kernel as k2
from ..ops.cuda import hints_kernel as k1
from ..ops.resize import linear_resize_matrix_np
from . import pipeline as P


@torch.no_grad()
def batch_fullres_fuse(l_full: torch.Tensor, ab_small: torch.Tensor,
                       out_hw: tuple[int, int]) -> torch.Tensor:
    """(N,H,W,1) full-res L + (N,h,w,2) predicted ab -> (N,H,W,3) uint8.

    The batched form of the reference's get_img_fullres chain. The batch
    loops over its images, as the JAX function maps over them: each image is
    an independent matmul resize + K2 compose, and the loop keeps the live
    intermediate one image wide (a 32 x 2048^2 batched product would hold
    over 1 GB of f32 intermediates for no gain).
    """
    H, W = out_hw
    dev = l_full.device
    rh = torch.as_tensor(linear_resize_matrix_np(ab_small.shape[1], H),
                         device=dev)
    rw = torch.as_tensor(linear_resize_matrix_np(ab_small.shape[2], W),
                         device=dev)
    out = torch.empty((l_full.shape[0], H, W, 3), dtype=torch.uint8,
                      device=dev)
    for i in range(l_full.shape[0]):
        out[i] = P.fullres_fuse(l_full[i], ab_small[i], rh, rw)
    return out


def _forward_compose(net, l_raw, hint_ab, hint_mask, maskcent):
    """l_raw (N,1,S,S) L in [0,100], hint_ab (N,2,S,S), hint_mask (N,1,S,S)
    -> (uint8 frames (N,S,S,3), predicted ab (N,2,S,S))."""
    ab = net(l_raw - 50.0, hint_ab, hint_mask, maskcent,
             precision_name="default")
    return k2.lab_to_rgb_u8_batch(l_raw[:, 0], ab[:, 0], ab[:, 1]), ab


@torch.no_grad()
def batch_forward_frames(weights, l_mc: torch.Tensor, hint_ab: torch.Tensor,
                         hint_mask: torch.Tensor, maskcent: float = 0.0
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched hint-conditioned colorization: (N,Xd,Xd,*) channel-last
    inputs (mean-centered L, hint ab, hint mask) -> (uint8 frames
    (N,Xd,Xd,3), predicted ab (N,Xd,Xd,2))."""
    net = as_module(weights, l_mc.device)
    rgb, ab = _forward_compose(net, l_mc.permute(0, 3, 1, 2) + 50.0,
                               hint_ab.permute(0, 3, 1, 2),
                               hint_mask.permute(0, 3, 1, 2), maskcent)
    return rgb, ab.permute(0, 2, 3, 1)


@torch.no_grad()
def batch_forward_frames_table(weights, l_mc: torch.Tensor,
                               boxes: torch.Tensor, values: torch.Tensor,
                               counts: torch.Tensor, maskcent: float = 0.0
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched colorization fed by per-image hint TABLES: (N,M,4) int32
    boxes + (N,M,2) values + (N,) int32 live counts, on ``l_mc``'s device,
    instead of dense planes. K1's batched entry rasterizes all N tables in
    one launch: the batched form of the table click."""
    net = as_module(weights, l_mc.device)
    hints = k1.rasterize_hints_batch(boxes, values, counts, l_mc.shape[1])
    rgb, ab = _forward_compose(net, l_mc.permute(0, 3, 1, 2) + 50.0,
                               hints[:, :2], hints[:, 2:], maskcent)
    return rgb, ab.permute(0, 2, 3, 1)


def frame_delta_stats(a, b):
    """(max |delta| in uint8 LSBs, fraction of exactly-equal pixels)
    between two uint8 frame stacks: the audit two runs of one batch are
    held to where their convs may differ in the last float bits (another
    batch size, another precision mode), which can flip isolated uint8
    values by 1."""
    d = np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16))
    return int(d.max()), float((d == 0).all(axis=-1).mean())


def _prep_l_mc(x: torch.Tensor) -> torch.Tensor:
    """(N,S,S,3) float RGB in [0,1] -> mean-centered L (N,S,S,1)."""
    return cs.rgb_to_lab(x)[..., :1] - 50.0


def _images(images_rgb, dev) -> torch.Tensor:
    imgs = torch.as_tensor(np.ascontiguousarray(images_rgb), device=dev)
    if imgs.dtype == torch.uint8:
        return imgs.to(torch.float32) / 255.0
    return imgs.to(torch.float32)


def colorize_batch_table(weights, images_rgb, boxes, values, counts,
                         maskcent: float = 0.0, device=None) -> np.ndarray:
    """Table-hint form of :func:`colorize_batch`: uint8 RGB images +
    per-image hint tables in, colorized uint8 frames out. Runs on the card
    unless ``device="cpu"``."""
    dev = resolve_device(device)
    net = as_module(weights, dev)
    rgb, _ab = batch_forward_frames_table(
        net, _prep_l_mc(_images(images_rgb, dev)),
        torch.as_tensor(np.asarray(boxes, np.int32), device=dev),
        torch.as_tensor(np.asarray(values, np.float32), device=dev),
        torch.as_tensor(np.asarray(counts, np.int32), device=dev),
        float(maskcent))
    return rgb.cpu().numpy()


def colorize_batch(weights, images_rgb, hint_ab=None, hint_mask=None,
                   maskcent: float = 0.0, device=None) -> np.ndarray:
    """Convenience batched serving: uint8 RGB images in, colorized uint8
    frames out.

    images_rgb: (N, S, S, 3) uint8 or float [0,1]; optional dense hints
    (N, S, S, 2) / (N, S, S, 1). The grayscale L is extracted on the device;
    hints default to zero (automatic colorization). Runs on the card unless
    ``device="cpu"``.
    """
    dev = resolve_device(device)
    net = as_module(weights, dev)
    imgs = _images(images_rgb, dev)
    n, s = imgs.shape[0], imgs.shape[1]
    hint_ab = (torch.zeros((n, s, s, 2), device=dev) if hint_ab is None else
               torch.as_tensor(np.asarray(hint_ab, np.float32), device=dev))
    hint_mask = (torch.zeros((n, s, s, 1), device=dev) if hint_mask is None
                 else torch.as_tensor(np.asarray(hint_mask, np.float32),
                                      device=dev))
    rgb, _ab = batch_forward_frames(net, _prep_l_mc(imgs), hint_ab,
                                    hint_mask, float(maskcent))
    return rgb.cpu().numpy()


@torch.no_grad()
def batch_stream_window_u8(weights, gray_u8: torch.Tensor,
                           boxes: torch.Tensor, values: torch.Tensor, count,
                           maskcent: float = 0.0) -> torch.Tensor:
    """A WINDOW of video frames through the streaming step at once: (T, S,
    S, 1) uint8 gray frames + ONE shared hint table (the semantics of
    ``engine.streaming._stream_step_u8_table``: K1 on the device, linear
    u8 -> L dequantization) -> (T, S, S, 3) uint8 frames. One K1 launch, one
    forward over the T frames, one launch of K2's batched entry."""
    net = as_module(weights, gray_u8.device)
    t, size = gray_u8.shape[0], gray_u8.shape[1]
    hints = k1.rasterize_hints_planar(boxes, values, count, size)
    l_raw = gray_u8.permute(0, 3, 1, 2).to(torch.float32) * (100.0 / 255.0)
    return _forward_compose(net, l_raw, hints[None, :2].expand(t, -1, -1, -1),
                            hints[None, 2:].expand(t, -1, -1, -1),
                            maskcent)[0]


def stream_window_u8(weights, frames_u8, boxes, values, count,
                     maskcent: float = 0.0, device=None) -> np.ndarray:
    """Public multi-frame streaming step: (T, S, S, 1) uint8 gray frames +
    one tracked-hint table in, (T, S, S, 3) uint8 colorized frames out.
    Runs on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    net = as_module(weights, dev)
    frames = torch.as_tensor(np.ascontiguousarray(frames_u8, np.uint8),
                             device=dev)
    return batch_stream_window_u8(
        net, frames,
        torch.as_tensor(np.asarray(boxes, np.int32), device=dev),
        torch.as_tensor(np.asarray(values, np.float32), device=dev),
        int(count), float(maskcent)).cpu().numpy()
