"""The click and full-res programs of the main path, on tensors.

Counterpart of ``ideepcolor_tpu/engine/pipeline.py``. There each stage
chain is one jitted XLA program; PyTorch runs eagerly, so here each is a
plain function whose fused steps are the hand-written kernels: K1 (hint
rasterizer) at the head of the table click and K2 (Lab -> uint8 compose)
at every frame. The clicks take K2's fused entry, which also returns the
requantized ab, the click's second output.

The JAX package pads full-res planes to 256-px buckets so one compiled
program serves many image sizes; eager PyTorch compiles nothing, so the
port builds the interpolation matrices at the exact size. The frames are
the ones the JAX package crops out of its padded buffers.
"""

from __future__ import annotations

import torch

from ..ops import colorspace as cs
from ..ops.cuda import colorspace_kernel as k2
from ..ops.cuda import hints_kernel as k1
from ..ops.resize import zoom_with_matrices


def rgb_to_lab_dev_u8(rgb_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (H,W,3) RGB -> Lab, the /255 dequantization on the device."""
    return cs.rgb_to_lab(rgb_u8.to(torch.float32) / 255.0)


def center_plane(lab: torch.Tensor, mean: float, norm: float
                 ) -> torch.Tensor:
    """(H,W,3) Lab -> mean-centered L plane (H,W,1)."""
    return (lab[..., :1] - mean) / norm


def compose_rgb_u8(img_l: torch.Tensor, ab: torch.Tensor) -> torch.Tensor:
    """(H,W,1) L + (H,W,2) ab -> (H,W,3) uint8 RGB through K2 (kept under
    the JAX package's name for its call sites)."""
    return k2.compose_frame_u8(img_l, ab)


def fullres_fuse(l_full: torch.Tensor, ab_small: torch.Tensor,
                 rh: torch.Tensor, rw: torch.Tensor) -> torch.Tensor:
    """Full-resolution frame (JAX ``fullres_fuse_bucketed``): align-corners
    bilinear upsample of (h,w,2) ab by rh (H,h) / rw (W,w), fused with the
    full-res (H,W,1) L by K2."""
    return compose_rgb_u8(l_full, zoom_with_matrices(ab_small, rh, rw))


def zeros_plane(ref: torch.Tensor) -> torch.Tensor:
    """A zero (H,W) f32 plane the size of ``ref``'s first two dims, with
    stride 0: K2 reads it without memory traffic."""
    return torch.zeros((), dtype=torch.float32,
                       device=ref.device).expand(ref.shape[:2])


def mask_fullres(mask: torch.Tensor, rh0: torch.Tensor,
                 rw0: torch.Tensor) -> torch.Tensor:
    """Full-res mask frame (JAX ``mask_fullres_bucketed``): nearest-upsample
    the (h,w,1) mask with 0/1 matrices, render 100 * (1 - mask) as L."""
    up = zoom_with_matrices(mask, rh0, rw0)
    zero = zeros_plane(up)
    return k2.lab_to_rgb_u8_hwc(100.0 * (1.0 - up[..., 0]), zero, zero)


def sup_fullres(planes: torch.Tensor, rh0: torch.Tensor,
                rw0: torch.Tensor) -> torch.Tensor:
    """Full-res hint frame (JAX ``sup_fullres_bucketed``): nearest-upsample
    (h,w,3) = [mask, ab], render 50 * mask as L with the hint ab."""
    up = zoom_with_matrices(planes, rh0, rw0)
    return compose_rgb_u8(50.0 * up[..., :1], up[..., 1:])


def make_table_click_program(apply_fn, size: int):
    """The table click: K1 -> U-Net -> K2's fused entry (frame and
    requantized ab).

    ``apply_fn(A (1,1,S,S), B (1,2,S,S), M (1,1,S,S)) -> (1,2,S,S)`` ab.
    The returned ``click(l_net (S,S,1), l_mc (S,S,1), boxes, values,
    count)`` gives ``(rgb (S,S,3) uint8, out_ab (S,S,2), hints (3,S,S))``;
    ``hints`` is K1's own planar output (ab, mask), which the caller reads
    back for its host mirrors.
    """

    @torch.no_grad()
    def click(l_net, l_mc, boxes, values, count):
        hints = k1.rasterize_hints_planar(boxes, values, count, size)
        pred = apply_fn(l_mc.permute(2, 0, 1)[None], hints[None, :2],
                        hints[None, 2:])[0]
        rgb, out_ab = k2.lab_to_rgb_u8_ab(l_net[..., 0], pred[0], pred[1])
        return rgb, out_ab, hints

    return click


def make_click_program(apply_fn):
    """The dense click: ``apply_fn(*model_args) -> (1,2,H,W)`` ab, then
    K2's fused entry. ``click(l_net, *model_args)`` gives
    ``(rgb (H,W,3) uint8, out_ab (H,W,2))``."""

    @torch.no_grad()
    def click(l_net, *model_args):
        ab = apply_fn(*model_args)[0]
        return k2.lab_to_rgb_u8_ab(l_net[..., 0], ab[0], ab[1])

    return click
