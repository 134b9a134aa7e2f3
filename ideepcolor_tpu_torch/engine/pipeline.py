"""The click, suggestion and full-res programs, on tensors.

Counterpart of ``ideepcolor_tpu/engine/pipeline.py``. There each stage
chain is one jitted XLA program. Here each is a plain function whose fused
steps are the hand-written kernels: K1 (hint rasterizer) at the head of the
table click and K2 (Lab -> uint8 compose) at every frame. A factory called
with a CUDA ``device`` returns that function as a captured CUDA graph
(``engine.graphs.GraphProgram``: one graph launch per click, the plain
function kept as ``.fn``); for the CPU, or without a device, it returns the
plain function itself. A program's hint count and click pixel are Python
ints on the plain path and one-element device tensors under capture, where
K1's device-count entry and a gather by device index read them. The clicks take K2's fused entry, which also returns the
requantized ab, the click's second output; the window frame and the uint8
suggestion palette take K2's compose. The suggestion chain between them
(``ops.kmeans``) is torch ops, as it is ``jnp`` ops in the JAX package.

The full-res programs work, as the JAX package's do, on planes padded to
``FULLRES_BUCKET``-px buckets with interpolation matrices padded to the same
rows (``ops.resize``'s builders with ``n_rows``): a captured graph fixes its
shapes as an XLA program does, so one graph serves every image size of a
bucket and the caller crops the padded frame. The image load, the getters,
``suggest_at`` behind ``get_ab_reccs`` and ``dist_entropy`` have program
factories of their own (``make_*_program``), so each is one graph launch on
the card.
"""

from __future__ import annotations

import torch

from ..ops import colorspace as cs
from ..ops import kmeans as km
from ..ops import quantize
from ..ops.cuda import colorspace_kernel as k2
from ..ops.cuda import hints_kernel as k1
from ..ops.resize import zoom_with_matrices
from . import graphs


def rgb_to_lab_dev(rgb: torch.Tensor) -> torch.Tensor:
    """(H,W,3) float RGB in [0,1] -> (H,W,3) Lab."""
    return cs.rgb_to_lab(rgb.to(torch.float32))


def rgb_to_lab_dev_u8(rgb_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (H,W,3) RGB -> Lab, the /255 dequantization on the device."""
    return cs.rgb_to_lab(rgb_u8.to(torch.float32) / 255.0)


def make_load_program(device=None):
    """The image load: ``load(rgb (Hb,Wb,3) uint8 or float in [0,1])``
    gives ``(lab (Hb,Wb,3), l (Hb,Wb,1))``, the L plane contiguous so K2
    reads 4 B/px of it. On the card one graph per bucket and source type."""

    @torch.no_grad()
    def load(rgb):
        lab = (rgb_to_lab_dev_u8(rgb) if rgb.dtype == torch.uint8
               else rgb_to_lab_dev(rgb))
        return lab, lab[..., :1].contiguous()

    return graphs.program(load, device)


def center_plane(lab: torch.Tensor, mean: float, norm: float
                 ) -> torch.Tensor:
    """(H,W,3) Lab -> mean-centered L plane (H,W,1)."""
    return (lab[..., :1] - mean) / norm


def compose_rgb_u8(img_l: torch.Tensor, ab: torch.Tensor) -> torch.Tensor:
    """(H,W,1) L + (H,W,2) ab -> (H,W,3) uint8 RGB through K2 (kept under
    the JAX package's name for its call sites)."""
    return k2.compose_frame_u8(img_l, ab)


FULLRES_BUCKET = 256


def bucket_size(n: int) -> int:
    """``n`` rounded up to a multiple of ``FULLRES_BUCKET``."""
    return ((n + FULLRES_BUCKET - 1) // FULLRES_BUCKET) * FULLRES_BUCKET


def fullres_fuse(l_full: torch.Tensor, ab_small: torch.Tensor,
                 rh: torch.Tensor, rw: torch.Tensor) -> torch.Tensor:
    """Full-resolution frame: align-corners bilinear upsample of (h,w,2) ab
    by rh (H,h) / rw (W,w), fused with the full-res (H,W,1) L by K2. The
    same body serves the padded planes (``fullres_fuse_bucketed``) and the
    GUI's window frame."""
    return compose_rgb_u8(l_full, zoom_with_matrices(ab_small, rh, rw))


def zeros_plane(ref: torch.Tensor) -> torch.Tensor:
    """A zero (H,W) f32 plane the size of ``ref``'s first two dims, with
    stride 0: K2 reads it without memory traffic."""
    return torch.zeros((), dtype=torch.float32,
                       device=ref.device).expand(ref.shape[:2])


def gray_fullres(l_full: torch.Tensor) -> torch.Tensor:
    """The (H,W,1) L plane as a gray uint8 frame (zero ab) by K2."""
    l = l_full[..., 0]
    zero = zeros_plane(l)
    return k2.lab_to_rgb_u8_hwc(l, zero, zero)


def mask_fullres(mask: torch.Tensor, rh0: torch.Tensor,
                 rw0: torch.Tensor) -> torch.Tensor:
    """Full-res mask frame: nearest-upsample the (h,w,1) mask with 0/1
    matrices (padded rows give mask 0, white), render 100 * (1 - mask) as
    L."""
    up = zoom_with_matrices(mask, rh0, rw0)
    zero = zeros_plane(up)
    return k2.lab_to_rgb_u8_hwc(100.0 * (1.0 - up[..., 0]), zero, zero)


def sup_fullres(planes: torch.Tensor, rh0: torch.Tensor,
                rw0: torch.Tensor) -> torch.Tensor:
    """Full-res hint frame: nearest-upsample (h,w,3) = [mask, ab], render
    50 * mask as L with the hint ab."""
    up = zoom_with_matrices(planes, rh0, rw0)
    return compose_rgb_u8(50.0 * up[..., :1], up[..., 1:])


# JAX's names for the getters' forms: the same bodies on the padded
# (Hb,Wb,1) L plane and matrices padded to (Hb,h) / (Wb,w); the caller
# crops the frame
fullres_fuse_bucketed = fullres_fuse
mask_fullres_bucketed = mask_fullres
sup_fullres_bucketed = sup_fullres


def make_getter_programs(device=None) -> dict:
    """The full-res getters as programs, by name: ``fullres`` (l_pad,
    ab_small, rh, rw), ``gray`` (l_pad), ``mask`` (mask, rh0, rw0) and
    ``sup`` (planes, rh0, rw0), each giving the padded uint8 frame. On the
    card each is one graph per bucket."""
    fns = {"fullres": fullres_fuse_bucketed, "gray": gray_fullres,
           "mask": mask_fullres_bucketed, "sup": sup_fullres_bucketed}
    return {name: graphs.program(torch.no_grad()(fn), device)
            for name, fn in fns.items()}


def make_table_click_program(apply_fn, size: int, device=None):
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

    return graphs.program(click, device)


def make_table_click_win_program(apply_fn, size: int, device=None):
    """The table click that also composes the GUI's window-size frame:
    the requantized output ab resized by the matrices rh (Hw, size) / rw
    (Ww, size) (``ops.resize.cubic_resize_matrix_np`` for the GUI), fused
    with the window's (Hw, Ww, 1) L plane by K2's compose.

    ``click(l_net, l_mc, l_win, rh, rw, boxes, values, count)`` gives
    ``(rgb, out_ab, win (Hw,Ww,3) uint8, hints)``; the first two and the
    last are the table click's own."""
    table_click = make_table_click_program(apply_fn, size)

    @torch.no_grad()
    def click(l_net, l_mc, l_win, rh, rw, boxes, values, count):
        rgb, out_ab, hints = table_click(l_net, l_mc, boxes, values, count)
        win = compose_rgb_u8(l_win, zoom_with_matrices(out_ab, rh, rw))
        return rgb, out_ab, win, hints

    return graphs.program(click, device)


def pixel_at(t: torch.Tensor, h, w) -> torch.Tensor:
    """``t[h, w]`` of a (H, W, ...) tensor. Python ints give a view; one-
    element index tensors on ``t``'s device (a captured program's click
    pixel) give a gather that runs where the graph runs. Neither reads
    anything back."""
    if not isinstance(h, torch.Tensor):
        return t[h, w]
    # w + W * h in one launch, in the index tensors' own integer type
    # (index_select takes int32 as well as int64)
    flat = torch.add(w, h, alpha=t.shape[1]).reshape(1)
    return t.reshape(t.shape[0] * t.shape[1],
                     *t.shape[2:]).index_select(0, flat)[0]


def suggest_at(dist_S: torch.Tensor, h, w, centers_tbl: torch.Tensor,
               generator: torch.Generator, K: int = 5, N: int = 25000,
               return_draws: bool = False):
    """Color suggestions at pixel (h, w) of a (H,W,Q) distribution map:
    the gather, CMF sampling and k-means run on the map's device and give
    (K,2) centers and (K,) confidences there, and with ``return_draws`` the
    uniform numbers drawn (``km.ab_recommendations``). h and w are Python
    ints or device index tensors (:func:`pixel_at`); nothing is read
    back."""
    return km.ab_recommendations(pixel_at(dist_S, h, w), centers_tbl,
                                 generator, K=K, N=N,
                                 return_draws=return_draws)


def make_suggest_program(device=None):
    """``get_ab_reccs``'s chain as a program: ``sugg(dist_S, h, w,
    centers_tbl, generator, K=5, N=25000, map_div=1)`` gives ``(out (K,3),
    u_bins (N,), u_seeds (RESTARTS,K))``: the (K,2) centers and the (K,)
    confidences as a third column, one buffer for one readback, and the
    uniform numbers the chain drew, which stay on the device. h and w are
    the pixel in net coordinates, Python ints or the device tensors of a
    ``graphs.TableStage`` (a graph reads the live pixel); the map's pixel
    is (h // map_div, w // map_div)."""

    @torch.no_grad()
    def sugg(dist_S, h, w, centers_tbl, generator, K=5, N=25000, map_div=1):
        centers, conf, u_bins, u_seeds = suggest_at(
            dist_S, h // map_div, w // map_div, centers_tbl, generator, K=K,
            N=N, return_draws=True)
        return torch.cat([centers, conf[:, None]], 1), u_bins, u_seeds

    return graphs.program(sugg, device)


def dist_entropy(dist: torch.Tensor) -> torch.Tensor:
    """Per-pixel sum p log p over the bin axis (last), in the reference's
    sign convention."""
    return quantize.entropy(dist, axis=-1)


def make_entropy_program(device=None):
    """:func:`dist_entropy` as a program: one graph per map shape."""
    return graphs.program(torch.no_grad()(dist_entropy), device)


def _palette_lab(l_net: torch.Tensor, h, w,
                 centers: torch.Tensor) -> torch.Tensor:
    """(K,2) ab centers at the click pixel's own L -> (K,3) Lab."""
    return torch.cat([pixel_at(l_net, h, w).expand(centers.shape[0], 1),
                      centers], 1)


def make_table_click_win_suggest_program(apply_fn, size: int, device=None):
    """Dist-session GUI click: net frame, window frame and color
    suggestions at the click pixel (h, w) of the per-image distribution map.

    ``click(l_net, l_mc, l_win, rh, rw, boxes, values, count, dist_map, h,
    w, centers_tbl, prev_rgb, generator, K=9, N=25000, map_div=1)`` gives
    ``(rgb, out_ab, win, colors, hints)``. colors is the reference's
    suggest_color contract: (K+1, 3) float in [0,1], row 0 the PREVIOUS
    frame's pixel at the click, then the K suggestions at the pixel's L (the
    plain ``lab_to_rgb`` chain, clipped: float colors, not a uint8 frame).
    map_div is the map's coordinate divisor (4 for the SIGGRAPH H/4 map).
    The JAX factory takes K, N and map_div because each is a compile there;
    here they are keyword options of the click: the plain function serves
    them all, and the captured program keeps one graph per (K, N, map_div)
    in its bounded cache."""
    win_click = make_table_click_win_program(apply_fn, size)

    @torch.no_grad()
    def click(l_net, l_mc, l_win, rh, rw, boxes, values, count,
              dist_map, h, w, centers_tbl, prev_rgb, generator,
              K=9, N=25000, map_div=1):
        rgb, out_ab, win, hints = win_click(l_net, l_mc, l_win, rh, rw,
                                            boxes, values, count)
        centers, _conf = suggest_at(dist_map, h // map_div, w // map_div,
                                    centers_tbl, generator, K=K, N=N)
        colors = cs.lab_to_rgb(_palette_lab(l_net, h, w, centers)
                               ).clamp(0.0, 1.0)
        cur = pixel_at(prev_rgb, h, w).to(torch.float32) / 255.0
        return rgb, out_ab, win, torch.cat([cur[None], colors], 0), hints

    return graphs.program(click, device)


def make_table_dist_program(dist_fwd, size: int, device=None):
    """The per-image suggestion forward from a hint table: K1 -> dist
    forward. ``predict(l_mc, boxes, values, count)`` gives ``(dist_map,
    hints)``, with ``dist_fwd`` as in :func:`make_table_suggest_program`."""

    @torch.no_grad()
    def predict(l_mc, boxes, values, count):
        hints = k1.rasterize_hints_planar(boxes, values, count, size)
        return dist_fwd(l_mc, hints[:2], hints[2:]), hints

    return graphs.program(predict, device)


def make_table_suggest_program(dist_fwd, size: int, K: int = 9,
                               N: int = 25000, map_div: int = 4,
                               device=None):
    """Serving suggest: hint table -> K1 -> dist forward -> CMF sampling ->
    k-means -> uint8 palette through K2's compose.

    ``dist_fwd(l_mc (S,S,1), ab (2,S,S), mask (1,S,S))`` gives the
    (S/map_div, S/map_div, Q) distribution map. ``sugg(l_net, l_mc, boxes,
    values, count, h, w, centers_tbl, generator)`` gives ``(dist_map,
    colors (K,3) uint8, conf (K,), hints, u_bins (N,), u_seeds
    (RESTARTS,K))``; the map is returned so the caller keeps it for later
    lookups without another forward, and the uniform numbers the chain drew
    stay on the device beside it."""

    @torch.no_grad()
    def sugg(l_net, l_mc, boxes, values, count, h, w, centers_tbl,
             generator):
        hints = k1.rasterize_hints_planar(boxes, values, count, size)
        dist_map = dist_fwd(l_mc, hints[:2], hints[2:])
        centers, conf, u_bins, u_seeds = suggest_at(
            dist_map, h // map_div, w // map_div, centers_tbl, generator, K=K,
            N=N, return_draws=True)
        # the palette goes to K2 as a 1 x K image: as (K, 1) every pixel
        # would be a row end and take the kernel's scalar path
        lab = _palette_lab(l_net, h, w, centers)
        colors = k2.lab_to_rgb_u8_hwc(lab[None, :, 0], lab[None, :, 1],
                                      lab[None, :, 2])[0]
        return dist_map, colors, conf, hints, u_bins, u_seeds

    return graphs.program(sugg, device)


def make_click_program(apply_fn, device=None):
    """The dense click: ``apply_fn(*model_args) -> (1,2,H,W)`` ab, then
    K2's fused entry. ``click(l_net, *model_args)`` gives
    ``(rgb (H,W,3) uint8, out_ab (H,W,2))``."""

    @torch.no_grad()
    def click(l_net, *model_args):
        ab = apply_fn(*model_args)[0]
        return k2.lab_to_rgb_u8_ab(l_net[..., 0], ab[0], ab[1])

    return graphs.program(click, device)


def make_dist_click_program(apply_fn, device=None):
    """The dense click of a model whose forward also gives the distribution
    map (the Caffe dist graph): ``apply_fn(*model_args) -> (pred_ab
    (1,2,H,W), dist_S (1,H,W,Q))``, then K2's fused entry.
    ``click(l_net, *model_args)`` gives ``(rgb (H,W,3) uint8, out_ab
    (H,W,2), dist_S (H,W,Q))``."""

    @torch.no_grad()
    def click(l_net, *model_args):
        pred_ab, dist_S = apply_fn(*model_args)
        rgb, out_ab = k2.lab_to_rgb_u8_ab(l_net[..., 0], pred_ab[0, 0],
                                          pred_ab[0, 1])
        return rgb, out_ab, dist_S[0]

    return graphs.program(click, device)
