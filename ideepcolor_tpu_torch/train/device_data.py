"""A corpus kept on the card as uint8, augmented there every step.

Counterpart of ``ideepcolor_tpu/train/device_data.py``. The images are
decoded once (the port's codec), resized to ``store``^2 with the port of
PIL's BILINEAR, and uploaded as one (N, store, store, 3) uint8 tensor. A
step then costs no host work: :func:`sample_batch` draws, on the card, a
random resized crop (scale 0.6-1.0, sampled align-corners bilinear onto the
output grid), a horizontal flip, the dequantization and rgb -> Lab, and with
``color_jitter`` the hue rotation, chroma scale and region compositing of
the JAX package (two regions; ``strong``: four, as an XOR checkerboard).

Random numbers come from a ``torch.Generator`` on the card. The draws are
made by :func:`draw_batch` and used by :func:`batch_from_draws`, the
deterministic core, which the tests feed with JAX's draws. Batches are
NCHW: ``{'l': (B,1,S,S), 'ab': (B,2,S,S)}`` f32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device
from ..ops import colorspace as cs
from ..ops.resize import resize_u8_pil_bilinear
from .data import list_images, read_rgb


def _bilinear_crop(imgs: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor
                   ) -> torch.Tensor:
    """Sample (B,H,W,C) images at the outer product of fractional
    coordinates ys (B,out) and xs (B,out), align-corners bilinear,
    separably: rows, then columns. uint8 images are dequantized (/255)
    after the gather; the values are the JAX package's, which dequantizes
    first."""
    B, H, W = imgs.shape[:3]
    b = torch.arange(B, device=imgs.device)
    f32 = lambda t: t.to(torch.float32) / 255.0 if t.dtype == torch.uint8 \
        else t  # noqa: E731
    y0 = ys.floor().to(torch.int64).clamp(0, H - 1)
    y1 = (y0 + 1).clamp(max=H - 1)
    wy = (ys - y0.to(ys.dtype))[..., None, None]
    rows = (f32(imgs[b[:, None], y0]) * (1.0 - wy)
            + f32(imgs[b[:, None], y1]) * wy)               # (B,out,W,C)
    x0 = xs.floor().to(torch.int64).clamp(0, W - 1)
    x1 = (x0 + 1).clamp(max=W - 1)
    wx = (xs - x0.to(xs.dtype))[:, None, :, None]
    r = torch.arange(ys.shape[1], device=imgs.device)
    pick = lambda xi: rows[b[:, None, None], r[None, :, None],  # noqa: E731
                           xi[:, None, :]]
    return pick(x0) * (1.0 - wx) + pick(x1) * wx            # (B,out,out,C)


def _crop_draws(generator, n_images: int, batch: int, device) -> dict:
    kw = dict(generator=generator, device=device)
    return {"idx": torch.randint(0, n_images, (batch,), **kw),
            "scale": torch.rand((batch,), **kw) * 0.4 + 0.6,
            "uy": torch.rand((batch,), **kw),
            "ux": torch.rand((batch,), **kw),
            "flip": torch.rand((batch,), **kw) < 0.5}


def draw_batch(generator: torch.Generator, n_images: int, batch: int,
               color_jitter: bool = False, strong: bool = False,
               device=None) -> dict:
    """Every random number one :func:`batch_from_draws` call takes.

    Crops: ``idx`` (B,) image index, ``scale`` in [0.6, 1), ``uy``/``ux`` in
    [0, 1) (the corner as a share of the room left), ``flip`` (B,) bool;
    with ``color_jitter`` a second crop ``b_*``, per region ``theta`` (R,B)
    in [0, 2 pi) and ``sat`` (R,B) chroma scales (R = 2, strong 4: regions
    a1, a2, b1, b2), and the split: ``pos`` (B,) in [0.3, 0.7), ``horiz``
    and ``use_b`` (B,) bool; strong: ``pos_y``, ``pos_x``, ``use_v``,
    ``use_h``."""
    kw = dict(generator=generator, device=device)
    d = _crop_draws(generator, n_images, batch, device)
    if not color_jitter:
        return d
    d.update({f"b_{k}": v for k, v in
              _crop_draws(generator, n_images, batch, device).items()})
    lo, hi = (0.5, 1.5) if strong else (0.7, 1.3)
    regions = 4 if strong else 2
    d["theta"] = torch.rand((regions, batch), **kw) * (2.0 * math.pi)
    d["sat"] = torch.rand((regions, batch), **kw) * (hi - lo) + lo
    frac = lambda: torch.rand((batch,), **kw) * 0.4 + 0.3  # noqa: E731
    coin = lambda p: torch.rand((batch,), **kw) < p  # noqa: E731
    if strong:
        d.update(pos_y=frac(), pos_x=frac(), use_v=coin(0.85),
                 use_h=coin(0.85))
    else:
        d.update(pos=frac(), horiz=coin(0.5), use_b=coin(0.75))
    return d


def _crops(images_u8: torch.Tensor, d: dict, size: int,
           prefix: str = "") -> torch.Tensor:
    S = images_u8.shape[1]
    grid = torch.arange(size, dtype=torch.float32,
                        device=images_u8.device) / (size - 1)
    g = lambda k: d[prefix + k]  # noqa: E731
    c = g("scale").to(torch.float32) * S                 # crop side (px)
    y0 = g("uy").to(torch.float32) * (S - c)
    x0 = g("ux").to(torch.float32) * (S - c)
    ys = y0[:, None] + grid[None] * (c - 1.0)[:, None]
    xs = x0[:, None] + grid[None] * (c - 1.0)[:, None]
    out = _bilinear_crop(images_u8[g("idx").to(torch.int64)], ys, xs)
    return torch.where(g("flip").to(torch.bool)[:, None, None, None],
                       out.flip(2), out)


def _jittered_ab(ab: torch.Tensor, theta: torch.Tensor,
                 sat: torch.Tensor) -> torch.Tensor:
    """Rotate (B,H,W,2) ab by theta (B,) and scale it by sat (B,)."""
    c, s = (f(theta)[:, None, None] for f in (torch.cos, torch.sin))
    a, b = ab[..., 0], ab[..., 1]
    return torch.stack([c * a - s * b, s * a + c * b], -1) \
        * sat[:, None, None, None]


def batch_from_draws(images_u8: torch.Tensor, d: dict, size: int,
                     color_jitter: bool = False, strong: bool = False
                     ) -> dict[str, torch.Tensor]:
    """The deterministic core of :func:`sample_batch`: (N,S,S,3) uint8
    corpus + :func:`draw_batch`'s numbers -> {'l', 'ab'} NCHW f32."""
    lab = cs.rgb_to_lab(_crops(images_u8, d, size))
    l, ab = lab[..., :1], lab[..., 1:]
    if color_jitter:
        lab_b = cs.rgb_to_lab(_crops(images_u8, d, size, "b_"))
        ab_b_in = lab_b[..., 1:]
        dev = images_u8.device
        ys = torch.arange(size, dtype=torch.float32, device=dev)[:, None] \
            .expand(size, size)
        xs = torch.arange(size, dtype=torch.float32, device=dev)[None, :] \
            .expand(size, size)
        th, sat = d["theta"], d["sat"]
        if strong:
            # up to four independently rotated regions: a vertical and a
            # horizontal split, crops a and b as an XOR checkerboard
            ab_a1, ab_a2 = (_jittered_ab(ab, th[i], sat[i]) for i in (0, 1))
            ab_b1, ab_b2 = (_jittered_ab(ab_b_in, th[i], sat[i])
                            for i in (2, 3))
            pos_y = d["pos_y"].to(torch.float32) * size
            pos_x = d["pos_x"].to(torch.float32) * size
            in_v = ((xs[None] >= pos_x[:, None, None])
                    & d["use_v"].to(torch.bool)[:, None, None])
            in_h = ((ys[None] >= pos_y[:, None, None])
                    & d["use_h"].to(torch.bool)[:, None, None])
            in_b = (in_v ^ in_h)[..., None]
            sub = in_h[..., None]
            ab_a = torch.where(sub, ab_a2, ab_a1)
            ab_b = torch.where(sub, ab_b2, ab_b1)
        else:
            ab_a = _jittered_ab(ab, th[0], sat[0])
            ab_b = _jittered_ab(ab_b_in, th[1], sat[1])
            # a random vertical or horizontal split at 30-70%; a quarter
            # of the samples stay one region
            pos = d["pos"].to(torch.float32) * size
            coord = torch.where(d["horiz"].to(torch.bool)[:, None, None],
                                ys[None], xs[None])
            in_b = ((coord >= pos[:, None, None])
                    & d["use_b"].to(torch.bool)[:, None, None])[..., None]
        l = torch.where(in_b, lab_b[..., :1], l)
        ab = torch.where(in_b, ab_b, ab_a)
    return {"l": l.permute(0, 3, 1, 2).contiguous(),
            "ab": ab.permute(0, 3, 1, 2).contiguous()}


def sample_batch(images_u8: torch.Tensor, generator: torch.Generator,
                 batch: int, size: int, color_jitter: bool = False,
                 strong: bool = False) -> dict[str, torch.Tensor]:
    """(N,S,S,3) uint8 corpus on the device -> a {'l','ab'} batch: per
    sample a uniform image pick, a random resized crop (0.6-1.0 of the
    stored side), a 50% horizontal flip and rgb -> Lab; ``color_jitter``
    rotates the ab plane by a random hue angle, scales chroma (0.7-1.3;
    strong 0.5-1.5) and composites independently jittered crops along
    random splits. On a tiny corpus that keeps a hint-conditioned net from
    memorizing each image's colors."""
    d = draw_batch(generator, images_u8.shape[0], batch, color_jitter,
                   strong, images_u8.device)
    return batch_from_draws(images_u8, d, size, color_jitter, strong)


class DeviceDataset:
    """Drop-in for :class:`~.data.ImageFolderLoader` when the corpus fits on
    the card: decoded once at ``store``^2 (uint8), uploaded once, sampled by
    :func:`sample_batch` with a generator on the card seeded with ``seed``.
    ``device``: the card unless "cpu"."""

    def __init__(self, root, batch_size: int = 16, size: int = 176,
                 store: int = 288, seed: int = 0,
                 color_jitter: bool | str = True, device=None):
        self.device = resolve_device(device)
        paths = list_images(root) if isinstance(root, str) else list(root)
        if not paths:
            raise FileNotFoundError(f"no images under {root}")
        frames = []
        for p in paths:
            im = read_rgb(p)
            if im is not None:
                frames.append(resize_u8_pil_bilinear(im, (store, store)))
        if not frames:
            raise FileNotFoundError(f"no decodable images under {root}")
        self.n_images = len(frames)
        self.batch_size = batch_size
        self.size = size
        self._dev = torch.from_numpy(np.stack(frames)).to(self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # color_jitter: False | True | "strong" (the 4-region tier)
        self.color_jitter = bool(color_jitter)
        self.strong = color_jitter == "strong"

    @property
    def bytes_on_device(self) -> int:
        return self._dev.numel()

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, torch.Tensor]:
        return sample_batch(self._dev, self._gen, self.batch_size, self.size,
                            color_jitter=self.color_jitter,
                            strong=self.strong)

    def close(self):
        pass


def corpus_fits_on_device(root, store: int = 288,
                          budget_bytes: int = 1 << 29) -> bool:
    """True when the decoded uint8 stack stays within ``budget_bytes``
    (512 MB by default, next to the model and optimizer state)."""
    n = len(list_images(root) if isinstance(root, str) else list(root))
    return 0 < n * store * store * 3 <= budget_bytes
