"""Inputs made from the seed: photographs stand-ins (smooth color fields
with noise, the same size on every seed) and the seed's random streams.
Every stream is a ``numpy`` generator keyed by (seed, purpose), so one
seed gives the same inputs in every run and the streams of different
purposes never overlap."""

from __future__ import annotations

import numpy as np

STREAMS = {"image": 1, "script": 2, "sample": 3, "warmup": 4, "tables": 5,
           "pool": 6}


def rng(seed: int, purpose: str) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), STREAMS[purpose]])


def image(r: np.random.Generator, H: int, W: int) -> np.ndarray:
    """(H, W, 3) uint8: per channel a product of a sine and a cosine of
    seeded frequencies and phases, plus Gaussian noise of 12 levels."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32) / max(H, W)
    f = r.uniform(3.0, 9.0, (3, 2)).astype(np.float32)
    p = r.uniform(0.0, 2 * np.pi, (3, 2)).astype(np.float32)
    base = np.stack([np.sin(f[c, 0] * yy + p[c, 0])
                     * np.cos(f[c, 1] * xx + p[c, 1]) for c in range(3)], -1)
    noise = r.standard_normal((H, W, 3), dtype=np.float32) * 12.0
    return np.clip(127.5 + 100.0 * base + noise, 0, 255).astype(np.uint8)


def images_device(seed: int, n: int, size: int, torch, device):
    """(n, size, size, 3) uint8 images of the same kind, made on the device
    with a generator seeded from ``seed`` (bulk input pools)."""
    gen = torch.Generator(device=device).manual_seed(
        int(rng(seed, "pool").integers(0, 1 << 62)))
    u = torch.rand((n, 3, 4), generator=gen, device=device)
    f = 3.0 + 6.0 * u[..., :2]
    p = 2 * np.pi * u[..., 2:]
    ax = torch.arange(size, device=device, dtype=torch.float32) / size
    yy, xx = ax[:, None], ax[None, :]
    base = (torch.sin(f[..., 0, None, None] * yy + p[..., 0, None, None])
            * torch.cos(f[..., 1, None, None] * xx + p[..., 1, None, None]))
    noise = torch.randn((n, 3, size, size), generator=gen, device=device)
    img = (127.5 + 100.0 * base + 12.0 * noise).clamp(0, 255)
    return img.to(torch.uint8).permute(0, 2, 3, 1).contiguous()
