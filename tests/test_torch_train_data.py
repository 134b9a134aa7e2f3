"""The port's training data against the JAX package's on the CPU: PIL's
BILINEAR resize, the folder loader's crops and batches, the device dataset's
on-device augmentation in its three jitter modes (on JAX's draws)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from ideepcolor_tpu.ops import host as jhost
from ideepcolor_tpu.train import data as jdata
from ideepcolor_tpu.train import device_data as jdd
from ideepcolor_tpu_torch.ops.resize import (pil_bilinear_matrix_np,
                                             resize_u8_pil_bilinear)
from ideepcolor_tpu_torch.train import data as tdata
from ideepcolor_tpu_torch.train import device_data as tdd
from ideepcolor_tpu_torch.utils import imageio
from ideepcolor_tpu_torch.utils.imageio import UnsupportedImage, encode_png

torch.set_num_threads(2)


def smooth_image(seed, H, W):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / max(H, W)
    base = np.stack([np.sin(6 * yy + c) * np.cos(5 * xx - 2 * c)
                     for c in range(3)], -1)
    return np.clip(127.5 + 100 * base + rng.normal(0, 12, (H, W, 3)),
                   0, 255).astype(np.uint8)


def corpus(root, sizes, seed=0):
    os.makedirs(root, exist_ok=True)
    for i, (H, W) in enumerate(sizes):
        with open(os.path.join(root, f"img{i:02d}.png"), "wb") as f:
            f.write(encode_png(smooth_image(seed + i, H, W)))
    return root


@pytest.mark.parametrize("src,dst", [
    ((400, 300), (176, 176)), ((37, 53), (64, 64)), ((301, 211), (97, 300)),
    ((100, 100), (33, 100)), ((100, 100), (100, 33)), ((64, 80), (256, 256)),
    ((5, 7), (3, 2)), ((17, 13), (288, 288)), ((288, 288), (288, 288))])
def test_resize_is_pil_bilinear_bit_for_bit(src, dst):
    """Shrinking (antialiased), enlarging, non-square, odd sizes, one side
    only and no change: equal to PIL byte for byte on random pixels."""
    im = np.random.default_rng(sum(src) + sum(dst)).integers(
        0, 256, (*src, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(im).resize(dst[::-1], Image.BILINEAR))
    got = resize_u8_pil_bilinear(im, dst)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_pil_coefficients_are_22_bit_and_normalized():
    m = pil_bilinear_matrix_np(400, 176)
    assert np.array_equal(m, np.round(m))
    assert np.abs(m.sum(1) - (1 << 22)).max() <= m.shape[1]
    assert (np.count_nonzero(m, 1) > 2).all()         # antialiased


@pytest.fixture
def numpy_lab(monkeypatch):
    """The JAX loader's Lab through its numpy path: no native build of the
    host library from a test."""
    monkeypatch.setattr(jhost, "get_lib", lambda: None)


@pytest.mark.parametrize("augment", [True, False])
def test_load_one_matches_jax_on_the_same_seed(tmp_path, augment):
    """The same rng calls cut the same crop and flip: equal float32 images
    (PIL and the port decode a PNG alike)."""
    root = corpus(str(tmp_path / "c"), [(90, 120), (77, 61)])
    for p in tdata.list_images(root):
        r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
        for _ in range(3):
            want = jdata._load_one(p, 48, r1, augment)
            got = tdata._load_one(p, 48, r2, augment)
            assert got.dtype == np.float32 and np.array_equal(got, want)
    assert tdata.list_images(root) == jdata.list_images(root)


def test_folder_loader_matches_jax(tmp_path, numpy_lab):
    """workers=1, same seed: the same images in the same order, Lab within
    2e-3 (the port's native host rgb2lab against the JAX loader's numpy
    form here, both f64 inside)."""
    root = corpus(str(tmp_path / "c"), [(90, 120), (77, 61), (64, 64)])
    jl = jdata.ImageFolderLoader(root, batch_size=3, size=32, seed=4,
                                 workers=1, prefetch=1)
    tl = tdata.ImageFolderLoader(root, batch_size=3, size=32, seed=4,
                                 workers=1, prefetch=1)
    try:
        for _ in range(2):
            want, got = next(jl), next(tl)
            assert got["l"].shape == (3, 1, 32, 32)
            assert got["ab"].shape == (3, 2, 32, 32)
            for k in ("l", "ab"):
                g = got[k].permute(0, 2, 3, 1).numpy()
                assert np.abs(g - want[k]).max() <= 2e-3, k
    finally:
        jl.close()
        tl.close()


def test_damaged_file_is_skipped_and_missing_decoder_raises(tmp_path,
                                                            monkeypatch):
    root = corpus(str(tmp_path / "c"), [(40, 40)])
    bad = os.path.join(root, "zz_bad.png")
    with open(bad, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + b"\x00" * 40)
    rng = np.random.default_rng(0)
    assert tdata._load_one(bad, 32, rng, True) is None
    assert jdata._load_one(bad, 32, np.random.default_rng(0), True) is None
    loader = tdata.ImageFolderLoader(root, batch_size=4, size=16, workers=1)
    try:
        assert next(loader)["l"].shape == (4, 1, 16, 16)
    finally:
        loader.close()
    jpg = os.path.join(root, "photo.jpg")
    with open(jpg, "wb") as f:
        f.write(b"\xff\xd8\xff\xe0" + b"\x00" * 64)
    monkeypatch.setattr(imageio, "_cv2", lambda: None)
    with pytest.raises(UnsupportedImage, match="OpenCV"):
        tdata._load_one(jpg, 32, rng, False)
    with pytest.raises(UnsupportedImage):
        tdd.DeviceDataset(root, size=16, store=32, device="cpu")
    loader = tdata.ImageFolderLoader(root, batch_size=8, size=16, workers=1)
    try:
        with pytest.raises(UnsupportedImage):
            for _ in range(4):
                next(loader)
    finally:
        loader.close()


def _jax_draws(key, n_images, batch, jitter, strong):
    """JAX's sample_batch draws, split as it splits its key."""
    r = jax.random
    k_a, k_b, k_rot, k_split = r.split(key, 4)
    d = {}

    def crops(k, prefix):
        k_idx, k_scale, k_y, k_x, k_flip = r.split(k, 5)
        d[prefix + "idx"] = r.randint(k_idx, (batch,), 0, n_images)
        d[prefix + "scale"] = r.uniform(k_scale, (batch,), minval=0.6,
                                        maxval=1.0)
        d[prefix + "uy"] = r.uniform(k_y, (batch,))
        d[prefix + "ux"] = r.uniform(k_x, (batch,))
        d[prefix + "flip"] = r.bernoulli(k_flip, 0.5, (batch,))

    crops(k_a, "")
    if jitter:
        crops(k_b, "b_")
        lo, hi = (0.5, 1.5) if strong else (0.7, 1.3)
        keys = r.split(k_rot, 4) if strong else r.split(k_rot)
        th, sat = [], []
        for k in keys:
            k_th, k_sat = r.split(k)
            th.append(r.uniform(k_th, (batch,), maxval=2.0 * jnp.pi))
            sat.append(r.uniform(k_sat, (batch,), minval=lo, maxval=hi))
        d["theta"], d["sat"] = jnp.stack(th), jnp.stack(sat)
        if strong:
            k_py, k_px, k_uv, k_uh = r.split(k_split, 4)
            d["pos_y"] = r.uniform(k_py, (batch,), minval=0.3, maxval=0.7)
            d["pos_x"] = r.uniform(k_px, (batch,), minval=0.3, maxval=0.7)
            d["use_v"] = r.bernoulli(k_uv, 0.85, (batch,))
            d["use_h"] = r.bernoulli(k_uh, 0.85, (batch,))
        else:
            k_pos, k_axis, k_use = r.split(k_split, 3)
            d["pos"] = r.uniform(k_pos, (batch,), minval=0.3, maxval=0.7)
            d["horiz"] = r.bernoulli(k_axis, 0.5, (batch,))
            d["use_b"] = r.bernoulli(k_use, 0.75, (batch,))
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.mark.parametrize("jitter", ["off", "on", "strong"])
def test_sample_batch_matches_jax_on_its_draws(jitter):
    """Crop, flip, Lab and (on, strong) the rotations and the region
    composite: L and ab within 2e-3 (measured: 1.6e-4, 2.3e-4, 2.8e-4; the
    crops agree to 1e-6, the rest is the two packages' f32 rgb -> Lab)."""
    imgs = np.stack([smooth_image(i, 48, 48) for i in range(5)])
    on, strong = jitter != "off", jitter == "strong"
    for seed in range(3):
        key = jax.random.key(seed)
        want = jdd.sample_batch(jnp.asarray(imgs), key, 6, 24,
                                color_jitter=on, strong=strong)
        got = tdd.batch_from_draws(torch.from_numpy(imgs),
                                   _jax_draws(key, 5, 6, on, strong), 24,
                                   on, strong)
        for k in ("l", "ab"):
            g = got[k].permute(0, 2, 3, 1).numpy()
            assert np.abs(g - np.asarray(want[k])).max() <= 2e-3, (seed, k)
    gen = torch.Generator().manual_seed(0)
    b = tdd.sample_batch(torch.from_numpy(imgs), gen, 4, 24, on, strong)
    assert b["l"].shape == (4, 1, 24, 24) and b["ab"].shape == (4, 2, 24, 24)
    assert float(b["l"].min()) >= -1e-3 and float(b["l"].max()) <= 100.01


def test_bilinear_crop_matches_jax():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (20, 30, 3)).astype(np.float32)
    ys = np.sort(rng.uniform(0, 19, 7)).astype(np.float32)
    xs = np.sort(rng.uniform(0, 29, 9)).astype(np.float32)
    want = np.asarray(jdd._bilinear_crop(jnp.asarray(img), ys, xs))
    got = tdd._bilinear_crop(torch.from_numpy(img)[None],
                             torch.from_numpy(ys)[None],
                             torch.from_numpy(xs)[None])[0]
    assert np.abs(got.numpy() - want).max() <= 1e-6


def test_device_dataset_on_the_cpu_and_its_budget(tmp_path, monkeypatch):
    root = corpus(str(tmp_path / "c"), [(90, 120), (77, 61), (50, 50)])
    ds = tdd.DeviceDataset(root, batch_size=4, size=24, store=40, seed=3,
                           color_jitter="strong", device="cpu")
    assert ds.n_images == 3 and ds.bytes_on_device == 3 * 40 * 40 * 3
    assert ds.strong and ds.color_jitter
    a, b = next(ds), next(ds)
    assert a["ab"].shape == (4, 2, 24, 24) and not torch.equal(a["ab"],
                                                               b["ab"])
    stored = np.asarray(Image.open(os.path.join(root, "img01.png")).resize(
        (40, 40), Image.BILINEAR))
    assert np.array_equal(ds._dev[1].numpy(), stored)
    for store, budget in ((288, 1 << 29), (40, 3 * 40 * 40 * 3),
                          (40, 3 * 40 * 40 * 3 - 1)):
        assert tdd.corpus_fits_on_device(root, store, budget) == \
            jdd.corpus_fits_on_device(root, store, budget)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdd.DeviceDataset(root, size=24, store=40)
