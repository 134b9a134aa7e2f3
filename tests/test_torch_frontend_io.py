"""The port's copies of the OpenCV steps that decide the front-ends' pixels,
and image input without OpenCV, on the CPU.

* ``ops/resize.resize_u8_cubic`` is ``cv2.resize(..., INTER_CUBIC)`` on
  uint8 bit for bit, as OpenCV computes it. A cv2 built with IPP (the pip
  wheel) hands INTER_CUBIC to IPP by default, whose float arithmetic rounds
  differently at near-half values (1 LSB on a few percent of the pixels),
  so the comparison switches IPP off (``cv2.ipp.setUseIPP(False)``).
* ``utils/imageio.rgb_to_gray_u8`` is ``cvtColor(RGB2GRAY)`` on uint8 bit
  for bit (IPP on or off), over every 8-bit color.
* ``ColorizeImageBase.load_image``, ``read_image`` and the demos decode
  PNG files without OpenCV: with ``cv2`` made unimportable a PNG gives what
  cv2.imread + BGR2RGB gives, and a JPEG raises UnsupportedImage.
"""

import os
import sys

import numpy as np
import pytest
import torch

import cv2

from ideepcolor_tpu_torch.api import ColorizeImageTorch
from ideepcolor_tpu_torch.ops.resize import resize_u8_cubic
from ideepcolor_tpu_torch.utils.imageio import (UnsupportedImage,
                                                encode_png, read_image,
                                                rgb_to_gray_u8)

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDENT = os.path.join(ROOT, "weights", "student_w025.npz")


def _image(seed, H, W):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / max(H, W)
    base = np.stack([np.sin(6 * yy + c) * np.cos(5 * xx - 2 * c)
                     for c in range(3)], -1)
    return np.clip(127.5 + 100 * base + rng.normal(0, 12, (H, W, 3)),
                   0, 255).astype(np.uint8)


@pytest.fixture
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


def _gui_sizes(H, W, win=512):
    r = win / float(max(H, W))
    return int(round(r * H / 4.0) * 4), int(round(r * W / 4.0) * 4)


@pytest.mark.parametrize("src,dst,ch", [
    # the GUI's three calls on a 1000x750 and a 750x1000 image: the window
    # (qt_gui.py:133), the gray window (:140), the load-size image (:143)
    ((750, 1000), _gui_sizes(750, 1000), 3),
    ((1000, 750), _gui_sizes(1000, 750), 3),
    ((750, 1000), (256, 256), 3),
    # up- and down-scaling, sizes not multiples of 4, one channel
    ((61, 47), (131, 93), 3),
    ((64, 64), (256, 256), 3),
    ((333, 501), (37, 22), 3),
    ((37, 53), (17, 22), 1),
    ((5, 3), (7, 2), 3),
    ((90, 90), (90, 90), 3),
])
def test_resize_u8_cubic_is_cv2_bit_for_bit(no_ipp, src, dst, ch):
    rng = np.random.default_rng(sum(src) + sum(dst))
    im = rng.integers(0, 256, src + (ch,), dtype=np.uint8)
    want = cv2.resize(im, dst[::-1], interpolation=cv2.INTER_CUBIC)
    got = resize_u8_cubic(torch.from_numpy(im), dst).numpy()
    np.testing.assert_array_equal(got, want.reshape(got.shape))


def test_resize_u8_cubic_on_random_shapes(no_ipp):
    """200 seeded shapes from 1 to 89 px a side, one and three channels:
    the vectorized part of the vertical pass (f32) and its integer tail
    both match."""
    rng = np.random.default_rng(5)
    for _ in range(200):
        H, W, h, w = (int(v) for v in rng.integers(1, 90, 4))
        ch = int(rng.choice([1, 3]))
        im = rng.integers(0, 256, (H, W, ch), dtype=np.uint8)
        want = cv2.resize(im, (w, h), interpolation=cv2.INTER_CUBIC)
        got = resize_u8_cubic(torch.from_numpy(im), (h, w)).numpy()
        np.testing.assert_array_equal(got, want.reshape(got.shape),
                                      err_msg=str((H, W, h, w, ch)))


def test_resize_u8_cubic_refuses_other_arrays():
    with pytest.raises(ValueError):
        resize_u8_cubic(torch.zeros((4, 4, 3)), (2, 2))
    with pytest.raises(ValueError):
        resize_u8_cubic(torch.zeros((4, 4), dtype=torch.uint8), (2, 2))


@pytest.mark.parametrize("ipp", [True, False])
def test_rgb_to_gray_u8_is_cv2_over_every_color(ipp):
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(ipp)
    try:
        v = np.arange(256, dtype=np.uint8)
        r, g, b = np.meshgrid(v, v, v, indexing="ij")
        rgb = np.stack([r, g, b], -1).reshape(4096, 4096, 3)
        want = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
        np.testing.assert_array_equal(rgb_to_gray_u8(rgb), want)
        np.testing.assert_array_equal(
            rgb_to_gray_u8(rgb[:7, :9]),
            cv2.cvtColor(np.ascontiguousarray(rgb[:7, :9, ::-1]),
                         cv2.COLOR_BGR2GRAY))
    finally:
        cv2.ipp.setUseIPP(was)
    with pytest.raises(ValueError):
        rgb_to_gray_u8(np.zeros((4, 4), np.uint8))


def _png_files(tmp_path):
    """A color PNG written by cv2, a gray PNG (IMREAD_COLOR expands it to
    three channels) and a color PNG from the port's encoder, each with the
    array cv2.imread + BGR2RGB gives for it."""
    color = _image(7, 80, 120)
    gray = _image(8, 45, 31)[..., 0]
    files = {}
    p = str(tmp_path / "color.png")
    cv2.imwrite(p, cv2.cvtColor(color, cv2.COLOR_RGB2BGR))
    files[p] = color
    p = str(tmp_path / "gray.png")
    cv2.imwrite(p, gray)
    files[p] = np.repeat(gray[..., None], 3, axis=2)
    p = str(tmp_path / "port.png")
    with open(p, "wb") as f:
        f.write(encode_png(color[::-1]))
    files[p] = color[::-1]
    for p, want in files.items():
        np.testing.assert_array_equal(
            cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB), want)
    jpg = str(tmp_path / "im.jpg")
    cv2.imwrite(jpg, color)
    return files, jpg


def test_load_image_needs_no_opencv(tmp_path, monkeypatch):
    """The repair: load_image reads PNG files with cv2 unimportable, equal
    to load_image_array of what cv2 decodes; a JPEG raises UnsupportedImage
    naming the package; a missing file FileNotFoundError."""
    files, jpg = _png_files(tmp_path)
    monkeypatch.setitem(sys.modules, "cv2", None)
    for path, want in files.items():
        np.testing.assert_array_equal(read_image(path), want)
        a, b = (ColorizeImageTorch(Xd=32, device="cpu") for _ in range(2))
        a.load_image(path)
        b.load_image_array(want)
        np.testing.assert_array_equal(a.img_rgb_fullres, want)
        np.testing.assert_array_equal(a.img_rgb, b.img_rgb)
        np.testing.assert_array_equal(a.get_img_gray_fullres(),
                                      b.get_img_gray_fullres())
    m = ColorizeImageTorch(Xd=32, device="cpu")
    with pytest.raises(UnsupportedImage, match="cv2"):
        m.load_image(jpg)
    with pytest.raises(FileNotFoundError):
        m.load_image(str(tmp_path / "missing.png"))


def test_demos_need_no_opencv(tmp_path, monkeypatch):
    """The demos take PNG paths and write PNGs with cv2 unimportable; a
    path gives what its decoded array gives."""
    from ideepcolor_tpu_torch.apps import demos
    files, jpg = _png_files(tmp_path)
    path = str(tmp_path / "color.png")
    monkeypatch.setitem(sys.modules, "cv2", None)
    by_path = demos.demo_local_hints(path, weights=STUDENT, Xd=32,
                                     backend="siggraph", device="cpu")
    by_array = demos.demo_local_hints(files[path], weights=STUDENT, Xd=32,
                                      backend="siggraph", device="cpu")
    assert by_path.keys() == by_array.keys()
    for k in by_path:
        np.testing.assert_array_equal(by_path[k], by_array[k])
    with pytest.raises(UnsupportedImage):
        demos.demo_local_hints(jpg, weights=STUDENT, Xd=32,
                               backend="siggraph", device="cpu")
    out = tmp_path / "out"
    monkeypatch.setattr(demos, "demo_local_hints",
                        lambda img: {"auto": read_image(img)})
    assert demos.main([path, str(out)]) == 0
    np.testing.assert_array_equal(read_image(str(out / "local_auto.png")),
                                  files[path])
