"""The port's API end to end against the JAX API, on the CPU: a scripted
session through ColorizeImageJax and ColorizeImageTorch(device="cpu") on
the bundled width-0.25 student, plus sentinels, the device default and the
port's isolation from JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ideepcolor_tpu import api as japi
from ideepcolor_tpu_torch import device as tdevice
from ideepcolor_tpu_torch.api import ColorizeImageTorch
from ideepcolor_tpu_torch.ops.hints import points_json_to_table, put_point

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDENT = os.path.join(ROOT, "weights", "student_w025.npz")
XD = 64


def _image(seed, H, W):
    """A seeded smooth color field with noise: image-like, not flat."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / max(H, W)
    base = np.stack([np.sin(6 * yy + c) * np.cos(5 * xx - 2 * c)
                     for c in range(3)], -1)
    return np.clip(127.5 + 100 * base + rng.normal(0, 12, (H, W, 3)),
                   0, 255).astype(np.uint8)


def _hints(n, seed):
    rng = np.random.default_rng(seed)
    return [{"y": int(rng.integers(0, XD)), "x": int(rng.integers(0, XD)),
             "ab": rng.uniform(-80, 80, 2).tolist(),
             "radius": int(rng.integers(0, 4))} for _ in range(n)]


def _session(m, load):
    """load_image_array of a 150x97 image (or set_image of a net-sized
    one), table clicks with 0, 1 and 5 hints, a dense click, getters."""
    out = {}
    if load == "array":
        m.load_image_array(_image(3, 150, 97))
    else:
        m.set_image(_image(4, XD, XD))
    out["gray"] = m.get_img_gray()
    out["gray_fullres"] = m.get_img_gray_fullres()
    for n in (0, 1, 5):
        out[f"table{n}"] = m.net_forward_table(
            *points_json_to_table(_hints(n, n), XD))
        out[f"ab_table{n}"] = m.output_ab.copy()
    out["input_ab"], out["input_mask"] = m.input_ab, m.input_mask
    out["fullres_table"] = m.get_img_fullres()
    ab = np.zeros((2, XD, XD), np.float32)
    mask = np.zeros((1, XD, XD), np.float32)
    for h in _hints(7, 9):
        put_point(ab, mask, [max(h["y"], 3), max(h["x"], 3)], 3, h["ab"])
    out["dense"] = m.net_forward(ab, mask)
    out["ab_dense"] = m.output_ab.copy()
    for g in ("get_img_fullres", "get_img_mask", "get_img_mask_fullres",
              "get_sup_img", "get_sup_fullres", "get_input_img"):
        out[g] = getattr(m, g)()
    out["psnr"] = m.get_result_PSNR()
    return out


@pytest.mark.parametrize("load", ["array", "set"])
def test_session_matches_jax(load):
    """Frames: <= 1 LSB on < 1% of the pixels (measured: 1 LSB on at most
    0.041% of a frame's pixels, most frames identical). output_ab is the
    ab of the frame's own Lab, so it agrees to 1e-3 wherever the frame
    agrees (measured 9e-5) and moves by up to ~0.6 at a pixel whose frame
    byte flipped. The hint mirrors of the table click are K1's output and
    equal the JAX host rasterizer's exactly."""
    jm = japi.ColorizeImageJax(Xd=XD)
    jm.prep_net(path=STUDENT)
    tm = ColorizeImageTorch(Xd=XD, device="cpu")
    tm.prep_net(path=STUDENT)
    want, got = _session(jm, load), _session(tm, load)
    assert set(want) == set(got)
    frames = {}
    for k, w in want.items():
        w, g = np.asarray(w), np.asarray(got[k])
        assert g.shape == w.shape, k
        if w.dtype == np.uint8:
            d = np.abs(g.astype(int) - w.astype(int)).max(-1)
            assert d.max() <= 1 and np.mean(d != 0) < 0.01, k
            frames[k] = d
    assert np.array_equal(got["input_ab"], want["input_ab"])
    assert np.array_equal(got["input_mask"], want["input_mask"])
    for ab_key, frame_key in (("ab_table0", "table0"), ("ab_table1", "table1"),
                              ("ab_table5", "table5"), ("ab_dense", "dense")):
        same = frames[frame_key] == 0
        d = np.abs(got[ab_key] - want[ab_key]).max(0)
        assert d[same].max() <= 1e-3, ab_key
    assert abs(got["psnr"] - want["psnr"]) < 1e-2


def test_table_click_equals_dense_click():
    """The K1 table click and the dense click with the same hints give the
    same frame (the rasterized planes are the dense hints)."""
    m = ColorizeImageTorch(Xd=XD, device="cpu")
    m.prep_net(path=STUDENT)
    m.set_image(_image(5, XD, XD))
    table = m.net_forward_table(*points_json_to_table(_hints(6, 2), XD))
    ab, mask = m.input_ab.copy(), m.input_mask.copy()
    assert mask.sum() > 0
    assert np.array_equal(m.net_forward(ab, mask), table)


def test_sentinels_and_shape_errors_match_jax():
    for cls, kw in ((japi.ColorizeImageJax, {}),
                    (ColorizeImageTorch, {"device": "cpu"})):
        m = cls(Xd=XD, **kw)
        z_ab, z_mask = np.zeros((2, XD, XD)), np.zeros((1, XD, XD))
        table = points_json_to_table([], XD)
        assert m.net_forward(z_ab, z_mask) == -1            # no image
        assert m.net_forward_table(*table) == -1
        m.set_image(_image(6, XD, XD))
        assert m.net_forward(z_ab, z_mask) == -1            # no net
        assert m.net_forward_table(*table) == -1
        with pytest.raises(ValueError):
            m.set_image(_image(6, XD + 1, XD))
        m.prep_net(path=STUDENT)
        with pytest.raises(ValueError):
            m.net_forward(np.zeros((XD, XD, 2)), z_mask)    # channel-last
        with pytest.raises(ValueError):
            m.net_forward(z_ab, np.zeros((XD, XD)))
        assert m.net_forward(z_ab, z_mask).shape == (XD, XD, 3)


def test_load_image_decodes_file_like_load_image_array(tmp_path):
    cv2 = pytest.importorskip("cv2")
    im = _image(7, 80, 120)
    path = str(tmp_path / "im.png")
    cv2.imwrite(path, cv2.cvtColor(im, cv2.COLOR_RGB2BGR))
    a, b = (ColorizeImageTorch(Xd=XD, device="cpu") for _ in range(2))
    a.load_image(path)
    b.load_image_array(im)
    assert np.array_equal(a.img_rgb, b.img_rgb)
    assert np.array_equal(a.get_img_gray_fullres(), b.get_img_gray_fullres())


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a usable CUDA device, an entry point that did not ask for
    the CPU raises instead of running there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ColorizeImageTorch(Xd=XD)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdevice.resolve_device("cuda")
    assert ColorizeImageTorch(Xd=XD, device="cpu").device.type == "cpu"


def test_port_imports_nothing_of_jax():
    """A fresh interpreter imports ideepcolor_tpu_torch and every module in
    it; no jax* and no ideepcolor_tpu.* module may enter sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ideepcolor_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'ideepcolor_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] == 'jax' or "
        "k.startswith(('jaxlib', 'ideepcolor_tpu.')) or "
        "k == 'ideepcolor_tpu')\n"
        "assert len(names) >= 15, names\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
