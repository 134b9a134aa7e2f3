"""The port's serving precisions against the JAX package's, on the CPU:
``prep_net(dtype="bfloat16")`` (bf16 weights, f32 accumulation) and
``precision_name="default"`` (TF32 on the card, f32 on the CPU), at Xd=64 on
the bundled width-0.25 student. f32 parity stays the default."""

import os

import numpy as np
import pytest
import torch
from torch import nn

from ideepcolor_tpu import api as japi
from ideepcolor_tpu_torch import device as tdevice
from ideepcolor_tpu_torch.api import (ColorizeImageTorch,
                                      ColorizeImageTorchDist)
from ideepcolor_tpu_torch.engine.batch import frame_delta_stats
from ideepcolor_tpu_torch.models.siggraph import (SIGGRAPHGenerator,
                                                  init_state_dict)
from ideepcolor_tpu_torch.ops.hints import points_json_to_table

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDENT = os.path.join(ROOT, "weights", "student_w025.npz")
XD = 64


def _image(seed, H, W):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / max(H, W)
    base = np.stack([np.sin(6 * yy + c) * np.cos(5 * xx - 2 * c)
                     for c in range(3)], -1)
    return np.clip(127.5 + 100 * base + rng.normal(0, 12, (H, W, 3)),
                   0, 255).astype(np.uint8)


def _table(n, seed=1):
    rng = np.random.default_rng(seed)
    return points_json_to_table(
        [{"y": int(rng.integers(0, XD)), "x": int(rng.integers(0, XD)),
          "ab": rng.uniform(-80, 80, 2).tolist(),
          "radius": int(rng.integers(0, 4))} for _ in range(n)], XD)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


@pytest.fixture(scope="module")
def clicks():
    """Table clicks with 0 and 5 hints through four models: JAX and port,
    f32 and bf16. frames[(backend, dtype, n)] and abs[...]."""
    frames, abs_ = {}, {}
    for dtype in (None, "bfloat16"):
        jm = japi.ColorizeImageJax(Xd=XD)
        jm.prep_net(path=STUDENT, dtype=dtype)
        tm = ColorizeImageTorch(Xd=XD, device="cpu")
        tm.prep_net(path=STUDENT, dtype=dtype)
        for name, m in (("jax", jm), ("port", tm)):
            m.load_image_array(_image(3, 150, 97))
            for n in (0, 5):
                frames[name, dtype, n] = m.net_forward_table(
                    *_table(n, n)).copy()
                abs_[name, dtype, n] = np.asarray(m.output_ab).copy()
    return frames, abs_


@pytest.mark.parametrize("n", [0, 5])
def test_bf16_click_matches_jax_bf16(clicks, n):
    """bf16 port against bf16 JAX, same weights and table: at most 4 LSB,
    PSNR at least 50 dB (measured: 1 LSB and 74.7 dB without hints, 2 LSB
    and 57.1 dB with five). The two round at other places (the JAX package
    also rounds ``x - mean`` and ``tanh * 110`` to bf16), so they are not
    held bit for bit."""
    frames, _ = clicks
    got, want = frames["port", "bfloat16", n], frames["jax", "bfloat16", n]
    max_lsb, _eq = frame_delta_stats(got, want)
    assert max_lsb <= 4 and _psnr(got, want) >= 50.0


@pytest.mark.parametrize("n", [0, 5])
def test_bf16_click_stays_near_f32(clicks, n):
    """bf16 against f32 in the port: at most 6 LSB, PSNR at least 45 dB,
    output_ab within 4 (measured: 2 LSB, 53.7 dB, 1.55), and no further
    from f32 than the JAX package's bf16 is from its f32, within 1 dB."""
    frames, abs_ = clicks
    got, f32 = frames["port", "bfloat16", n], frames["port", None, n]
    max_lsb, _eq = frame_delta_stats(got, f32)
    assert max_lsb <= 6 and _psnr(got, f32) >= 45.0
    assert np.abs(abs_["port", "bfloat16", n]
                  - abs_["port", None, n]).max() <= 4.0
    jax_psnr = _psnr(frames["jax", "bfloat16", n], frames["jax", None, n])
    assert _psnr(got, f32) >= jax_psnr - 1.0
    assert not np.array_equal(got, f32)          # the cast did happen


def test_bf16_dist_map_matches_jax_bf16_and_f32():
    """The distribution map of a bf16 dist backend: within 2e-3 of the JAX
    bf16 map (measured 4.0e-4) and within 1e-2 of the port's f32 map
    (measured 1.6e-3); rows still sum to 1."""
    maps = {}
    for name, cls, kw, dtype in (
            ("jax", japi.ColorizeImageJaxDist, {}, "bfloat16"),
            ("port", ColorizeImageTorchDist, {"device": "cpu"}, "bfloat16"),
            ("f32", ColorizeImageTorchDist, {"device": "cpu"}, None)):
        d = cls(Xd=XD, **kw)
        d.prep_net(path=STUDENT, dtype=dtype)
        d.set_image(_image(4, XD, XD))
        assert d.predict_dist_table(*_table(5, 5)) == 0
        maps[name] = np.asarray(d._dev_dist)
    assert maps["port"].dtype == np.float32
    assert np.abs(maps["port"] - maps["jax"]).max() <= 2e-3
    assert np.abs(maps["port"] - maps["f32"]).max() <= 1e-2
    assert np.abs(maps["port"].sum(-1) - 1).max() <= 1e-5


def test_cast_weights_stores_convs_in_bf16_and_keeps_batchnorm_f32():
    """The weights are stored in bf16 (not cast on every call); BatchNorm
    computes in f32 on parameters rounded through bf16, as the JAX
    package's ``_cast_params`` rounds every parameter; every conv gives f32
    back; ``dtype=None`` changes nothing."""
    sd = init_state_dict(0.125)
    for k in sd:                                 # not exactly representable
        if k.endswith(("running_mean", "running_var")):
            sd[k] = sd[k] + 0.123456789
    f32 = SIGGRAPHGenerator.from_state_dict(sd)
    assert f32.cast_weights_(None) is f32
    for k, v in f32.state_dict().items():
        assert torch.equal(v, sd[k]), k
    net = SIGGRAPHGenerator.from_state_dict(sd).cast_weights_("bfloat16")
    seen = []
    for name, m in net.named_modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            assert m.weight.dtype == m.bias.dtype == torch.bfloat16, name
            m.register_forward_hook(
                lambda mod, i, o: seen.append((i[0].dtype, o.dtype)))
        elif isinstance(m, nn.BatchNorm2d):
            for t, key in ((m.running_mean, "running_mean"),
                           (m.running_var, "running_var")):
                assert t.dtype == torch.float32
                want = sd[f"{name}.{key}"].to(torch.bfloat16).float()
                assert torch.equal(t, want) and not torch.equal(
                    t, sd[f"{name}.{key}"])
    x = torch.zeros(1, 1, 16, 16)
    out = net(x, torch.zeros(1, 2, 16, 16), torch.zeros(1, 1, 16, 16))
    assert out.dtype == torch.float32 and len(seen) == 30    # all but model_class
    # each conv was handed f32 and gave f32 back around its bf16 product
    assert all(i == o == torch.float32 for i, o in seen)


def test_precision_is_scoped_to_the_forward():
    """``precision_name="default"`` sets the two TF32 flags for the forward
    only and puts them back, whatever they were; "highest" clears them for
    the forward; another name raises as the JAX package's lookup does. On
    the CPU both modes compute the same f32."""
    net = SIGGRAPHGenerator.from_state_dict(init_state_dict(0.125))
    flags = []
    net.model1[0].register_forward_hook(lambda *a: flags.append(
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32)))
    args = (torch.rand(1, 1, 16, 16), torch.zeros(1, 2, 16, 16),
            torch.zeros(1, 1, 16, 16))
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    try:
        for outer in ((True, False), (False, True)):
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = outer
            with torch.no_grad():
                hi = net(*args)
                lo = net(*args, precision_name="default")
            assert (torch.backends.cudnn.allow_tf32,
                    torch.backends.cuda.matmul.allow_tf32) == outer
            assert torch.equal(hi, lo)
        assert flags == [(False, False), (True, True)] * 2
        with pytest.raises(KeyError):
            net(*args, precision_name="fastest")
        with pytest.raises(RuntimeError):        # restored on an error too
            with tdevice.conv_precision("default"):
                raise RuntimeError("inside")
        assert (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32) == outer
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before


def test_f32_parity_is_the_default_of_the_api():
    """``prep_net`` without ``dtype`` keeps every parameter f32 and equal to
    the checkpoint; the dist class passes ``dtype`` through."""
    m = ColorizeImageTorch(Xd=XD, device="cpu")
    m.prep_net(path=STUDENT)
    assert all(p.dtype == torch.float32 for p in m.net.parameters())
    d = ColorizeImageTorchDist(Xd=XD, device="cpu")
    d.prep_net(path=STUDENT, dtype="bfloat16")
    assert d.net.model1[0].weight.dtype == torch.bfloat16
    assert d.net.model1[4].weight.dtype == torch.float32
