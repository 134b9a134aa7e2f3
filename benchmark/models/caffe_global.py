"""The reference application's global-hints Caffe graph
(``models/global_model/deploy_nodist.prototxt``; Zhang et al. 2017,
arXiv:1705.02999, section 3.3): FLOPs, weights drawn from the seed, and the
plain reference forward.

The trunk is the distribution graph's (``models.caffe_dist``) with an
L-only ``bw_conv1_1`` (no hint branch: the blob's hint channels feed no
layer). A 1x1-conv MLP takes the 314-channel histogram blob (313 bins and
an on/off flag) and the 2-channel saturation blob: ``s_conv1(s) +
glob_conv1(g)``, ReLU, norm, then ``glob_conv2..4`` each [conv ReLU norm];
its (N, 512) output is added at every pixel after ``conv4_3norm``.
Regression head: ``conv9_1`` (k4 s2 p1 transposed) + ``conv2_2_short``,
ReLU, ``conv9_2`` ReLU norm; ``conv10_1`` (transposed) +
``conv1_2_short``, ReLU, ``conv10_2`` ReLU; ``conv10_ab`` (1x1), tanh,
``pred_ab.scale`` (100). Every norm is Caffe's normalize-only BatchNorm.
The saturation blob is zeros, as the reference application's GUI and
notebook feed it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from models.caffe_dist import _DIV, _TRUNK, _calibration_blob, _conv
from models.siggraph import precision
from reference.glob_stats import histogram

# (name, in, out, kernel, dilation, transposed), as in models.caffe_dist
_HEAD = [
    ("conv9_1", 256, 128, 4, 1, True),
    ("conv2_2_short", 128, 128, 3, 1, False),
    ("conv9_2", 128, 128, 3, 1, False),
    ("conv10_1", 128, 128, 4, 1, True),
    ("conv1_2_short", 64, 128, 3, 1, False),
    ("conv10_2", 128, 128, 3, 1, False),
    ("conv10_ab", 128, 2, 1, 1, False),
]
_MLP = [
    ("s_conv1", 2, 512, 1, 1, False), ("glob_conv1", 314, 512, 1, 1, False),
    ("glob_conv2", 512, 512, 1, 1, False),
    ("glob_conv3", 512, 512, 1, 1, False),
    ("glob_conv4", 512, 512, 1, 1, False),
]
_LAYERS = [t for t in _TRUNK if t[0] != "ab_conv1_1"] + _HEAD + _MLP
_NORMS = [("conv1_2norm", 64), ("conv2_2norm", 128), ("conv3_3norm", 256),
          ("conv4_3norm", 512), ("conv5_3norm", 512), ("conv6_3norm", 512),
          ("conv7_3norm", 512), ("conv8_3norm", 256), ("conv9_2norm", 128),
          ("s_glob_conv1norm", 512), ("glob_conv2norm", 512),
          ("glob_conv3norm", 512), ("glob_conv4norm", 512)]
# the head's output grids, as a divisor of the input size (a transposed
# conv's is its output's); the trunk's are ``models.caffe_dist``'s
_HEAD_DIV = {"conv9_1": 2, "conv2_2_short": 2, "conv9_2": 2, "conv10_1": 1,
             "conv1_2_short": 1, "conv10_2": 1, "conv10_ab": 1}


def flops(cfg: dict, size: int) -> float:
    """Multiply-adds x 2 of one forward at ``size``: every conv and
    transposed conv (a transposed one counted on its input grid) of the
    trunk and the head, and the MLP's on its one pixel: 150.17 GFLOP at
    256 x 256."""
    total = 0.0
    for name, cin, cout, k, _d, tr in _LAYERS:
        if (name, cin, cout, k, _d, tr) in _MLP:
            hw = 1
        else:
            div = _HEAD_DIV.get(name, _DIV.get(name, 8))
            hw = (size // (div * 2 if tr else div)) ** 2
        total += 2.0 * cin * cout * k * k * hw
    return total


def load_weights(cfg: dict, seed: int, device) -> dict:
    """The program's state dict, drawn on ``device`` from ``seed``:
    He-normal convs (std sqrt(2 / (in * k * k)), zero biases) in one call,
    ``pred_ab.scale`` 100, and every norm calibrated, each after the layers
    before it are set: the MLP's four on the histograms of a seeded batch of
    64 color fields of 64 x 64 (``reference.glob_stats``), the trunk's and
    the head's on 8 seeded blobs of 64 x 64 (``models.caffe_dist``'s) with
    the first 8 of those histograms."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    shapes = [((i, o, k, k) if tr else (o, i, k, k)) for _n, i, o, k, _d, tr
              in _LAYERS]
    flat = torch.randn(sum(int(np.prod(s)) for s in shapes), generator=gen,
                       device=device)
    w, at = {}, 0
    for (name, cin, cout, k, _d, _tr), s in zip(_LAYERS, shapes):
        n = int(np.prod(s))
        w[f"{name}.weight"] = flat[at:at + n].view(s) * float(
            np.sqrt(2.0 / (cin * k * k)))
        w[f"{name}.bias"] = torch.zeros(cout, device=device)
        at += n
    for name, c in _NORMS:
        w[f"{name}.mean"] = torch.zeros(c, device=device)
        w[f"{name}.var"] = torch.ones(c, device=device)
    w["pred_ab.scale"] = torch.tensor(100.0, device=device)
    with precision("float32"), torch.no_grad():
        hists = histogram(_color_fields(gen, device, 64, 64))
        emb = _mlp(w, hists, calibrate=True)
        blob = _calibration_blob(gen, device)
        _forward(w, blob[:, :1] + 50.0, emb[:len(blob)], calibrate=True)
    return w


def _color_fields(gen, device, n: int, size: int) -> torch.Tensor:
    """(n, size, size, 3) float RGB in [0, 1]: per channel a product of a
    sine and a cosine of seeded frequencies and phases, plus noise, as the
    cell's images (``harness.inputs.image``)."""
    u = torch.rand((n, 3, 4), generator=gen, device=device)
    f, p = 3.0 + 6.0 * u[..., :2], 2 * np.pi * u[..., 2:]
    ax = torch.arange(size, device=device, dtype=torch.float32) / size
    yy, xx = ax[:, None], ax[None, :]
    base = (torch.sin(f[..., 0, None, None] * yy + p[..., 0, None, None])
            * torch.cos(f[..., 1, None, None] * xx + p[..., 1, None, None]))
    noise = torch.randn((n, 3, size, size), generator=gen, device=device)
    img = (127.5 + 100.0 * base + 12.0 * noise).clamp(0, 255).floor()
    return (img / 255.0).permute(0, 2, 3, 1)


def _norm(w, x, name, calibrate):
    if calibrate:
        w[f"{name}.mean"] = x.mean(dim=(0, 2, 3))
        w[f"{name}.var"] = x.var(dim=(0, 2, 3), unbiased=False)
    m, v = w[f"{name}.mean"], w[f"{name}.var"]
    return (x - m[:, None, None]) / torch.sqrt(v[:, None, None] + 1e-5)


def _mlp(w, hist, calibrate=False):
    """(N, 313) histograms -> (N, 512) embedding: the blob is the histogram
    and the flag 1; the saturation blob is zeros."""
    n = hist.shape[0]
    g = torch.cat([hist, torch.ones((n, 1), device=hist.device)], 1)
    s = torch.zeros((n, 2), device=hist.device)
    c = lambda x, name: _conv(w, x, name, torch.float32)  # noqa: E731
    x = F.relu(c(s[:, :, None, None], "s_conv1")
               + c(g[:, :, None, None], "glob_conv1"))
    x = _norm(w, x, "s_glob_conv1norm", calibrate)
    for i in (2, 3, 4):
        x = _norm(w, F.relu(c(x, f"glob_conv{i}")), f"glob_conv{i}norm",
                  calibrate)
    return x[:, :, 0, 0]


def _forward(w, l, emb, calibrate=False):
    """l (N,1,S,S) L in [0, 100], emb (N,512) -> (N,2,S,S) pred_ab."""
    relu = F.relu
    c = lambda x, name: _conv(w, x, name, torch.float32)  # noqa: E731
    norm = lambda x, name: _norm(w, x, name, calibrate)  # noqa: E731
    down = lambda x: x[:, :, ::2, ::2]  # noqa: E731
    x = relu(c(l - 50.0, "bw_conv1_1"))
    n1 = norm(relu(c(x, "conv1_2")), "conv1_2norm")
    x = relu(c(down(n1), "conv2_1"))
    n2 = norm(relu(c(x, "conv2_2")), "conv2_2norm")
    x = relu(c(down(n2), "conv3_1"))
    x = relu(c(x, "conv3_2"))
    n3 = norm(relu(c(x, "conv3_3")), "conv3_3norm")
    x = relu(c(down(n3), "conv4_1"))
    x = relu(c(x, "conv4_2"))
    x = norm(relu(c(x, "conv4_3")), "conv4_3norm") + emb[:, :, None, None]
    for blk in ("conv5", "conv6", "conv7"):
        for i in (1, 2, 3):
            x = relu(c(x, f"{blk}_{i}"))
        x = norm(x, f"{blk}_3norm")
    x = relu(c(x, "conv8_1") + c(n3, "conv3_3_short"))
    x = relu(c(x, "conv8_2"))
    x = norm(relu(c(x, "conv8_3")), "conv8_3norm")
    x = relu(c(x, "conv9_1") + c(n2, "conv2_2_short"))
    x = norm(relu(c(x, "conv9_2")), "conv9_2norm")
    x = relu(c(x, "conv10_1") + c(n1, "conv1_2_short"))
    x = relu(c(x, "conv10_2"))
    return torch.tanh(c(x, "conv10_ab")) * w["pred_ab.scale"]


def reference(w: dict, cfg: dict, l: torch.Tensor, hist: torch.Tensor,
              prec: str) -> dict:
    """l (N,1,S,S) L in [0, 100], hist (N,313) -> {"pred": (N,2,S,S)}, the
    convs at ``prec`` ("float32" with TF32 off, or "tf32")."""
    with precision("tf32" if prec == "tf32" else "float32"):
        return {"pred": _forward(w, l, _mlp(w, hist))}
