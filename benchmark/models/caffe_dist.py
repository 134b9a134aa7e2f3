"""The reference application's Caffe distribution graph
(``models/reference_model/deploy_nopred.prototxt``; Zhang et al. 2017,
arXiv:1705.02999): FLOPs, weights drawn from the seed, and the plain
reference forward.

The blob is ``[L - 50, hint ab, mask * 110]``. Trunk: ``bw_conv1_1(L) +
ab_conv1_1(ab, mask)``, ReLU; conv1-4 blocks of [conv ReLU] then a
normalize-only BatchNorm, the stride-2 steps slices; conv5-6 dilated 2;
conv7; ``conv8_1`` (k4 s2 p1 transposed) + ``conv3_3_short``, two convs,
norm. Hypercolumn head: conv3_pred + conv4..7_pred (transposed, up from
H/8) + conv8_pred at H/4, ReLU, ``pred_313``; two fixed bilinear x2
upsamplers (grouped transposed convs with the kernel below); softmax of
the logits x ``scale_S`` is the distribution, softmax x ``scale_T`` its
annealed mean over the 313 bin centers the predicted ab.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from reference.bins import pts_in_hull
from models.siggraph import precision

# (name, in, out, kernel, dilation, transposed)
_TRUNK = [
    ("bw_conv1_1", 1, 64, 3, 1, False), ("ab_conv1_1", 3, 64, 3, 1, False),
    ("conv1_2", 64, 64, 3, 1, False),
    ("conv2_1", 64, 128, 3, 1, False), ("conv2_2", 128, 128, 3, 1, False),
    ("conv3_1", 128, 256, 3, 1, False), ("conv3_2", 256, 256, 3, 1, False),
    ("conv3_3", 256, 256, 3, 1, False),
    ("conv4_1", 256, 512, 3, 1, False), ("conv4_2", 512, 512, 3, 1, False),
    ("conv4_3", 512, 512, 3, 1, False),
    ("conv5_1", 512, 512, 3, 2, False), ("conv5_2", 512, 512, 3, 2, False),
    ("conv5_3", 512, 512, 3, 2, False),
    ("conv6_1", 512, 512, 3, 2, False), ("conv6_2", 512, 512, 3, 2, False),
    ("conv6_3", 512, 512, 3, 2, False),
    ("conv7_1", 512, 512, 3, 1, False), ("conv7_2", 512, 512, 3, 1, False),
    ("conv7_3", 512, 512, 3, 1, False),
    ("conv8_1", 512, 256, 4, 1, True),
    ("conv3_3_short", 256, 256, 3, 1, False),
    ("conv8_2", 256, 256, 3, 1, False), ("conv8_3", 256, 256, 3, 1, False),
]
_HEAD = [
    ("conv3_pred", 256, 384, 3, 1, False),
    ("conv4_pred", 512, 384, 4, 1, True), ("conv5_pred", 512, 384, 4, 1, True),
    ("conv6_pred", 512, 384, 4, 1, True), ("conv7_pred", 512, 384, 4, 1, True),
    ("conv8_pred", 256, 384, 3, 1, False),
    ("pred_313", 384, 313, 1, 1, False),
]
_NORMS = [("conv1_2norm", 64), ("conv2_2norm", 128), ("conv3_3norm", 256),
          ("conv4_3norm", 512), ("conv5_3norm", 512), ("conv6_3norm", 512),
          ("conv7_3norm", 512), ("conv8_3norm", 256)]
# the output grid of each layer, as a divisor of the input size
_DIV = {"bw_conv1_1": 1, "ab_conv1_1": 1, "conv1_2": 1, "conv2_1": 2,
        "conv2_2": 2, "conv3_1": 4, "conv3_2": 4, "conv3_3": 4,
        "conv3_3_short": 4, "conv8_1": 4, "conv8_2": 4, "conv8_3": 4,
        "conv3_pred": 4, "conv4_pred": 4, "conv5_pred": 4, "conv6_pred": 4,
        "conv7_pred": 4, "conv8_pred": 4, "pred_313": 4}
# the fixed x2 bilinear kernel of the '*_us' layers (last row, column 0)
US_KERNEL = ((0.25, 0.5, 0.25, 0.0), (0.5, 1.0, 0.5, 0.0),
             (0.25, 0.5, 0.25, 0.0), (0.0, 0.0, 0.0, 0.0))


def _layers(cfg):
    bins = cfg["bins"]
    return _TRUNK + [(n, i, bins if n == "pred_313" else o, k, d, t)
                     for n, i, o, k, d, t in _HEAD]


def flops(cfg: dict, size: int) -> float:
    """Multiply-adds x 2 of one forward at ``size``: every conv and
    transposed conv (a transposed one counted on its input grid), the two
    grouped upsamplers, and the annealed mean's product."""
    total = 0.0
    for name, cin, cout, k, _d, tr in _layers(cfg):
        div = _DIV.get(name, 8)
        hw = (size // (div * 2 if tr else div)) ** 2
        total += 2.0 * cin * cout * k * k * hw
    q = cfg["bins"]
    for div in (4, 2):                     # the upsamplers' input grids
        total += 2.0 * q * 16 * (size // div) ** 2
    return total + 2.0 * q * 2 * size * size


def load_weights(cfg: dict, seed: int, device) -> dict:
    """He-normal convs (std sqrt(2 / (in * k * k)), zero biases) drawn on
    ``device`` from ``seed`` in one call, the prototxt's scale factors, and
    every norm calibrated: its mean and variance are those of its own input
    in one forward of a seeded batch (8 blobs of 64 x 64: smooth L planes,
    a few hint boxes), each layer after the layers before it are set."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    layers = _layers(cfg)
    shapes = [((i, o, k, k) if tr else (o, i, k, k)) for _n, i, o, k, _d, tr
              in layers]
    flat = torch.randn(sum(int(np.prod(s)) for s in shapes), generator=gen,
                       device=device)
    w, at = {}, 0
    for (name, cin, cout, k, _d, _tr), s in zip(layers, shapes):
        n = int(np.prod(s))
        w[f"{name}.weight"] = flat[at:at + n].view(s) * float(
            np.sqrt(2.0 / (cin * k * k)))
        w[f"{name}.bias"] = torch.zeros(cout, device=device)
        at += n
    for name, c in _NORMS:
        w[f"{name}.mean"] = torch.zeros(c, device=device)
        w[f"{name}.var"] = torch.ones(c, device=device)
    w["scale_S.scale"] = torch.tensor(cfg["scale_S"], device=device)
    w["scale_T.scale"] = torch.tensor(cfg["scale_T"], device=device)
    with precision("float32"), torch.no_grad():
        _trunk(w, _calibration_blob(gen, device), calibrate=True)
    return w


def _calibration_blob(gen, device, size: int = 64, batch: int = 8):
    u = lambda *s: torch.rand(s, generator=gen, device=device)  # noqa: E731
    yy = torch.arange(size, device=device)[:, None] / size
    xx = torch.arange(size, device=device)[None, :] / size
    blob = torch.zeros((batch, 4, size, size), device=device)
    f = 2 + 7 * u(batch, 2)
    noise = torch.randn((batch, size, size), generator=gen, device=device)
    for i in range(batch):
        blob[i, 0] = (50 * torch.sin(f[i, 0] * yy + i)
                      * torch.cos(f[i, 1] * xx - i) + 5 * noise[i])
        for _ in range(i % 4):
            y, x = (int(v) for v in (u(2) * (size - 7)))
            blob[i, 1:3, y:y + 7, x:x + 7] = (u(2) * 160 - 80)[:, None, None]
            blob[i, 3, y:y + 7, x:x + 7] = 110.0
    return blob


def _conv(w, x, name, dtype):
    wt, b = w[f"{name}.weight"].to(dtype), w[f"{name}.bias"].to(dtype)
    x = x.to(dtype)
    if wt.shape[-1] == 4:                     # the k4 s2 p1 transposed convs
        y = F.conv_transpose2d(x, wt, b, stride=2, padding=1)
    else:
        d = 2 if name[:5] in ("conv5", "conv6") else 1
        k = wt.shape[-1]
        y = F.conv2d(x, wt, b, padding=d * (k - 1) // 2, dilation=d)
    return y.to(torch.float32)


def _trunk(w, data, dtype=torch.float32, calibrate=False):
    relu = F.relu

    def norm(x, name):
        if calibrate:
            w[f"{name}.mean"] = x.mean(dim=(0, 2, 3))
            w[f"{name}.var"] = x.var(dim=(0, 2, 3), unbiased=False)
        m, v = w[f"{name}.mean"], w[f"{name}.var"]
        return (x - m[:, None, None]) / torch.sqrt(v[:, None, None] + 1e-5)

    c = lambda x, n: _conv(w, x, n, dtype)  # noqa: E731
    down = lambda x: x[:, :, ::2, ::2]  # noqa: E731
    x = relu(c(data[:, 0:1], "bw_conv1_1") + c(data[:, 1:4], "ab_conv1_1"))
    t = {"conv1_2norm": norm(relu(c(x, "conv1_2")), "conv1_2norm")}
    x = relu(c(down(t["conv1_2norm"]), "conv2_1"))
    t["conv2_2norm"] = norm(relu(c(x, "conv2_2")), "conv2_2norm")
    x = relu(c(down(t["conv2_2norm"]), "conv3_1"))
    x = relu(c(x, "conv3_2"))
    t["conv3_3norm"] = norm(relu(c(x, "conv3_3")), "conv3_3norm")
    x = relu(c(down(t["conv3_3norm"]), "conv4_1"))
    x = relu(c(x, "conv4_2"))
    t["conv4_3norm"] = norm(relu(c(x, "conv4_3")), "conv4_3norm")
    x = t["conv4_3norm"]
    for blk in ("conv5", "conv6", "conv7"):
        for i in (1, 2, 3):
            x = relu(c(x, f"{blk}_{i}"))
        x = t[f"{blk}_3norm"] = norm(x, f"{blk}_3norm")
    x = relu(c(x, "conv8_1") + c(t["conv3_3norm"], "conv3_3_short"))
    x = relu(c(x, "conv8_2"))
    t["conv8_3norm"] = norm(relu(c(x, "conv8_3")), "conv8_3norm")
    return t


def _up2(x):
    k = torch.tensor(US_KERNEL, dtype=x.dtype, device=x.device)
    return F.conv_transpose2d(x, k.expand(x.shape[1], 1, 4, 4), stride=2,
                              padding=1, groups=x.shape[1])


def forward(w: dict, cfg: dict, l: torch.Tensor, ab: torch.Tensor,
            mask: torch.Tensor, dtype=torch.float32):
    """l (N,1,S,S) L in [0, 100]; ab (N,2,S,S); mask (N,1,S,S) in {0, 1}
    -> (pred_ab (N,2,S,S), dist (N,S,S,313) bins last). ``dtype`` is the
    convs' compute type; softmaxes and the mean are float32."""
    data = torch.cat([l - 50.0, ab, mask * 110.0], 1)
    t = _trunk(w, data, dtype)
    c = lambda x, n: _conv(w, x, n, dtype)  # noqa: E731
    h = sum(c(t[f"conv{i}_3norm"], f"conv{i}_pred") for i in range(3, 9))
    logits = _up2(_up2(c(F.relu(h), "pred_313"))).permute(0, 2, 3, 1)
    dist = torch.softmax(logits * w["scale_S.scale"], dim=-1)
    dist_t = torch.softmax(logits * w["scale_T.scale"], dim=-1)
    pts = torch.from_numpy(pts_in_hull()).to(logits.device)
    pred = dist_t @ pts
    return pred.permute(0, 3, 1, 2), dist


def reference(w: dict, cfg: dict, l, ab, mask, prec: str) -> dict:
    """The dense click's prediction and distribution at ``prec``, as
    :func:`models.siggraph.reference`."""
    dtype = torch.bfloat16 if prec == "bfloat16" else torch.float32
    with precision("tf32" if prec == "tf32" else "float32"):
        pred, dist = forward(w, cfg, l, ab, mask, dtype)
    return {"pred": pred, "map": dist}
