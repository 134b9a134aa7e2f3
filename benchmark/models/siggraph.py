"""SIGGRAPHGenerator (Zhang et al. 2017, arXiv:1705.02999; the reference
application's ``models/pytorch/model.py``): FLOPs, weights and the plain
reference forward.

The net: input ``cat((L - 50) / 100, ab / 110, mask)``; model1-4 [conv ReLU]
x2-3 then BatchNorm, each after a stride-2 slice (model2-4); model5-6 the
same, dilated 2; model7; three k4 s2 p1 transposed convs up (model8up,
9up, 10up) added to 3x3 shortcut convs of model3, 2 and 1; model8-9 lead
with a ReLU; model10 is ReLU, conv, LeakyReLU(0.2); ``tanh(1x1 conv) *
110``. The class head is a 1x1 conv to 529 bins on model8's output,
softmax of its logits x 0.2, at a quarter of the size.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

def _spec(w):
    """(block, convs as (in, out, kernel, dilation), BatchNorm after,
    leading ReLU, resolution divisor) at the widths ``w``; the class
    head's out is the configuration's bin count (None here)."""
    c1, c2, c3, c4 = w
    return [
        ("model1", [(4, c1, 3, 1), (c1, c1, 3, 1)], True, False, 1),
        ("model2", [(c1, c2, 3, 1), (c2, c2, 3, 1)], True, False, 2),
        ("model3", [(c2, c3, 3, 1), (c3, c3, 3, 1), (c3, c3, 3, 1)], True,
         False, 4),
        ("model4", [(c3, c4, 3, 1), (c4, c4, 3, 1), (c4, c4, 3, 1)], True,
         False, 8),
        ("model5", [(c4, c4, 3, 2)] * 3, True, False, 8),
        ("model6", [(c4, c4, 3, 2)] * 3, True, False, 8),
        ("model7", [(c4, c4, 3, 1)] * 3, True, False, 8),
        ("model8up", [(c4, c3, 4, 1)], False, False, 4),
        ("model3short8", [(c3, c3, 3, 1)], False, False, 4),
        ("model8", [(c3, c3, 3, 1)] * 2, True, True, 4),
        ("model9up", [(c3, c2, 4, 1)], False, False, 2),
        ("model2short9", [(c2, c2, 3, 1)], False, False, 2),
        ("model9", [(c2, c2, 3, 1)], True, True, 2),
        ("model10up", [(c2, c2, 4, 1)], False, False, 1),
        ("model1short10", [(c1, c2, 3, 1)], False, False, 1),
        ("model10", [(c2, c2, 3, 1)], False, True, 1),
        ("model_out", [(c2, 2, 1, 1)], False, False, 1),
        ("model_class", [(c3, None, 1, 1)], False, False, 4),
    ]


_DECONV = {"model8up", "model9up", "model10up"}


def _indices(block, n_convs, bn):
    """The Sequential indices of a block's convs and BatchNorm."""
    start = 1 if block in ("model8", "model9", "model10") else 0
    convs = [start + 2 * i for i in range(n_convs)]
    return convs, (convs[-1] + 2 if bn else None)


def flops(cfg: dict, size: int, dist: bool = False) -> float:
    """Multiply-adds x 2 of one forward at ``size`` x ``size``: every conv
    and transposed conv, from the configuration's widths; ``dist`` adds
    the class head."""
    total = 0.0
    for block, convs, _bn, _relu, div in _spec(cfg["widths"]):
        if block == "model_class" and not dist:
            continue
        for cin, cout, k, _d in convs:
            cout = cfg["class_bins"] if cout is None else cout
            if block in _DECONV:          # counted on the input grid
                hw = (size // (div * 2)) ** 2
            else:
                hw = (size // div) ** 2
            total += 2.0 * cin * cout * k * k * hw
    return total


def load_weights(cfg: dict, seed: int, device) -> dict:
    """The committed weights file (float16, the JAX layout: HWIO convs,
    spatially flipped HWIO transposed convs) as float32 torch-layout
    tensors on ``device``. ``seed`` is unused: these weights are fixed."""
    out = {}
    with np.load(cfg["weights"]["file"]) as z:
        for k in z.files:
            v = z[k].astype(np.float32)
            if v.ndim == 4:
                if k.split(".")[0] in _DECONV:      # -> (in, out, kh, kw)
                    v = v.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
                else:                                # -> (out, in, kh, kw)
                    v = v.transpose(3, 2, 0, 1)
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out


@contextlib.contextmanager
def precision(name: str):
    """``float32``: cuDNN and cuBLAS in full float32 (TF32 off); ``tf32``:
    both may take TF32. Restores the flags on the way out."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    tf32 = name == "tf32"
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def forward(w: dict, cfg: dict, l: torch.Tensor, ab: torch.Tensor,
            mask: torch.Tensor, dtype=torch.float32, dist: bool = False):
    """l (N,1,S,S) L in [0, 100]; ab (N,2,S,S) hint ab; mask (N,1,S,S) in
    {0, 1} -> (N,2,S,S) predicted ab, and with ``dist`` the (N,529,S/4,S/4)
    class distribution too. ``dtype`` is the convs' compute type (float32,
    or bfloat16 with the output cast back); everything else is float32."""

    def conv(x, name, dil=1, deconv=False):
        wt, b = w[f"{name}.weight"].to(dtype), w[f"{name}.bias"].to(dtype)
        x = x.to(dtype)
        if deconv:
            y = F.conv_transpose2d(x, wt, b, stride=2, padding=1)
        else:
            k = wt.shape[-1]
            y = F.conv2d(x, wt, b, padding=dil * (k - 1) // 2, dilation=dil)
        return y.to(torch.float32)

    def bn(x, name):
        g = lambda s: w[f"{name}.{s}"][None, :, None, None]  # noqa: E731
        return ((x - g("running_mean")) / torch.sqrt(g("running_var") + 1e-5)
                * g("weight") + g("bias"))

    def block(x, name):
        spec = _BLOCKS[name]
        _b, convs, has_bn, lead_relu, _div = spec
        idx, bn_i = _indices(name, len(convs), has_bn)
        if lead_relu:
            x = F.relu(x)
        for (cin, cout, k, d), i in zip(convs, idx):
            x = conv(x, f"{name}.{i}", d, deconv=name in _DECONV)
            if name == "model10":
                x = F.leaky_relu(x, 0.2)
            elif name not in _BARE:
                x = F.relu(x)
        return bn(x, f"{name}.{bn_i}") if has_bn else x

    x = torch.cat([(l - 50.0) / 100.0, ab / 110.0, mask], 1)
    c1 = block(x, "model1")
    c2 = block(c1[:, :, ::2, ::2], "model2")
    c3 = block(c2[:, :, ::2, ::2], "model3")
    c4 = block(c3[:, :, ::2, ::2], "model4")
    c7 = block(block(block(c4, "model5"), "model6"), "model7")
    c8 = block(block(c7, "model8up") + block(c3, "model3short8"), "model8")
    c9 = block(block(c8, "model9up") + block(c2, "model2short9"), "model9")
    c10 = block(block(c9, "model10up") + block(c1, "model1short10"),
                "model10")
    pred = torch.tanh(block(c10, "model_out")) * 110.0
    if not dist:
        return pred
    return pred, torch.softmax(block(c8, "model_class") * 0.2, dim=1)


_BLOCKS = {s[0]: s for s in _spec((64, 128, 256, 512))}
_BARE = {"model8up", "model9up", "model10up", "model3short8", "model2short9",
         "model1short10", "model_class", "model_out"}


def reference(w: dict, cfg: dict, l, ab, mask, prec: str) -> dict:
    """The click's prediction at ``prec``: "float32" (the reference: TF32
    off), "tf32" or "bfloat16" (the controls a step below)."""
    dtype = torch.bfloat16 if prec == "bfloat16" else torch.float32
    with precision("tf32" if prec == "tf32" else "float32"):
        return {"pred": forward(w, cfg, l, ab, mask, dtype)}
