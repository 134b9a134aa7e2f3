"""The reference's Caffe colorization graphs as one ``nn.Module`` (NCHW).

Counterpart of ``ideepcolor_tpu/models/caffe_net.py``: the three deployed
prototxt variants over one trunk.

  variant='main'   : two input branches (L, and hint ab + mask) added at
                     conv1_1, an encoder whose stride-2 '_ss' layers are
                     slices, dilated conv5/6, decoder deconvs with '_short'
                     skip adds, regression head conv10_ab -> tanh ->
                     ``pred_ab.scale`` (100).
  variant='dist'   : the trunk through conv8_3norm, then the hypercolumn head
                     (conv3..8_pred summed, ReLU, pred_313 at H/4), two fixed
                     bilinear x2 upsamplers, and two softmaxes: ``scale_S``
                     (the suggestion distribution) and ``scale_T`` (whose
                     expectation over the 313 bin centers is the annealed-mean
                     ``pred_ab``).
  variant='global' : L-only conv1_1, a 1x1-conv MLP over the 314-channel
                     global histogram (+ 2-channel saturation), its (N,512)
                     embedding added to conv4_3norm at every pixel.

Submodules carry the Caffe layer names, so the state dict's keys are the JAX
param dict's (``bw_conv1_1.weight``, ``conv1_2norm.mean``,
``pred_ab.scale``, ...) and a ``.caffemodel`` converter is a pure relayout.
Details carried over exactly: BatchNorm comes after the ReLU and only
normalizes, ``(x - mean) * rsqrt(var + 1e-5)``, no gamma or beta; the
histogram embedding is added after conv4_3norm; ``pred_ab`` of the dist
variant is computed in f32 whatever the serving precision.

Layouts: the blob and every feature map are channel-first. The distribution
map alone leaves :meth:`CaffeColorNet.apply_dist` bins-last, (N, H, W, 313),
so that a pixel's pdf is contiguous for the suggestion chain and both
softmaxes run over the contiguous axis.

Serving precision: ``precision_name="default"`` lets the convs take TF32;
:meth:`CaffeColorNet.cast_weights_` stores the convs' weights in bf16, where
each conv casts its input to the weight's type and its output back to f32.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from ..data.color_bins import get_bins
from ..device import conv_precision
from ..ops.resize import bilinear_up2_fixed
from . import layers as L
from .siggraph import _Conv2d, _ConvTranspose2d

VARIANTS = ("main", "dist", "global")

# Encoder/decoder conv specs shared by every variant:
# (name, in_ch, out_ch, kernel, dilation, kind)
_TRUNK_CONVS = [
    ("bw_conv1_1", 1, 64, 3, 1, "conv"),
    ("ab_conv1_1", 3, 64, 3, 1, "conv"),       # absent in 'global'
    ("conv1_2", 64, 64, 3, 1, "conv"),
    ("conv2_1", 64, 128, 3, 1, "conv"),
    ("conv2_2", 128, 128, 3, 1, "conv"),
    ("conv3_1", 128, 256, 3, 1, "conv"),
    ("conv3_2", 256, 256, 3, 1, "conv"),
    ("conv3_3", 256, 256, 3, 1, "conv"),
    ("conv4_1", 256, 512, 3, 1, "conv"),
    ("conv4_2", 512, 512, 3, 1, "conv"),
    ("conv4_3", 512, 512, 3, 1, "conv"),
    ("conv5_1", 512, 512, 3, 2, "conv"),
    ("conv5_2", 512, 512, 3, 2, "conv"),
    ("conv5_3", 512, 512, 3, 2, "conv"),
    ("conv6_1", 512, 512, 3, 2, "conv"),
    ("conv6_2", 512, 512, 3, 2, "conv"),
    ("conv6_3", 512, 512, 3, 2, "conv"),
    ("conv7_1", 512, 512, 3, 1, "conv"),
    ("conv7_2", 512, 512, 3, 1, "conv"),
    ("conv7_3", 512, 512, 3, 1, "conv"),
    ("conv8_1", 512, 256, 4, 1, "deconv"),
    ("conv3_3_short", 256, 256, 3, 1, "conv"),
    ("conv8_2", 256, 256, 3, 1, "conv"),
    ("conv8_3", 256, 256, 3, 1, "conv"),
]

_MAIN_HEAD_CONVS = [
    ("conv9_1", 256, 128, 4, 1, "deconv"),
    ("conv2_2_short", 128, 128, 3, 1, "conv"),
    ("conv9_2", 128, 128, 3, 1, "conv"),
    ("conv10_1", 128, 128, 4, 1, "deconv"),
    ("conv1_2_short", 64, 128, 3, 1, "conv"),
    ("conv10_2", 128, 128, 3, 1, "conv"),
    ("conv10_ab", 128, 2, 1, 1, "conv"),
]

_DIST_HEAD_CONVS = [
    ("conv3_pred", 256, 384, 3, 1, "conv"),
    ("conv4_pred", 512, 384, 4, 1, "deconv"),
    ("conv5_pred", 512, 384, 4, 1, "deconv"),
    ("conv6_pred", 512, 384, 4, 1, "deconv"),
    ("conv7_pred", 512, 384, 4, 1, "deconv"),
    ("conv8_pred", 256, 384, 3, 1, "conv"),
    ("pred_313", 384, 313, 1, 1, "conv"),
]

_GLOBAL_MLP_CONVS = [
    ("s_conv1", 2, 512, 1, 1, "conv"),
    ("glob_conv1", 314, 512, 1, 1, "conv"),
    ("glob_conv2", 512, 512, 1, 1, "conv"),
    ("glob_conv3", 512, 512, 1, 1, "conv"),
    ("glob_conv4", 512, 512, 1, 1, "conv"),
]

# (name, channels)
_BNS = [("conv1_2norm", 64), ("conv2_2norm", 128), ("conv3_3norm", 256),
        ("conv4_3norm", 512), ("conv5_3norm", 512), ("conv6_3norm", 512),
        ("conv7_3norm", 512), ("conv8_3norm", 256)]
_MAIN_BNS = [("conv9_2norm", 128)]
_GLOBAL_BNS = [("s_glob_conv1norm", 512), ("glob_conv2norm", 512),
               ("glob_conv3norm", 512), ("glob_conv4norm", 512)]

# scale layers: (name, the prototxt's value)
_SCALES = {"main": [("pred_ab", 100.0)], "global": [("pred_ab", 100.0)],
           "dist": [("scale_S", 0.2), ("scale_T", 2.6)]}


def _convs_for(variant: str):
    convs = [c for c in _TRUNK_CONVS
             if not (variant == "global" and c[0] == "ab_conv1_1")]
    if variant in ("main", "global"):
        convs += _MAIN_HEAD_CONVS
    if variant == "dist":
        convs += _DIST_HEAD_CONVS
    if variant == "global":
        convs += _GLOBAL_MLP_CONVS
    return convs


def _bns_for(variant: str):
    bns = list(_BNS)
    if variant in ("main", "global"):
        bns += _MAIN_BNS
    if variant == "global":
        bns += _GLOBAL_BNS
    return bns


class _Norm(nn.Module):
    """Caffe's TEST-phase BatchNorm: normalize only, in f32."""

    def __init__(self, channels: int):
        super().__init__()
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.var + 1e-5)
        return (x - self.mean[:, None, None]) * inv[:, None, None]


class _Scale(nn.Module):
    """A Caffe Scale layer's one stored factor."""

    def __init__(self, value: float):
        super().__init__()
        self.register_buffer("scale", torch.tensor(float(value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale


def _down(x: torch.Tensor) -> torch.Tensor:
    """A '_ss' layer: the stride-2 slice, made contiguous NCHW so the next
    conv takes the kernels it takes for any other contiguous input."""
    return x[:, :, ::2, ::2].contiguous()


class CaffeColorNet(nn.Module):
    """One of the three Caffe graphs; ``variant`` picks the layers."""

    def __init__(self, variant: str = "main"):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"variant must be one of {VARIANTS}, got "
                             f"{variant!r}")
        self.variant = variant
        for name, cin, cout, k, d, kind in _convs_for(variant):
            if kind == "deconv":
                layer = _ConvTranspose2d(cin, cout, 4, stride=2, padding=1)
            else:
                layer = _Conv2d(cin, cout, k, padding=d * (k - 1) // 2,
                                dilation=d)
            self.add_module(name, layer)
        for name, channels in _bns_for(variant):
            self.add_module(name, _Norm(channels))
        for name, value in _SCALES[variant]:
            self.add_module(name, _Scale(value))
        if variant == "dist":
            self.register_buffer(
                "pts_in_hull",
                torch.from_numpy(get_bins().pts_in_hull.astype(np.float32)),
                persistent=False)

    @classmethod
    def from_state_dict(cls, sd: Mapping[str, torch.Tensor],
                        variant: str | None = None) -> "CaffeColorNet":
        """Build the variant the (torch-layout) weights belong to and load
        them strictly, in eval mode."""
        net = cls(variant or variant_of(sd))
        net.load_state_dict(sd, strict=True)
        return net.eval()

    def cast_weights_(self, dtype) -> "CaffeColorNet":
        """Serving precision, in place (``None`` leaves f32). The convs'
        weights and biases are stored in ``dtype`` ("bfloat16"), which makes
        it their compute type. The BatchNorm statistics and the scale
        factors are rounded through ``dtype``, as every parameter is in the
        JAX package, and stay f32 tensors: normalization, tanh, the
        softmaxes and the annealed mean compute in f32, where the JAX
        package rounds their results to bf16 as well."""
        if dtype is None:
            return self
        dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.to(dt)
            elif isinstance(m, _Norm):
                for t in (m.mean, m.var):
                    t.data = t.data.to(dt).to(torch.float32)
            elif isinstance(m, _Scale):
                m.scale.data = m.scale.data.to(dt).to(torch.float32)
        return self

    # ----- the graph -----
    def _trunk(self, data: torch.Tensor, glob_embedding=None) -> dict:
        """Shared encoder through conv8_3norm. data (N,4,H,W) =
        [L - 50, hint ab, mask * 110], the Caffe blob. Returns the norms the
        heads read."""
        relu = torch.relu
        data = data.contiguous()
        x = self.bw_conv1_1(data[:, 0:1])
        if self.variant != "global":
            x = x + self.ab_conv1_1(data[:, 1:4])
        x = relu(x)
        conv1_2norm = self.conv1_2norm(relu(self.conv1_2(x)))

        x = relu(self.conv2_1(_down(conv1_2norm)))
        conv2_2norm = self.conv2_2norm(relu(self.conv2_2(x)))

        x = relu(self.conv3_1(_down(conv2_2norm)))
        x = relu(self.conv3_2(x))
        conv3_3norm = self.conv3_3norm(relu(self.conv3_3(x)))

        x = relu(self.conv4_1(_down(conv3_3norm)))
        x = relu(self.conv4_2(x))
        conv4_3norm = self.conv4_3norm(relu(self.conv4_3(x)))
        if glob_embedding is not None:
            conv4_3norm = conv4_3norm + glob_embedding[:, :, None, None]

        x = conv4_3norm
        for i in (1, 2, 3):
            x = relu(getattr(self, f"conv5_{i}")(x))
        conv5_3norm = self.conv5_3norm(x)
        x = conv5_3norm
        for i in (1, 2, 3):
            x = relu(getattr(self, f"conv6_{i}")(x))
        conv6_3norm = self.conv6_3norm(x)
        x = conv6_3norm
        for i in (1, 2, 3):
            x = relu(getattr(self, f"conv7_{i}")(x))
        conv7_3norm = self.conv7_3norm(x)

        x = relu(self.conv8_1(conv7_3norm) + self.conv3_3_short(conv3_3norm))
        x = relu(self.conv8_2(x))
        conv8_3norm = self.conv8_3norm(relu(self.conv8_3(x)))
        return dict(conv1_2norm=conv1_2norm, conv2_2norm=conv2_2norm,
                    conv3_3norm=conv3_3norm, conv4_3norm=conv4_3norm,
                    conv5_3norm=conv5_3norm, conv6_3norm=conv6_3norm,
                    conv7_3norm=conv7_3norm, conv8_3norm=conv8_3norm)

    def _regression_head(self, t: dict) -> torch.Tensor:
        relu = torch.relu
        x = relu(self.conv9_1(t["conv8_3norm"])
                 + self.conv2_2_short(t["conv2_2norm"]))
        x = self.conv9_2norm(relu(self.conv9_2(x)))
        x = relu(self.conv10_1(x) + self.conv1_2_short(t["conv1_2norm"]))
        x = relu(self.conv10_2(x))
        return self.pred_ab(torch.tanh(self.conv10_ab(x)))

    def _dist_logits(self, data: torch.Tensor) -> torch.Tensor:
        """The 313 logits at full resolution, bins last: (N, H, W, 313)."""
        t = self._trunk(data)
        h = (self.conv3_pred(t["conv3_3norm"])
             + self.conv4_pred(t["conv4_3norm"])
             + self.conv5_pred(t["conv5_3norm"])
             + self.conv6_pred(t["conv6_3norm"])
             + self.conv7_pred(t["conv7_3norm"])
             + self.conv8_pred(t["conv8_3norm"]))
        logits = self.pred_313(torch.relu(h))            # (N, 313, H/4, W/4)
        logits = bilinear_up2_fixed(bilinear_up2_fixed(logits))
        return logits.permute(0, 2, 3, 1).contiguous()

    def apply_main(self, data: torch.Tensor,
                   precision_name: str = "highest") -> torch.Tensor:
        """variant='main': (N,4,H,W) blob -> (N,2,H,W) pred_ab."""
        with conv_precision(precision_name):
            return self._regression_head(self._trunk(data))

    def apply_dist(self, data: torch.Tensor,
                   precision_name: str = "highest"):
        """variant='dist': (N,4,H,W) blob -> (pred_ab (N,2,H,W), dist_S
        (N,H,W,313)). dist_S is the suggestion distribution (``scale_S``,
        0.2 by default); pred_ab the annealed-mean point estimate through
        ``scale_T``, an f32 product at full precision in every mode."""
        with conv_precision(precision_name):
            logits = self._dist_logits(data)
        dist_S = torch.softmax(self.scale_S(logits), dim=-1)
        dist_T = torch.softmax(self.scale_T(logits), dim=-1)
        with conv_precision("highest"):
            pred_ab = dist_T @ self.pts_in_hull              # (N, H, W, 2)
        return pred_ab.permute(0, 3, 1, 2), dist_S

    def dist_map(self, data: torch.Tensor,
                 precision_name: str = "highest") -> torch.Tensor:
        """``apply_dist(...)[1]`` without the work for the point estimate it
        would drop (the suggestion forwards keep the map only)."""
        with conv_precision(precision_name):
            logits = self._dist_logits(data)
        return torch.softmax(self.scale_S(logits), dim=-1)

    def apply_global(self, data: torch.Tensor,
                     glob_ab_313_mask: torch.Tensor,
                     s_avg_mask: torch.Tensor | None = None,
                     precision_name: str = "highest") -> torch.Tensor:
        """variant='global': (N,4,H,W) blob (its hint channels feed no
        layer) + (N,314) histogram blob, 313 bins and the on/off flag last,
        + optional (N,2) mean saturation and flag (zeros by default: the
        reference's GUI path never feeds it) -> (N,2,H,W) pred_ab."""
        relu = torch.relu
        if s_avg_mask is None:
            s_avg_mask = torch.zeros((data.shape[0], 2), dtype=data.dtype,
                                     device=data.device)
        with conv_precision(precision_name):
            g = glob_ab_313_mask[:, :, None, None]           # a 1x1 "image"
            s = s_avg_mask[:, :, None, None]
            x = self.s_glob_conv1norm(relu(self.s_conv1(s)
                                           + self.glob_conv1(g)))
            x = self.glob_conv2norm(relu(self.glob_conv2(x)))
            x = self.glob_conv3norm(relu(self.glob_conv3(x)))
            x = self.glob_conv4norm(relu(self.glob_conv4(x)))
            t = self._trunk(data, glob_embedding=x[:, :, 0, 0])
            return self._regression_head(t)

    def forward(self, data: torch.Tensor, *args, **kwargs):
        """The variant's own forward: ``apply_main``, ``apply_dist`` or
        ``apply_global``."""
        return getattr(self, f"apply_{self.variant}")(data, *args, **kwargs)


def make_blob(img_l_mc: torch.Tensor, input_ab: torch.Tensor,
              input_mask: torch.Tensor, mask_mult: float = 110.0
              ) -> torch.Tensor:
    """Assemble the (N,4,H,W) input blob from channel-first planes: (1,H,W)
    mean-centered L, (2,H,W) raw hint ab, (1,H,W) mask in {0,1} (or the same
    with a leading batch axis)."""
    blob = torch.cat([img_l_mc, input_ab, input_mask * mask_mult], dim=-3)
    return blob[None] if blob.ndim == 3 else blob


def variant_of(keys) -> str:
    """Which graph a param dict or state dict belongs to, by its layers."""
    if "pred_313.weight" in keys:
        return "dist"
    if "glob_conv1.weight" in keys:
        return "global"
    if "conv10_ab.weight" in keys:
        return "main"
    raise ValueError("not a Caffe-family checkpoint (no 'conv10_ab.weight', "
                     "'pred_313.weight' or 'glob_conv1.weight')")


def as_module(weights, device=None, variant: str | None = None
              ) -> CaffeColorNet:
    """What the batch engine takes where the JAX functions take ``params``:
    a :class:`CaffeColorNet` (returned as it is, moved to ``device`` when one
    is given) or a state dict."""
    if not isinstance(weights, nn.Module):
        weights = CaffeColorNet.from_state_dict(weights, variant)
    if device is not None:
        weights = weights.to(device)
    return weights.requires_grad_(False)


def _f32(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32, order="C"))


def state_dict_from_params(params: Mapping[str, np.ndarray],
                           variant: str | None = None
                           ) -> dict[str, torch.Tensor]:
    """Carry weights across: the JAX package's Caffe-family params (HWIO
    convs, flipped-HWIO deconvs; f16 or f32; numpy or anything ``np.asarray``
    takes), or an already torch-layout dict of the same keys -> this module's
    f32 state dict."""
    variant = variant or variant_of(params)
    # HWIO keeps the first conv's one input channel in axis 2, its 64
    # outputs last; torch's layout is (64, 1, 3, 3)
    hwio = np.asarray(params["bw_conv1_1.weight"]).shape[-1] == 64
    sd: dict[str, torch.Tensor] = {}
    for name, _cin, _cout, _k, _d, kind in _convs_for(variant):
        w = np.asarray(params[f"{name}.weight"])
        if hwio:
            w = (L.hwio_to_torch_convT(w) if kind == "deconv"
                 else L.hwio_to_torch_conv(w))
        sd[f"{name}.weight"] = _f32(w)
        sd[f"{name}.bias"] = _f32(params[f"{name}.bias"])
    for name, _channels in _bns_for(variant):
        sd[f"{name}.mean"] = _f32(params[f"{name}.mean"])
        sd[f"{name}.var"] = _f32(params[f"{name}.var"])
    for name, _value in _SCALES[variant]:
        sd[f"{name}.scale"] = _f32(params[f"{name}.scale"]).reshape(())
    return sd


def load_state_dict_file(path: str, variant: str | None = None
                         ) -> dict[str, torch.Tensor]:
    """Load converted Caffe-family weights -- an ``.npz`` in the JAX
    package's layout or in torch's (f16 storage is cast to f32), or a torch
    ``.pth``/``.pt`` state dict -- as this module's state dict."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
    elif path.endswith((".pth", ".pt")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        arrays = {k: v.numpy() for k, v in sd.items()}
    else:
        raise ValueError(f"unsupported checkpoint format: {path}")
    return state_dict_from_params(arrays, variant)


def init_state_dict(variant: str = "main", seed: int = 0,
                    calibrate: bool = False) -> dict[str, torch.Tensor]:
    """He-normal random weights (zero biases, identity BatchNorm statistics,
    the prototxts' scale factors), drawn with numpy so that every device and
    installation holds the same bytes. The numbers differ from the JAX
    package's ``init_params``; the distribution is the same.

    The blob's L and mask channels span tens of units, and normalize-only
    BatchNorm with identity statistics passes that scale on: a plain He-init
    net drives ``tanh`` and the softmaxes into saturation and drowns the
    histogram embedding. ``calibrate=True`` gives every BatchNorm the
    statistics of its own input on a seeded batch
    (:func:`calibrate_norms_`), as training would: the activations of such
    a net have the scale a trained net's have."""
    rng = np.random.default_rng(seed)
    sd: dict[str, torch.Tensor] = {}
    for name, cin, cout, k, _d, kind in _convs_for(variant):
        shape = (cin, cout, k, k) if kind == "deconv" else (cout, cin, k, k)
        std = np.sqrt(2.0 / (cin * k * k))
        sd[f"{name}.weight"] = _f32(rng.standard_normal(shape) * std)
        sd[f"{name}.bias"] = torch.zeros(cout)
    for name, channels in _bns_for(variant):
        sd[f"{name}.mean"] = torch.zeros(channels)
        sd[f"{name}.var"] = torch.ones(channels)
    for name, value in _SCALES[variant]:
        sd[f"{name}.scale"] = torch.tensor(float(value))
    if calibrate:
        net = calibrate_norms_(CaffeColorNet.from_state_dict(sd, variant),
                               seed)
        sd = {k: v.clone() for k, v in net.state_dict().items()}
    return sd


@torch.no_grad()
def calibrate_norms_(net: CaffeColorNet, seed: int = 0, size: int = 64,
                     batch: int = 8) -> CaffeColorNet:
    """Set every BatchNorm's mean and variance, in place, to those of its
    input in one forward of a seeded batch of ``batch`` blobs of ``size`` x
    ``size`` pixels (smooth L planes, a few hint boxes; for the global
    variant a random sparse histogram each), on the CPU. Each layer sees
    the already calibrated layers before it."""
    rng = np.random.default_rng([seed, 1])
    yy, xx = np.mgrid[0:size, 0:size] / size
    blob = np.zeros((batch, 4, size, size), np.float32)
    for i in range(batch):
        f = rng.uniform(2, 9, 2)
        blob[i, 0] = (50 * np.sin(f[0] * yy + i) * np.cos(f[1] * xx - i)
                      + rng.normal(0, 5, (size, size)))
        for _ in range(i % 4):
            y, x = rng.integers(0, size - 7, 2)
            blob[i, 1:3, y:y + 7, x:x + 7] = rng.uniform(-80, 80, (2, 1, 1))
            blob[i, 3, y:y + 7, x:x + 7] = 110.0
    args = [torch.from_numpy(blob)]
    if net.variant == "global":
        glob = np.zeros((batch, 314), np.float32)
        for i in range(1, batch):              # row 0: no histogram
            bins = rng.integers(0, 313, 12)
            glob[i, bins] = rng.random(12)
            glob[i, :313] /= glob[i, :313].sum()
            glob[i, 313] = 1.0
        args.append(torch.from_numpy(glob))

    def set_stats(norm, inputs):
        x = inputs[0].to(torch.float32)
        norm.mean.copy_(x.mean(dim=(0, 2, 3)))
        norm.var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(set_stats) for m in net.modules()
             if isinstance(m, _Norm)]
    try:
        net.cpu()(*args)
    finally:
        for h in hooks:
            h.remove()
    return net
