"""SIGGRAPH user-guided colorization U-Net as an ``nn.Module`` (NCHW).

Counterpart of ``ideepcolor_tpu/models/siggraph.py`` (``apply``), keyed like
the reference's ``SIGGRAPHGenerator`` torch state dict, so the JAX package's
checkpoints load with ``load_state_dict(strict=True)`` after a pure
relayout. Details carried over exactly:

* input ``concat(L/100, ab/110, mask - maskcent)``, output ``tanh * 110``;
* stride-2 steps are slices ``x[:, :, ::2, ::2]``, not strided convs;
* model5 and model6 are dilated by 2;
* model8 and model9 start with a ReLU after the skip add; model10 is
  ReLU -> conv -> LeakyReLU(0.2);
* inference BatchNorm with eps 1e-5;
* channel counts come from the weights, so width-scaled students load too;
* ``forward(dist=True)`` also runs the 529-bin distribution head on
  conv8_3 (``model_class``, a 1x1 conv; softmax of its logits x 0.2) and
  returns the regression output times 110 a SECOND time, the reference's
  quirk in dist mode (callers ignore that value; it is reproduced for parity
  of the public return);
* serving precision: ``forward(precision_name="default")`` lets the convs
  take TF32 (the JAX package's ``Precision.DEFAULT``), and
  :meth:`SIGGRAPHGenerator.cast_weights_` stores the weights in bf16, where
  each conv casts its input to the weight's type and its output back to
  f32 (the JAX package's ``_cast_params`` and ``layers.conv2d``);
* layout: a TF32 forward on the card runs its activations channels-last
  (NHWC), the layout of the TF32 kernels cuDNN picks, so it launches no
  NCHW <-> NHWC transposes around them; every other forward runs
  contiguous NCHW (:func:`activation_format`). The stored weights stay
  NCHW either way; a channels-last forward takes a kept channels-last copy
  of each conv's weight;
* epilogues: an f32 inference forward on the card runs each conv of
  model1-model10 without its bias and finishes its output in place with one
  launch of kernel K4 (``ops/cuda/conv_epilogue_kernel.py``): the bias, the
  skip sum where the next block takes one, the activation and the block's
  BatchNorm, 26 launches a forward in place of 67 eager ones. The CPU, bf16
  convs, training mode and a forward autograd records keep the eager chain
  of the Sequentials (:meth:`SIGGRAPHGenerator._fuses_epilogues`); the
  module tree and its state-dict keys are the same either way;
* training: :func:`forward_train` (``apply_train``) runs the same net over
  a flat dict of tensors (:func:`train_params`) and returns the singly
  scaled regression output and the raw class logits at H/4; its BatchNorm
  is written out elementwise, so the running statistics are trained too.
  A trunk conv given as a tuple of out-channel slices runs tensor
  parallel, each slice on its own device (the sharded train step).
"""

from __future__ import annotations

import contextlib
import os
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import conv_precision
from ..ops.cuda.conv_epilogue_kernel import conv_epilogue
from ..ops.resize import upsample_nearest
from ..utils.profiling import annotate
from . import layers as L

# (block, conv indices within the torch Sequential, bn index or None), the
# Sequential layouts of the reference generator.
_BLOCKS: list[tuple[str, list[int], int | None]] = [
    ("model1", [0, 2], 4),
    ("model2", [0, 2], 4),
    ("model3", [0, 2, 4], 6),
    ("model4", [0, 2, 4], 6),
    ("model5", [0, 2, 4], 6),
    ("model6", [0, 2, 4], 6),
    ("model7", [0, 2, 4], 6),
    ("model8up", [0], None),
    ("model3short8", [0], None),
    ("model8", [1, 3], 5),
    ("model9up", [0], None),
    ("model2short9", [0], None),
    ("model9", [1], 3),
    ("model10up", [0], None),
    ("model1short10", [0], None),
    ("model10", [1], None),
    ("model_class", [0], None),
    ("model_out", [0], None),
]
_DECONV_BLOCKS = {"model8up", "model9up", "model10up"}
# the three skip sums: the block each feeds -> (its upsampling block, its
# shortcut block)
_JOINS = {"model8": ("model8up", "model3short8"),
          "model9": ("model9up", "model2short9"),
          "model10": ("model10up", "model1short10")}

FULL_CHANNELS = (64, 128, 256, 512)


def scaled_channels(width: float) -> tuple[int, int, int, int]:
    """Channel tiers of a width-multiplied student, rounded up to multiples
    of 8, as the JAX package builds them."""
    r8 = lambda c: max(8, int(-(-c * width // 8)) * 8)  # noqa: E731
    return tuple(r8(c) for c in FULL_CHANNELS)


class _LayoutWeight:
    """The weight a conv takes for its input's layout. A channels-last input
    takes a channels-last copy of the stored NCHW weight, the layout the
    conv would otherwise convert the weight to on every call. The copy is
    kept, and refreshed in place when the weight was written (a load, an
    in-place update), cast or moved since; a captured graph reads the copy
    as the last eager forward left it. Any other input, or a forward that
    records gradients for the weight, takes the weight as it is."""

    def _weight_for(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        # channels innermost, also in a strided slice; a tensor that is
        # contiguous too (one channel, or 1x1) counts as NCHW, as in torch
        if (x.stride(1) != 1 or x.shape[1] == 1 or x.is_contiguous()
                or (w.requires_grad and torch.is_grad_enabled())):
            return w
        src, version, cl = self.__dict__.get("_cl_weight", (None,) * 3)
        if (src is not None and src.data_ptr() == w.data_ptr()
                and version == w._version):
            return cl
        if cl is not None and (cl.shape, cl.dtype, cl.device) == (
                w.shape, w.dtype, w.device):
            cl.copy_(w)           # in place: graphs captured on it follow
        else:
            cl = w.detach().contiguous(memory_format=torch.channels_last)
        # ``src`` keeps the weight's storage alive, so no other tensor can
        # take its address while the copy is keyed on it
        self.__dict__["_cl_weight"] = (w.detach(), w._version, cl)
        return cl


class _Conv2d(_LayoutWeight, nn.Conv2d):
    """A conv whose weight's type is its compute type: the input is cast to
    it and the output back to f32 (accumulation is f32 in cuDNN and on the
    CPU). With f32 weights both casts return their argument."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.weight.dtype)
        return self._conv_forward(x, self._weight_for(x),
                                  self.bias).to(torch.float32)

    def forward_without_bias(self, x: torch.Tensor) -> torch.Tensor:
        """The conv alone, f32 weights and input: its bias is left to the
        caller's epilogue (K4)."""
        return self._conv_forward(x, self._weight_for(x), None)


class _ConvTranspose2d(_LayoutWeight, nn.ConvTranspose2d):
    """As :class:`_Conv2d`, for the three k4 s2 p1 upsampling convs."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.weight.dtype)
        return F.conv_transpose2d(
            x, self._weight_for(x), self.bias, self.stride, self.padding,
            self.output_padding, self.groups,
            self.dilation).to(torch.float32)

    def forward_without_bias(self, x: torch.Tensor) -> torch.Tensor:
        """As :meth:`_Conv2d.forward_without_bias`."""
        return F.conv_transpose2d(
            x, self._weight_for(x), None, self.stride, self.padding,
            self.output_padding, self.groups, self.dilation)


def _conv(cin: int, cout: int, k: int = 3, dilation: int = 1) -> nn.Conv2d:
    return _Conv2d(cin, cout, k, padding=dilation * (k - 1) // 2,
                   dilation=dilation)


def _deconv(cin: int, cout: int) -> nn.ConvTranspose2d:
    return _ConvTranspose2d(cin, cout, 4, stride=2, padding=1)


def _trunk(cin: int, cout: int, n: int, dilation: int = 1) -> nn.Sequential:
    """[conv ReLU] * n, then BatchNorm."""
    layers: list[nn.Module] = []
    for i in range(n):
        layers += [_conv(cin if i == 0 else cout, cout, 3, dilation),
                   nn.ReLU()]
    return nn.Sequential(*layers, nn.BatchNorm2d(cout))


# the span of an NCHW forward: one object, entered again and again
_NO_SPAN = contextlib.nullcontext()


def activation_format(device: torch.device,
                      precision_name: str) -> torch.memory_format:
    """The memory layout of a forward's activations: channels-last for a
    forward at "default" (TF32) on a CUDA device, whose conv kernels in
    cuDNN all take NHWC; contiguous NCHW for "highest" (the f32 clicks keep
    the NCHW kernels, and with them their last bits) and for any forward on
    the CPU (the JAX parity tests' path)."""
    if device.type == "cuda" and precision_name == "default":
        return torch.channels_last
    return torch.contiguous_format


class SIGGRAPHGenerator(nn.Module):
    """The U-Net with both heads. ``channels`` are the four tiers
    (c1, c2, c3, c4); :meth:`from_state_dict` reads them off the weights."""

    def __init__(self, channels: tuple[int, int, int, int] = FULL_CHANNELS):
        super().__init__()
        c1, c2, c3, c4 = channels
        self.model1 = _trunk(4, c1, 2)
        self.model2 = _trunk(c1, c2, 2)
        self.model3 = _trunk(c2, c3, 3)
        self.model4 = _trunk(c3, c4, 3)
        self.model5 = _trunk(c4, c4, 3, dilation=2)
        self.model6 = _trunk(c4, c4, 3, dilation=2)
        self.model7 = _trunk(c4, c4, 3)
        self.model8up = nn.Sequential(_deconv(c4, c3))
        self.model3short8 = nn.Sequential(_conv(c3, c3))
        self.model8 = nn.Sequential(nn.ReLU(), _conv(c3, c3), nn.ReLU(),
                                    _conv(c3, c3), nn.ReLU(),
                                    nn.BatchNorm2d(c3))
        self.model9up = nn.Sequential(_deconv(c3, c2))
        self.model2short9 = nn.Sequential(_conv(c2, c2))
        self.model9 = nn.Sequential(nn.ReLU(), _conv(c2, c2), nn.ReLU(),
                                    nn.BatchNorm2d(c2))
        self.model10up = nn.Sequential(_deconv(c2, c2))
        self.model1short10 = nn.Sequential(_conv(c1, c2))
        self.model10 = nn.Sequential(nn.ReLU(), _conv(c2, c2),
                                     nn.LeakyReLU(0.2))
        self.model_class = nn.Sequential(_conv(c3, 529, 1))
        self.model_out = nn.Sequential(_conv(c2, 2, 1))

    @classmethod
    def from_state_dict(cls, sd: Mapping[str, torch.Tensor]
                        ) -> "SIGGRAPHGenerator":
        """Build at the width the (torch-layout) weights carry and load them
        strictly. The module is in eval mode (inference BatchNorm)."""
        chans = tuple(int(sd[f"model{i}.0.weight"].shape[0])
                      for i in (1, 2, 3, 4))
        net = cls(chans)
        net.load_state_dict(sd, strict=True)
        return net.eval()

    def cast_weights_(self, dtype) -> "SIGGRAPHGenerator":
        """Serving precision, in place (the JAX package's ``_cast_params``;
        ``None`` leaves f32). The convs' weights and biases are stored in
        ``dtype`` ("bfloat16"), which makes it their compute type. BatchNorm
        computes in f32 on parameters rounded through ``dtype``, as every
        parameter is there. Where the JAX package also rounds elementwise
        results to bf16 (``x - mean`` in its batchnorm, ``tanh(.) * 110``
        at the output), this module keeps f32."""
        if dtype is None:
            return self
        dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.to(dt)
            elif isinstance(m, nn.BatchNorm2d):
                for t in (m.weight, m.bias, m.running_mean, m.running_var):
                    t.data = t.data.to(dt).to(torch.float32)
        return self

    def _fuses_epilogues(self, x: torch.Tensor) -> bool:
        """Whether K4 finishes each conv of this forward: on a CUDA device,
        f32 activations and f32 convs, inference BatchNorm, no gradient
        recorded. The CPU, bf16 convs (:meth:`cast_weights_`), a module in
        training mode and a forward that autograd records keep the eager
        chain of the Sequentials."""
        return (x.device.type == "cuda" and x.dtype == torch.float32
                and self.model1[0].weight.dtype == torch.float32
                and not self.training
                and not (torch.is_grad_enabled() and (x.requires_grad or any(
                    p.requires_grad for p in self.parameters()))))

    def forward(self, input_A: torch.Tensor, input_B: torch.Tensor,
                mask_B: torch.Tensor, maskcent: float = 0.0,
                dist: bool = False, dist_lowres: bool = False,
                precision_name: str = "highest"):
        """input_A (N,1,H,W) L - 50; input_B (N,2,H,W) hint ab; mask_B
        (N,1,H,W) hint mask -> (N,2,H,W) ab in [-110, 110].

        ``precision_name``: "highest" (f32 convs, the parity mode) or
        "default" (the convs may take TF32 on the card), scoped to this
        call (``device.conv_precision``). On a CUDA device "default" also
        runs the activations channels-last (:func:`activation_format`), so
        the outputs come back as channels-last tensors.

        With ``dist=True`` returns ``(out_reg * 110, out_cl)``: out_cl
        (N,529,H,W) softmax probabilities over the ab bins, the H/4 map
        nearest-upsampled x4. A lookup on the upsampled map equals one at
        (h // 4, w // 4) on the H/4 map, so ``dist_lowres=True`` keeps
        (N,529,H/4,W/4) and saves 16x the memory."""
        fmt = activation_format(input_A.device, precision_name)
        nhwc = (annotate("model.nhwc") if fmt == torch.channels_last
                else _NO_SPAN)
        with conv_precision(precision_name), nhwc:
            return self._forward(input_A, input_B, mask_B, maskcent, dist,
                                 dist_lowres, fmt)

    def _forward(self, input_A, input_B, mask_B, maskcent, dist,
                 dist_lowres, fmt):
        # the layout of :func:`activation_format`, whatever the callers'
        # views are (the engines pass channel-last views, the clicks planar
        # planes). Every op below keeps its input's layout, so the whole
        # net runs in it. The module's weights stay NCHW, which keeps the
        # "highest" forwards on their NCHW kernels; a channels-last forward
        # takes each conv's kept channels-last copy (:class:`_LayoutWeight`)
        x = torch.cat([input_A / 100.0, input_B / 110.0, mask_B - maskcent],
                      dim=1).contiguous(memory_format=fmt)
        if self._fuses_epilogues(x):
            conv8_3, conv10_2 = self._k4_forward(x)
        else:
            conv1_2 = self.model1(x)
            conv2_2 = self.model2(conv1_2[:, :, ::2, ::2])
            conv3_3 = self.model3(conv2_2[:, :, ::2, ::2])
            conv4_3 = self.model4(conv3_3[:, :, ::2, ::2])
            conv7_3 = self.model7(self.model6(self.model5(conv4_3)))
            conv8_3 = self.model8(self.model8up(conv7_3)
                                  + self.model3short8(conv3_3))
            conv9_3 = self.model9(self.model9up(conv8_3)
                                  + self.model2short9(conv2_2))
            conv10_2 = self.model10(self.model10up(conv9_3)
                                    + self.model1short10(conv1_2))
        out_reg = torch.tanh(self.model_out(conv10_2)) * 110.0
        if not dist:
            return out_reg
        out_cl = torch.softmax(self.model_class(conv8_3) * 0.2, dim=1)
        if not dist_lowres:
            out_cl = upsample_nearest(out_cl, 4, h_axis=-2, w_axis=-1)
        return out_reg * 110.0, out_cl

    def _k4_forward(self, x: torch.Tensor):
        """model1-model10 wired as :meth:`_forward`'s eager chain wires
        them, each conv run without its bias and finished in place by one
        K4 launch: 26 a forward. Returns conv8_3 and conv10_2."""
        b, join = self._k4_block, self._k4_join
        conv1_2 = b("model1", x)
        conv2_2 = b("model2", conv1_2[:, :, ::2, ::2])
        conv3_3 = b("model3", conv2_2[:, :, ::2, ::2])
        conv4_3 = b("model4", conv3_3[:, :, ::2, ::2])
        conv7_3 = b("model7", b("model6", b("model5", conv4_3)))
        conv8_3 = b("model8", join("model8", conv7_3, conv3_3))
        conv9_3 = b("model9", join("model9", conv8_3, conv2_2))
        conv10_2 = b("model10", join("model10", conv9_3, conv1_2))
        return conv8_3, conv10_2

    def _k4_block(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Block ``name`` by its ``_BLOCKS`` row: each conv without its
        bias, then one K4 launch with the bias, the activation module that
        follows the conv and, after the last conv, the block's BatchNorm
        where it has one. The conv indices of a block in ``_RELU_LED``
        start at 1: :meth:`_k4_join` applied its leading ReLU."""
        _, convs, bn = _BLOCK[name]
        seq = getattr(self, name)
        for i in convs:
            x = conv_epilogue(
                seq[i].forward_without_bias(x), seq[i].bias,
                negative_slope=_slope(seq[i + 1]),
                bn=seq[bn] if bn is not None and i == convs[-1] else None)
        return x

    def _k4_join(self, name: str, x: torch.Tensor,
                 s: torch.Tensor) -> torch.Tensor:
        """The skip sum that feeds block ``name``, ``up(x) + short(s)``
        (``_JOINS``), and the block's leading ReLU (its module 0), as one
        K4 launch over the upsampling conv's output."""
        up, short = (getattr(self, b)[0] for b in _JOINS[name])
        return conv_epilogue(up.forward_without_bias(x), up.bias,
                             pair=short.forward_without_bias(s),
                             pair_bias=short.bias,
                             negative_slope=_slope(getattr(self, name)[0]))


def _slope(act: nn.Module) -> float | None:
    """K4's activation for the module ``act``: None for a ReLU, the
    negative slope of a LeakyReLU."""
    return act.negative_slope if isinstance(act, nn.LeakyReLU) else None



def as_module(weights, device=None) -> SIGGRAPHGenerator:
    """What the engines take where the JAX functions take ``params``: a
    :class:`SIGGRAPHGenerator` (returned as it is, moved to ``device`` when
    one is given) or a state dict of :func:`state_dict_from_params` /
    :func:`load_state_dict_file` (a module is built from it on every call:
    callers that call often pass the module)."""
    if not isinstance(weights, nn.Module):
        weights = SIGGRAPHGenerator.from_state_dict(weights)
    if device is not None:
        weights = weights.to(device)
    return weights.requires_grad_(False)


def _is_hwio(arrays: Mapping[str, np.ndarray]) -> bool:
    """The JAX package's layout puts the 4 input channels of the first conv
    in axis 2 (HWIO); torch's puts them in axis 1 (OIHW). Any width."""
    return np.asarray(arrays["model1.0.weight"]).shape[2] == 4


def state_dict_from_params(params: Mapping[str, np.ndarray]
                           ) -> dict[str, torch.Tensor]:
    """Carry weights across: the JAX package's SIGGRAPH params (HWIO convs,
    flipped-HWIO deconvs; any width; f16 or f32; numpy or anything
    ``np.asarray`` takes) or an already torch-layout state dict -> this
    module's f32 state dict, ``num_batches_tracked`` included so
    ``load_state_dict(strict=True)`` accepts it."""
    hwio = _is_hwio(params)
    f32 = lambda v: torch.from_numpy(  # noqa: E731
        np.array(v, dtype=np.float32, order="C"))
    sd: dict[str, torch.Tensor] = {}
    for block, conv_idx, bn_idx in _BLOCKS:
        for j in conv_idx:
            w = np.asarray(params[f"{block}.{j}.weight"])
            if hwio:
                w = (L.hwio_to_torch_convT(w) if block in _DECONV_BLOCKS
                     else L.hwio_to_torch_conv(w))
            sd[f"{block}.{j}.weight"] = f32(w)
            sd[f"{block}.{j}.bias"] = f32(params[f"{block}.{j}.bias"])
        if bn_idx is not None:
            for suffix in ("weight", "bias", "running_mean", "running_var"):
                key = f"{block}.{bn_idx}.{suffix}"
                sd[key] = f32(params[key])
            sd[f"{block}.{bn_idx}.num_batches_tracked"] = torch.zeros(
                (), dtype=torch.int64)
    return sd


def load_state_dict_file(path: str) -> dict[str, torch.Tensor]:
    """Load a SIGGRAPH checkpoint -- ``.npz`` in either layout (f16 storage
    is cast to f32), or a torch ``.pth``/``.pt`` state dict -- as this
    module's state dict.

    Two forms the JAX package's loader takes are refused: an orbax
    directory (reading one needs JAX; export it to ``.npz`` with the JAX
    package's ``utils/session.save_params_npz``) and a pickled module (a
    ``.pth`` is read with ``weights_only=True``, which unpickles tensors and
    containers only)."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory, an orbax checkpoint of the JAX package: "
            f"reading one needs JAX. Export it to .npz with the JAX "
            f"package's utils/session.save_params_npz (for a train state, "
            f"its params) and load that file")
    if path.endswith(".npz"):
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
    elif path.endswith((".pth", ".pt")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        arrays = {k: v.numpy() for k, v in sd.items()
                  if "num_batches_tracked" not in k}
    else:
        raise ValueError(f"unsupported checkpoint format: {path}")
    if "model1.0.weight" not in arrays:
        raise ValueError(f"{path} is not a SIGGRAPH-family checkpoint (no "
                         "'model1.0.weight')")
    return state_dict_from_params(arrays)


_BLOCK = {b[0]: b for b in _BLOCKS}
_DILATION = {"model5": 2, "model6": 2}
_RELU_LED = {"model8", "model9", "model10"}
_BARE = {"model8up", "model9up", "model10up", "model3short8", "model2short9",
         "model1short10", "model_class", "model_out"}


def train_params(sd: Mapping[str, torch.Tensor], device=None
                 ) -> dict[str, torch.Tensor]:
    """The trained tensors of a state dict: every entry but
    ``num_batches_tracked``, as f32 leaves that require grad. BatchNorm's
    ``running_mean`` and ``running_var`` are among them: the JAX package
    differentiates its whole params dict, so its optimizer trains them."""
    return {k: v.detach().to(device=device, dtype=torch.float32,
                             copy=True).contiguous().requires_grad_(True)
            for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def _conv_train(params, name: str, x: torch.Tensor) -> torch.Tensor:
    """One conv of the flat dict. The weight's type is the compute type
    (the input is cast to it, the output back to the input's type), as in
    :class:`_Conv2d`, so a bf16 teacher runs through the same code.

    Tensor parallelism: where the dict holds a tuple of out-channel slices
    of the weight and of the bias (``parallel.mesh.TP_PARAMS``, one slice
    per device of the model axis), each slice's device computes its output
    channels from a copy of ``x``, and the slices are gathered on ``x``'s
    device (``.to`` and ``torch.cat`` carry each slice's gradient back to
    its device)."""
    w, b = params[f"{name}.weight"], params[f"{name}.bias"]
    if isinstance(w, tuple):
        return torch.cat([
            _conv_train({f"{name}.weight": w_k, f"{name}.bias": b_k}, name,
                        x.to(w_k.device)).to(x.device)
            for w_k, b_k in zip(w, b)], 1)
    block = name.split(".")[0]
    out_dtype, x = x.dtype, x.to(w.dtype)
    if block in _DECONV_BLOCKS:
        y = F.conv_transpose2d(x, w, b, stride=2, padding=1)
    else:
        d = _DILATION.get(block, 1)
        y = F.conv2d(x, w, b, padding=d * (w.shape[-1] - 1) // 2, dilation=d)
    return y.to(out_dtype)


def _batchnorm_train(params, name: str, x: torch.Tensor) -> torch.Tensor:
    """Inference BatchNorm written out elementwise (the JAX package's
    ``layers.batchnorm``): ``F.batch_norm`` is not differentiable in its
    running statistics, which the JAX package trains."""
    c = lambda s: params[f"{name}.{s}"][:, None, None]  # noqa: E731
    return ((x - c("running_mean")) * torch.rsqrt(c("running_var") + 1e-5)
            * c("weight") + c("bias"))


def _block_train(params, name: str, x: torch.Tensor) -> torch.Tensor:
    """One Sequential block on the flat dict, activations where the
    reference's Sequentials have them (the JAX package's ``_block``)."""
    _, conv_idx, bn_idx = _BLOCK[name]
    if name in _RELU_LED:
        x = F.relu(x)
    for i, j in enumerate(conv_idx):
        x = _conv_train(params, f"{name}.{j}", x)
        if name == "model10" and i == len(conv_idx) - 1:
            x = F.leaky_relu(x, 0.2)
        elif name not in _BARE:
            x = F.relu(x)
    if bn_idx is not None:
        x = _batchnorm_train(params, f"{name}.{bn_idx}", x)
    return x


def forward_train(params: Mapping[str, torch.Tensor], input_A: torch.Tensor,
                  input_B: torch.Tensor, mask_B: torch.Tensor,
                  maskcent: float = 0.0, precision_name: str = "default"):
    """The training forward, the JAX package's ``siggraph.apply_train``:
    (N,1,H,W) L - 50, (N,2,H,W) hint ab, (N,1,H,W) mask -> (out_reg
    (N,2,H,W), ``tanh * 110`` once; logits (N,529,H/4,W/4), raw
    ``model_class`` output on conv8_3: no softmax, no upsample, no second
    x110).

    ``params`` is a flat dict of torch-layout tensors (:func:`train_params`),
    differentiable in every entry. BatchNorm uses the running statistics.
    ``precision_name`` scopes the convs of this forward
    (``device.conv_precision``); a caller that differentiates must hold the
    same scope over ``backward()``, whose convs run after this returns."""
    blk = lambda n, x: _block_train(params, n, x)  # noqa: E731
    with conv_precision(precision_name):
        x = torch.cat([input_A / 100.0, input_B / 110.0, mask_B - maskcent],
                      dim=1).contiguous()
        conv1_2 = blk("model1", x)
        conv2_2 = blk("model2", conv1_2[:, :, ::2, ::2])
        conv3_3 = blk("model3", conv2_2[:, :, ::2, ::2])
        conv4_3 = blk("model4", conv3_3[:, :, ::2, ::2])
        conv7_3 = blk("model7", blk("model6", blk("model5", conv4_3)))
        conv8_3 = blk("model8", blk("model8up", conv7_3)
                      + blk("model3short8", conv3_3))
        logits = blk("model_class", conv8_3)
        conv9_3 = blk("model9", blk("model9up", conv8_3)
                      + blk("model2short9", conv2_2))
        conv10_2 = blk("model10", blk("model10up", conv9_3)
                       + blk("model1short10", conv1_2))
        out_reg = torch.tanh(blk("model_out", conv10_2)) * 110.0
    return out_reg, logits


def init_state_dict(width: float = 1.0, seed: int = 0
                    ) -> dict[str, torch.Tensor]:
    """He-normal random weights at ``width`` (zero biases, identity
    BatchNorm), from a seeded ``torch.Generator``. The numbers differ from
    the JAX package's ``init_params``; the distribution is the same."""
    chans = FULL_CHANNELS if width == 1.0 else scaled_channels(width)
    with torch.device("meta"):           # shapes only, no default init
        shapes = SIGGRAPHGenerator(chans).state_dict()
    gen = torch.Generator().manual_seed(seed)
    sd: dict[str, torch.Tensor] = {}
    for name, t in shapes.items():
        if name.endswith("num_batches_tracked"):
            sd[name] = torch.zeros((), dtype=torch.int64)
        elif t.dim() == 4:
            # fan_in = cin * k * k; ConvTranspose2d keeps cin in axis 0
            block = name.split(".")[0]
            cin = t.shape[0] if block in _DECONV_BLOCKS else t.shape[1]
            std = float(np.sqrt(2.0 / (cin * t.shape[2] * t.shape[3])))
            sd[name] = torch.randn(t.shape, generator=gen) * std
        elif name.endswith(("running_var", "weight")):   # BatchNorm
            sd[name] = torch.ones(t.shape)
        else:                                 # biases, running means
            sd[name] = torch.zeros(t.shape)
    return sd
