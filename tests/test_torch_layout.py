"""The SIGGRAPH forward's memory layout on the CPU
(``models.siggraph.activation_format``): channels-last only for a forward
at "default" (TF32) on a CUDA device, contiguous NCHW for "highest" and for
every forward on the CPU. A CPU forward is the NCHW forward bit for bit,
also from the engines' channel-last views. The channels-last path itself
runs here too, through ``_forward`` or with the rule patched as on the
card: every layer keeps the layout, the module's weights and state dict
stay as they were, the ``model.nhwc`` span marks those forwards alone, and
the engines that run at "default" give the NCHW forward's frames from its
channels-last outputs."""

import numpy as np
import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

from ideepcolor_tpu_torch.engine import batch as tb
from ideepcolor_tpu_torch.engine import streaming as tst
from ideepcolor_tpu_torch.models import siggraph as sg
from ideepcolor_tpu_torch.ops.hints import MAX_HINTS
from ideepcolor_tpu_torch.ops.quantize import make_pts_grid

torch.set_num_threads(2)

N, S = 2, 32


@pytest.fixture(scope="module")
def net():
    sd = sg.init_state_dict(0.25, seed=0)
    # BatchNorm away from the identity, so its layout matters too
    g = torch.Generator().manual_seed(1)
    for k, v in sd.items():
        if k.endswith(("running_mean", "bias")) and v.dim() == 1:
            sd[k] = torch.randn(v.shape, generator=g) * 0.1
    return sg.SIGGRAPHGenerator.from_state_dict(sd).requires_grad_(False)


def _inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    A = torch.rand((N, 1, S, S), generator=g) * 100.0 - 50.0
    B = torch.rand((N, 2, S, S), generator=g) * 120.0 - 60.0
    M = (torch.rand((N, 1, S, S), generator=g) > 0.9).float()
    return A, B * M, M


def _nhwc_on_default(device, precision_name):
    """The rule as it reads on the card, whatever the device."""
    return (torch.channels_last if precision_name == "default"
            else torch.contiguous_format)


@pytest.mark.parametrize("device,precision,want", [
    ("cuda", "default", torch.channels_last),
    ("cuda:0", "default", torch.channels_last),
    ("cuda", "highest", torch.contiguous_format),
    ("cpu", "default", torch.contiguous_format),
    ("cpu", "highest", torch.contiguous_format),
])
def test_the_layout_rule(device, precision, want):
    assert sg.activation_format(torch.device(device), precision) == want


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_a_cpu_forward_is_the_nchw_forward_bit_for_bit(net, precision):
    A, B, M = _inputs()
    with torch.no_grad():
        out = net(A, B, M, 0.5, precision_name=precision)
        want = net._forward(A, B, M, 0.5, False, False,
                            torch.contiguous_format)
        # the engines' boundary: channel-last views of the same planes
        views = [t.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
                 for t in (A, B, M)]
        from_views = net(*views, 0.5, precision_name=precision)
        reg, dist = net(A, B, M, 0.5, dist=True, dist_lowres=True,
                        precision_name=precision)
    assert out.is_contiguous() and from_views.is_contiguous()
    assert torch.equal(out, want) and torch.equal(from_views, want)
    assert torch.equal(reg, want * 110.0) and dist.is_contiguous()


def test_a_channels_last_forward_keeps_the_layout_and_the_weights(net):
    A, B, M = _inputs(1)
    before = {k: (v.clone(), v.stride()) for k, v in net.state_dict().items()}
    layouts = []

    def keep(mod, inp, out):
        layouts.append((type(mod).__name__,
                        out.is_contiguous(memory_format=torch.channels_last)))

    layers = (nn.Conv2d, nn.ConvTranspose2d, nn.BatchNorm2d, nn.ReLU,
              nn.LeakyReLU)
    hooks = [m.register_forward_hook(keep) for m in net.modules()
             if isinstance(m, layers)]
    try:
        with torch.no_grad():
            out = net._forward(A, B, M, 0.0, False, False,
                               torch.channels_last)
    finally:
        for h in hooks:
            h.remove()
    assert len(layouts) > 60 and all(cl for _, cl in layouts), layouts
    assert out.is_contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        nchw = net._forward(A, B, M, 0.0, False, False,
                            torch.contiguous_format)
    assert (out - nchw).abs().max() <= 1e-3
    after = net.state_dict()
    assert after.keys() == before.keys()
    for k, (v, stride) in before.items():
        assert torch.equal(after[k], v) and after[k].stride() == stride, k
    for name, p in net.named_parameters():
        assert p.is_contiguous(), name
        if p.dim() == 4 and p.shape[-1] > 1:
            assert not p.is_contiguous(memory_format=torch.channels_last)


def test_the_nhwc_span_marks_the_channels_last_forwards_alone(
        net, monkeypatch):
    A, B, M = _inputs(2)

    def spans():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with torch.no_grad():
                for precision in ("highest", "default"):
                    net(A, B, M, 0.0, precision_name=precision)
        return sum(e.name == "model.nhwc" for e in prof.events())

    assert spans() == 0                    # the CPU: NCHW at both
    monkeypatch.setattr(sg, "activation_format", _nhwc_on_default)
    assert spans() == 1                    # "default" alone
    with torch.no_grad():                  # untraced: no span, same result
        out = net(A, B, M, 0.0, precision_name="default")
    assert out.is_contiguous(memory_format=torch.channels_last)


def _tables():
    boxes = np.zeros((N, MAX_HINTS, 4), np.int32)
    values = np.zeros((N, MAX_HINTS, 2), np.float32)
    counts = np.array([0, 3], np.int32)
    rng = np.random.default_rng(5)
    for j in range(3):
        y, x = rng.integers(2, S - 8, 2)
        boxes[1, j] = [y, x, y + 4, x + 5]
        values[1, j] = rng.uniform(-60, 60, 2)
    return [torch.from_numpy(a) for a in (boxes, values, counts)]


def _engine(form, net):
    """One call of an engine that runs the net at "default"."""
    rng = np.random.default_rng(3)
    l_mc = torch.from_numpy(
        rng.uniform(-50, 50, (N, S, S, 1)).astype(np.float32))
    boxes, values, counts = _tables()
    with torch.no_grad():
        if form == "table":
            return tb.batch_forward_frames_table(net, l_mc, boxes, values,
                                                 counts, 0.0)
        if form == "dense":
            hints = tb.k1.rasterize_hints_batch(boxes, values, counts, S)
            return tb.batch_forward_frames(
                net, l_mc, hints[:, :2].permute(0, 2, 3, 1),
                hints[:, 2:].permute(0, 2, 3, 1), 0.0)
        if form == "window":
            gray = torch.from_numpy(
                rng.integers(0, 256, (N, S, S, 1), dtype=np.uint8))
            return (tb.batch_stream_window_u8(net, gray, boxes[1], values[1],
                                              3, 0.0),)
        if form == "stream":
            ab = torch.zeros((1, S, S, 2))
            mask = torch.zeros((1, S, S, 1))
            ab[0, 4:9, 6:12], mask[0, 4:9, 6:12] = 40.0, 1.0
            return tst._stream_step(net, l_mc[:1] + 50.0, ab, mask)
        hs = ws = torch.tensor([5, 20], dtype=torch.int32)
        pts = torch.from_numpy(make_pts_grid()).float()
        return tb.batch_suggest_table(net, l_mc, boxes, values, counts, hs,
                                      ws, pts, seed=7, K=3, N=2000)


@pytest.mark.parametrize("form",
                         ["table", "dense", "window", "stream", "suggest"])
def test_engines_take_the_channels_last_outputs(net, monkeypatch, form):
    want = _engine(form, net)
    monkeypatch.setattr(sg, "activation_format", _nhwc_on_default)
    got = _engine(form, net)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if w.dtype == torch.uint8:
            max_lsb, equal = tb.frame_delta_stats(g.numpy(), w.numpy())
            assert max_lsb <= 1 and equal >= 0.99, (max_lsb, equal)
        else:
            assert (g - w).abs().max() <= 1e-3


def _convs(net):
    return [m for m in net.modules() if isinstance(m, sg._LayoutWeight)]


def _fresh(net):
    """The same weights, of the same type, in a module that has kept no
    copy."""
    dtype = net.model1[0].weight.dtype
    return sg.SIGGRAPHGenerator.from_state_dict(
        {k: v.float() for k, v in net.state_dict().items()}
    ).requires_grad_(False).cast_weights_(
        None if dtype == torch.float32 else dtype)


def test_a_kept_weight_copy_is_the_per_call_conversion_bit_for_bit(net):
    g = torch.Generator().manual_seed(4)
    for m in _convs(net):
        cin = m.weight.shape[1 if isinstance(m, nn.Conv2d) else 0]
        x = torch.randn((N, cin, 2 * S // 4, 2 * S // 4), generator=g)
        for xin in (x.contiguous(memory_format=torch.channels_last),
                    x.contiguous(memory_format=torch.channels_last)
                    [:, :, ::2, ::2]):
            if isinstance(m, nn.Conv2d):
                want = m._conv_forward(xin, m.weight, m.bias)
            else:
                want = nn.ConvTranspose2d.forward(m, xin)
            with torch.no_grad():
                got = m(xin)
            assert torch.equal(got, want)
            assert got.is_contiguous(memory_format=torch.channels_last)
        kept = m.__dict__["_cl_weight"][2]
        assert kept.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(kept, m.weight) and m.weight.is_contiguous()


def test_an_nchw_forward_and_a_training_forward_keep_no_copy():
    net = sg.SIGGRAPHGenerator.from_state_dict(
        sg.init_state_dict(0.25, seed=3)).requires_grad_(False)
    A, B, M = _inputs(5)
    with torch.no_grad():
        net(A, B, M, 0.0, precision_name="default")
    assert not any("_cl_weight" in m.__dict__ for m in _convs(net))
    net.requires_grad_(True)
    reg, dist = net._forward(A, B, M, 0.0, True, True, torch.channels_last)
    (reg.square().mean() + dist.square().mean()).backward()
    assert not any("_cl_weight" in m.__dict__ for m in _convs(net))
    assert all(m.weight.grad is not None for m in _convs(net))


def _load(net, other):
    net.load_state_dict(other.state_dict())


def _scale(net, other):
    with torch.no_grad():
        for m in _convs(net):
            m.weight.mul_(0.5)


def _rebind(net, other):
    for m, o in zip(_convs(net), _convs(other)):
        m.weight.data = o.weight.detach().clone()


def _cast(net, other):
    net.cast_weights_("bfloat16")


@pytest.mark.parametrize("write,in_place", [(_load, True), (_scale, True),
                                            (_rebind, True), (_cast, False)])
def test_the_kept_copy_follows_the_weights(write, in_place):
    net = sg.SIGGRAPHGenerator.from_state_dict(
        sg.init_state_dict(0.25, seed=6)).requires_grad_(False)
    other = sg.SIGGRAPHGenerator.from_state_dict(
        sg.init_state_dict(0.25, seed=7)).requires_grad_(False)
    A, B, M = _inputs(6)

    def cl_forward(m):
        with torch.no_grad():
            return m._forward(A, B, M, 0.0, True, True,
                              torch.channels_last)

    cl_forward(net)
    kept = [m.__dict__["_cl_weight"][2] for m in _convs(net)]
    write(net, other)
    got = cl_forward(net)
    want = cl_forward(_fresh(net))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    now = [m.__dict__["_cl_weight"][2] for m in _convs(net)]
    # a write of the same shape and type refreshes the copy in place, so
    # a graph captured on it reads the new weights
    assert all((a is b) == in_place for a, b in zip(kept, now))
    for m in _convs(net):
        assert torch.equal(m.__dict__["_cl_weight"][2], m.weight)
        assert m.weight.is_contiguous()
