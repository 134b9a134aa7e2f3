"""K4, the SIGGRAPH convs' epilogue kernel, and the forward that runs it, on
the CPU.

The CUDA kernel itself is held to its plain version on the card
(``tests/test_torch_card_kernels.py``, marked ``card``). Here: the CPU
forward is the Sequentials' eager chain exactly, the state-dict keys are
those of the reference's layout, the K4 walk (26 epilogues a forward, run
here with the plain version in place of the kernel) computes the same net,
the forward picks the walk only where it may, and the wrapper refuses what
the kernel does not take before it builds or launches anything.
"""

import pytest
import torch
from torch import nn

from ideepcolor_tpu_torch.models import siggraph
from ideepcolor_tpu_torch.ops.cuda import build
from ideepcolor_tpu_torch.ops.cuda import conv_epilogue_kernel as k4


class _OnCuda:
    """A CPU tensor that reports a CUDA device: what a wrapper sees when it
    is handed a card tensor."""

    device = torch.device("cuda", 0)

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


def _sd(width=0.25, seed=0):
    """Seeded weights at ``width`` with nonzero biases and BatchNorm terms
    (``init_state_dict`` leaves them at 0 and 1)."""
    sd = siggraph.init_state_dict(width, seed)
    g = torch.Generator().manual_seed(seed + 1)
    for k, v in sd.items():
        if k.endswith("running_var"):
            sd[k] = torch.rand(v.shape, generator=g) + 0.5
        elif v.dim() == 1:
            sd[k] = v + 0.1 * torch.randn(v.shape, generator=g)
    return sd


def _inputs(N=2, S=32, seed=3):
    g = torch.Generator().manual_seed(seed)
    A = torch.rand(N, 1, S, S, generator=g) * 100 - 50
    M = (torch.rand(N, 1, S, S, generator=g) < 0.05).float()
    B = (torch.rand(N, 2, S, S, generator=g) * 160 - 80) * M
    return A, B, M


def _sequential_forward(m, A, B, M, maskcent=0.0):
    """The forward as the Sequentials compose it, the reference's order."""
    x = torch.cat([A / 100.0, B / 110.0, M - maskcent], dim=1).contiguous()
    c1 = m.model1(x)
    c2 = m.model2(c1[:, :, ::2, ::2])
    c3 = m.model3(c2[:, :, ::2, ::2])
    c4 = m.model4(c3[:, :, ::2, ::2])
    c7 = m.model7(m.model6(m.model5(c4)))
    c8 = m.model8(m.model8up(c7) + m.model3short8(c3))
    c9 = m.model9(m.model9up(c8) + m.model2short9(c2))
    c10 = m.model10(m.model10up(c9) + m.model1short10(c1))
    return torch.tanh(m.model_out(c10)) * 110.0, c8


def _net(width=0.25, seed=0):
    return siggraph.SIGGRAPHGenerator.from_state_dict(
        _sd(width, seed)).requires_grad_(False)


@pytest.mark.parametrize("maskcent", [0.0, 0.5])
def test_cpu_forward_is_the_sequential_chain(maskcent):
    net = _net()
    A, B, M = _inputs()
    want, c8 = _sequential_forward(net, A, B, M, maskcent)
    with torch.no_grad():
        assert torch.equal(net(A, B, M, maskcent), want)
        reg2, dist = net(A, B, M, maskcent, dist=True, dist_lowres=True)
    assert torch.equal(reg2, want * 110.0)
    assert torch.equal(dist, torch.softmax(net.model_class(c8) * 0.2, 1))


def test_state_dict_keys_are_the_reference_layout():
    """The module tree is the Sequentials' as before: every key the
    ``_BLOCKS`` table names, and no other, so checkpoints load strictly."""
    want = set()
    for block, convs, bn in siggraph._BLOCKS:
        want |= {f"{block}.{j}.{p}" for j in convs for p in ("weight",
                                                               "bias")}
        if bn is not None:
            want |= {f"{block}.{bn}.{p}" for p in (
                "weight", "bias", "running_mean", "running_var",
                "num_batches_tracked")}
    net = siggraph.SIGGRAPHGenerator()
    assert set(net.state_dict()) == want
    sd = _sd(1.0)
    net.load_state_dict(sd, strict=True)
    assert set(siggraph.state_dict_from_params(
        {k: v.numpy() for k, v in sd.items()
         if not k.endswith("num_batches_tracked")})) == want


def _plain_in_place(calls):
    """:func:`conv_epilogue_plain` written over ``y``, as K4 leaves it;
    each call's arguments are kept."""
    def run(y, bias, pair=None, pair_bias=None, negative_slope=None,
            bn=None):
        calls.append(dict(C=y.shape[1], pair=pair is not None,
                          slope=negative_slope, bn=bn is not None))
        return y.copy_(k4.conv_epilogue_plain(y, bias, pair, pair_bias,
                                              negative_slope, bn))
    return run


@pytest.mark.parametrize("width", [0.25, 0.5])
def test_k4_walk_computes_the_net(monkeypatch, width):
    """The walk the card takes, each conv without its bias and one
    epilogue after it, with the plain version standing in for the kernel:
    26 epilogues (19 in model1-7, 3 in model8, 2 in model9, 2 in model10),
    three of them skip sums, nine with a BatchNorm, one LeakyReLU; the
    result is the eager chain's up to the rounding of a conv's bias."""
    net = _net(width)
    calls = []
    monkeypatch.setattr(siggraph, "conv_epilogue", _plain_in_place(calls))
    monkeypatch.setattr(net, "_fuses_epilogues", lambda x: True)
    A, B, M = _inputs()
    with torch.no_grad():
        got = net(A, B, M)
    want, _c8 = _sequential_forward(net, A, B, M)
    assert len(calls) == 26
    assert sum(c["pair"] for c in calls) == 3
    assert sum(c["bn"] for c in calls) == 9
    assert [c["slope"] for c in calls if c["slope"] is not None] == [0.2]
    assert calls[-1] == dict(C=siggraph.scaled_channels(width)[1],
                             pair=False, slope=0.2, bn=False)
    assert torch.allclose(got, want, rtol=0, atol=1e-3)


class _Probe:
    """What ``_fuses_epilogues`` reads of an input."""

    def __init__(self, device="cuda", dtype=torch.float32, grad=False):
        self.device = torch.device(device)
        self.dtype = dtype
        self.requires_grad = grad


@pytest.mark.parametrize("case,fuses", [
    ("card", True),
    ("cpu", False),
    ("f64_input", False),
    ("bf16_convs", False),
    ("training", False),
    ("recorded", False),
    ("input_grad", False),
])
def test_forward_picks_k4_only_where_it_may(case, fuses):
    net = _net()
    probe = _Probe()
    grad = torch.no_grad()
    if case == "cpu":
        probe = _Probe("cpu")
    elif case == "f64_input":
        probe = _Probe(dtype=torch.float64)
    elif case == "bf16_convs":
        net.cast_weights_("bfloat16")
    elif case == "training":
        net.train()
    elif case == "recorded":
        net.requires_grad_(True)
        grad = torch.enable_grad()
    elif case == "input_grad":
        probe = _Probe(grad=True)
        grad = torch.enable_grad()
    with grad:
        assert net._fuses_epilogues(probe) is fuses


def test_plain_version_is_the_eager_chain():
    """:func:`conv_epilogue_plain` is what the Sequentials compute after a
    conv: the bias add, the skip add, the activation, the BatchNorm."""
    g = torch.Generator().manual_seed(0)
    y, p = torch.randn(2, 8, 5, 6, generator=g), torch.randn(
        2, 8, 5, 6, generator=g)
    b, pb = torch.randn(8, generator=g), torch.randn(8, generator=g)
    bn = nn.BatchNorm2d(8).eval()
    bn.running_mean.normal_(generator=g)
    bn.running_var.uniform_(0.5, 2.0, generator=g)
    c = lambda t: t.view(1, -1, 1, 1)  # noqa: E731
    assert torch.equal(k4.conv_epilogue_plain(y, b, bn=bn),
                       bn(nn.ReLU()(y + c(b))))
    assert torch.equal(
        k4.conv_epilogue_plain(y, b, p, pb),
        nn.ReLU()((y + c(b)) + (p + c(pb))))
    assert torch.equal(k4.conv_epilogue_plain(y, b, negative_slope=0.2),
                       nn.LeakyReLU(0.2)(y + c(b)))


def _cuda(*shape, dtype=torch.float32, fmt=torch.contiguous_format):
    return _OnCuda(torch.zeros(*shape, dtype=dtype).contiguous(
        memory_format=fmt))


def _bad(case):
    """(y, bias, keyword arguments) of a call K4 refuses, by ``case``."""
    y, b = _cuda(2, 8, 4, 4), _cuda(8)
    bn = nn.BatchNorm2d(8)
    if case == "cpu":
        return torch.zeros(2, 8, 4, 4), torch.zeros(8), {}
    if case == "f64":
        return _cuda(2, 8, 4, 4, dtype=torch.float64), b, {}
    if case == "bf16":
        return _cuda(2, 8, 4, 4, dtype=torch.bfloat16), b, {}
    if case == "rank":
        return _cuda(8, 4, 4), b, {}
    if case == "strided":
        return _OnCuda(torch.zeros(2, 8, 4, 8)[..., ::2]), b, {}
    if case == "bias_shape":
        return y, _cuda(4), {}
    if case == "bias_dtype":
        return y, _cuda(8, dtype=torch.float64), {}
    if case == "bias_on_cpu":
        return y, torch.zeros(8), {}
    if case == "pair_layout":
        return y, b, dict(pair=_cuda(2, 8, 4, 4, fmt=torch.channels_last),
                          pair_bias=b)
    if case == "pair_shape":
        return y, b, dict(pair=_cuda(2, 8, 4, 5), pair_bias=b)
    if case == "pair_without_bias":
        return y, b, dict(pair=_cuda(2, 8, 4, 4))
    if case == "bn_on_cpu":
        return y, b, dict(bn=bn)
    if case == "channels":
        return _cuda(1, 4096, 1, 1), _cuda(4096), {}
    raise KeyError(case)


@pytest.mark.parametrize("case,match", [
    ("cpu", "want a CUDA tensor"),
    ("f64", "float32"),
    ("bf16", "float32"),
    ("rank", r"\(N, C, H, W\)"),
    ("strided", "contiguous, NCHW or channels-last"),
    ("bias_shape", r"contiguous \(8,\)"),
    ("bias_dtype", "bias must be float32"),
    ("bias_on_cpu", "bias on cpu"),
    ("pair_layout", "strides"),
    ("pair_shape", "strides"),
    ("pair_without_bias", "pair_bias"),
    ("bn_on_cpu", "running_mean on cpu"),
    ("channels", "channels"),
])
def test_k4_wrapper_rejects_before_launch(monkeypatch, case, match):
    """K4's wrapper raises on what the kernel does not take, before it
    loads the library or launches."""
    def never(*a):
        raise AssertionError("K4 reached its library")
    monkeypatch.setattr(k4.KERNEL, "load", never)
    monkeypatch.setattr(k4.KERNEL, "launch", never)
    before = k4.KERNEL.launches
    y, bias, kw = _bad(case)
    with pytest.raises(ValueError, match=match):
        k4.conv_epilogue(y, bias, **kw)
    assert k4.KERNEL.launches == before


def test_k4_raises_on_cuda_without_kernel(monkeypatch):
    """On a CUDA tensor the wrapper launches K4 or raises; with no toolkit
    to build it, it raises and never returns the plain result."""
    monkeypatch.setattr(build, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("no nvcc")))
    monkeypatch.setattr(k4.KERNEL, "_fn", None)
    monkeypatch.setattr(k4.KERNEL, "library_path",
                        lambda: build.BUILD_DIR / "missing.so")
    before = k4.KERNEL.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        k4.conv_epilogue(_cuda(2, 8, 4, 4), _cuda(8),
                         bn=None, negative_slope=0.2)
    assert k4.KERNEL.launches == before
    assert k4.KERNEL in build.KERNELS
