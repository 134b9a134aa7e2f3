"""The port's hand-written kernels on a CUDA device, held to their plain
versions on the same card. Every test here is marked ``card`` and skips
without a device. The file imports neither JAX nor the repository's test
configuration, so on the card's machine (which has no JAX) it runs alone:

    python3 -m pytest --noconftest -m card tests/test_torch_card_kernels.py

K3 (the global color statistics) against the plain chain on seeded
references: the kernel takes the direct distance to each bin center and the
chain its product expansion, so the two may disagree on the bin of one
pooled pixel within rounding of a boundary; the means agree within 2e-5;
the kernel gives the same bits on every call.

K4 (a SIGGRAPH conv's epilogue, in place) against its plain chain, bit
for bit: bias, skip sum, activation and cuDNN's BatchNorm; the whole
forward (the TF32 channels-last batch and the f32 captured click) against
the eager chain of the Sequentials, on cuDNN's deterministic kernels; a
captured click follows weights loaded between two replays.
"""

import os

import numpy as np
import pytest
import torch
from torch import nn

from ideepcolor_tpu_torch.models import global_stats, siggraph
from ideepcolor_tpu_torch.ops.cuda import conv_epilogue_kernel as k4
from ideepcolor_tpu_torch.ops.cuda import global_stats_kernel as k3

TEACHER = os.path.join(os.path.dirname(__file__), os.pardir, "weights",
                       "teacher.npz")


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _reference(seed, H, W):
    """A seeded smooth color field with noise, f32 (H, W, 3) in [0, 1], as
    the uint8 references are divided down."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / max(H, W)
    base = np.stack([np.sin(6 * yy + c) * np.cos(5 * xx - 2 * c)
                     for c in range(3)], -1)
    u8 = np.clip(127.5 + 100 * base + rng.normal(0, 12, (H, W, 3)), 0, 255)
    return u8.astype(np.uint8).astype(np.float32) / 255.0


@pytest.mark.card
@pytest.mark.parametrize("seed,H,W", [(3, 256, 256), (4, 256, 256),
                                      (5, 1000, 752)])
def test_k3_against_the_plain_chain(card, seed, H, W):
    rgb = torch.from_numpy(_reference(seed, H, W)).to(card)
    before = k3.KERNEL.launches
    glob, s_avg, bgr_avg = k3.global_stats(rgb)
    again = k3.global_stats(rgb)
    p_glob, p_s, p_bgr = k3.global_stats_plain(rgb)
    torch.cuda.synchronize()
    assert k3.KERNEL.launches == before + 2
    pooled = (H // 4) * (W // 4)
    counts = (glob.double() * pooled).round().long()
    p_counts = (p_glob.double() * pooled).round().long()
    assert int(counts.sum()) == pooled
    diff = (counts - p_counts).abs()
    assert int(diff.max()) <= 1 and int(diff.sum()) <= 2     # one pixel
    assert float((s_avg - p_s).abs()) <= 2e-5
    assert float((bgr_avg - p_bgr).abs().max()) <= 2e-5
    for got, want in zip(again, (glob, s_avg, bgr_avg)):
        assert torch.equal(got, want)


@pytest.mark.card
def test_k3_is_extract_on_the_card(card):
    """``extract`` on a CUDA tensor is one K3 call: new tensors each call,
    on the card, equal to the wrapper's."""
    rgb = torch.from_numpy(_reference(6, 256, 256)).to(card)
    before = k3.KERNEL.launches
    a = global_stats.extract(rgb)
    b = global_stats.extract(rgb)
    assert k3.KERNEL.launches == before + 2
    want = k3.global_stats(rgb)
    for key, w in zip(("glob_ab_313", "s_avg", "bgr_avg"), want):
        assert a[key].device.type == "cuda"
        assert a[key].data_ptr() != b[key].data_ptr()
        assert torch.equal(a[key], w) and torch.equal(b[key], w)
    assert abs(float(a["glob_ab_313"].sum()) - 1.0) <= 1e-5


def _bn(C, seed, device):
    """An inference BatchNorm with seeded statistics and affine terms."""
    g = torch.Generator().manual_seed(seed)
    bn = nn.BatchNorm2d(C).eval()
    bn.running_mean.copy_(torch.randn(C, generator=g))
    bn.running_var.copy_(torch.rand(C, generator=g) * 2 + 0.05)
    bn.weight.data.copy_(torch.randn(C, generator=g))
    bn.bias.data.copy_(torch.randn(C, generator=g))
    return bn.to(device)


# channels -> (H, W) of the test tensor: the net's sizes cut to keep N=16
# small, and one shape whose inner size is no multiple of 4 (scalar path)
_SHAPES = {64: (128, 128), 128: (64, 64), 256: (32, 32), 512: (16, 16),
           6: (15, 13)}


@pytest.mark.card
@pytest.mark.parametrize("C", [64, 128, 256, 512, 6])
@pytest.mark.parametrize("N", [1, 16])
@pytest.mark.parametrize("nhwc", [False, True], ids=["nchw", "nhwc"])
def test_k4_against_the_plain_chain(card, C, N, nhwc):
    """Every epilogue K4 runs (ReLU or LeakyReLU(0.2), with and without the
    pair, with and without BatchNorm) in place on a seeded conv output,
    against :func:`conv_epilogue_plain` on the same card: the same bits."""
    H, W = _SHAPES[C]
    fmt = torch.channels_last if nhwc else torch.contiguous_format
    g = torch.Generator().manual_seed(C * 100 + N)
    mk = lambda *s: torch.randn(*s, generator=g).to(card)  # noqa: E731
    y0 = mk(N, C, H, W).contiguous(memory_format=fmt)
    p0 = mk(N, C, H, W).contiguous(memory_format=fmt)
    bias, pbias = mk(C), mk(C)
    bn = _bn(C, C + N, card)
    for slope in (None, 0.2):
        for pair in (False, True):
            for with_bn in (False, True):
                kw = dict(pair=p0 if pair else None,
                          pair_bias=pbias if pair else None,
                          negative_slope=slope, bn=bn if with_bn else None)
                want = k4.conv_epilogue_plain(y0, bias, **kw)
                y = y0.clone()
                before = k4.KERNEL.launches
                got = k4.conv_epilogue(y, bias, **kw)
                torch.cuda.synchronize()
                assert got is y and k4.KERNEL.launches == before + 1
                assert y.stride() == y0.stride()
                bad = int((got != want).sum())
                assert bad == 0, (slope, pair, with_bn, bad)


def _sd(seed, scale=1.0):
    """The teacher's weights, every tensor scaled by ``scale`` and its
    biases and BatchNorm terms shifted by seeded noise where seed > 0."""
    sd = siggraph.load_state_dict_file(TEACHER)
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in sd.items():
        if v.is_floating_point():
            v = v * scale
            if seed and v.dim() == 1 and not k.endswith("running_var"):
                v = v + 0.05 * torch.randn(v.shape, generator=g)
        out[k] = v
    return out


def _eager(net):
    """``net`` with its epilogues forced onto the eager chain."""
    net._fuses_epilogues = lambda x: False
    return net


def _deterministic():
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=True)


def _batch(card, N=16, S=256, seed=7):
    g = torch.Generator().manual_seed(seed)
    A = (torch.rand(N, 1, S, S, generator=g) * 100 - 50).to(card)
    mask = (torch.rand(N, 1, S, S, generator=g) < 0.002).float().to(card)
    B = (torch.rand(N, 2, S, S, generator=g) * 160 - 80).to(card)
    return A, B * mask, mask


@pytest.mark.card
def test_k4_batch_forward_against_the_eager_chain(card):
    """The N=16 TF32 channels-last forward of the batch engine, K4's 26
    launches against the Sequentials' eager chain, on cuDNN's deterministic
    kernels on both sides: the same bits."""
    sd = _sd(0)
    net = siggraph.SIGGRAPHGenerator.from_state_dict(sd).to(card)
    ref = _eager(siggraph.SIGGRAPHGenerator.from_state_dict(sd).to(card))
    net.requires_grad_(False)
    ref.requires_grad_(False)
    A, B, M = _batch(card)
    with _deterministic(), torch.no_grad():
        before = k4.KERNEL.launches
        got = net(A, B, M, precision_name="default")
        torch.cuda.synchronize()
        assert k4.KERNEL.launches == before + 26
        want = ref(A, B, M, precision_name="default")
        assert k4.KERNEL.launches == before + 26
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want), float((got - want).abs().max())


def _session(card, sd, eager=False):
    from ideepcolor_tpu_torch.api.colorize import ColorizeImageTorch
    m = ColorizeImageTorch(Xd=256, device=card)
    m.prep_net(path=TEACHER)
    m.net.load_state_dict(sd, strict=True)
    if eager:
        _eager(m.net)
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:192, 0:256] / 256.0
    img = np.stack([np.sin(7 * yy + c) * np.cos(4 * xx - c)
                    for c in range(3)], -1)
    m.load_image_array(np.clip(127.5 + 100 * img + rng.normal(
        0, 10, img.shape), 0, 255).astype(np.uint8))
    return m


def _table(n=5, seed=3):
    from ideepcolor_tpu_torch.ops.hints import MAX_HINTS
    rng = np.random.default_rng(seed)
    boxes = np.zeros((MAX_HINTS, 4), np.int32)
    values = np.zeros((MAX_HINTS, 2), np.float32)
    for i in range(n):
        y, x, r = rng.integers(8, 240), rng.integers(8, 240), rng.integers(
            0, 4)
        boxes[i] = (y - r, x - r, y + r, x + r)
        values[i] = rng.uniform(-60, 60, 2)
    return boxes, values, n


@pytest.mark.card
def test_k4_captured_click_against_the_eager_chain(card):
    """The f32 table click (one captured graph, NCHW, N=1) with K4's
    launches among its nodes, against a session whose net runs the eager
    chain, both captured under cuDNN's deterministic flag: the same frame
    and ab."""
    sd = _sd(0)
    with _deterministic():
        m, ref = _session(card, sd), _session(card, sd, eager=True)
        before = k4.KERNEL.launches
        for _ in range(3):                    # capture, then replays
            got = m.net_forward_table(*_table()).copy()
        assert k4.KERNEL.launches >= before + 3 * 26
        want = ref.net_forward_table(*_table()).copy()
        assert torch.equal(m._dev_output_ab, ref._dev_output_ab)
    assert np.array_equal(got, want)


@pytest.mark.card
def test_k4_captured_click_follows_a_weight_reload(card):
    """Weights loaded in place between two replays of a captured click
    reach the next replay: K4 reads the biases and the BatchNorm terms by
    pointer, the f32 convs their weights."""
    old, new = _sd(0), _sd(5, scale=0.97)
    with _deterministic():
        m = _session(card, old)
        first = m.net_forward_table(*_table()).copy()
        again = m.net_forward_table(*_table()).copy()     # a replay
        m.net.load_state_dict(new, strict=True)
        after = m.net_forward_table(*_table()).copy()
        fresh = _session(card, new).net_forward_table(*_table()).copy()
    assert np.array_equal(again, first)
    assert float((after != first).mean()) > 0.05
    assert np.array_equal(after, fresh)
