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
"""

import numpy as np
import pytest
import torch

from ideepcolor_tpu_torch.models import global_stats
from ideepcolor_tpu_torch.ops.cuda import global_stats_kernel as k3


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
