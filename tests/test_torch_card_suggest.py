"""The dist model's suggestions on a CUDA device, each entry a captured
graph: the uniform numbers a palette drew stay on the device in the
program's own output buffers and give the palette again through the
deterministic cores of ``ops.kmeans``; a palette is the one the chain drew
before it handed its numbers back (the sampler's, then the seeding's, from
the model's generator); and a call copies no more between host and device
than the pixel or table up and the palette down. Every test here is marked
``card`` and skips without a device. The file imports neither JAX nor the
repository's test configuration, so on the card's machine it runs alone:

    python3 -m pytest --noconftest -m card tests/test_torch_card_suggest.py
"""

import os

import numpy as np
import pytest
import torch

from ideepcolor_tpu_torch.api.colorize import ColorizeImageTorchDist
from ideepcolor_tpu_torch.engine import pipeline as P
from ideepcolor_tpu_torch.ops import kmeans as km
from ideepcolor_tpu_torch.ops.cuda import colorspace_kernel as k2

STUDENT = os.path.join(os.path.dirname(__file__), os.pardir, "weights",
                       "student_w025.npz")
XD, K, N = 64, 9, 25000
ENTRIES = ["get_ab_reccs", "suggest_table"]


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _table():
    boxes = np.array([[10, 12, 13, 15], [40, 30, 41, 31]], np.int32)
    values = np.array([[35.0, -20.0], [-10.0, 50.0]], np.float32)
    return boxes, values, 2


def _model(device):
    d = ColorizeImageTorchDist(Xd=XD, device=device)
    d.prep_net(path=STUDENT)
    rng = np.random.default_rng(2)
    d.load_image_array((rng.random((90, 70, 3)) * 255).astype(np.uint8))
    assert d.predict_dist_table(*_table()) == 0
    return d


def _call(d, entry, h, w):
    """(centers or None, conf, colors or None) of one call."""
    if entry == "get_ab_reccs":
        c, conf = d.get_ab_reccs(h, w, K=K, N=N, return_conf=True)
        return c, conf, None
    colors, conf = d.suggest_table(*_table(), h, w, K=K, N=N)
    return None, conf, colors


def _palette_from(d, h, w, centers, conf, colors, want_c, want_conf):
    assert np.array_equal(conf, want_conf.cpu().numpy())
    if centers is not None:
        assert np.array_equal(centers, want_c.cpu().numpy())
    else:
        lab = P._palette_lab(d._dev_l_net, h, w, want_c)
        assert np.array_equal(colors, k2.lab_to_rgb_u8_hwc(
            lab[None, :, 0], lab[None, :, 1], lab[None, :, 2])[0].cpu()
            .numpy())


@pytest.mark.card
@pytest.mark.parametrize("entry", ENTRIES)
def test_captured_suggestions_keep_their_draws(card, entry):
    """Three calls (the capture, then replays): after each, the draws
    are the graph's own buffers, the same ones every call, and give its
    palette again bit for bit."""
    d = _model(card)
    ptrs = set()
    for i, (h, w) in enumerate([(20, 33), (50, 7), (3, 60)]):
        centers, conf, colors = _call(d, entry, h, w)
        u_bins, u_seeds = d._dev_draws
        assert u_bins.device.type == "cuda" and u_bins.shape == (N,)
        assert u_seeds.shape == (km.RESTARTS, K)
        if i:
            ptrs.add((u_bins.data_ptr(), u_seeds.data_ptr()))
        pdf = d._dev_dist[h // 4, w // 4]
        want_c, want_conf = km.kmeans_from_uniform(
            d._dev_pts(), km.bins_from_uniform(pdf, u_bins), u_seeds)
        _palette_from(d, h, w, centers, conf, colors, want_c, want_conf)
    assert len(ptrs) == 1


@pytest.mark.card
@pytest.mark.parametrize("entry", ENTRIES)
def test_captured_suggestion_is_the_chain_as_it_drew_before(card, entry):
    """From one state of the model's generator, the captured palette is
    that of the eager chain as it drew before the draws were handed back:
    ``sample_bins`` then ``weighted_kmeans``."""
    d = _model(card)
    h, w = 21, 44
    _call(d, entry, h, w)                     # capture
    d._generator.manual_seed(17)
    centers, conf, colors = _call(d, entry, h, w)
    gen = torch.Generator(device=card).manual_seed(17)
    counts = km.sample_bins(d._dev_dist[h // 4, w // 4], gen, N=N)
    want_c, want_conf = km.weighted_kmeans(d._dev_pts(), counts, gen, K=K)
    _palette_from(d, h, w, centers, conf, colors, want_c, want_conf)


@pytest.mark.card
@pytest.mark.parametrize("entry,up,down", [("get_ab_reccs", 1, 1),
                                           ("suggest_table", 1, 2)])
def test_a_suggestion_copies_only_its_inputs_and_palette(card, entry, up,
                                                         down):
    """Under the profiler, a replayed call copies its table and pixel up
    once and its palette (and confidences) down, and nothing else crosses
    between host and device."""
    from torch.profiler import ProfilerActivity, profile
    d = _model(card)
    _call(d, entry, 20, 33)                   # capture
    _call(d, entry, 20, 33)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _call(d, entry, 30, 5)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("HtoD" in n for n in names) == up, names
    assert sum("DtoH" in n for n in names) == down, names
