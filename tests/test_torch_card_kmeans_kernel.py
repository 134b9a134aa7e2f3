"""K5, the suggestion chain's kernel, on a CUDA device, held to its plain
version, ``ops.kmeans.bins_from_uniform`` then ``kmeans_from_uniform``, on
the same card from the same pdf and draws. Every test here is marked
``card`` and skips without a device. The file imports neither JAX nor the
repository's test configuration, so on the card's machine it runs alone:

    python3 -m pytest --noconftest -m card tests/test_torch_card_kmeans_kernel.py

The histogram is the chain's exactly. The palette (centers, confidences,
order) is the chain's bit for bit; where it is not, float32 rounding
decided a choice (a seeding draw at the boundary of two points, two
restarts' inertias within rounding of each other), and both palettes must
be among those that the benchmark's check allows for these draws
(``benchmark/models/siggraph_dist.py`` ``palettes``).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from ideepcolor_tpu_torch.data.color_bins import get_bins
from ideepcolor_tpu_torch.ops import kmeans as km
from ideepcolor_tpu_torch.ops.cuda import kmeans_kernel as k5

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
SEEDS = 3
STEPS = 30


def _check_module():
    """``benchmark/models/siggraph_dist.py``, the check's chain."""
    import sys
    bench = os.path.join(ROOT, "benchmark")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    spec = importlib.util.spec_from_file_location(
        "k5_check_siggraph_dist",
        os.path.join(bench, "models", "siggraph_dist.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _table(name, device):
    if name == "grid529":
        r = np.arange(-110, 120, 10)
        pts = np.array(np.meshgrid(r, r)).reshape(2, -1).T
    else:
        pts = get_bins().pts_in_hull
    return torch.as_tensor(pts, dtype=torch.float32, device=device)


def _pdf(kind, Q, seed, device):
    g = torch.Generator().manual_seed(seed)
    if kind == "peaky":
        pdf = torch.softmax(torch.randn(Q, generator=g) * 4.0, 0)
    elif kind == "flat":
        pdf = torch.full((Q,), 1.0 / Q)
    else:                                   # one bin holds all the mass
        pdf = torch.zeros(Q)
        pdf[int(torch.randint(Q, (1,), generator=g))] = 1.0
    return pdf.to(device)


def _draws(N, K, seed, device):
    g = torch.Generator(device=device).manual_seed(1000 + seed)
    return (torch.rand(N, generator=g, device=device),
            torch.rand((km.RESTARTS, K), generator=g, device=device))


def _allowed(check, pdf, pts, u_bins, u_seeds, centers, conf) -> bool:
    for c, share, _n in check.palettes(pdf, pts, u_bins, u_seeds, STEPS):
        if np.array_equal(c, centers) and np.array_equal(share, conf):
            return True
    return False


@pytest.mark.card
@pytest.mark.parametrize("table", ["grid529", "hull313"])
@pytest.mark.parametrize("kind", ["peaky", "flat", "one_bin"])
@pytest.mark.parametrize("N", [1, 1000, 25000])
@pytest.mark.parametrize("K", [1, 5, 9, 32])
def test_k5_is_the_plain_chain(card, table, kind, N, K):
    pts = _table(table, card)
    check = None
    for seed in range(SEEDS):
        pdf = _pdf(kind, pts.shape[0], seed, card)
        u_bins, u_seeds = _draws(N, K, seed, card)
        before = k5.KERNEL.launches
        out, counts = k5.suggest(pdf, pts, u_bins, u_seeds, STEPS,
                                 return_counts=True)
        assert k5.KERNEL.launches == before + 1
        w = km.bins_from_uniform(pdf, u_bins)
        assert torch.equal(counts.to(torch.int64), w)
        want_c, want_conf = km.kmeans_from_uniform(pts, w, u_seeds, STEPS)
        got_c, got_conf = out[:, :2], out[:, 2]
        if torch.equal(got_c, want_c) and torch.equal(got_conf, want_conf):
            continue
        # rounding decided a choice: both palettes must be allowed ones
        check = check or _check_module()
        for c, f in ((got_c, got_conf), (want_c, want_conf)):
            assert _allowed(check, pdf, pts, u_bins, u_seeds,
                            c.cpu().numpy(), f.cpu().numpy()), (
                f"{table} {kind} N={N} K={K} seed {seed}: "
                f"{c.tolist()} {f.tolist()}")


@pytest.mark.card
@pytest.mark.parametrize("K", [1, 9, 32])
def test_k5_captured_equals_eager(card, K):
    pts = _table("grid529", card)
    pdf = _pdf("peaky", 529, 7, card)
    u_bins, u_seeds = _draws(25000, K, 7, card)
    eager = k5.suggest(pdf, pts, u_bins, u_seeds, STEPS)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k5.suggest(pdf, pts, u_bins, u_seeds, STEPS)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = k5.suggest(pdf, pts, u_bins, u_seeds, STEPS)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)
    # the graph reads its inputs where they lie: new draws, new palette
    u_bins.copy_(_draws(25000, K, 8, card)[0])
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, k5.suggest(pdf, pts, u_bins, u_seeds, STEPS))


@pytest.mark.card
def test_ab_recommendations_takes_k5_on_the_card(card):
    """The suggestion chain on the card is one K5 launch after its draws,
    and its draws give the plain chain's palette again."""
    pts = _table("grid529", card)
    pdf = _pdf("peaky", 529, 3, card)
    gen = torch.Generator(device=card).manual_seed(5)
    before = k5.KERNEL.launches
    c, conf, u_bins, u_seeds = km.ab_recommendations(
        pdf, pts, gen, K=9, return_draws=True)
    assert k5.KERNEL.launches == before + 1
    want_c, want_conf = km.kmeans_from_uniform(
        pts, km.bins_from_uniform(pdf, u_bins), u_seeds)
    assert torch.equal(c, want_c) and torch.equal(conf, want_conf)
    # beyond the kernel's limits the chain runs
    before = k5.KERNEL.launches
    km.ab_recommendations(pdf, pts, gen, K=k5.MAX_K + 1)
    assert k5.KERNEL.launches == before


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_ab_recommendations_takes_k5_whatever_the_pdf_dtype(card, dtype):
    """A bf16 session's map (or a float64 one) takes K5 too, on the
    float32 values the plain chain computes with: the same palette."""
    pts = _table("grid529", card)
    pdf = _pdf("peaky", 529, 4, card).to(dtype)
    gen = torch.Generator(device=card).manual_seed(6)
    before = k5.KERNEL.launches
    c, conf, u_bins, u_seeds = km.ab_recommendations(
        pdf, pts, gen, K=9, return_draws=True)
    assert k5.KERNEL.launches == before + 1
    want_c, want_conf = km.kmeans_from_uniform(
        pts, km.bins_from_uniform(pdf, u_bins), u_seeds)
    if not (torch.equal(c, want_c) and torch.equal(conf, want_conf)):
        pdf32 = pdf.to(torch.float32)
        for got, share in ((c, conf), (want_c, want_conf)):
            assert _allowed(_check_module(), pdf32, pts, u_bins, u_seeds,
                            got.cpu().numpy(), share.cpu().numpy())
