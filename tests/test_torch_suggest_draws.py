"""The uniform numbers a suggestion drew, kept on the device beside the map
(``ColorizeImageTorchDist._dev_draws``), on the CPU at Xd=64 on the bundled
width-0.25 student: they give each entry's palette again through the
deterministic cores of ``ops.kmeans``, and through the JAX package's; a
fixed generator seed gives the palettes the programs gave before they
handed the draws back; and the dist entries open their spans (``click``
around ``predict_dist_table``, ``suggest`` around ``get_ab_reccs`` and
``suggest_table``)."""

import collections
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ideepcolor_tpu.ops import kmeans as jkm
from ideepcolor_tpu_torch.api.colorize import (ColorizeImageTorchCaffeDist,
                                               ColorizeImageTorchDist)
from ideepcolor_tpu_torch.engine import pipeline as tP
from ideepcolor_tpu_torch.ops import kmeans as tkm
from ideepcolor_tpu_torch.ops.cuda import colorspace_kernel as k2
from ideepcolor_tpu_torch.ops.hints import points_json_to_table
from ideepcolor_tpu_torch.utils import profiling as tprof

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDENT = os.path.join(ROOT, "weights", "student_w025.npz")
XD = 64
K, N = 9, 25000
ENTRIES = ["get_ab_reccs", "suggest_table"]

# the suggest program's (K, 3) output, centers and confidences, as float32
# bytes, computed by the commit before the programs handed their draws back
# (the map below, the pixel and the generator seed of each case)
PARENT_PROGRAM_OUT = {
    (0, 37, 21): "04d7d2c10f49c9c2a089303ef5000f4254ee30c2f0a22f3e6cc10a42"
                 "1abb9e4254e3253e6af666c03793a2417e57043ecfe8a0c25c6e8d42"
                 "3468e83d07b2b242c445a3c07b31943d78b47b42c9f5c6c2e57e873d"
                 "3340bf42626e7e42b055823d024db7c281a60cc2f085493d",
    (7, 60, 3): "d35d4cbecaad11426974873ea408afc2947365428126423eaff33942"
                "93f923c28ca11c3ef45dd2c2afbf27c2ba83d83d965832c2bae8e2c1"
                "71ac8b3d09b7b1c275aaacc2a25d853de81ca642c118ab423a7a7c3d"
                "683cabc0b84096c2e44e693da97cab4265060ac0d157103d",
}


def _image(seed, H, W):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / max(H, W)
    base = np.stack([np.sin(6 * yy + c) * np.cos(5 * xx - 2 * c)
                     for c in range(3)], -1)
    return np.clip(127.5 + 100 * base + rng.normal(0, 12, (H, W, 3)),
                   0, 255).astype(np.uint8)


def _table(n, seed=1):
    rng = np.random.default_rng(seed)
    return points_json_to_table(
        [{"y": int(rng.integers(0, XD)), "x": int(rng.integers(0, XD)),
          "ab": rng.uniform(-80, 80, 2).tolist(),
          "radius": int(rng.integers(0, 4))} for _ in range(n)], XD)


@pytest.fixture(scope="module")
def dist():
    d = ColorizeImageTorchDist(Xd=XD, device="cpu")
    d.prep_net(path=STUDENT)
    d.load_image_array(_image(3, 90, 70))
    assert d.predict_dist_table(*_table(5)) == 0
    return d


def _suggest(d, entry, h, w, seed):
    """The entry's palette at (h, w) from generator seed ``seed``: (the
    (K,2) centers or None, the (K,) confidences, the uint8 colors or
    None)."""
    d._generator.manual_seed(seed)
    if entry == "get_ab_reccs":
        centers, conf = d.get_ab_reccs(h, w, K=K, N=N, return_conf=True)
        return centers, conf, None
    colors, conf = d.suggest_table(*_table(5), h, w, K=K, N=N)
    return None, conf, colors


def _pdf(d, h, w):
    return d._dev_dist[h // d.dist_map_div, w // d.dist_map_div]


def _cores(pdf, pts, u_bins, u_seeds):
    """The palette from the draws through ``ops.kmeans``'s deterministic
    cores, step by step: the sampler's histogram, the seeds of each
    restart, Lloyd, the lowest inertia, the sort by occupancy."""
    w = tkm.bins_from_uniform(pdf, u_bins).to(torch.float32)
    seeds = tkm.seeds_from_uniform(pts, w, u_seeds)
    centers, mass, inertia = tkm._lloyd(pts, w, seeds, u_seeds.shape[1], 30)
    best = int(inertia.argmin())
    order = torch.argsort(-mass[best], stable=True)
    return centers[best][order], mass[best][order] / w.sum()


@pytest.mark.parametrize("seed", [3, 11])
@pytest.mark.parametrize("entry", ENTRIES)
def test_exposed_draws_reproduce_the_palette(dist, entry, seed):
    h, w = 37, 21
    centers, conf, colors = _suggest(dist, entry, h, w, seed)
    u_bins, u_seeds = dist._dev_draws
    assert u_bins.shape == (N,) and u_seeds.shape == (tkm.RESTARTS, K)
    want_c, want_conf = _cores(_pdf(dist, h, w), dist._dev_pts(), u_bins,
                               u_seeds)
    assert np.array_equal(conf, want_conf.numpy())
    if centers is not None:
        assert np.array_equal(centers, want_c.numpy())
    else:
        lab = tP._palette_lab(dist._dev_l_net, h, w, want_c)
        want = k2.lab_to_rgb_u8_hwc(lab[None, :, 0], lab[None, :, 1],
                                    lab[None, :, 2])[0]
        assert np.array_equal(colors, want.numpy())


@pytest.mark.parametrize("entry", ENTRIES)
def test_draws_fed_to_the_jax_cores_give_the_same_centers(dist, entry,
                                                          monkeypatch):
    """The JAX package's sampler, its uniform numbers replaced by the
    port's, gives the same histogram; its Lloyd from the seeds the port's
    draws give gives the palette within the bars of test_torch_kmeans
    (centers 1e-3, masses equal, inertia 1e-4 relative)."""
    h, w = 50, 9
    centers, conf, _colors = _suggest(dist, entry, h, w, 5)
    if centers is None:               # suggest_table gives no centers: the
        centers, conf = _cores(       # cores' (held to it bit for bit above)
            _pdf(dist, h, w), dist._dev_pts(), *dist._dev_draws)
        centers, conf = centers.numpy(), conf.numpy()
    u_bins, u_seeds = (t.numpy() for t in dist._dev_draws)
    pdf = _pdf(dist, h, w).numpy()
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape: jnp.asarray(u_bins))
    with jax.disable_jit():
        counts = np.asarray(jkm.sample_bins(jnp.asarray(pdf),
                                            jax.random.key(0), N=N))
    monkeypatch.undo()
    pts = dist._dev_pts()
    port_counts = tkm.bins_from_uniform(torch.from_numpy(pdf),
                                        torch.from_numpy(u_bins))
    assert np.array_equal(counts, port_counts.numpy())
    wts = counts.astype(np.float32)
    seeds = tkm.seeds_from_uniform(pts, torch.from_numpy(wts),
                                   torch.from_numpy(u_seeds)).numpy()
    runs = [[np.asarray(x) for x in jkm._lloyd(
        jnp.asarray(pts.numpy()), jnp.asarray(wts), jnp.asarray(s), K, 30)]
        for s in seeds]
    best = min(runs, key=lambda r: float(r[2]))
    order = np.argsort(-best[1], kind="stable")
    assert np.abs(best[0][order] - centers).max() <= 1e-3
    assert np.array_equal(best[1][order] / wts.sum(), conf)


@pytest.mark.parametrize("case", sorted(PARENT_PROGRAM_OUT))
def test_fixed_seed_gives_the_parent_program_palette(case):
    seed, h, w = case
    rng = np.random.default_rng(23)
    dmap = torch.from_numpy(rng.dirichlet(np.ones(529) * 0.05, (16, 16))
                            .astype(np.float32))
    pts = torch.from_numpy(np.stack(np.meshgrid(
        np.arange(-110, 111, 10), np.arange(-110, 111, 10), indexing="ij"),
        -1).reshape(-1, 2).astype(np.float32))
    out, _u_bins, _u_seeds = tP.make_suggest_program()(
        dmap, h, w, pts, torch.Generator().manual_seed(seed), K=K, N=N,
        map_div=4)
    assert out.numpy().tobytes().hex() == PARENT_PROGRAM_OUT[case]


@pytest.mark.parametrize("entry", ENTRIES)
def test_fixed_seed_gives_the_parent_entry_palette(dist, entry):
    """The entries' palettes are those of the chain as it drew before:
    the sampler's N numbers, then the seeding's, from one generator
    (``sample_bins`` then ``weighted_kmeans``), bit for bit."""
    h, w = 21, 44
    centers, conf, colors = _suggest(dist, entry, h, w, 17)
    gen = torch.Generator().manual_seed(17)
    pts = dist._dev_pts()
    counts = tkm.sample_bins(_pdf(dist, h, w), gen, N=N)
    want_c, want_conf = tkm.weighted_kmeans(pts, counts, gen, K=K)
    assert np.array_equal(conf, want_conf.numpy())
    if centers is not None:
        assert np.array_equal(centers, want_c.numpy())
    else:
        lab = tP._palette_lab(dist._dev_l_net, h, w, want_c)
        assert np.array_equal(colors, k2.lab_to_rgb_u8_hwc(
            lab[None, :, 0], lab[None, :, 1], lab[None, :, 2])[0].numpy())


@pytest.mark.parametrize("bad_k", [0, 26])
def test_get_ab_reccs_bounds_its_palette_as_suggest_table_does(dist, bad_k):
    """A K outside [1, MAX_SUGGEST_K] is refused before anything is drawn:
    the generator and the kept draws stay as they were."""
    dist.get_ab_reccs(21, 44, K=K, N=N)
    state, draws = dist._generator.get_state(), dist._dev_draws
    with pytest.raises(ValueError, match="k must be in"):
        dist.get_ab_reccs(21, 44, K=bad_k, N=N)
    assert torch.equal(dist._generator.get_state(), state)
    assert dist._dev_draws is draws
    assert dist.MAX_SUGGEST_K == ColorizeImageTorchCaffeDist.MAX_SUGGEST_K


def _spans(tmp_path, fn):
    with tprof.device_trace(str(tmp_path)):
        fn()
    with open(tmp_path / tprof.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


@pytest.mark.parametrize("cls", [ColorizeImageTorchDist,
                                 ColorizeImageTorchCaffeDist])
@pytest.mark.parametrize("entry,root,want", [
    ("predict_dist_table", "click", {"click.hints": 1, "click.upload": 1}),
    ("get_ab_reccs", "suggest", {"click.upload": 1}),
    ("suggest_table", "suggest", {"click.hints": 1, "click.upload": 1}),
])
def test_dist_entry_spans(tmp_path, cls, entry, root, want):
    """One root span per call, ``click`` for the forward of
    ``predict_dist_table`` and ``suggest`` for a suggestion, with the
    table's and pixel's spans inside it and no other root."""
    d = cls(Xd=32, device="cpu")
    d.prep_net() if cls is ColorizeImageTorchCaffeDist else d.prep_net(
        path=STUDENT)
    d.load_image_array(_image(4, 40, 30))
    table = points_json_to_table([{"y": 5, "x": 7, "ab": [20.0, -30.0],
                                   "radius": 1}], 32)
    assert d.predict_dist_table(*table) == 0
    call = {"predict_dist_table": lambda: d.predict_dist_table(*table),
            "get_ab_reccs": lambda: d.get_ab_reccs(9, 11, K=3, N=2000),
            "suggest_table": lambda: d.suggest_table(*table, 9, 11, K=3,
                                                     N=2000)}[entry]
    spans = _spans(tmp_path, call)
    assert collections.Counter(n for n, _s, _e in spans) == {root: 1, **want}
    (r0, r1), = [(s, e) for n, s, e in spans if n == root]
    for n, s, e in spans:
        assert r0 <= s <= e <= r1, (n, s, e, r0, r1)
