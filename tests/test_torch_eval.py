"""The port's evaluation (PSNR curve, hint fidelity, contact sheet) against
the JAX app's on the CPU, on the same images, weights and hint locations:
the port's per-chunk normals are replaced by JAX's draws from the same
seeds."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from ideepcolor_tpu.apps import eval as jeval
from ideepcolor_tpu_torch.apps import eval as teval
from ideepcolor_tpu_torch.models import siggraph as tsig
from ideepcolor_tpu_torch.utils.imageio import decode_image, encode_png

torch.set_num_threads(2)
STUDENT = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "weights", "student_w025.npz")
COUNTS = (0, 1, 2, 5, 10, 25)


def smooth_image(seed, H, W):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / max(H, W)
    base = np.stack([np.sin(6 * yy + c) * np.cos(5 * xx - 2 * c)
                     for c in range(3)], -1)
    return np.clip(127.5 + 100 * base + rng.normal(0, 12, (H, W, 3)),
                   0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def models():
    with np.load(STUDENT) as z:
        params = {k: z[k] for k in z.files}
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    net = tsig.SIGGRAPHGenerator.from_state_dict(
        tsig.state_dict_from_params(params)).requires_grad_(False)
    return jp, net


@pytest.fixture(scope="module")
def images():
    return np.stack([smooth_image(40 + i, 64, 64) for i in range(5)]
                    ).astype(np.float32) / 255.0


@pytest.fixture
def jax_locations(monkeypatch):
    """Each chunk's hint locations from JAX's key for the same seed."""
    def normals(key_seed, n, device):
        z = jax.random.normal(jax.random.key(key_seed), (n, 32, 2))
        return torch.from_numpy(np.array(z)).to(device)
    monkeypatch.setattr(teval, "chunk_normals", normals)


def test_psnr_curve_matches_jax(models, images, jax_locations):
    """Five 64-px images in chunks of 4 (the tail padded), counts 0-25:
    each count's mean within 0.01 dB and each image's PSNR within 0.05 dB
    of JAX's (measured: 1.3e-5 and 3.3e-5 dB; the frames differ by 1 LSB
    on a few pixels)."""
    jp, net = models
    want, want_per = jeval.evaluate(jp, images, COUNTS, batch=4, seed=3,
                                    return_per_image=True)
    got, got_per = teval.evaluate(net, images, COUNTS, batch=4, seed=3,
                                  return_per_image=True, device="cpu")
    assert list(got) == list(want)
    for k in COUNTS:
        assert abs(got[k] - want[k]) <= 0.01, (k, got[k], want[k])
        assert got_per[k].shape == (5,)
        assert np.abs(got_per[k] - want_per[k]).max() <= 0.05
    assert got[25] > got[0]
    assert abs(teval.curve_auc(got) - jeval.curve_auc(want)) <= 0.01
    # a stream of chunks gives the array's curve
    chunks = (images[i:i + 4] for i in range(0, 5, 4))
    assert teval.evaluate(net, chunks, COUNTS, batch=4, seed=3,
                          device="cpu") == got


def test_hint_fidelity_matches_jax(models, images, jax_locations):
    """ΔE adherence (true and counterfactual colors, with and without the
    hints) within 0.02 and the influence radii within 0.3 px of JAX's
    (both rounded by the function; measured: equal)."""
    jp, net = models
    kw = dict(batch=4, seed=1, counts=(1, 5), rotations=(0.0, 180.0))
    want = jeval.hint_fidelity(jp, images, **kw)
    got = teval.hint_fidelity(net, images, device="cpu", **kw)
    assert list(got) == list(want)
    for k, v in want.items():
        tol = 0.3 if k.startswith("radius") else 0.02
        assert abs(got[k] - v) <= tol, (k, got[k], v)


def test_colorization_grid_matches_jax(models, images, jax_locations,
                                       tmp_path):
    """The contact sheet (PNG) against the JAX app's: the same layout, the
    ground-truth column equal, the rendered tiles within 1 LSB on < 2e-3
    of the pixels (measured: 1 LSB on 1.2e-5)."""
    jp, net = models
    counts = (0, 2, 10)
    jpath, tpath = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    jeval.save_colorization_grid(jp, images, counts, jpath, seed=2, batch=4)
    teval.save_colorization_grid(net, images, counts, tpath, seed=2,
                                 batch=4, device="cpu")
    want = np.asarray(Image.open(jpath).convert("RGB"))
    with open(tpath, "rb") as f:
        got = decode_image(f.read())
    assert got.shape == want.shape == (5 * 64, 4 * 64, 3)
    d = np.abs(got.astype(int) - want.astype(int)).max(-1)
    assert d.max() <= 1 and np.mean(d != 0) < 2e-3
    assert np.array_equal(got[:, 192:], want[:, 192:])
    with pytest.raises(ValueError, match="PNG"):
        teval.save_colorization_grid(net, images, counts,
                                     str(tmp_path / "t.jpg"), device="cpu")


def test_auc_helpers_match_jax():
    rng = np.random.default_rng(0)
    per = {k: rng.uniform(20, 30, 7) for k in COUNTS}
    curve = {k: float(v.mean()) for k, v in per.items()}
    assert np.isclose(teval.curve_auc(curve), jeval.curve_auc(curve))
    assert teval.curve_auc({3: 1.0}) is None
    assert np.allclose(teval.per_image_auc(per), jeval.per_image_auc(per))
    assert teval.auc_spread(teval.per_image_auc(per)) == \
        jeval.auc_spread(jeval.per_image_auc(per))
    assert teval.auc_spread([]) == jeval.auc_spread([])
    mass = rng.uniform(0, 1, 128)
    for frac in (0.5, 0.9):
        assert teval._mass_radius(mass, frac) == jeval._mass_radius(mass,
                                                                    frac)


def test_counts_checked_and_loading_matches_jax(models, tmp_path):
    _, net = models
    for k in (-1, 33):
        with pytest.raises(ValueError, match="hint count"):
            teval.evaluate(net, np.zeros((1, 16, 16, 3), np.float32), [k],
                           device="cpu")
    root = tmp_path / "imgs"
    root.mkdir()
    for i, (H, W) in enumerate([(90, 70), (64, 64), (33, 100)]):
        (root / f"{i}.png").write_bytes(encode_png(smooth_image(i, H, W)))
    want = jeval.load_eval_images(str(root), 48, limit=2)
    got = teval.load_eval_images(str(root), 48, limit=2)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    chunks = list(teval.iter_image_chunks(str(root), 48, batch=2))
    assert [len(c) for c in chunks] == [2, 1]
