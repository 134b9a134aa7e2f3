"""The port's batch engine against the JAX package's single-device forms,
on the CPU: the same numpy-seeded inputs and width-0.25 weights through
``ideepcolor_tpu.engine.batch`` (at its ``default`` precision) and its
counterpart, at sizes 32 and 64. Frames are compared by
``frame_delta_stats``: at most 1 LSB with at least 99.9% of the pixels
equal, the JAX package's own bound between two runs of one batch (measured
here: identical); predicted ab within 1e-3. Against the port's own
per-image table click the batch must agree exactly.

The global-histogram forms run the Caffe global graph (full width, seeded
calibrated weights) and are held to the JAX forms by the bounds of
``tests/test_torch_caffe_api.py`` (1 LSB on at most 5e-3 of the pixels;
predicted ab max 5e-2, mean 1e-3). The batched suggestions draw other random
numbers than JAX's: they are equal to the port's own per-image chain on the
same generators, and held to JAX at K=1, where the one center is the mean
of the samples and only the sampling noise of N=25000 draws separates the
packages (3 LSB of the palette color; measured 1)."""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ideepcolor_tpu.engine import batch as jb
from ideepcolor_tpu.engine import pipeline as jP
from ideepcolor_tpu.models import siggraph as jsig
from ideepcolor_tpu_torch.api import (ColorizeImageTorch,
                                      ColorizeImageTorchCaffeGlobDist)
from ideepcolor_tpu_torch.engine import batch as tb
from ideepcolor_tpu_torch.engine import streaming as tst
from ideepcolor_tpu_torch.models.siggraph import (SIGGRAPHGenerator,
                                                  state_dict_from_params)
from ideepcolor_tpu_torch.models import caffe_net as tcaffe
from ideepcolor_tpu_torch.ops import colorspace as tcs
from ideepcolor_tpu_torch.ops import kmeans as tkm
from ideepcolor_tpu_torch.ops.hints import MAX_HINTS
from ideepcolor_tpu_torch.ops.quantize import make_pts_grid
from ideepcolor_tpu_torch.parallel import mesh as pmesh

from _torch_caffe import jax_params_from_state_dict, smooth_image

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def weights():
    params = jsig.init_params(jax.random.key(0), width=0.25)
    sd = state_dict_from_params({k: np.asarray(v) for k, v in params.items()})
    return params, sd, SIGGRAPHGenerator.from_state_dict(sd)


def _held(got, want):
    max_lsb, equal = tb.frame_delta_stats(got, want)
    assert max_lsb <= 1 and equal >= 0.999, (max_lsb, equal)


def _tables(n, size):
    boxes = np.zeros((n, MAX_HINTS, 4), np.int32)
    values = np.zeros((n, MAX_HINTS, 2), np.float32)
    counts = np.zeros((n,), np.int32)
    rng = np.random.default_rng(n)
    for i in range(n):
        counts[i] = i % 4                          # 0 hints included
        for j in range(counts[i]):
            y, x = rng.integers(2, size - 8, 2)
            boxes[i, j] = [y, x, y + 4, x + 5]
            values[i, j] = rng.uniform(-60, 60, 2)
    return boxes, values, counts


def test_batch_fullres_fuse_matches_jax_and_single():
    rng = np.random.default_rng(11)
    l = rng.uniform(0, 100, (3, 64, 80, 1)).astype(np.float32)
    ab = rng.uniform(-60, 60, (3, 16, 16, 2)).astype(np.float32)
    out = tb.batch_fullres_fuse(torch.from_numpy(l), torch.from_numpy(ab),
                                (64, 80))
    assert out.shape == (3, 64, 80, 3) and out.dtype == torch.uint8
    want = np.asarray(jb.batch_fullres_fuse(jnp.asarray(l), jnp.asarray(ab),
                                            (64, 80)))
    _held(out.numpy(), want)
    one = np.asarray(jP.fullres_fuse(jnp.asarray(l[1]), jnp.asarray(ab[1]),
                                     (64, 80)))
    _held(out[1].numpy(), one)


def test_batch_forward_frames_matches_jax(weights):
    params, sd, net = weights
    rng = np.random.default_rng(9)
    N, S = 3, 32
    l_mc = rng.uniform(-50, 50, (N, S, S, 1)).astype(np.float32)
    hab = np.zeros((N, S, S, 2), np.float32)
    hm = np.zeros((N, S, S, 1), np.float32)
    hab[1, 10:14, 10:14] = [40, -30]
    hm[1, 10:14, 10:14] = 1
    rgb_j, ab_j = jb.batch_forward_frames(params, l_mc, hab, hm,
                                          jnp.float32(0.0))
    for w in (sd, net):                           # a state dict or the module
        rgb, ab = tb.batch_forward_frames(
            w, *(torch.from_numpy(a) for a in (l_mc, hab, hm)), 0.0)
        assert rgb.shape == (N, S, S, 3) and rgb.dtype == torch.uint8
        assert ab.shape == (N, S, S, 2)           # channel-last, as JAX's
        _held(rgb.numpy(), np.asarray(rgb_j))
        assert np.abs(ab.numpy() - np.asarray(ab_j)).max() <= 1e-3
    # maskcent reaches the net
    rgb_c, _ = tb.batch_forward_frames(
        net, *(torch.from_numpy(a) for a in (l_mc, hab, hm)), 0.5)
    rgb_jc, _ = jb.batch_forward_frames(params, l_mc, hab, hm,
                                        jnp.float32(0.5))
    _held(rgb_c.numpy(), np.asarray(rgb_jc))
    assert not torch.equal(rgb_c, rgb)


def test_batch_table_matches_dense_planes_and_jax(weights):
    """The table form (K1's batched entry; its plain version here) is
    bit-identical to the dense-plane form for the same hints, and held to
    JAX's table form."""
    params, _, net = weights
    N, S = 4, 64
    rng = np.random.default_rng(9)
    l_mc = rng.uniform(-50, 50, (N, S, S, 1)).astype(np.float32)
    boxes, values, counts = _tables(N, S)
    rgb_t, ab_t = tb.batch_forward_frames_table(
        net, torch.from_numpy(l_mc), torch.from_numpy(boxes),
        torch.from_numpy(values), torch.from_numpy(counts), 0.0)
    hab = np.zeros((N, S, S, 2), np.float32)
    hm = np.zeros((N, S, S, 1), np.float32)
    for i in range(N):
        for j in range(counts[i]):
            y1, x1, y2, x2 = boxes[i, j]
            hab[i, y1:y2 + 1, x1:x2 + 1] = values[i, j]
            hm[i, y1:y2 + 1, x1:x2 + 1] = 1
    rgb_d, ab_d = tb.batch_forward_frames(
        net, *(torch.from_numpy(a) for a in (l_mc, hab, hm)), 0.0)
    assert torch.equal(rgb_t, rgb_d) and torch.equal(ab_t, ab_d)
    assert not torch.equal(rgb_t[0], rgb_t[1])
    rgb_j, ab_j = jb.batch_forward_frames_table(
        params, jnp.asarray(l_mc), jnp.asarray(boxes), jnp.asarray(values),
        jnp.asarray(counts), jnp.float32(0.0))
    _held(rgb_t.numpy(), np.asarray(rgb_j))
    assert np.abs(ab_t.numpy() - np.asarray(ab_j)).max() <= 1e-3


def test_frame_delta_stats_and_prep_l_mc_equal_jax():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    b = a.copy()
    b[0, 3, 4, 1] ^= 1
    b[1, 7, 7] = 255 - b[1, 7, 7]
    assert tb.frame_delta_stats(a, b) == jb.frame_delta_stats(a, b)
    assert tb.frame_delta_stats(a, a) == (0, 1.0)
    x = rng.random((2, 16, 16, 3)).astype(np.float32)
    got = tb._prep_l_mc(torch.from_numpy(x)).numpy()
    want = np.asarray(jb._prep_l_mc(jnp.asarray(x)))
    assert got.shape == (2, 16, 16, 1)
    assert np.abs(got - want).max() <= 1e-4


@pytest.mark.parametrize("dtype", ["uint8", "float"])
def test_colorize_batch_matches_jax(weights, dtype):
    params, sd, _ = weights
    rng = np.random.default_rng(11)
    imgs = (rng.random((4, 32, 32, 3)) * 255).astype(np.uint8)
    if dtype == "float":
        imgs = imgs.astype(np.float32) / 255.0
    out = tb.colorize_batch(sd, imgs, device="cpu")
    assert out.shape == (4, 32, 32, 3) and out.dtype == np.uint8
    _held(out, jb.colorize_batch(params, imgs))
    hab = np.zeros((4, 32, 32, 2), np.float32)
    hm = np.zeros((4, 32, 32, 1), np.float32)
    hab[2, 4:9, 4:9] = [50, 20]
    hm[2, 4:9, 4:9] = 1
    hinted = tb.colorize_batch(sd, imgs, hab, hm, device="cpu")
    _held(hinted, jb.colorize_batch(params, imgs, hab, hm))
    assert np.array_equal(hinted[0], out[0])
    assert not np.array_equal(hinted[2], out[2])


def test_colorize_batch_table_matches_jax_and_per_image_clicks(weights):
    """uint8 images + per-image tables: held to JAX; and each frame is
    exactly the port's own table click on that image and table (on the CPU
    ``default`` and ``highest`` are the same f32)."""
    params, sd, net = weights
    N, S = 5, 32
    rng = np.random.default_rng(4)
    imgs = (rng.random((N, S, S, 3)) * 255).astype(np.uint8)
    boxes, values, counts = _tables(N, S)
    out = tb.colorize_batch_table(net, imgs, boxes, values, counts,
                                  device="cpu")
    assert out.shape == (N, S, S, 3) and out.dtype == np.uint8
    _held(out, jb.colorize_batch_table(params, imgs, boxes, values, counts))
    m = ColorizeImageTorch(Xd=S, device="cpu")
    m.prep_net(width=0.25)
    m.net.load_state_dict(sd)
    for i in range(N):
        m.set_image(imgs[i])
        click = m.net_forward_table(boxes[i], values[i], counts[i])
        assert np.array_equal(out[i], click), i


def test_stream_window_matches_jax_and_the_stream_step(weights):
    """T frames + one shared table: held to JAX's window; each frame is
    exactly the per-frame streaming step's (linear u8 -> L, no dist)."""
    params, sd, net = weights
    T, S = 4, 32
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (T, S, S, 1), dtype=np.uint8)
    boxes, values, _ = _tables(4, S)
    out = tb.stream_window_u8(net, frames, boxes[3], values[3], 3,
                              device="cpu")
    assert out.shape == (T, S, S, 3) and out.dtype == np.uint8
    _held(out, jb.stream_window_u8(params, frames, boxes[3], values[3], 3))
    for t in range(T):
        rgb, _ = tst._stream_step_u8_table(
            net, torch.from_numpy(frames[t:t + 1]),
            torch.from_numpy(boxes[3]), torch.from_numpy(values[3]), 3,
            size=S, with_dist=False)
        assert np.array_equal(out[t], rgb.numpy()), t
    assert not np.array_equal(
        out, tb.stream_window_u8(net, frames, boxes[3], values[3], 0,
                                 device="cpu"))


def test_no_mesh_argument_and_entry_points_default_to_the_card(
        weights, monkeypatch):
    """The five public forms take ``mesh`` where the JAX forms do (the
    one-program forms under them do not, as in JAX), and the sharded
    program factories exist; the numpy entry points run on the card unless
    asked for the CPU, and so does the default mesh (``make_mesh()``)."""
    _, sd, _ = weights
    jax_public = (jb.colorize_batch, jb.colorize_batch_table,
                  jb.stream_window_u8, jb.suggest_batch_table,
                  jb.colorize_batch_global)
    for jfn in jax_public:
        fn = getattr(tb, jfn.__name__)
        params = list(inspect.signature(fn).parameters)
        jparams = list(inspect.signature(jfn).parameters)
        assert "mesh" in params
        assert params.index("mesh") == jparams.index("mesh"), jfn.__name__
    for fn in (tb.batch_forward_frames, tb.batch_forward_frames_table,
               tb.batch_stream_window_u8, tb.batch_suggest_table,
               tb.batch_forward_frames_global):
        assert "mesh" not in inspect.signature(fn).parameters
    for name in ("make_sharded_batch_forward", "make_sharded_table_forward",
                 "mesh_batch_align"):
        assert callable(getattr(tb, name))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    imgs = np.zeros((1, 32, 32, 3), np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.colorize_batch(sd, imgs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.stream_window_u8(sd, imgs[..., :1], np.zeros((MAX_HINTS, 4)),
                            np.zeros((MAX_HINTS, 2)), 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.suggest_batch_table(sd, imgs, np.zeros((1, MAX_HINTS, 4)),
                               np.zeros((1, MAX_HINTS, 2)), [0], [3], [3])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.colorize_batch_global({}, imgs, np.zeros((1, 314)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmesh.make_mesh()


@pytest.fixture(scope="module")
def global_weights():
    sd = tcaffe.init_state_dict("global", seed=12, calibrate=True)
    params = {k: jnp.asarray(v) for k, v in
              jax_params_from_state_dict(sd, "global").items()}
    return params, sd, tcaffe.CaffeColorNet.from_state_dict(sd)


def _globs(n, seed=5):
    """(n, 314) histogram blobs; row 0 all zero (no histogram)."""
    rng = np.random.default_rng(seed)
    g = np.zeros((n, 314), np.float32)
    for i in range(1, n):
        bins = rng.integers(0, 313, 9)
        g[i, bins] = rng.random(9)
        g[i, :313] /= g[i, :313].sum()
        g[i, 313] = 1.0
    return g


def _held_caffe(got, want):
    d = np.abs(got.astype(int) - want.astype(int)).max(-1)
    assert d.max() <= 1 and np.mean(d != 0) <= 5e-3, \
        (d.max(), np.mean(d != 0))


def test_batch_forward_frames_global_matches_jax(global_weights):
    params, sd, net = global_weights
    N, S = 3, 32
    imgs = np.stack([smooth_image(40 + i, S, S) for i in range(N)])
    l_mc = tb._prep_l_mc(torch.from_numpy(imgs).float() / 255.0)
    hints3 = np.zeros((N, S, S, 3), np.float32)
    hints3[1, 8:13, 8:13] = [40, -30, 110]
    glob = _globs(N)
    rgb_j, ab_j = jb.batch_forward_frames_global(
        params, jnp.asarray(l_mc.numpy()), jnp.asarray(hints3),
        jnp.asarray(glob))
    for w in (sd, net):                           # a state dict or the module
        rgb, ab = tb.batch_forward_frames_global(
            w, l_mc, torch.from_numpy(hints3), torch.from_numpy(glob))
        assert rgb.shape == (N, S, S, 3) and rgb.dtype == torch.uint8
        assert ab.shape == (N, S, S, 2)           # channel-last, as JAX's
        _held_caffe(rgb.numpy(), np.asarray(rgb_j))
        d = np.abs(ab.numpy() - np.asarray(ab_j))
        assert d.max() <= 5e-2 and d.mean() <= 1e-3, (d.max(), d.mean())
    # the histogram is per image: swapping two rows changes those frames
    rgb_s, _ = tb.batch_forward_frames_global(
        net, l_mc, torch.from_numpy(hints3),
        torch.from_numpy(glob[[0, 2, 1]]))
    assert torch.equal(rgb_s[0], rgb[0])
    assert not torch.equal(rgb_s[1], rgb[1])


def test_colorize_batch_global_matches_jax_and_per_image_calls(
        global_weights, tmp_path):
    """uint8 images + blobs: held to JAX's; and each frame held to the
    port's own ``net_forward(..., glob_dist)`` on that image (a batch of 4
    and a batch of 1 may take other conv kernels: 1 LSB on 5e-3)."""
    params, sd, net = global_weights
    N, S = 4, 32
    imgs = np.stack([smooth_image(50 + i, S, S) for i in range(N)])
    glob = _globs(N)
    out = tb.colorize_batch_global(net, imgs, glob, device="cpu")
    assert out.shape == (N, S, S, 3) and out.dtype == np.uint8
    _held_caffe(out, jb.colorize_batch_global(params, imgs, glob))
    path = str(tmp_path / "global.pth")
    torch.save(sd, path)
    m = ColorizeImageTorchCaffeGlobDist(Xd=S, device="cpu")
    m.prep_net(0, caffemodel_path=path)
    zeros = np.zeros((2, S, S)), np.zeros((1, S, S))
    for i in range(N):
        m.set_image(imgs[i])
        frame = m.net_forward(*zeros, -1 if i == 0 else glob[i, :313])
        _held_caffe(out[i], frame)
    hints3 = np.zeros((N, S, S, 3), np.float32)
    hints3[2, 4:9, 4:9] = [50, 20, 110]
    hinted = tb.colorize_batch_global(sd, imgs, glob, hints3, device="cpu")
    _held_caffe(hinted, jb.colorize_batch_global(params, imgs, glob, hints3))
    assert np.array_equal(hinted[0], out[0])


def _suggest_inputs(N, S):
    rng = np.random.default_rng(8)
    imgs = np.stack([smooth_image(60 + i, S, S) for i in range(N)])
    boxes, values, counts = _tables(N, S)
    hs = rng.integers(0, S, N).astype(np.int32)
    ws = rng.integers(0, S, N).astype(np.int32)
    return imgs, boxes, values, counts, hs, ws


def test_batch_suggest_equals_the_per_image_chain(weights):
    """Each image's palette is the port's own chain at its pixel: the
    (h // 4, w // 4) pdf of the batched dist forward, the image's own
    generator, the pixel's own L."""
    _, _, net = weights
    N, S, K = 4, 32, 5
    imgs, boxes, values, counts, hs, ws = _suggest_inputs(N, S)
    colors, conf = tb.suggest_batch_table(net, imgs, boxes, values, counts,
                                          hs, ws, K=K, N=5000, seed=3,
                                          device="cpu")
    assert colors.shape == (N, K, 3) and colors.dtype == np.uint8
    assert conf.shape == (N, K)
    assert np.abs(conf.sum(1) - 1).max() < 1e-5
    assert (np.diff(conf, axis=1) <= 0).all()
    l_mc = tb._prep_l_mc(torch.from_numpy(imgs).float() / 255.0)
    pts = torch.from_numpy(make_pts_grid()).float()
    with torch.no_grad():
        hints = torch.stack([torch.cat(tb.k1.rasterize_hints_planar(
            torch.from_numpy(boxes[i]), torch.from_numpy(values[i]),
            int(counts[i]), S).split([2, 1]), 0) for i in range(N)])
        _, dist = net(l_mc.permute(0, 3, 1, 2), hints[:, :2], hints[:, 2:],
                      0.0, dist=True, dist_lowres=True,
                      precision_name="default")
    for i in range(N):
        c, f = tkm.ab_recommendations(
            dist[i, :, hs[i] // 4, ws[i] // 4], pts,
            tb.image_generator(3, i, "cpu"), K=K, N=5000)
        lab = torch.cat([(l_mc[i, hs[i], ws[i]] + 50.0).expand(K, 1), c], 1)
        assert np.array_equal(colors[i], tcs.lab_to_rgb_u8(lab).numpy()), i
        assert np.allclose(conf[i], f.numpy(), atol=1e-6)
    again, _ = tb.suggest_batch_table(net, imgs, boxes, values, counts, hs,
                                      ws, K=K, N=5000, seed=3, device="cpu")
    other, _ = tb.suggest_batch_table(net, imgs, boxes, values, counts, hs,
                                      ws, K=K, N=5000, seed=4, device="cpu")
    assert np.array_equal(again, colors) and not np.array_equal(other, colors)
    # an image's stream does not depend on what else the batch holds
    alone, _ = tb.suggest_batch_table(
        net, imgs[:1], boxes[:1], values[:1], counts[:1], hs[:1], ws[:1],
        K=K, N=5000, seed=3, device="cpu")
    assert np.abs(alone[0].astype(int) - colors[0].astype(int)).max() <= 1


def test_suggest_batch_table_matches_jax_at_one_center(weights):
    """K=1: the center is the mean of the samples, so the packages differ
    by sampling noise only, whatever their random numbers."""
    params, _, net = weights
    N, S = 3, 32
    imgs, boxes, values, counts, hs, ws = _suggest_inputs(N, S)
    colors, conf = tb.suggest_batch_table(net, imgs, boxes, values, counts,
                                          hs, ws, K=1, device="cpu")
    jcolors, jconf = jb.suggest_batch_table(params, imgs, boxes, values,
                                            counts, hs, ws, K=1)
    assert colors.shape == jcolors.shape == (N, 1, 3)
    assert np.abs(colors.astype(int) - jcolors.astype(int)).max() <= 3
    assert np.allclose(conf, 1.0) and np.allclose(jconf, 1.0)
    assert len({tuple(c[0]) for c in colors}) == N    # per-image pixels
