"""The ``mesh=`` forms of the port's batch engine on the CPU, against the
port's unsharded forms and against the JAX package's forms on its mesh.

JAX runs on the 8 virtual CPU devices that tests/conftest.py forces; the
port on a mesh of repeated ``cpu`` entries of the same shape, through its
kernels' plain versions. The SIGGRAPH forms run a width-0.25 net (weights
carried across with ``state_dict_from_params``) at 32x32 and 64x64, the
global form the seeded, calibrated Caffe global net at 32x32.

Bounds: frames by ``frame_delta_stats``, at most 1 LSB with at least 99.9%
of the pixels equal, the JAX package's sharded-vs-unsharded contract
(``ideepcolor_tpu/engine/batch.py:86-97``, held in
``tests/test_engine_batch.py:181-188``); measured here: sharded against
unsharded identical, against JAX's mesh 1 LSB on 5.1e-5 of the pixels. The
Caffe global net against JAX keeps the bound of
``tests/test_torch_batch.py`` for that net (1 LSB on at most 5e-3 of the
pixels). Sharded palettes equal the unsharded ones exactly
(``tests/test_engine_batch.py:215-216``); against JAX's they are held at
K=1 within 3 LSB, the port's existing suggest bound
(``tests/test_torch_batch.py``). The server rows copy
``tests/test_serve.py:317-330,528-531``."""

import io
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ideepcolor_tpu.engine import batch as jb
from ideepcolor_tpu.models import siggraph as jsig
from ideepcolor_tpu.parallel import mesh as jmesh
from ideepcolor_tpu_torch.apps import serve
from ideepcolor_tpu_torch.engine import batch as tb
from ideepcolor_tpu_torch.models import caffe_net as tcaffe
from ideepcolor_tpu_torch.models.siggraph import (SIGGRAPHGenerator,
                                                  state_dict_from_params)
from ideepcolor_tpu_torch.ops.hints import MAX_HINTS
from ideepcolor_tpu_torch.parallel import mesh as pmesh

from _torch_caffe import jax_params_from_state_dict, smooth_image

torch.set_num_threads(2)
CPU8 = ["cpu"] * 8
# the port's meshes and JAX's of the same shape, each of batch alignment 4
MESHES = {
    "(4,2)": (lambda: pmesh.make_mesh(8, 2, devices=CPU8),
              lambda: jmesh.make_mesh(8, 2)),
    "(2,2,2)": (lambda: pmesh.make_hybrid_mesh(2, 2, devices=CPU8),
                lambda: jmesh.make_hybrid_mesh(2, 2)),
}


@pytest.fixture(scope="module")
def weights():
    params = jsig.init_params(jax.random.key(0), width=0.25)
    sd = state_dict_from_params({k: np.asarray(v) for k, v in params.items()})
    return params, SIGGRAPHGenerator.from_state_dict(sd)


def _held(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    max_lsb, equal = tb.frame_delta_stats(got, want)
    assert max_lsb <= 1 and equal >= 0.999, (max_lsb, equal)


def _inputs(n, size, seed=0):
    rng = np.random.default_rng(seed)
    imgs = np.stack([smooth_image(100 + i, size, size) for i in range(n)])
    boxes = np.zeros((n, MAX_HINTS, 4), np.int32)
    values = np.zeros((n, MAX_HINTS, 2), np.float32)
    counts = np.zeros((n,), np.int32)
    for i in range(n):
        counts[i] = i % 4                          # 0 hints included
        for j in range(counts[i]):
            y, x = rng.integers(2, size - 8, 2)
            boxes[i, j] = [y, x, y + 4, x + 5]
            values[i, j] = rng.uniform(-60, 60, 2)
    return imgs, boxes, values, counts


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("n", [16, 19])
def test_colorize_batch_table_sharded_matches_unsharded(weights, mesh, n):
    """n=19 is uneven on the alignment 4: padded with row-0 replicas, the
    padding dropped."""
    _, net = weights
    m = MESHES[mesh][0]()
    args = _inputs(n, 32, seed=n)
    out = tb.colorize_batch_table(net, *args, mesh=m)
    assert out.shape == (n, 32, 32, 3)
    _held(out, tb.colorize_batch_table(net, *args, device="cpu"))


def test_colorize_batch_table_matches_jax_on_its_mesh(weights):
    params, net = weights
    pm, jm = (f() for f in MESHES["(4,2)"])
    args = _inputs(19, 64, seed=3)
    out = tb.colorize_batch_table(net, *args, maskcent=0.5, mesh=pm,
                                  device="cpu")
    _held(out, jb.colorize_batch_table(params, *args, maskcent=0.5,
                                       mesh=jm))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_colorize_batch_sharded_matches_unsharded_and_jax(weights, mesh):
    """The dense-plane form, hinted, n=7 on alignment 4."""
    params, net = weights
    pm, jm = (f() for f in MESHES[mesh])
    n, s = 7, 32
    imgs = _inputs(n, s, seed=7)[0]
    hab = np.zeros((n, s, s, 2), np.float32)
    hm = np.zeros((n, s, s, 1), np.float32)
    hab[2, 5:9, 5:9] = [30.0, -40.0]
    hm[2, 5:9, 5:9] = 1.0
    out = tb.colorize_batch(net, imgs, hab, hm, mesh=pm)
    _held(out, tb.colorize_batch(net, imgs, hab, hm, device="cpu"))
    if mesh == "(4,2)":
        _held(out, jb.colorize_batch(params, imgs, hab, hm, mesh=jm))


def test_make_sharded_forwards_match_jax_programs(weights):
    """The program-level forms: place_batch and the cached program, dense
    and table, against JAX's on its mesh (frames, and ab within 1e-3 as
    ``tests/test_engine_batch.py:38-39``)."""
    params, net = weights
    pm, jm = (f() for f in MESHES["(2,2,2)"])
    n, s = 8, 32
    rng = np.random.default_rng(4)
    l_mc = rng.uniform(-50, 50, (n, s, s, 1)).astype(np.float32)
    _, boxes, values, counts = _inputs(n, s, seed=4)
    fn, place = tb.make_sharded_table_forward(pm)
    rgb, ab = fn(net, *place(l_mc, boxes, values, counts), 0.0)
    assert isinstance(rgb, pmesh.ShardedTensor) and rgb.shape == (n, s, s, 3)
    jfn, jplace = jb.make_sharded_table_forward(jm)
    with jm:
        jrgb, jab = jfn(params, *jplace(l_mc, boxes, values, counts),
                        jnp.float32(0.0))
    _held(np.asarray(rgb), np.asarray(jrgb))
    assert np.abs(np.asarray(ab) - np.asarray(jab)).max() < 1e-3
    fn, place = tb.make_sharded_batch_forward(pm)
    hab = np.zeros((n, s, s, 2), np.float32)
    hm = np.zeros((n, s, s, 1), np.float32)
    rgb_d, _ = fn(net, *place(l_mc, hab, hm), 0.0)
    rgb_u, _ = tb.batch_forward_frames(net, torch.from_numpy(l_mc),
                                       torch.from_numpy(hab),
                                       torch.from_numpy(hm))
    _held(np.asarray(rgb_d), rgb_u.numpy())


@pytest.fixture(scope="module")
def global_weights():
    sd = tcaffe.init_state_dict("global", seed=12, calibrate=True)
    params = {k: jnp.asarray(v) for k, v in
              jax_params_from_state_dict(sd, "global").items()}
    return params, tcaffe.CaffeColorNet.from_state_dict(sd)


def test_colorize_batch_global_sharded_matches_unsharded_and_jax(
        global_weights):
    """Row 0's histogram is all zero (the glob_dist=-1 sentinel); n=5 on
    alignment 4, hints on one image."""
    params, net = global_weights
    pm, jm = (f() for f in MESHES["(4,2)"])
    n, s = 5, 32
    imgs = _inputs(n, s, seed=5)[0]
    rng = np.random.default_rng(5)
    glob = np.zeros((n, 314), np.float32)
    for i in range(1, n):
        bins = rng.integers(0, 313, 9)
        glob[i, bins] = rng.random(9)
        glob[i, :313] /= glob[i, :313].sum()
        glob[i, 313] = 1.0
    hints3 = np.zeros((n, s, s, 3), np.float32)
    hints3[3, 4:9, 4:9] = [50, 20, 110]
    out = tb.colorize_batch_global(net, imgs, glob, hints3, mesh=pm)
    _held(out, tb.colorize_batch_global(net, imgs, glob, hints3,
                                        device="cpu"))
    want = jb.colorize_batch_global(params, imgs, glob, hints3, mesh=jm)
    d = np.abs(out.astype(int) - want.astype(int)).max(-1)
    assert d.max() <= 1 and np.mean(d != 0) <= 5e-3, (d.max(),
                                                      np.mean(d != 0))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_stream_window_sharded_matches_unsharded_and_jax(weights, mesh):
    """T=19 frames and one shared table on alignment 4."""
    params, net = weights
    pm, jm = (f() for f in MESHES[mesh])
    rng = np.random.default_rng(19)
    frames = rng.integers(0, 256, (19, 32, 32, 1), dtype=np.uint8)
    _, boxes, values, _ = _inputs(4, 32, seed=19)
    out = tb.stream_window_u8(net, frames, boxes[3], values[3], 3, mesh=pm)
    assert out.shape == (19, 32, 32, 3)
    _held(out, tb.stream_window_u8(net, frames, boxes[3], values[3], 3,
                                   device="cpu"))
    if mesh == "(2,2,2)":
        _held(out, jb.stream_window_u8(params, frames, boxes[3], values[3],
                                       3, mesh=jm))


def _suggest_inputs(n, s):
    imgs, boxes, values, counts = _inputs(n, s, seed=8)
    rng = np.random.default_rng(8)
    return (imgs, boxes, values, counts,
            rng.integers(0, s, n).astype(np.int32),
            rng.integers(0, s, n).astype(np.int32))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_suggest_batch_table_sharded_equals_unsharded(weights, mesh):
    """Each image keeps the generator of its global index, so the sharded
    palettes are the unsharded ones, padding (n=5 on alignment 4) or not
    (n=8)."""
    _, net = weights
    pm = MESHES[mesh][0]()
    for n in (5, 8):
        args = _suggest_inputs(n, 32)
        c_m, f_m = tb.suggest_batch_table(net, *args, K=4, N=2000, mesh=pm,
                                          seed=3)
        c_u, f_u = tb.suggest_batch_table(net, *args, K=4, N=2000, seed=3,
                                          device="cpu")
        assert c_m.shape == (n, 4, 3) and c_m.dtype == np.uint8
        assert np.array_equal(c_m, c_u) and np.array_equal(f_m, f_u)
    assert not np.array_equal(c_m[0], c_m[n - 1])


def test_suggest_batch_table_matches_jax_on_its_mesh_at_one_center(weights):
    params, net = weights
    pm, jm = (f() for f in MESHES["(4,2)"])
    args = _suggest_inputs(5, 32)
    colors, conf = tb.suggest_batch_table(net, *args, K=1, mesh=pm)
    jcolors, jconf = jb.suggest_batch_table(params, *args, K=1, mesh=jm)
    assert colors.shape == jcolors.shape == (5, 1, 3)
    assert np.abs(colors.astype(int) - jcolors.astype(int)).max() <= 3
    assert np.allclose(conf, 1.0) and np.allclose(jconf, 1.0)


def test_mesh_and_device_must_agree(weights):
    _, net = weights
    pm = MESHES["(4,2)"][0]()
    args = _inputs(4, 32)
    with pytest.raises(ValueError, match="disagrees"):
        tb.colorize_batch_table(net, *args, mesh=pm, device="cuda")
    with pytest.raises(ValueError, match="disagrees"):
        tb.colorize_batch(net, args[0], mesh=pm, device="cuda:0")


STUDENT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "weights", "student_w025.npz")


@pytest.fixture
def mesh_server(monkeypatch):
    """A port server whose mesh is 8 CPU entries (``local_devices``
    replaced, as a machine with 8 cards would give it)."""
    monkeypatch.setattr(pmesh, "local_devices",
                        lambda device_type="cuda": [torch.device("cpu")] * 8)
    srv = serve.make_server(port=0, size=64, weights=STUDENT,
                            dtype="float32", device="cpu", auto_batch=8,
                            use_mesh=True)
    yield srv
    srv.server_close()


def test_server_mesh_pads_a_burst_of_three_to_eight(mesh_server):
    """Three concurrent net-res requests coalesce into one dispatch padded
    to the mesh's alignment 8; each frame is the unsharded table batch's;
    ``/colorize_batch`` is split too; health names the mesh."""
    svc = mesh_server.RequestHandlerClass.service
    assert svc.mesh is not None
    assert svc.health()["mesh"] == {"data": 8, "model": 1}
    assert svc.batcher.align == 8 and svc.batcher.bucket_caps() == [8]
    assert svc.batcher.cap_for(3) == 8
    svc.batcher.wait_s = 0.4
    imgs, boxes, values, counts = _inputs(3, 64, seed=30)
    counts[:] = 1
    outs = [None] * 3

    def one(i):
        outs[i] = svc.batcher.submit(imgs[i], boxes[i], values[i],
                                     int(counts[i]))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert svc.batcher.dispatches == 1 and svc.batcher.batched_requests == 3
    want = tb.colorize_batch_table(svc.model.net, imgs, boxes, values,
                                   counts, device="cpu")
    _held(np.stack(outs), want)
    buf = io.BytesIO()
    np.savez(buf, images=imgs, boxes=boxes, values=values, counts=counts)
    with np.load(io.BytesIO(svc.colorize_batch(buf.getvalue()))) as z:
        _held(z["frames"], want)


def test_server_auto_batch_below_mesh_alignment_is_loud(monkeypatch):
    monkeypatch.setattr(pmesh, "local_devices",
                        lambda device_type="cuda": [torch.device("cpu")] * 8)
    with pytest.raises(ValueError, match="alignment"):
        serve.ColorizeService(size=64, weights=STUDENT, dtype="float32",
                              device="cpu", auto_batch=2, use_mesh=True)
