"""The port's device mesh (``parallel/mesh.py``) against the JAX package's
on the CPU: JAX runs on the 8 virtual CPU devices that tests/conftest.py
forces, the port on a mesh of 8 repeated ``cpu`` entries of the same shape.
Mesh shapes, axis names and errors; which parameters are split over the
model axis and what each position holds (the port's OIHW weight on axis 0
where JAX splits its HWIO weight's last axis); the batch sharding, the
alignment and the padding of the batch forms."""

import numpy as np
import pytest
import torch

import jax

from ideepcolor_tpu.engine import batch as jb
from ideepcolor_tpu.models import siggraph as jsig
from ideepcolor_tpu.parallel import mesh as jmesh
from ideepcolor_tpu_torch.engine import batch as tb
from ideepcolor_tpu_torch.models import layers as tlayers
from ideepcolor_tpu_torch.models import siggraph as tsig
from ideepcolor_tpu_torch.parallel import mesh as pmesh

CPU8 = ["cpu"] * 8
MESHES = {
    "make_mesh(8, 2)": (lambda: jmesh.make_mesh(8, 2),
                        lambda: pmesh.make_mesh(8, 2, devices=CPU8)),
    "make_mesh(4, 1)": (lambda: jmesh.make_mesh(4, 1),
                        lambda: pmesh.make_mesh(4, 1, devices=CPU8)),
    "make_hybrid_mesh(2, 2)": (
        lambda: jmesh.make_hybrid_mesh(2, 2),
        lambda: pmesh.make_hybrid_mesh(2, 2, devices=CPU8)),
}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_shape_names_and_alignment_match_jax(name):
    jm, tm = (f() for f in MESHES[name])
    assert tm.axis_names == jm.axis_names
    assert tm.devices.shape == jm.devices.shape
    assert list(tm.shape.items()) == list(jm.shape.items())
    assert tb.mesh_batch_align(tm) == jb.mesh_batch_align(jm)
    assert all(d == torch.device("cpu") for d in tm.devices.flat)
    # hashable and equal by value: the sharded programs are cached per mesh
    assert tm == MESHES[name][1]() and hash(tm) == hash(MESHES[name][1]())
    assert tb._sharded_table_forward_for(tm) is \
        tb._sharded_table_forward_for(MESHES[name][1]())


@pytest.mark.parametrize("jax_call,port_call", [
    (lambda: jmesh.make_mesh(8, 3),
     lambda: pmesh.make_mesh(8, 3, devices=CPU8)),
    (lambda: jmesh.make_mesh(16, 2),
     lambda: pmesh.make_mesh(16, 2, devices=CPU8)),
    (lambda: jmesh.make_hybrid_mesh(3, 2),
     lambda: pmesh.make_hybrid_mesh(3, 2, devices=CPU8)),
    (lambda: jmesh.make_hybrid_mesh(2, 3),
     lambda: pmesh.make_hybrid_mesh(2, 3, devices=CPU8))])
def test_mesh_errors_match_jax(jax_call, port_call):
    """What JAX refuses with a ValueError, the port refuses too; where JAX
    words it itself (a size that does not divide), in the same words."""
    with pytest.raises(ValueError) as jerr:
        jax_call()
    with pytest.raises(ValueError) as terr:
        port_call()
    if "must divide" in str(jerr.value):
        assert str(terr.value) == str(jerr.value)


def test_mixed_meshes_and_placements_raise(monkeypatch):
    """A mesh lies on one kind of device; a tensor of another device than
    the CPU never moves onto a CPU mesh (a meta tensor stands for a CUDA
    one here); across processes (a stand-in group of two ranks whose peer
    gives the same devices) a ``model_parallel`` that does not divide one
    rank's devices raises, as does a dcn other than the rank count."""
    with pytest.raises(ValueError, match="one kind"):
        pmesh.Mesh(np.array([["cpu", "cuda:0"]], dtype=object),
                   ("data", "model"))
    with pytest.raises(ValueError, match="axis names"):
        pmesh.Mesh(np.array(["cpu"] * 2, dtype=object), ("data", "model"))
    m = pmesh.make_mesh(4, 1, devices=CPU8)
    with pytest.raises(ValueError, match="cannot be placed"):
        pmesh.put(torch.empty(4, device="meta"), pmesh.batch_sharding(m))
    with pytest.raises(ValueError, match="equal chunks"):
        pmesh.put(torch.zeros(6), pmesh.batch_sharding(m))
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "all_gather_object",
                        lambda out, obj: out.__setitem__(slice(None),
                                                         [obj] * len(out)))
    for call in (lambda: pmesh.make_hybrid_mesh(2, 2, devices=CPU8[:3]),
                 lambda: pmesh.make_mesh(6, 2, devices=CPU8[:3])):
        with pytest.raises(ValueError, match="never crosses a process"):
            call()
    with pytest.raises(ValueError, match="dcn is the process count"):
        pmesh.make_hybrid_mesh(4, 1, devices=CPU8[:4])
    hm = pmesh.make_hybrid_mesh(2, 2, devices=CPU8[:4])
    assert hm.devices.shape == (2, 2, 2) and hm.rank == 1
    assert hm.ranks.tolist() == [[[0, 0], [0, 0]], [[1, 1], [1, 1]]]
    assert hm.local_positions() == [(1, 0, 0), (1, 0, 1), (1, 1, 0),
                                    (1, 1, 1)]
    assert hm.spans_processes


@pytest.mark.parametrize("procs,rank,want", [
    (None, None, [0, 1, 2, 3]), ("1", "0", [0, 1, 2, 3]),
    ("2", "1", [2, 3]), ("4", "3", [3])])
def test_local_devices_take_the_local_ranks_share(monkeypatch, procs, rank,
                                                  want):
    """One process takes every card of its host; of ``LOCAL_WORLD_SIZE``
    processes a launcher starts on a host, the one of ``LOCAL_RANK`` takes
    its equal share (four stand-in cards here); more processes than cards
    raise."""
    monkeypatch.setattr(pmesh, "resolve_device", torch.device)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for name, value in (("LOCAL_WORLD_SIZE", procs), ("LOCAL_RANK", rank)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    assert pmesh.local_devices("cuda") == [torch.device("cuda", i)
                                           for i in want]
    assert pmesh.local_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    with pytest.raises(ValueError, match="share 4 cards"):
        pmesh.local_devices("cuda")


def test_param_shardings_split_jax_keys_on_oihw_axis0():
    """The same keys are split over the model axis as in JAX, and each
    position holds the same numbers: JAX's HWIO shard, brought to OIHW, is
    the port's axis-0 slice at that position."""
    params = jsig.init_params(jax.random.key(0), width=0.25)
    sd = tsig.state_dict_from_params({k: np.asarray(v)
                                      for k, v in params.items()})
    jm = jmesh.make_mesh(8, 2)
    tm = pmesh.make_mesh(8, 2, devices=CPU8)
    jsh = jmesh.param_shardings(params, jm)
    tsh = pmesh.param_shardings(sd, tm)
    jsplit = {k for k, s in jsh.items() if not s.is_fully_replicated}
    tsplit = {k for k, s in tsh.items() if not s.is_fully_replicated}
    assert tsplit == jsplit == pmesh.TP_PARAMS
    assert all(tsh[k].spec == (("model",),) for k in tsplit)
    assert str(tsh["model5.0.weight"].spec) != \
        str(tsh["model1.0.weight"].spec)
    jsharded = jmesh.shard_params(params, jm)
    tsharded = pmesh.shard_params(sd, tm)
    for k in ("model5.0.weight", "model6.2.bias", "model7.4.weight",
              "model1.0.weight"):
        for shard in jsharded[k].addressable_shards:
            pos = tuple(int(i) for i in
                        np.argwhere(jm.devices == shard.device)[0])
            piece = np.asarray(shard.data)
            if piece.ndim == 4:
                piece = tlayers.hwio_to_torch_conv(piece)
            assert np.array_equal(tsharded[k].piece(pos).numpy(), piece), \
                (k, pos)
        assert torch.equal(tsharded[k].gather(), sd[k])


@pytest.mark.parametrize("hybrid", [False, True])
def test_batch_sharding_places_like_jax(hybrid):
    """The batch's leading axis over (dcn, data), replicated over model:
    each position holds JAX's rows."""
    jm = jmesh.make_hybrid_mesh(2, 2) if hybrid else jmesh.make_mesh(8, 2)
    tm = (pmesh.make_hybrid_mesh(2, 2, devices=CPU8) if hybrid
          else pmesh.make_mesh(8, 2, devices=CPU8))
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    jx = jmesh.shard_batch({"x": x}, jm)["x"]
    tx = pmesh.shard_batch({"x": x}, tm)["x"]
    assert not tx.sharding.is_fully_replicated
    assert tx.sharding.spec == jmesh.batch_sharding(jm).spec
    assert len(tx.pieces) == 8 == len(jx.sharding.device_set)
    for shard in jx.addressable_shards:
        pos = tuple(int(i) for i in
                    np.argwhere(jm.devices == shard.device)[0])
        assert np.array_equal(tx.piece(pos).numpy(), np.asarray(shard.data))
    assert np.array_equal(np.asarray(tx), x)
    rep = pmesh.put(x, pmesh.replicated(tm))
    assert rep.sharding.is_fully_replicated
    assert all(np.array_equal(p.numpy(), x) for p in rep.pieces.values())
    # a mesh that repeats its device copies nothing: every piece is a view
    t = torch.from_numpy(x)
    base = t.untyped_storage().data_ptr()
    assert all(p.untyped_storage().data_ptr() == base for p in
               pmesh.put(t, pmesh.batch_sharding(tm)).pieces.values())


@pytest.mark.parametrize("n,align", [(5, 4), (8, 4), (1, 8), (19, 4)])
def test_pad_batch_pads_as_jax(n, align):
    rng = np.random.default_rng(n)
    a = rng.integers(0, 100, (n, 3, 2)).astype(np.int32)
    b = rng.normal(size=(n,)).astype(np.float32)
    jn, (ja, jb_) = jb._pad_batch(n, align, jax.numpy.asarray(a),
                                  jax.numpy.asarray(b))
    tn, (ta, tb_) = tb._pad_batch(n, align, torch.from_numpy(a),
                                  torch.from_numpy(b))
    assert tn == jn and tn % align == 0
    assert np.array_equal(np.asarray(ta), np.asarray(ja))
    assert np.array_equal(np.asarray(tb_), np.asarray(jb_))


def test_replicate_is_the_module_on_its_own_device_and_follows_updates():
    """On a repeated device a replica is the module itself; on another
    device a copy that is made again once the weights change (here the
    "other device" is the meta device, which holds shapes only)."""
    net = tsig.SIGGRAPHGenerator.from_state_dict(tsig.init_state_dict(0.25))
    assert pmesh.replicate(net, torch.device("cpu")) is net
    meta = torch.device("meta")
    r1 = pmesh.replicate(net, meta)
    assert r1 is not net and r1.model1[0].weight.device == meta
    assert pmesh.replicate(net, meta) is r1
    with torch.no_grad():
        net.model1[0].weight.add_(1.0)
    assert pmesh.replicate(net, meta) is not r1
