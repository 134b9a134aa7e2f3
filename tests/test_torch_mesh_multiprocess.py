"""The port's mesh across processes on the CPU: two ranks of a gloo group
(``tests/_torch_ranks.py``), each giving ``devices=["cpu"] * 4``, against
the single-process meshes of ``tests/test_torch_mesh.py`` and
``tests/test_torch_train_sharded.py`` (eight ``cpu`` entries) and against
the JAX package's sharded step on its eight virtual CPU devices.

Bounds. A rank sums its two chunks' gradients in one backward and the
all-reduce adds the ranks: another order of sums than one process's single
backward, so the params after a step are held in units of lr, as the card
against the CPU is (``TRAIN_*`` of ``chip_smoke.py``): within 2.001 lr, at
most 0.1 of them more than 1e-3 lr apart. The loss, a mean of the same
chunk losses, is held to 1e-6 relative. The two ranks' params are equal
byte for byte after every step. Measured here: the train step on both
meshes 5.1e-4 lr from one process's, none of the weights 1e-3 lr apart,
the loss 1.1e-7 relative.

The ranks are spawned once per scenario and joined within a deadline of
their own (there is no pytest-timeout here); the width-0.25 net at 32x32
keeps each run to a few seconds.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_ranks import app_rank, digest, run_ranks, steps_rank
from ideepcolor_tpu.parallel import mesh as jmesh
from ideepcolor_tpu.train import step as jstep
from ideepcolor_tpu_torch.engine import batch as tb
from ideepcolor_tpu_torch.models import layers as tlayers
from ideepcolor_tpu_torch.models import siggraph as tsig
from ideepcolor_tpu_torch.ops.hints import MAX_HINTS
from ideepcolor_tpu_torch.parallel import mesh as pmesh
from ideepcolor_tpu_torch.train import distill as tdistill
from ideepcolor_tpu_torch.train import step as tstep
from ideepcolor_tpu_torch.utils.imageio import encode_png
from test_torch_train_sharded import (LR, batch_np, jax_hints, jax_params,
                                      port_batch, weight_gap)

torch.set_num_threads(2)
CPU8 = ["cpu"] * 8
TRAIN_DW_BOUND = 2.001
TRAIN_DW_SHARE = 0.1
LOSS_REL = 1e-6
SINGLE = {"hybrid": lambda: pmesh.make_hybrid_mesh(2, 2, devices=CPU8),
          "make_mesh": lambda: pmesh.make_mesh(8, 2, devices=CPU8)}
FORMS = ("colorize_batch_table", "colorize_batch", "suggest_batch_table",
         "colorize_batch_global", "stream_window_u8")


def table_batch(n=8, s=32, seed=4):
    """(l_mc, boxes, values, counts) of ``n`` images with 0-10 hints."""
    rng = np.random.default_rng(seed)
    y1, x1 = (rng.integers(0, s - 4, (n, MAX_HINTS)) for _ in range(2))
    boxes = np.stack([y1, x1, y1 + rng.integers(0, 4, (n, MAX_HINTS)),
                      x1 + rng.integers(0, 4, (n, MAX_HINTS))], -1)
    return (rng.uniform(-50, 50, (n, s, s, 1)).astype(np.float32),
            boxes.astype(np.int32),
            rng.uniform(-80, 80, (n, MAX_HINTS, 2)).astype(np.float32),
            rng.integers(0, 11, n).astype(np.int32))


@pytest.fixture(scope="module")
def inputs():
    p = jax_params(0.25, 7)
    b = batch_np(1)
    key = jax.random.key(5)
    return {"lr": LR, "params": p, "np_batch": b, "key": key,
            "table_batch": table_batch(),
            "sd": tsig.state_dict_from_params(p),
            "batch": port_batch(b), "hints": jax_hints(key, b["ab"]),
            "teacher": tsig.state_dict_from_params(jax_params(0.5, 2)),
            "student": tsig.state_dict_from_params(jax_params(0.25, 3))}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    work = tmp_path_factory.mktemp("ranks")
    torch.save({k: inputs[k] for k in ("lr", "sd", "batch", "hints",
                                       "teacher", "student",
                                       "table_batch")},
               os.path.join(work, "inputs.pt"))
    return work, run_ranks(steps_rank, work)


def single_train_step(inputs, mesh_name):
    cfg = tstep.TrainConfig(lr=LR, precision_name="highest", remat=False)
    step, shard_state, shard_batch = tstep.make_sharded_train_step(
        cfg, SINGLE[mesh_name]())
    state = shard_state(tstep.init_state(cfg, inputs["sd"], device="cpu"))
    state, aux = step(state, shard_batch(inputs["batch"]),
                      hints=inputs["hints"])
    return tstep.full_params(state["params"]), aux


def test_meshes_across_processes_lay_out_the_ranks(ranks):
    """Both makers give the single-process mesh's shape; rank r drives the
    dcn = r slab of the hybrid mesh and the rows of its devices, rank-major,
    of make_mesh(8, 2); each rank's local positions are its own."""
    _, outs = ranks
    hybrid_ranks = [[[0, 0], [0, 0]], [[1, 1], [1, 1]]]
    for r, out in enumerate(outs):
        for name, want in (("hybrid", hybrid_ranks),
                           ("make_mesh", [[0, 0], [0, 0], [1, 1], [1, 1]])):
            got, single = out["meshes"][name], SINGLE[name]()
            assert got["shape"] == dict(single.shape)
            assert got["devices"] == [str(d) for d in single.devices.flat]
            assert got["ranks"] == want and got["rank"] == r
            assert got["spans"] and not single.spans_processes
            assert got["local"] == [
                p for p in np.ndindex(single.devices.shape)
                if np.array(want)[p] == r]


@pytest.mark.parametrize("mesh_name", sorted(SINGLE))
def test_train_step_across_processes_matches_one_process(ranks, inputs,
                                                         mesh_name):
    """One step with given hints against the single-process mesh's step,
    then one with a generator seeded alike in both ranks (the hints drawn
    for the whole batch in each rank): the ranks' params equal byte for
    byte after both steps, and every logged value equal across ranks."""
    _, outs = ranks
    r0, r1 = (o["train", mesh_name] for o in outs)
    assert r0["digests"] == r1["digests"]
    assert r0["aux"] == r1["aux"] and r0["aux2"] == r1["aux2"]
    want, want_aux = single_train_step(inputs, mesh_name)
    for k in ("loss", "reg", "cls"):
        assert abs(r0["aux"][k] - float(want_aux[k])) \
            <= LOSS_REL * abs(float(want_aux[k])), k
    gap, share = weight_gap(r0["params"], want, LR)
    assert gap <= TRAIN_DW_BOUND and share <= TRAIN_DW_SHARE, (gap, share)
    assert digest(r0["params"]) == r0["digests"][0]


def test_train_step_across_processes_matches_jax(ranks, inputs):
    """The hybrid mesh's step across the ranks against JAX's sharded step
    on its (2, 2, 2) hybrid mesh, with JAX's hint draws: the bar of
    tests/test_torch_train_sharded.py."""
    _, outs = ranks
    got = outs[0]["train", "hybrid"]
    jcfg = jstep.TrainConfig(lr=LR, remat=False)
    jstate = jstep.init_state(jax.random.key(0), jcfg, params={
        k: jnp.asarray(v) for k, v in inputs["params"].items()})
    jm = jmesh.make_hybrid_mesh(2, 2)
    jitted, jshard_state, jshard_batch = jstep.make_sharded_train_step(
        jcfg, jm)
    with jm:
        jstate, jaux = jitted(jshard_state(jstate), jshard_batch({
            k: jnp.asarray(v) for k, v in inputs["np_batch"].items()}),
            inputs["key"])
    assert np.allclose(got["aux"]["loss"], float(jaux["loss"]), rtol=1e-4)
    jw = tlayers.hwio_to_torch_conv(
        np.asarray(jstate["params"]["model1.0.weight"]))
    assert np.allclose(got["params"]["model1.0.weight"].numpy(), jw,
                       atol=1e-5)


def test_distill_step_across_processes_matches_one_process(ranks, inputs):
    """A width-0.25 student of a width-0.5 f32 teacher on the hybrid mesh:
    the teacher replicated to each rank's positions, the student's gradient
    averaged over the ranks."""
    _, outs = ranks
    r0, r1 = outs[0]["distill"], outs[1]["distill"]
    assert r0["digests"] == r1["digests"] and r0["aux"] == r1["aux"]
    dcfg = tdistill.DistillConfig(width=0.25, precision_name="highest")
    step, shard_state, shard_batch, put_teacher = \
        tdistill.make_sharded_distill_step(dcfg, SINGLE["hybrid"]())
    teacher = tdistill.teacher_params(inputs["teacher"], "float32", "cpu")
    state = shard_state(tdistill.init_student(dcfg, inputs["student"],
                                              device="cpu"))
    state, aux = step(state, put_teacher(teacher),
                      shard_batch(inputs["batch"]),
                      torch.Generator().manual_seed(4))
    for k in ("loss", "reg", "kl"):
        assert abs(r0["aux"][k] - float(aux[k])) \
            <= LOSS_REL * abs(float(aux[k])), k
    gap, share = weight_gap(r0["params"],
                            tstep.full_params(state["params"]), dcfg.lr)
    assert gap <= TRAIN_DW_BOUND and share <= TRAIN_DW_SHARE, (gap, share)


def test_rank0_state_file_loads_on_one_device(ranks):
    """Rank 0 writes the sharded state whole; past the barrier both ranks
    read the whole file, and it loads in a single-device run with rank 0's
    params, byte for byte."""
    work, outs = ranks
    res = outs[0]["train", "hybrid"]
    state = tstep.load_train_state(os.path.join(work, "state.pt"),
                                   tstep.TrainConfig(lr=LR), "cpu")
    assert state["step"] == 1
    assert all(torch.equal(state["params"][k], res["params"][k])
               for k in res["params"])
    assert [o["train", "hybrid"]["file_digest"] for o in outs] == \
        [res["digests"][0]] * 2


def test_sharded_table_forward_runs_each_ranks_chunks(ranks, inputs):
    """The program-level table forward on the hybrid mesh across the
    ranks: each rank computes the chunks of its dcn slab, equal byte for
    byte to the single-process mesh's pieces at those positions."""
    _, outs = ranks
    fn, place = tb.make_sharded_table_forward(SINGLE["hybrid"]())
    net = tsig.SIGGRAPHGenerator.from_state_dict(inputs["sd"])
    rgb, _ = fn(net, *place(*inputs["table_batch"]), 0.0)
    for r, out in enumerate(outs):
        got = out["table_forward"]
        assert sorted(got) == [(r, 0, 0), (r, 1, 0)]
        assert all(np.array_equal(v, rgb.piece(pos).numpy())
                   for pos, v in got.items())


def test_batch_forms_and_server_refuse_a_cross_process_mesh(ranks):
    """The five mesh= forms raise before any work on a mesh with positions
    in another rank (their frames come back to this host whole; JAX's fail
    at np.asarray); the server refuses to start in a run of two
    processes."""
    _, outs = ranks
    for r, out in enumerate(outs):
        ref = out["refusals"]
        for form in FORMS:
            assert ref[form] is not None and "not addressable" in ref[form] \
                and f"rank(s) [{1 - r}]" in ref[form], (form, ref[form])
        assert "one process" in ref["ColorizeService"]
        assert ref["serve.main"].startswith("serve: ")


def test_train_app_under_two_ranks_writes_each_checkpoint_once(tmp_path):
    """``apps/train.main`` as a launcher starts it in two ranks: the app
    starts a gloo group itself and leaves none behind; the mesh spans both
    ranks; rank 0 alone prints the step log and writes each checkpoint of
    ``--ckpt-every`` and the ``.pth`` export, once; the last state loads on
    one device."""
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        (data / f"im{i}.png").write_bytes(encode_png(
            rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)))
    ck = str(tmp_path / "ck")
    student = str(tmp_path / "w025.npz")
    np.savez(student, **{k: v.numpy() for k, v in
                         tsig.init_state_dict(0.25, 1).items()
                         if "num_batches" not in k})
    argv = [str(data), "--batch", "2", "--size", "32", "--steps", "4",
            "--ckpt-every", "2", "--ckpt", ck, "--log-every", "1",
            "--device", "cpu", "--init-from", student,
            "--export", str(tmp_path / "w.pth")]
    outs = run_ranks(app_rank, tmp_path, argv, group=False)
    assert [o["rc"] for o in outs] == [0, 0]
    assert [o["backends"] for o in outs] == [["gloo"], ["gloo"]]
    assert not any(o["group_left"] for o in outs)
    assert outs[0]["saved"] == ["ck_2.pt", "ck_4.pt", "w.pth"]
    assert outs[1]["saved"] == [] and outs[1]["stdout"] == ""
    assert "mesh: {'data': 2, 'model': 1}" in outs[0]["stdout"]
    assert "step 4: loss=" in outs[0]["stdout"]
    assert sorted(p.name for p in tmp_path.glob("ck_*")) == \
        ["ck_2.pt", "ck_4.pt"]
    state = tstep.load_train_state(ck + "_4.pt", tstep.TrainConfig(), "cpu")
    assert state["step"] == 4
    net = tsig.SIGGRAPHGenerator(tsig.scaled_channels(0.25))
    net.load_state_dict(torch.load(tmp_path / "w.pth", weights_only=True),
                        strict=True)
