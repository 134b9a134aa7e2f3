"""The port's sharded train and distill steps on the CPU, on meshes of
repeated ``cpu`` entries: against the port's single-device steps and
against the JAX package's sharded steps on the 8 virtual CPU devices of
tests/conftest.py, at the same mesh shapes.

The net is width 0.25 (128-channel trunk convs, which 2-way tensor
parallelism divides), batch 8 at 32x32, the JAX params with seeded
BatchNorm statistics carried across. Bounds:

* against the port's single-device step: loss within 1e-5 relative, and
  the weights after one step within 2 lr with at most 1e-3 of them more
  than 1e-3 lr apart, the first-step bounds of
  ``tests/test_torch_train_step.py`` (Adam divides each gradient by its own
  magnitude, so f32 summation order moves a weight by up to 2 lr);
* against JAX's ``make_sharded_train_step``: loss rtol 1e-4 and
  ``model1.0.weight`` atol 1e-5, the JAX test's own bar
  (``tests/test_parallel_train.py:187-191``);
* on a (1, 1) mesh the step is ``make_train_step``'s byte for byte.

Measured on (4, 2) and (2, 2, 2): loss 1.1e-7 relative from the
single-device step and from JAX's, weights within 0.0017 lr of the
single-device step's, ``model1.0.weight`` within 1.5e-8 of JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ideepcolor_tpu.models import siggraph as jsig
from ideepcolor_tpu.parallel import mesh as jmesh
from ideepcolor_tpu.train import hints_sim as jhs
from ideepcolor_tpu.train import step as jstep
from ideepcolor_tpu_torch.models import layers as tlayers
from ideepcolor_tpu_torch.models import siggraph as tsig
from ideepcolor_tpu_torch.parallel import mesh as pmesh
from ideepcolor_tpu_torch.train import distill as tdistill
from ideepcolor_tpu_torch.train import step as tstep

torch.set_num_threads(2)
CPU8 = ["cpu"] * 8
MESHES = {
    "(4,2)": (lambda: pmesh.make_mesh(8, 2, devices=CPU8),
              lambda: jmesh.make_mesh(8, 2)),
    "(2,2,2)": (lambda: pmesh.make_hybrid_mesh(2, 2, devices=CPU8),
                lambda: jmesh.make_hybrid_mesh(2, 2)),
}
LR = 3e-4


def nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def jax_params(width, seed):
    """JAX params with seeded biases and BatchNorm statistics (a He-init
    net's are zero and one)."""
    rng = np.random.default_rng(seed)
    p = {k: np.asarray(v) for k, v in
         jsig.init_params(jax.random.key(seed), width=width).items()}
    for k, v in p.items():
        if k.endswith("running_mean") or k.endswith("bias"):
            p[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        elif k.endswith("running_var") or (v.ndim == 1
                                           and k.endswith("weight")):
            p[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return p


def batch_np(seed, n=8, s=32):
    rng = np.random.default_rng(seed)
    return {"l": rng.uniform(0, 100, (n, s, s, 1)).astype(np.float32),
            "ab": rng.uniform(-80, 80, (n, s, s, 2)).astype(np.float32)}


def port_batch(b):
    return {k: nchw(v).contiguous() for k, v in b.items()}


def jax_hints(key, ab):
    a, m = jhs.sample_hints(key, jnp.asarray(ab))
    return nchw(np.asarray(a)).contiguous(), nchw(np.asarray(m)).contiguous()


def weight_gap(got, want, lr):
    """max |dw| / lr and the share of weights more than 1e-3 lr apart."""
    d = torch.cat([(got[k] - want[k].detach()).abs().flatten()
                   for k in want]) / lr
    return float(d.max()), float((d > 1e-3).double().mean())


def single_step(cfg, sd, batch, generator=None, hints=None):
    state = tstep.init_state(cfg, sd, device="cpu")
    return tstep.make_train_step(cfg)(state, batch, generator, hints)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_train_step_matches_single_device_and_jax(mesh):
    """One step with JAX's hint draws, on the port's mesh against its
    single-device step and against JAX's sharded step on the same mesh."""
    pm, jm = (f() for f in MESHES[mesh])
    p = jax_params(0.25, 7)
    sd = tsig.state_dict_from_params(p)
    b = batch_np(1)
    key = jax.random.key(5)
    hints = jax_hints(key, b["ab"])
    cfg = tstep.TrainConfig(lr=LR, precision_name="highest", remat=False)
    want, want_aux = single_step(cfg, sd, port_batch(b), hints=hints)

    step, shard_state, shard_batch = tstep.make_sharded_train_step(cfg, pm)
    state = shard_state(tstep.init_state(cfg, sd, device="cpu"))
    assert isinstance(state["params"]["model5.0.weight"], tuple)
    assert all(w.shape[0] == 64 for w in state["params"]["model6.2.weight"])
    state, aux = step(state, shard_batch(port_batch(b)), hints=hints)
    assert state["step"] == 1
    for name in ("loss", "reg", "cls"):
        assert np.isclose(float(aux[name]), float(want_aux[name]),
                          rtol=1e-5), name
    got = tstep.full_params(state["params"])
    gap, share = weight_gap(got, want["params"], LR)
    assert gap <= 2 and share <= 1e-3, (gap, share)

    jcfg = jstep.TrainConfig(lr=LR, remat=False)
    jstate = jstep.init_state(jax.random.key(0), jcfg,
                              params={k: jnp.asarray(v)
                                      for k, v in p.items()})
    jitted, jshard_state, jshard_batch = jstep.make_sharded_train_step(
        jcfg, jm)
    with jm:
        jstate, jaux = jitted(jshard_state(jstate),
                              jshard_batch({k: jnp.asarray(v)
                                            for k, v in b.items()}), key)
    assert np.allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-4)
    jw = tlayers.hwio_to_torch_conv(
        np.asarray(jstate["params"]["model1.0.weight"]))
    assert np.allclose(got["model1.0.weight"].numpy(), jw, atol=1e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_one_by_one_mesh_is_the_single_device_step(remat):
    """Hints from one generator seed, rematerialized or not: the (1, 1)
    mesh's loss and every weight equal the single-device step's."""
    sd = tsig.state_dict_from_params(jax_params(0.25, 3))
    b = port_batch(batch_np(2))
    cfg = tstep.TrainConfig(lr=LR, precision_name="highest", remat=remat)
    want, want_aux = single_step(cfg, sd, b, torch.Generator().manual_seed(9))
    pm = pmesh.make_mesh(1, 1, devices=["cpu"])
    step, shard_state, shard_batch = tstep.make_sharded_train_step(cfg, pm)
    state = tstep.init_state(cfg, sd, device="cpu")
    assert shard_state(state) is state
    state, aux = step(state, shard_batch(b), torch.Generator().manual_seed(9))
    assert all(torch.equal(aux[k], want_aux[k]) for k in want_aux)
    assert all(torch.equal(state["params"][k], want["params"][k])
               for k in want["params"])


def test_generator_hints_are_drawn_once_for_the_whole_batch():
    """Without ``hints=``, the sharded step draws the hints of the whole
    batch from the caller's generator: the single-device step's hints, so
    the loss is the single-device loss; rematerialization over the tensor
    parallel forward changes nothing."""
    sd = tsig.state_dict_from_params(jax_params(0.25, 4))
    b = port_batch(batch_np(3))
    pm = MESHES["(4,2)"][0]()
    auxes = []
    for remat in (False, True):
        cfg = tstep.TrainConfig(lr=LR, precision_name="highest", remat=remat)
        want, want_aux = single_step(cfg, sd, b,
                                     torch.Generator().manual_seed(11))
        step, shard_state, _ = tstep.make_sharded_train_step(cfg, pm)
        state = shard_state(tstep.init_state(cfg, sd, device="cpu"))
        state, aux = step(state, b, torch.Generator().manual_seed(11))
        assert np.isclose(float(aux["loss"]), float(want_aux["loss"]),
                          rtol=1e-5)
        gap, share = weight_gap(tstep.full_params(state["params"]),
                                want["params"], LR)
        assert gap <= 2 and share <= 1e-3, (gap, share)
        auxes.append((aux, tstep.full_params(state["params"])))
    (a0, p0), (a1, p1) = auxes
    assert torch.equal(a0["loss"], a1["loss"])
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


def test_sharded_state_file_loads_single_device_and_back(tmp_path):
    """A tensor-parallel state is written whole: the file loads in a
    single-device run, and sharding it again continues exactly as the
    sharded state it was written from."""
    sd = tsig.state_dict_from_params(jax_params(0.25, 5))
    cfg = tstep.TrainConfig(lr=LR, precision_name="highest", remat=False)
    pm = MESHES["(2,2,2)"][0]()
    step, shard_state, _ = tstep.make_sharded_train_step(cfg, pm)
    state = shard_state(tstep.init_state(cfg, sd, device="cpu"))
    b = port_batch(batch_np(4))
    state, _ = step(state, b, torch.Generator().manual_seed(1))
    path = str(tmp_path / "state.pt")
    tstep.save_train_state(path, state)
    whole = tstep.load_train_state(path, cfg, "cpu")
    full = tstep.full_params(state["params"])
    assert all(torch.equal(whole["params"][k], full[k]) for k in full)
    assert whole["step"] == 1
    single, single_aux = tstep.make_train_step(cfg)(
        tstep.load_train_state(path, cfg, "cpu"), b,
        torch.Generator().manual_seed(2))
    a, aux_a = step(state, b, torch.Generator().manual_seed(2))
    c, aux_c = step(shard_state(whole), b, torch.Generator().manual_seed(2))
    fa, fc = tstep.full_params(a["params"]), tstep.full_params(c["params"])
    assert torch.equal(aux_a["loss"], aux_c["loss"])
    assert all(torch.equal(fa[k], fc[k]) for k in fa)
    assert np.isclose(float(aux_a["loss"]), float(single_aux["loss"]),
                      rtol=1e-5)
    gap, share = weight_gap(fa, single["params"], LR)
    assert gap <= 2 and share <= 1e-3, (gap, share)


def test_sharded_distill_step_matches_single_device():
    """A width-0.5 student of a full-width f32 teacher on an (8, 1) mesh:
    the teacher replicated, the student's gradient summed. Both nets have
    seeded biases and statistics: in a He-init student the trunk's
    gradients are near 1e-5, and Adam turns their last-bit differences
    into up to 2 lr on a few percent of the weights."""
    dcfg = tdistill.DistillConfig(width=0.5, precision_name="highest")
    teacher = tdistill.teacher_params(
        tsig.state_dict_from_params(jax_params(1.0, 2)), "float32",
        device="cpu")
    student = tsig.state_dict_from_params(jax_params(0.5, 3))
    b = port_batch(batch_np(6))
    want = tdistill.init_student(dcfg, student, device="cpu")
    want, want_aux = tdistill.make_distill_step(dcfg)(
        want, teacher, b, torch.Generator().manual_seed(4))
    pm = pmesh.make_mesh(8, 1, devices=CPU8)
    step, shard_state, shard_batch, put_teacher = \
        tdistill.make_sharded_distill_step(dcfg, pm)
    state = shard_state(tdistill.init_student(dcfg, student, device="cpu"))
    state, aux = step(state, put_teacher(teacher), shard_batch(b),
                      torch.Generator().manual_seed(4))
    for name in ("loss", "reg", "kl"):
        assert np.isclose(float(aux[name]), float(want_aux[name]),
                          rtol=1e-5), name
    gap, share = weight_gap(tstep.full_params(state["params"]),
                            want["params"], dcfg.lr)
    assert gap <= 2 and share <= 1e-3, (gap, share)


def test_train_cli_model_parallel_on_four_cpu_entries(tmp_path, monkeypatch,
                                                      capsys):
    """``--model-parallel 2`` where ``local_devices`` gives four entries:
    a (2, 2) mesh, printed as JAX prints it, one step taken, its state file
    loadable on one device."""
    from ideepcolor_tpu_torch.apps import train as train_cli
    from ideepcolor_tpu_torch.utils.imageio import encode_png
    monkeypatch.setattr(pmesh, "local_devices",
                        lambda device_type="cuda": [torch.device("cpu")] * 4)
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        (data / f"im{i}.png").write_bytes(encode_png(
            rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)))
    student = str(tmp_path / "w025.npz")
    np.savez(student, **{k: v.numpy() for k, v in
                         tsig.init_state_dict(0.25, 1).items()
                         if "num_batches" not in k})
    assert train_cli.main([str(data), "--batch", "2", "--size", "32",
                           "--steps", "1", "--ckpt", str(tmp_path / "ck"),
                           "--log-every", "1", "--device", "cpu",
                           "--init-from", student,
                           "--model-parallel", "2"]) == 0
    out = capsys.readouterr().out
    assert "mesh: {'data': 2, 'model': 2}" in out
    assert "step 1: loss=" in out
    state = tstep.load_train_state(str(tmp_path / "ck_1.pt"),
                                   tstep.TrainConfig(), "cpu")
    assert state["step"] == 1
    assert state["params"]["model5.0.weight"].shape == (128, 128, 3, 3)
