"""The port's train and distill steps against the JAX package's on the CPU:
the same weights, batch and hints in, the loss of every step and the
weights after; save and resume, rematerialization, the precision scope."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ideepcolor_tpu.models import siggraph as jsig
from ideepcolor_tpu.train import distill as jdistill
from ideepcolor_tpu.train import hints_sim as jhs
from ideepcolor_tpu.train import step as jstep
from ideepcolor_tpu_torch.models import siggraph as tsig
from ideepcolor_tpu_torch.train import distill as tdistill
from ideepcolor_tpu_torch.train import step as tstep

torch.set_num_threads(2)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def jax_params(width, seed):
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


def batch_np(seed, n=2, s=32):
    rng = np.random.default_rng(seed)
    return {"l": rng.uniform(0, 100, (n, s, s, 1)).astype(np.float32),
            "ab": rng.uniform(-80, 80, (n, s, s, 2)).astype(np.float32)}


def port_batch(b):
    return {k: nchw(v) for k, v in b.items()}


def jax_hints(key, ab, p_keep=1 / 8):
    """The hints JAX's loss draws from ``key``, as the port takes them."""
    a, m = jhs.sample_hints(key, jnp.asarray(ab), p_keep=p_keep)
    return nchw(np.asarray(a)), nchw(np.asarray(m))


def weight_gap(jparams, tparams, lr, share_above):
    """max |dw| / lr over every weight, and the share of weights more than
    ``share_above`` lr apart, the JAX params brought to the torch layout.

    Adam divides each gradient by its own running magnitude, so a weight
    whose gradient is tiny against the rest of its tensor (where f32
    summation order changes it relatively most) can move by anything up to
    2 lr a step differently; the bounds are in these terms."""
    want = tsig.state_dict_from_params(
        {k: np.asarray(v) for k, v in jparams.items()})
    d = np.concatenate([np.abs(tparams[k].detach().numpy()
                               - want[k].numpy()).ravel()
                        for k in tparams]) / lr
    return float(d.max()), float(np.mean(d > share_above))


def test_three_train_steps_match_jax():
    """Loss terms of each step within 1e-5 relative (measured: equal to
    1e-9). Weights, lr 3e-4: after the first step within 2 lr, at most
    1e-3 of them more than 1e-3 lr apart (measured: 0.03 lr, 6.1e-5);
    after the third within 6 lr, at most 1e-3 of them more than 0.1 lr
    apart (measured: 1.23 lr, 5.6e-5; the differences grow as Adam's
    moments take in the gradients of slightly different weights)."""
    cfg = jstep.TrainConfig()
    p = jax_params(0.25, 7)
    jstate = jstep.init_state(jax.random.key(0), cfg,
                              params={k: jnp.asarray(v)
                                      for k, v in p.items()})
    jtrain = jstep.make_train_step(cfg)
    tcfg = tstep.TrainConfig(precision_name="highest")
    state = tstep.init_state(tcfg, tsig.state_dict_from_params(p),
                             device="cpu")
    train = tstep.make_train_step(tcfg)
    for i in range(3):
        b = batch_np(i)
        key = jax.random.key(100 + i)
        jstate, jaux = jtrain(jstate, {k: jnp.asarray(v) for k, v in
                                       b.items()}, key)
        state, aux = train(state, port_batch(b),
                           hints=jax_hints(key, b["ab"]))
        for name in ("loss", "reg", "cls"):
            assert np.isclose(float(aux[name]), float(jaux[name]),
                              rtol=1e-5), (i, name)
        if i == 0:
            gap, share = weight_gap(jstate["params"], state["params"],
                                    cfg.lr, 1e-3)
            assert gap <= 2 and share <= 1e-3, (gap, share)
    assert state["step"] == int(jstate["step"]) == 3
    gap, share = weight_gap(jstate["params"], state["params"], cfg.lr, 0.1)
    assert gap <= 6 and share <= 1e-3, (gap, share)


@pytest.mark.parametrize("gt_weight,temperature", [(0.5, 2.0)])
def test_two_distill_steps_match_jax(gt_weight, temperature):
    """A width-0.25 student of a width-0.5 f32 teacher, with the ground
    truth term and a temperature: loss terms within 1e-5 relative per step
    (measured: equal to 1e-9); weights after two steps at lr 1e-3 within 4
    lr, at most 1e-3 of them more than 0.1 lr apart (the train step's
    bounds; measured: 0.079 lr, none)."""
    dkw = dict(width=0.25, gt_weight=gt_weight, temperature=temperature)
    jcfg = jdistill.DistillConfig(**dkw)
    tcfg = tdistill.DistillConfig(precision_name="highest", **dkw)
    teacher = jax_params(0.5, 11)
    student = jax_params(0.25, 12)
    jstate = jdistill.init_student(jax.random.key(0), jcfg,
                                   params={k: jnp.asarray(v)
                                           for k, v in student.items()})
    jteacher = {k: jnp.asarray(v) for k, v in teacher.items()}
    jstep_fn = jdistill.make_distill_step(jcfg)
    state = tdistill.init_student(tcfg, tsig.state_dict_from_params(student),
                                  device="cpu")
    tteacher = tdistill.teacher_params(tsig.state_dict_from_params(teacher),
                                       "float32", device="cpu")
    step = tdistill.make_distill_step(tcfg)
    for i in range(2):
        b = batch_np(10 + i)
        key = jax.random.key(200 + i)
        jstate, jaux = jstep_fn(jstate, jteacher,
                                {k: jnp.asarray(v) for k, v in b.items()},
                                key)
        state, aux = step(state, tteacher, port_batch(b),
                          hints=jax_hints(key, b["ab"]))
        assert set(aux) == set(jaux) == {"loss", "reg", "kl", "gt"}
        for name in aux:
            assert np.isclose(float(aux[name]), float(jaux[name]),
                              rtol=1e-5), (i, name)
    gap, share = weight_gap(jstate["params"], state["params"], jcfg.lr, 0.1)
    assert gap <= 4 and share <= 1e-3, (gap, share)


def _port_run(cfg, steps, sd, resume_at=None, tmp=None):
    state = tstep.init_state(cfg, sd, device="cpu")
    train = tstep.make_train_step(cfg)
    losses = []
    for i in range(steps):
        if i == resume_at:
            path = str(tmp / "state.pt")
            tstep.save_train_state(path, state)
            state = tstep.load_train_state(path, cfg, device="cpu")
        b = port_batch(batch_np(30 + i))
        state, aux = train(state, b, torch.Generator().manual_seed(i))
        losses.append(float(aux["loss"]))
    return losses, state


def test_save_and_resume_equal_straight_through(tmp_path):
    """A state saved after two steps and loaded back takes the third step
    to the same loss and weights, byte for byte: params, Adam's moments and
    counts, and the schedule's count (a cosine schedule, so a count off by
    one would change the lr)."""
    cfg = tstep.TrainConfig(precision_name="highest", schedule="cosine",
                            warmup_steps=1, total_steps=6, lr=1e-3)
    sd = tsig.init_state_dict(0.125, seed=3)
    want_l, want_s = _port_run(cfg, 3, sd)
    got_l, got_s = _port_run(cfg, 3, sd, resume_at=2, tmp=tmp_path)
    assert got_l == want_l
    assert got_s["step"] == 3
    for k, v in want_s["params"].items():
        assert torch.equal(got_s["params"][k], v), k
    blob = torch.load(tmp_path / "state.pt", weights_only=True)
    assert blob["step"] == 2 and blob["format"] == tstep.STATE_FORMAT


def test_load_train_state_refuses_other_files(tmp_path):
    path = str(tmp_path / "w.pt")
    torch.save(tsig.init_state_dict(0.125), path)
    with pytest.raises(ValueError, match="train state"):
        tstep.load_train_state(path, tstep.TrainConfig(), device="cpu")


def test_remat_equals_no_remat():
    """Recomputing the forward in the backward gives the same loss and the
    same updated weights, byte for byte, on the CPU."""
    sd = tsig.init_state_dict(0.125, seed=5)
    out = []
    for remat in (True, False):
        cfg = tstep.TrainConfig(precision_name="highest", remat=remat)
        out.append(_port_run(cfg, 1, sd))
    (la, sa), (lb, sb) = out
    assert la == lb
    assert all(torch.equal(sa["params"][k], sb["params"][k])
               for k in sa["params"])


@pytest.mark.parametrize("name,tf32", [("default", True),
                                       ("highest", False)])
def test_precision_scope_covers_the_backward(name, tf32):
    """TF32 for "default" (accepted deviation: the JAX step's
    Precision.DEFAULT): cuDNN's and cuBLAS's TF32 flags are set while the
    backward runs, whose convs start after the forward returned, and
    restored after the step."""
    seen = []
    cfg = tstep.TrainConfig(precision_name=name, remat=False)
    state = tstep.init_state(cfg, tsig.init_state_dict(0.125, seed=1),
                             device="cpu")
    state["params"]["model1.0.weight"].register_hook(
        lambda g: seen.append((torch.backends.cudnn.allow_tf32,
                               torch.backends.cuda.matmul.allow_tf32)))
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    tstep.make_train_step(cfg)(state, port_batch(batch_np(1)),
                               torch.Generator().manual_seed(0))
    assert seen == [(tf32, tf32)]
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before


def test_init_student_refuses_another_width_and_bf16_teacher_runs():
    cfg = tdistill.DistillConfig(width=0.5)
    with pytest.raises(ValueError, match="width-tier"):
        tdistill.init_student(cfg, tsig.init_state_dict(0.25), device="cpu")
    with pytest.raises(ValueError):
        jdistill.init_student(jax.random.key(0),
                              jdistill.DistillConfig(width=0.5),
                              params=jsig.init_params(jax.random.key(0),
                                                      width=0.25))
    teacher = tdistill.teacher_params(tsig.init_state_dict(0.25, seed=2),
                                      "bfloat16", device="cpu")
    assert teacher["model1.0.weight"].dtype == torch.bfloat16
    assert teacher["model1.4.running_var"].dtype == torch.float32
    cfg = tdistill.DistillConfig(width=0.125)
    state = tdistill.init_student(cfg, device="cpu")
    state, aux = tdistill.make_distill_step(cfg)(
        state, teacher, port_batch(batch_np(3)),
        torch.Generator().manual_seed(0))
    assert np.isfinite(float(aux["loss"])) and state["step"] == 1
