"""Teacher -> student distillation for the reduced-width serving tiers.

Counterpart of ``ideepcolor_tpu/train/distill.py``. A
width-multiplied SIGGRAPH student (``models.siggraph.scaled_channels``)
learns the full-width teacher's singly-scaled regression output and its
529-bin distribution at H/4 (KL at ``temperature``), under the same
simulated hints for both. The teacher is frozen: it runs under
``torch.no_grad`` on weights cast to ``teacher_dtype`` the way
``SIGGRAPHGenerator.cast_weights_`` casts them (bf16 convs, f32
activations; the JAX package also rounds its bf16 teacher's activations).
:func:`make_sharded_distill_step` is the step on a ``parallel.mesh.Mesh``,
data parallel only, as in JAX: teacher and student replicated, the
student's gradient summed over the batch positions (and averaged over the
ranks on a mesh across processes).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..models import siggraph
from ..parallel import mesh as pmesh
from . import hints_sim, losses
from . import step as tstep


@dataclass
class DistillConfig:
    width: float = 0.5          # student channel multiplier
    lr: float = 1e-3
    reg_weight: float = 10.0    # smooth-L1 on ab vs the teacher's ab
    kl_weight: float = 1.0      # KL(teacher dist || student dist) at H/4
    gt_weight: float = 0.0      # optional smooth-L1 vs ground-truth ab
    temperature: float = 1.0    # softens both distributions
    maskcent: float = 0.0
    hint_p_keep: float = 1.0 / 8.0
    remat: bool = False         # students are small; off by default
    # lr schedule, as in step.TrainConfig
    schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: int = 0
    precision_name: str = "default"


def as_train_config(cfg: DistillConfig) -> tstep.TrainConfig:
    return tstep.TrainConfig(lr=cfg.lr, schedule=cfg.schedule,
                             warmup_steps=cfg.warmup_steps,
                             total_steps=cfg.total_steps,
                             precision_name=cfg.precision_name)


def init_student(cfg: DistillConfig, params=None, seed: int = 0,
                 device=None) -> dict:
    """A fresh student state on ``device`` (the card unless "cpu").
    ``params`` (a torch-layout state dict) must be at ``cfg.width``'s
    channel tiers: the first conv takes 4 channels at every width, so the
    tier is checked here."""
    if params is None:
        params = siggraph.init_state_dict(cfg.width, seed)
    else:
        want = siggraph.scaled_channels(cfg.width)[0]
        got = int(params["model1.0.weight"].shape[0])
        if got != want:
            raise ValueError(
                f"--init-from params are width-tier c1={got}, but --width "
                f"{cfg.width} needs c1={want}; a mismatched init would "
                "silently train the wrong-size student")
    return tstep.init_state(as_train_config(cfg), params, device=device)


def teacher_params(sd, dtype=None, device=None) -> dict[str, torch.Tensor]:
    """A frozen teacher for :func:`distill_loss`: a torch-layout state dict
    on ``device`` with its conv weights cast to ``dtype`` (None or
    "float32": f32) and BatchNorm rounded through it, as
    ``cast_weights_`` does."""
    dev = resolve_device(device)
    net = siggraph.SIGGRAPHGenerator.from_state_dict(sd).to(dev)
    if dtype not in (None, "float32", torch.float32):
        net.cast_weights_(dtype)
    return {k: v.detach() for k, v in net.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def distill_loss(student_params, teacher, batch, cfg: DistillConfig,
                 generator: torch.Generator | None = None, hints=None):
    """batch: {'l': (N,1,H,W) L in [0, 100], 'ab': (N,2,H,W)}. Teacher and
    student see the same hints (from ``generator``, or ``hints``)."""
    if hints is None:
        hints = hints_sim.sample_hints(batch["ab"], generator,
                                       p_keep=cfg.hint_p_keep)
    A = batch["l"] - 50.0
    with torch.no_grad():
        t_reg, t_logits = siggraph.forward_train(
            teacher, A, *hints, cfg.maskcent, cfg.precision_name)
    s_reg, s_logits = tstep.train_forward(student_params, A, *hints,
                                          cfg.maskcent, cfg.precision_name,
                                          cfg.remat)
    l_reg = losses.smooth_l1(s_reg / 110.0, t_reg / 110.0)
    t_prob = torch.softmax(t_logits / cfg.temperature, dim=1)
    s_logp = torch.log_softmax(s_logits / cfg.temperature, dim=1)
    l_kl = (t_prob * (torch.log(t_prob.clamp_min(1e-20)) - s_logp)).sum(
        1).mean()
    total = cfg.reg_weight * l_reg + cfg.kl_weight * l_kl
    aux = {"loss": total, "reg": l_reg, "kl": l_kl}
    if cfg.gt_weight:
        l_gt = losses.smooth_l1(s_reg / 110.0, batch["ab"] / 110.0)
        total = total + cfg.gt_weight * l_gt
        aux = {**aux, "loss": total, "gt": l_gt}
    return total, aux


def make_distill_step(cfg: DistillConfig):
    """``step(state, teacher, batch, generator, hints=None) -> (state,
    aux)``: one Adam update of the student, in place."""
    tcfg = as_train_config(cfg)

    def step(state, teacher, batch, generator=None, hints=None):
        aux = tstep.apply_update(state, tcfg, lambda: distill_loss(
            state["params"], teacher, batch, cfg, generator, hints))
        return state, aux

    return step


def make_sharded_distill_step(cfg: DistillConfig, mesh):
    """The distillation step on ``mesh``, data parallel over its batch
    axes. Returns ``(step, shard_state, shard_batch, put_teacher)``:
    ``shard_state`` puts the student on this rank's first mesh device (no
    tensor parallelism; rank 0's across processes), ``put_teacher``
    replicates the frozen teacher to this rank's positions,
    ``step(state, teacher, batch, generator=None, hints=None)`` as
    :func:`make_distill_step`'s. Each batch position of this rank runs
    :func:`distill_loss` on its chunk; the loss is the chunks' mean and one
    backward sums the student's gradient (``train.step``'s machinery, which
    averages it over the ranks across processes). On a (1, 1) mesh this is
    :func:`make_distill_step`'s step."""
    tcfg = as_train_config(cfg)

    def shard_state(state):
        return tstep.shard_train_state(state, tcfg, mesh,
                                       tensor_parallel=False)

    def shard_batch(batch):
        return pmesh.shard_batch(batch, mesh)

    def put_teacher(teacher):
        return {k: pmesh.put(v, pmesh.replicated(mesh))
                for k, v in teacher.items()}

    def step(state, teacher, batch, generator=None, hints=None):
        inputs = tstep.shard_inputs(mesh, batch, generator, hints,
                                    cfg.hint_p_keep)

        def loss_and_aux():
            results = []
            for pos, b, h in inputs:
                with pmesh.device_scope(mesh.devices[pos]):
                    results.append(distill_loss(
                        tstep.replicate_params(state["params"], mesh, pos),
                        {k: tstep.placed_at(v, mesh, pos)
                         for k, v in teacher.items()}, b, cfg, hints=h))
            return tstep.mean_over_chunks(results, mesh.first_local_device)

        return state, tstep.apply_update(state, tcfg, loss_and_aux, mesh)

    return step, shard_state, shard_batch, put_teacher


def load_student_state(path: str, cfg: DistillConfig, device=None) -> dict:
    """Restore a student state written by ``step.save_train_state``."""
    return tstep.load_train_state(path, as_train_config(cfg), device)
