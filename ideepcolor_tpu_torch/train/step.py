"""One training step of the SIGGRAPH net on one device or on a mesh, its
optimizer and its learning-rate schedule, and the train state's file.

Counterpart of ``ideepcolor_tpu/train/step.py``. ``optax.adam(
lr, b1=0.9, b2=0.99)`` becomes ``torch.optim.Adam(betas=(0.9, 0.99),
eps=1e-8)``, fused on the card. Its learning rate is set before every
update from the count of updates made so far, with optax's schedule
values: optax reads the schedule at the count before the update, so the
first update of a warm-up has lr 0, and ``warmup_cosine_decay_schedule``'s
``decay_steps`` includes the warm-up. The state is a dict, ``{'params':
train_params, 'opt': Adam, 'step': int}``, updated in place.

The JAX step differentiates its whole params dict, BatchNorm's running
statistics included; so does this one (``models.siggraph.forward_train``).
``TrainConfig.precision_name`` is the convs' precision, forward and
backward: "default" (TF32 on the card, the JAX step's
``Precision.DEFAULT``) or "highest" (f32).

:func:`make_sharded_train_step` is the step on a ``parallel.mesh.Mesh``:
data parallel over its batch axes, tensor parallel on the trunk convs over
its model axis (``parallel.mesh.TP_PARAMS``). Its state holds each such
param as a tuple of out-channel slices, one per model-axis device; the
train-state file holds every param whole, so a sharded run's file loads in
a single-device run and back. On a mesh across processes each rank runs
its own chunks, and the gradients, the loss and the aux values are
averaged over the ranks (``all_reduce``) before the update; rank 0 writes
the file.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import conv_precision, resolve_device
from ..models import siggraph
from ..ops.quantize import make_pts_grid
from ..parallel import mesh as pmesh
from . import hints_sim, losses

STATE_FORMAT = "ideepcolor_tpu_torch.train_state.v1"


@dataclass
class TrainConfig:
    lr: float = 3e-4
    class_weight: float = 1.0
    reg_weight: float = 10.0
    maskcent: float = 0.0
    hint_p_keep: float = 1.0 / 8.0
    # recompute the forward in the backward pass: memory for operations
    remat: bool = True
    # learning-rate schedule: "constant" (the reference recipe) or "cosine"
    # (linear warm-up to lr, cosine decay to lr/100 over total_steps)
    schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: int = 0
    precision_name: str = "default"


def _linear(init: float, end: float, steps: int, count: int) -> np.float32:
    """optax.linear_schedule in its own f32 arithmetic."""
    if steps <= 0:
        return np.float32(init)
    frac = np.float32(1) - np.float32(min(max(count, 0), steps)) \
        / np.float32(steps)
    return np.float32(init - end) * frac + np.float32(end)


def _cosine(init: float, decay_steps: int, alpha: float,
            count: int) -> np.float32:
    """optax.cosine_decay_schedule (exponent 1) in f32."""
    c = np.float32(min(count, decay_steps))
    # cos of the f32 argument, correctly rounded to f32 (XLA's f32 cos
    # agrees with it on all but about 1% of the schedule's arguments)
    arg = np.float32(np.pi) * c / np.float32(decay_steps)
    cos = np.float32(0.5) * (np.float32(1)
                             + np.float32(np.cos(np.float64(arg))))
    return np.float32(init) * (np.float32(1 - alpha) * cos
                               + np.float32(alpha))


def check_schedule(cfg) -> None:
    if cfg.schedule == "cosine":
        if cfg.total_steps <= 0:
            raise ValueError("cosine schedule needs total_steps > 0")
        if cfg.total_steps <= max(cfg.warmup_steps, 1):
            # optax refuses a cosine decay of no steps when it is built
            raise ValueError("cosine schedule needs total_steps > "
                             "warmup_steps")
    elif cfg.schedule != "constant":
        raise ValueError(f"unknown schedule {cfg.schedule!r}")


def lr_at(cfg, count: int) -> float:
    """The learning rate of the update made after ``count`` updates: the
    value optax's schedule of ``make_optimizer`` gives at that count."""
    check_schedule(cfg)
    if cfg.schedule == "cosine":
        warm = max(cfg.warmup_steps, 1)
        if count < warm:
            return float(_linear(0.0, cfg.lr, warm, count))
        alpha = 0.0 if cfg.lr == 0.0 else (cfg.lr / 100.0) / cfg.lr
        return float(_cosine(cfg.lr, cfg.total_steps - warm, alpha,
                             count - warm))
    if cfg.warmup_steps > 0:
        return float(_linear(0.0, cfg.lr, cfg.warmup_steps, count))
    return float(np.float32(cfg.lr))


def make_optimizer(cfg, params: dict[str, torch.Tensor]
                   ) -> torch.optim.Adam:
    """Adam over ``params`` (b1 0.9, b2 0.99, eps 1e-8), fused where the
    params lie on the card; its lr is set per update by the train step."""
    check_schedule(cfg)
    on_card = next(iter(params.values())).device.type == "cuda"
    return torch.optim.Adam(list(params.values()), lr=lr_at(cfg, 0),
                            betas=(0.9, 0.99), eps=1e-8,
                            fused=on_card or None,
                            foreach=None if on_card else True)


def init_state(cfg: TrainConfig, params=None, seed: int = 0,
               device=None) -> dict:
    """A fresh train state on ``device`` (the card unless "cpu").
    ``params``: a torch-layout state dict to fine-tune from
    (``load_state_dict_file``); without it, seeded random full-width
    weights."""
    if params is None:
        params = siggraph.init_state_dict(1.0, seed)
    p = siggraph.train_params(params, resolve_device(device))
    return {"params": p, "opt": make_optimizer(cfg, p), "step": 0}


def pts_grid(device) -> torch.Tensor:
    """The 529 centers of the full 23x23 ab grid, the class head's bins."""
    return torch.as_tensor(make_pts_grid(), dtype=torch.float32,
                           device=device)


def train_forward(params, A, hint_ab, hint_mask, maskcent: float,
                  precision_name: str, remat: bool):
    """``siggraph.forward_train``; with ``remat`` its activations are not
    kept but recomputed in the backward (the same values)."""
    if remat:
        return checkpoint(siggraph.forward_train, params, A, hint_ab,
                          hint_mask, maskcent, precision_name,
                          use_reentrant=False)
    return siggraph.forward_train(params, A, hint_ab, hint_mask, maskcent,
                                  precision_name)


def loss_fn(params, batch, cfg: TrainConfig, centers: torch.Tensor,
            generator: torch.Generator | None = None, hints=None):
    """batch: {'l': (N,1,H,W) L in [0, 100], 'ab': (N,2,H,W)}. The hints
    are sampled from ``generator`` (``hints_sim.sample_hints``) unless
    ``hints`` gives them as (hint_ab, hint_mask). -> (total, aux)."""
    gt_ab = batch["ab"]
    if hints is None:
        hints = hints_sim.sample_hints(gt_ab, generator,
                                       p_keep=cfg.hint_p_keep)
    out_reg, logits = train_forward(params, batch["l"] - 50.0, *hints,
                               cfg.maskcent, cfg.precision_name, cfg.remat)
    l_reg = losses.smooth_l1(out_reg / 110.0, gt_ab / 110.0)
    # the class target at the logits' resolution (H/4): the 4x4 mean ab
    ab_q = F.avg_pool2d(gt_ab, 4)
    l_cls = losses.class_xent(logits, ab_q, centers, nn=10, sigma=5.0)
    total = cfg.reg_weight * l_reg + cfg.class_weight * l_cls
    return total, {"loss": total, "reg": l_reg, "cls": l_cls}


def _flat_collective(tensors: list[torch.Tensor], op) -> None:
    """``op`` (an in-place collective on one tensor) over ``tensors``,
    through one flat buffer per device and dtype, copied back in place.
    Every rank passes tensors of the same shapes in the same order."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    with torch.no_grad():
        for ts in groups.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            op(flat)
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t))


def mean_over_processes(tensors: list[torch.Tensor]) -> None:
    """Each tensor replaced in place by its mean over the ranks of the
    ``torch.distributed`` group: ``all_reduce`` of the sum, divided by the
    rank count. The ranks end with the same bytes."""
    w = pmesh.process_count()

    def mean(flat):
        dist.all_reduce(flat)
        flat.div_(w)
    _flat_collective(tensors, mean)


def apply_update(state: dict, cfg, loss_and_aux, mesh=None) -> dict:
    """Backward of ``loss_and_aux()``'s total and one Adam update at the
    schedule's lr, with the convs' precision scope held over the backward
    (its convs run after the forward's scope would have closed). On a
    ``mesh`` across processes, every gradient (each slice of a sliced
    param) and every aux value is first averaged over the ranks: each
    rank's total is the mean over its chunks, so with equal chunks per rank
    the update follows the gradient of the global mean. Returns the aux
    values, detached."""
    opt = state["opt"]
    for g in opt.param_groups:
        g["lr"] = lr_at(cfg, state["step"])
    opt.zero_grad(set_to_none=True)
    with conv_precision(cfg.precision_name):
        total, aux = loss_and_aux()
        total.backward()
    aux = {k: v.detach() for k, v in aux.items()}
    if mesh is not None and mesh.spans_processes:
        # after backward, not in hooks: a rematerialized forward runs its
        # hooks again
        mean_over_processes([p.grad for g in opt.param_groups
                             for p in g["params"] if p.grad is not None])
        values = torch.stack(list(aux.values()))
        mean_over_processes([values])
        aux = dict(zip(aux, values.unbind()))
    opt.step()
    state["step"] += 1
    return aux


def make_train_step(cfg: TrainConfig):
    """``step(state, batch, generator, hints=None) -> (state, aux)``: the
    loss, its gradient w.r.t. every param, one Adam update, in place."""
    grids: dict = {}

    def train_step(state, batch, generator=None, hints=None):
        dev = batch["ab"].device
        centers = grids.get(dev)
        if centers is None:
            centers = grids[dev] = pts_grid(dev)
        aux = apply_update(state, cfg, lambda: loss_fn(
            state["params"], batch, cfg, centers, generator, hints))
        return state, aux

    return train_step


# ----- the sharded step: data parallel over the mesh's batch axes, the
# trunk convs tensor parallel over its model axis, one controller -----

def full_params(params: dict) -> dict[str, torch.Tensor]:
    """Every param whole and detached: a tensor-parallel param's slices
    concatenated on its first slice's device."""
    return {k: (torch.cat([s.detach().to(v[0].device) for s in v])
                if isinstance(v, tuple) else v.detach())
            for k, v in params.items()}


def _leaves(params: dict) -> dict[str, torch.Tensor]:
    """The optimizer's tensors in order: a sliced param's slices in model
    order."""
    out = {}
    for k, v in params.items():
        if isinstance(v, tuple):
            out.update({f"{k}#{m}": t for m, t in enumerate(v)})
        else:
            out[k] = v
    return out


def _whole_opt_state(params: dict, opt) -> dict:
    """``opt.state_dict()`` in the layout of a state whose params are
    whole: the moments of a sliced param concatenated like its slices."""
    sd = opt.state_dict()
    state, i = {}, 0
    for j, v in enumerate(params.values()):
        n = len(v) if isinstance(v, tuple) else 1
        parts = [sd["state"][i + m] for m in range(n)
                 if i + m in sd["state"]]
        if parts:
            state[j] = {name: (torch.cat([p[name].to(t.device)
                                          for p in parts])
                               if n > 1 and t.dim() else t)
                        for name, t in parts[0].items()}
        i += n
    return {"state": state,
            "param_groups": [dict(g, params=list(range(len(params))))
                             for g in sd["param_groups"]]}


def _sliced_opt_state(whole: dict, params: dict) -> dict:
    """The inverse of :func:`_whole_opt_state` for ``params``' slicing."""
    state, i = {}, 0
    for j, v in enumerate(params.values()):
        n = len(v) if isinstance(v, tuple) else 1
        if j in whole["state"]:
            sizes = [t.shape[0] for t in v] if n > 1 else None
            for name, t in whole["state"][j].items():
                pieces = (torch.split(t, sizes) if n > 1 and t.dim()
                          else [t] * n)
                for m in range(n):
                    state.setdefault(i + m, {})[name] = pieces[m].clone()
        i += n
    return {"state": state,
            "param_groups": [dict(g, params=list(range(i)))
                             for g in whole["param_groups"]]}


def _broadcast_state(state: dict) -> None:
    """Rank 0's params and Adam's moments and counts, in place on every
    rank: a JAX ``device_put`` of one host value to a global sharding
    assumes every process gives the same bytes."""
    leaves = list(_leaves(state["params"]).values())
    opt = state["opt"]
    tensors = leaves + [v for p in leaves for v in opt.state.get(
        p, {}).values() if isinstance(v, torch.Tensor)]
    shapes: list = [None] * pmesh.process_count()
    dist.all_gather_object(shapes, [tuple(t.shape) for t in tensors])
    if any(s != shapes[0] for s in shapes):
        raise ValueError("the ranks' train states differ in layout (a "
                         "resumed rank beside a fresh one?)")
    _flat_collective(tensors, lambda flat: dist.broadcast(flat, src=0))


def shard_train_state(state: dict, cfg, mesh,
                      tensor_parallel: bool = True) -> dict:
    """A train state laid out for ``mesh``: every param a leaf on this
    rank's first mesh device, except, with ``tensor_parallel``, the trunk
    convs (``parallel.mesh.TP_PARAMS``), split on their out channels into
    one slice per model-axis device at this rank's first data position;
    Adam's moments follow their params. Where nothing moves, ``state``
    itself. On a mesh across processes every rank then holds rank 0's
    params and moments (broadcast). The state given is consumed, as JAX
    donates it: the result may share its tensors."""
    first = mesh.first_local_device
    mdevs = [mesh.devices[p] for p in pmesh.model_positions(
        mesh, pmesh.local_batch_positions(mesh)[0])]
    new = {}
    for k, v in full_params(state["params"]).items():
        old = state["params"][k]
        if tensor_parallel and len(mdevs) > 1 and k in pmesh.TP_PARAMS:
            if v.shape[0] % len(mdevs):
                raise ValueError(f"{k}: {v.shape[0]} out channels do not "
                                 f"split over {len(mdevs)} model devices")
            new[k] = tuple(t.to(d, copy=True).requires_grad_(True)
                           for t, d in zip(v.chunk(len(mdevs)), mdevs))
        elif isinstance(old, torch.Tensor) and old.device == first:
            new[k] = old
        else:
            pmesh.check_placement(v, mesh)
            new[k] = v.to(first, copy=True).requires_grad_(True)
    if all(new[k] is state["params"][k] for k in new):
        out = state
    else:
        opt = make_optimizer(cfg, _leaves(new))
        opt.load_state_dict(_sliced_opt_state(
            _whole_opt_state(state["params"], state["opt"]), new))
        out = {"params": new, "opt": opt, "step": state["step"]}
    if mesh.spans_processes:
        _broadcast_state(out)
    return out


def replicate_params(params: dict, mesh, pos) -> dict:
    """The params as mesh position ``pos`` computes with them:
    differentiable copies on its devices (a slice on its model-axis
    device), so one backward sums every position's gradient into the
    master params. Where the device repeats, the master itself."""
    dev = mesh.devices[pos]
    mdevs = [mesh.devices[p] for p in pmesh.model_positions(mesh, pos)]
    return {k: (tuple(t.to(d) for t, d in zip(v, mdevs))
                if isinstance(v, tuple) else v.to(dev))
            for k, v in params.items()}


def placed_at(x, mesh, pos) -> torch.Tensor:
    """Position ``pos``'s copy of a replicated input."""
    if isinstance(x, pmesh.ShardedTensor):
        return x.piece(pos)
    pmesh.check_placement(x, mesh)
    return x.to(mesh.devices[pos])


def _chunk(x, mesh) -> list[torch.Tensor]:
    """The batch chunk of each of this rank's batch positions: a placed
    batch's pieces, or a whole tensor split into equal chunks over every
    batch position of the mesh."""
    local = pmesh.local_batch_positions(mesh)
    if isinstance(x, pmesh.ShardedTensor):
        return [x.piece(p) for p in local]
    pmesh.check_placement(x, mesh)
    positions = pmesh.batch_positions(mesh)
    if x.shape[0] % len(positions):
        raise ValueError(f"a batch of {x.shape[0]} does not split into "
                         f"{len(positions)} equal chunks")
    size = x.shape[0] // len(positions)
    return [x[i * size:(i + 1) * size].to(mesh.devices[p])
            for i, p in enumerate(positions) if p in local]


def shard_inputs(mesh, batch: dict, generator, hints, p_keep: float
                 ) -> list[tuple]:
    """Per batch position of ``mesh`` that this rank runs: (position,
    batch chunk, hints). Every rank gives the whole batch (placed or not).
    The hints are ``hints`` split like the batch or, without them, drawn
    ONCE for the whole batch from ``generator`` on this rank's first mesh
    device (``hints_sim.draw_hint_numbers``; every rank seeds its own
    generator alike) and computed per chunk, so a sharded step sees the
    single-device step's hints."""
    local = pmesh.local_batch_positions(mesh)
    chunks = {k: _chunk(v, mesh) for k, v in batch.items()}
    if hints is not None:
        hint_chunks = [_chunk(h, mesh) for h in hints]
    else:
        draws = hints_sim.draw_hint_numbers(batch["ab"].shape[0], generator,
                                            mesh.first_local_device)
        draw_chunks = [[None] * len(local) if d is None else _chunk(d, mesh)
                       for d in draws]
        hint_chunks = list(zip(*[
            hints_sim.hints_from_draws(ab, *(d[j] for d in draw_chunks),
                                       p_keep=p_keep)
            for j, ab in enumerate(chunks["ab"])]))
    return [(p, {k: c[j] for k, c in chunks.items()},
             tuple(h[j] for h in hint_chunks))
            for j, p in enumerate(local)]


def mean_over_chunks(results: list, device) -> tuple:
    """(total, aux) of equal chunks: the mean of each on ``device``; one
    chunk's own values where there is one."""
    if len(results) == 1:
        return results[0]
    mean = lambda ts: torch.stack([t.to(device) for t in ts]).mean()  # noqa
    return (mean([r[0] for r in results]),
            {k: mean([r[1][k] for r in results]) for k in results[0][1]})


def make_sharded_train_step(cfg: TrainConfig, mesh):
    """The train step on ``mesh``. Returns ``(step, shard_state,
    shard_batch)``: ``shard_state(state)`` lays a state out for the mesh
    (:func:`shard_train_state`), ``shard_batch(batch)`` places a batch on
    its batch axes, ``step(state, batch, generator=None, hints=None) ->
    (state, aux)`` as :func:`make_train_step`'s.

    Each (dcn, data) position runs ``loss_fn`` on its chunk with the params
    replicated to it (:func:`replicate_params`); the loss is the mean of
    the chunks' (equal chunks); ONE backward sums the replicas' gradients
    into the master params, then one Adam update at the schedule's lr. On
    a (1, 1) mesh this is :func:`make_train_step`'s step. Across
    processes each rank runs its positions and gives the whole batch and a
    generator seeded alike; :func:`apply_update` averages the ranks'
    gradients."""
    grids: dict = {}

    def centers_on(dev):
        if dev not in grids:
            grids[dev] = pts_grid(dev)
        return grids[dev]

    def shard_state(state):
        return shard_train_state(state, cfg, mesh)

    def shard_batch(batch):
        return pmesh.shard_batch(batch, mesh)

    def step(state, batch, generator=None, hints=None):
        inputs = shard_inputs(mesh, batch, generator, hints,
                              cfg.hint_p_keep)

        def loss_and_aux():
            results = []
            for pos, b, h in inputs:
                dev = mesh.devices[pos]
                with pmesh.device_scope(dev):
                    results.append(loss_fn(
                        replicate_params(state["params"], mesh, pos), b,
                        cfg, centers_on(dev), hints=h))
            return mean_over_chunks(results, mesh.first_local_device)

        return state, apply_update(state, cfg, loss_and_aux, mesh)

    return step, shard_state, shard_batch


# ----- the train state's file: params, Adam's moments and counts, and the
# count of updates; torch.save, read back with weights_only=True. A sharded
# state is written whole -----

def save_train_state(path: str, state: dict) -> None:
    """Write ``state`` to ``path``. In a ``torch.distributed`` group every
    rank calls it: rank 0 writes, and every rank waits at a barrier until
    the file is whole."""
    if pmesh.process_rank() == 0:
        torch.save({"format": STATE_FORMAT,
                    "params": full_params(state["params"]),
                    "opt": _whole_opt_state(state["params"], state["opt"]),
                    "step": int(state["step"])}, path)
    pmesh.barrier()


def load_train_state(path: str, cfg, device=None) -> dict:
    """Restore a state written by :func:`save_train_state` onto ``device``
    (the card unless "cpu"). The optimizer is rebuilt from ``cfg`` and
    given the saved moments and counts."""
    dev = resolve_device(device)
    blob = torch.load(path, map_location=dev, weights_only=True)
    if not isinstance(blob, dict) or blob.get("format") != STATE_FORMAT:
        raise ValueError(f"{path} is not a train state of this package "
                         f"(format {STATE_FORMAT})")
    p = siggraph.train_params(blob["params"], dev)
    opt = make_optimizer(cfg, p)
    opt.load_state_dict(blob["opt"])
    return {"params": p, "opt": opt, "step": int(blob["step"])}
