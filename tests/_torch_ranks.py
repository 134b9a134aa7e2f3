"""Rank programs for tests/test_torch_mesh_multiprocess.py.

:func:`run_ranks` spawns the ranks of a ``torch.distributed`` gloo group
over a ``file://`` store in the test's own directory (no port, so test
workers never collide), joins them within a deadline of its own and returns
what each rank wrote. The rank programs import torch and the port only,
never JAX: the test compares their results with JAX in its own process.
"""

from __future__ import annotations

import contextlib
import datetime
import hashlib
import io
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 2
CPU4 = ["cpu"] * 4


def run_ranks(fn, workdir, *args, group: bool = True,
              deadline: float = 240.0) -> list:
    """``fn(rank, workdir, *args)`` in :data:`WORLD` spawned processes, in
    an initialized gloo group unless ``group`` is False; returns each
    rank's result. A rank that raises fails the run with its traceback;
    ranks still running at ``deadline`` seconds are killed and the run
    fails."""
    workdir = str(workdir)
    ctx = mp.start_processes(_entry, args=(fn, workdir, group, args),
                             nprocs=WORLD, join=False, start_method="spawn")
    end = time.monotonic() + deadline
    try:
        while not ctx.join(timeout=max(end - time.monotonic(), 0.1)):
            if time.monotonic() >= end:
                raise TimeoutError(f"ranks still running after {deadline} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(WORLD)]


def init_group(rank: int, workdir: str,
               init=dist.init_process_group) -> None:
    init(
        "gloo", init_method=f"file://{os.path.join(workdir, 'store')}",
        rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=120))


def _entry(rank, fn, workdir, group, args):
    torch.set_num_threads(2)
    if group:
        init_group(rank, workdir)
    try:
        out = fn(rank, workdir, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def digest(params: dict) -> str:
    """sha256 of every tensor's bytes, in key order."""
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(k.encode())
        h.update(params[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def steps_rank(rank: int, workdir: str) -> dict:
    """The meshes, train steps, distill step, state file and refusals on
    meshes across the two ranks, each rank with four ``cpu`` entries."""
    from ideepcolor_tpu_torch.apps import serve
    from ideepcolor_tpu_torch.engine import batch as B
    from ideepcolor_tpu_torch.models import siggraph as tsig
    from ideepcolor_tpu_torch.parallel import mesh as pmesh
    from ideepcolor_tpu_torch.train import distill as tdistill
    from ideepcolor_tpu_torch.train import step as tstep

    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    meshes = {"hybrid": pmesh.make_hybrid_mesh(2, 2, devices=CPU4),
              "make_mesh": pmesh.make_mesh(8, 2, devices=CPU4)}
    out: dict = {"meshes": {
        name: dict(shape=dict(m.shape), ranks=m.ranks.tolist(),
                   local=m.local_positions(), rank=m.rank,
                   spans=m.spans_processes, devices=[str(d) for d in
                                                     m.devices.flat])
        for name, m in meshes.items()}}

    cfg = tstep.TrainConfig(lr=inp["lr"], precision_name="highest",
                            remat=False)
    for name, m in meshes.items():
        step, shard_state, shard_batch = tstep.make_sharded_train_step(cfg, m)
        state = shard_state(tstep.init_state(cfg, inp["sd"], device="cpu"))
        state, aux = step(state, shard_batch(inp["batch"]),
                          hints=inp["hints"])
        # a copy: the next step updates the params in place
        full = {k: v.clone() for k, v in
                tstep.full_params(state["params"]).items()}
        res = {"aux": {k: float(v) for k, v in aux.items()},
               "digests": [digest(full)]}
        if rank == 0:
            res["params"] = full
        if name == "hybrid":
            path = os.path.join(workdir, "state.pt")
            tstep.save_train_state(path, state)
            # past the barrier the file is whole in every rank
            res["file_digest"] = digest(
                tstep.load_train_state(path, cfg, "cpu")["params"])
        state, aux = step(state, inp["batch"],
                          torch.Generator().manual_seed(9))
        res["digests"].append(digest(tstep.full_params(state["params"])))
        res["aux2"] = {k: float(v) for k, v in aux.items()}
        out["train", name] = res

    dcfg = tdistill.DistillConfig(width=0.25, precision_name="highest")
    dstep, shard_state, shard_batch, put_teacher = \
        tdistill.make_sharded_distill_step(dcfg, meshes["hybrid"])
    teacher = tdistill.teacher_params(inp["teacher"], "float32", "cpu")
    state = shard_state(tdistill.init_student(dcfg, inp["student"],
                                              device="cpu"))
    state, aux = dstep(state, put_teacher(teacher),
                       shard_batch(inp["batch"]),
                       torch.Generator().manual_seed(4))
    full = tstep.full_params(state["params"])
    out["distill"] = {"aux": {k: float(v) for k, v in aux.items()},
                      "digests": [digest(full)],
                      "params": full if rank == 0 else None}

    # the program-level table forward runs this rank's chunks
    hm = meshes["hybrid"]
    fn, place = B.make_sharded_table_forward(hm)
    net = tsig.SIGGRAPHGenerator.from_state_dict(inp["sd"])
    rgb, _ = fn(net, *place(*inp["table_batch"]), 0.0)
    out["table_forward"] = {pos: t.numpy() for pos, t in rgb.pieces.items()}

    # every batch form refuses before any work (no weights are given, so
    # work would fail otherwise), and the server does not start
    imgs = np.zeros((4, 32, 32, 3), np.uint8)
    boxes = np.zeros((4, 256, 4), np.int32)
    values = np.zeros((4, 256, 2), np.float32)
    counts = np.zeros(4, np.int32)
    forms = {
        "colorize_batch_table": lambda: B.colorize_batch_table(
            None, imgs, boxes, values, counts, mesh=hm),
        "colorize_batch": lambda: B.colorize_batch(None, imgs, mesh=hm),
        "suggest_batch_table": lambda: B.suggest_batch_table(
            None, imgs, boxes, values, counts, counts, counts, mesh=hm),
        "colorize_batch_global": lambda: B.colorize_batch_global(
            None, imgs, np.zeros((4, 314), np.float32), mesh=hm),
        "stream_window_u8": lambda: B.stream_window_u8(
            None, imgs[..., :1], boxes[0], values[0], 0, mesh=hm)}
    out["refusals"] = {}
    for form, call in forms.items():
        try:
            call()
            out["refusals"][form] = None
        except ValueError as e:
            out["refusals"][form] = str(e)
    for name, call in (("ColorizeService",
                        lambda: serve.ColorizeService(device="cpu")),
                       ("serve.main", lambda: serve.main(["--device",
                                                          "cpu"]))):
        try:
            call()
            out["refusals"][name] = None
        except (RuntimeError, SystemExit) as e:
            out["refusals"][name] = str(e)
    return out


def app_rank(rank: int, workdir: str, argv: list) -> dict:
    """``apps/train.main(argv)`` as a launcher starts it (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``; the app starts the group, whose rendezvous is
    pointed at the file store here): the files each rank saved, its
    output, the group's backend and whether the app destroyed it."""
    from ideepcolor_tpu_torch.apps import train as train_cli
    os.environ.update(WORLD_SIZE=str(WORLD), RANK=str(rank), LOCAL_RANK="0")
    backends = []
    real_init = dist.init_process_group

    def init(backend, **kw):
        backends.append(backend)
        init_group(rank, workdir, real_init)
    dist.init_process_group = init
    saved = []
    real_save = torch.save

    def save(obj, f, *a, **kw):
        saved.append(os.path.basename(f))
        return real_save(obj, f, *a, **kw)
    torch.save = save
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = train_cli.main(argv)
    finally:
        dist.init_process_group = real_init
        torch.save = real_save
    return {"rc": rc, "saved": saved, "stdout": buf.getvalue(),
            "backends": backends, "group_left": dist.is_initialized()}
