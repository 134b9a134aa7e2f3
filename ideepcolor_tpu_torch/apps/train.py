"""Training CLI: user-guided colorization on an image folder, on the card.

Counterpart of ``ideepcolor_tpu/apps/train.py`` on one device: the data
(a device-resident corpus augmented on the card, or host-decoded batches) ->
simulated hints -> train step (or a distillation step against a frozen
teacher) -> train-state files -> optionally a params-only ``.npz`` that
both packages' loaders read (torch layout).

``--steps`` is the total: a resumed run takes the remaining steps, and its
data generator is seeded with ``1 + start_step`` so that it draws new
batches. The train state is the port's own file (``train/step.py``), not
an orbax directory. ``--model-parallel`` above 1 waits for the mesh forms.

Run: python -m ideepcolor_tpu_torch.apps.train DATA_DIR [--steps N]
     [--batch N] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("data_dir")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=176,
                    help="training crop size (must be divisible by 8)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--lr-schedule", type=str, default="constant",
                    choices=("constant", "cosine"),
                    help="cosine: linear warmup then cosine decay to "
                         "lr/100 over --steps")
    ap.add_argument("--warmup-steps", type=int, default=0)
    ap.add_argument("--ckpt", type=str, default="./train_ckpt",
                    help="train states go to CKPT_<step>.pt")
    ap.add_argument("--ckpt-every", type=int, default=500)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--resume", type=str, default="",
                    help="a train-state file to continue")
    ap.add_argument("--init-from", type=str, default="",
                    help="params-only checkpoint (.npz/.pth) to initialize "
                         "from with FRESH optimizer state (fine-tuning); "
                         "--resume instead continues a full train state")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--export", type=str, default="",
                    help="also save the final params as .npz (torch "
                         "layout), loadable by both packages' prep_net")
    ap.add_argument("--distill-from", type=str, default="",
                    help="teacher checkpoint (.npz/.pth): train a "
                         "width-multiplied student against it instead of "
                         "ground truth; 'random' uses a random-init teacher "
                         "(smoke runs)")
    ap.add_argument("--width", type=float, default=0.5,
                    help="student channel multiplier for --distill-from")
    ap.add_argument("--teacher-dtype", type=str, default="bfloat16",
                    help="teacher weights' type during distillation")
    ap.add_argument("--color-jitter", type=str, default="on",
                    choices=("on", "off", "strong"),
                    help="device-mode hue-rotation/compositing augmentation "
                         "(host mode has none; 'off' makes both modes train "
                         "on the same distribution; 'strong' = up to 4 "
                         "independently rotated regions)")
    ap.add_argument("--data-mode", type=str, default="auto",
                    choices=("auto", "host", "device"),
                    help="device: upload the corpus once and augment on the "
                         "card; auto picks device when the corpus fits in "
                         "512 MB")
    ap.add_argument("--device", type=str, default=None,
                    help="'cpu' to train on the CPU; the card otherwise")
    return ap.parse_args(argv)


def _check(ap_args) -> None:
    if ap_args.resume and ap_args.init_from:
        raise SystemExit("--resume and --init-from are mutually exclusive: "
                         "resume continues a full train state (optimizer "
                         "included); init-from starts a fresh run from "
                         "params only")
    if ap_args.model_parallel > 1:
        raise SystemExit("--model-parallel is not available in the "
                         "PyTorch/CUDA port: the sharded train step waits "
                         "for ROADMAP item 14c")
    if ap_args.export and not ap_args.export.endswith(".npz"):
        raise SystemExit(f"--export {ap_args.export}: the port exports "
                         f"params as .npz only")


def main(argv=None):
    args = parse_args(argv)
    _check(args)
    from ..device import resolve_device
    from ..models import siggraph
    from ..train import distill
    from ..train import step as tstep
    from ..train.data import ImageFolderLoader
    from ..train.device_data import DeviceDataset, corpus_fits_on_device
    from ..utils.profiling import StageTimer

    dev = resolve_device(args.device)
    cfg = tstep.TrainConfig(lr=args.lr, schedule=args.lr_schedule,
                            warmup_steps=args.warmup_steps,
                            total_steps=args.steps)
    init_sd = (siggraph.load_state_dict_file(args.init_from)
               if args.init_from else None)
    distilling = bool(args.distill_from)
    if distilling:
        dcfg = distill.DistillConfig(width=args.width, lr=args.lr,
                                     schedule=args.lr_schedule,
                                     warmup_steps=args.warmup_steps,
                                     total_steps=args.steps)
        sd = (siggraph.init_state_dict(1.0, 0)
              if args.distill_from == "random"
              else siggraph.load_state_dict_file(args.distill_from))
        teacher = distill.teacher_params(sd, args.teacher_dtype, dev)
        print(f"distilling width={args.width} student from "
              f"{args.distill_from} ({args.teacher_dtype} teacher)")
        if args.resume:
            state = distill.load_student_state(args.resume, dcfg, dev)
        else:
            state = distill.init_student(dcfg, init_sd, device=dev)
        dstep = distill.make_distill_step(dcfg)
        step = lambda st, b, g: dstep(st, teacher, b, g)  # noqa: E731
        log_keys = ("reg", "kl")
    else:
        if args.resume:
            state = tstep.load_train_state(args.resume, cfg, dev)
        else:
            state = tstep.init_state(cfg, init_sd, device=dev)
        step = tstep.make_train_step(cfg)
        log_keys = ("reg", "cls")
    if args.resume:
        print(f"resumed at step {state['step']}")
    elif args.init_from:
        print(f"params initialized from {args.init_from} "
              f"(fresh optimizer)")

    use_device_data = (args.data_mode == "device"
                       or (args.data_mode == "auto"
                           and corpus_fits_on_device(args.data_dir)))
    if use_device_data:
        loader = DeviceDataset(
            args.data_dir, batch_size=args.batch, size=args.size,
            color_jitter=("strong" if args.color_jitter == "strong"
                          else args.color_jitter == "on"), device=dev)
        print(f"device-resident dataset: {loader.n_images} images, "
              f"{loader.bytes_on_device / 1e6:.1f} MB on {dev} "
              f"(augmented there, color_jitter={args.color_jitter})")
    else:
        loader = ImageFolderLoader(args.data_dir, batch_size=args.batch,
                                   size=args.size)
    timer = StageTimer()

    # --steps is the TOTAL: a resumed run takes the remainder, so the lr
    # schedule (read at the restored count) stays aligned with the loop
    start_step = state["step"]
    remaining = max(args.steps - start_step, 0)
    if args.resume:
        print(f"{remaining} steps remaining to --steps {args.steps}")
    # a resumed run draws new hints, not the sequence from step 0
    gen = torch.Generator(device=dev).manual_seed(1 + start_step)
    t_log = time.perf_counter()
    try:
        for i in range(remaining):
            batch = {k: v.to(dev, non_blocking=True)
                     for k, v in next(loader).items()}
            with timer.stage("step"):        # the host's dispatch of a step
                state, aux = step(state, batch, gen)
            if (i + 1) % args.log_every == 0:
                parts = " ".join(f"{k}={float(aux[k]):.4f}"
                                 for k in log_keys)
                # reading the loss waited for the device: the wall time
                # since the last log covers log_every whole steps
                now = time.perf_counter()
                ips = args.batch * args.log_every / max(now - t_log, 1e-9)
                t_log = now
                print(f"step {state['step']}: loss={float(aux['loss']):.4f} "
                      f"{parts} ({ips:.1f} imgs/s)", flush=True)
            if (i + 1) % args.ckpt_every == 0 or i + 1 == remaining:
                path = f"{args.ckpt}_{state['step']}.pt"
                tstep.save_train_state(path, state)
                print(f"checkpoint -> {path}")
    finally:
        loader.close()
    if args.export:
        np.savez(args.export, **{k: v.detach().cpu().numpy()
                                 for k, v in state["params"].items()})
        print(f"exported params -> {args.export}")
    print(timer.report())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
