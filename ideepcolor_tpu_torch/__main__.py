"""Unified CLI: ``python -m ideepcolor_tpu_torch <command> [args]``.

Counterpart of ``ideepcolor_tpu/__main__.py``: one front door to every app
of the port (each also runs standalone as ``python -m
ideepcolor_tpu_torch.apps.<name>``):

    gui     Qt interactive colorization app (ref ideepcolor.py flags)
    serve   HTTP server: /colorize, sessions, batching, browser UI
    train   train / fine-tune / distill SIGGRAPH checkpoints
    eval    PSNR-vs-hint-count sweep (+--save-grid contact sheet)
    video   colorize a frame stream (uint8 pipeline)
    demos   headless notebook walkthroughs (local hints, global hist)
    fidelity  the port's checkpoint/numerics acceptance in one command
"""
from __future__ import annotations

import sys

_COMMANDS = {
    "gui": ("ideepcolor_tpu_torch.apps.ideepcolor", "Qt interactive app"),
    "serve": ("ideepcolor_tpu_torch.apps.serve", "HTTP serving"),
    "train": ("ideepcolor_tpu_torch.apps.train", "training / distillation"),
    "eval": ("ideepcolor_tpu_torch.apps.eval", "quality evaluation"),
    "video": ("ideepcolor_tpu_torch.apps.video", "video colorization"),
    "demos": ("ideepcolor_tpu_torch.apps.demos", "headless demos"),
    "fidelity": ("ideepcolor_tpu_torch.apps.fidelity",
                 "checkpoint/numerics acceptance against the JAX package "
                 "(one PASS/FAIL/SKIP line per artifact)"),
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("--version", "-V"):
        from ideepcolor_tpu_torch import __version__
        print(f"ideepcolor-tpu-torch {__version__}")
        return 0
    if not argv or argv[0] in ("-h", "--help", "help"):
        from ideepcolor_tpu_torch import __version__
        lines = "\n".join(f"  {name:<7} {desc}"
                          for name, (_, desc) in _COMMANDS.items())
        print(f"ideepcolor-tpu-torch {__version__} — interactive "
              f"colorization on the card (PyTorch/CUDA)\n\nusage: python -m "
              f"ideepcolor_tpu_torch COMMAND [args]\n\ncommands:\n{lines}\n\n"
              "COMMAND --help shows its own flags.")
        return 0
    cmd = argv[0]
    if cmd not in _COMMANDS:
        print(f"unknown command {cmd!r}; try: "
              + " ".join(_COMMANDS), file=sys.stderr)
        return 2
    import importlib
    mod = importlib.import_module(_COMMANDS[cmd][0])
    return mod.main(argv[1:]) or 0


if __name__ == "__main__":
    raise SystemExit(main())
