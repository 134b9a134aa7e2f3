"""Checkpoint converter between the reference's formats and the port's.

Counterpart of ``scripts/convert_checkpoint.py``. Three directions:

* a torch ``.pth`` / ``.pt`` state dict of ``SIGGRAPHGenerator`` (the
  reference's published weights; BatchNorm's ``num_batches_tracked`` is
  dropped) -> an ``.npz`` in torch layout;
* a Caffe ``.caffemodel`` (parsed natively, no Caffe) -> an ``.npz`` of the
  ``--variant`` graph (main, dist or global);
* SIGGRAPH weights (an ``.npz`` in the JAX package's layout or torch's, a
  ``.pth``, or a train state of this package's trainer) -> a ``.pth`` state
  dict that the reference's ``SIGGRAPHGenerator`` loads with
  ``strict=True``.

Every SIGGRAPH state is checked by a strict load into the port's
``SIGGRAPHGenerator`` before it is written; every output loads in
``prep_net``. Refused, each with one line that names the way out: an orbax
directory (the JAX package's; reading one needs JAX), a Caffe-family state
written as ``.pth`` (the reference has no torch model of the Caffe graphs),
an unknown suffix. There is no orbax output: the port keeps ``.npz``.

Run: python -m ideepcolor_tpu_torch.apps.convert IN OUT
     [--variant main|dist|global]
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch

from ..models import caffe_net, siggraph
from ..models.caffemodel_io import load_caffemodel
from ..utils.session import save_params_npz

PTH = (".pth", ".pt")


def read_checkpoint(src: str, variant: str = "main"
                    ) -> tuple[str, dict[str, torch.Tensor]]:
    """``src`` -> ``(graph, state dict)``: graph is ``"siggraph"`` or the
    Caffe variant. Raises SystemExit with the way out for what it
    refuses."""
    if os.path.isdir(src):
        raise SystemExit(
            f"{src} is a directory, an orbax checkpoint of the JAX package: "
            f"reading one needs JAX. Export it to .npz with the JAX "
            f"package's utils/session.save_params_npz and convert that file")
    if src.endswith(".caffemodel"):
        return variant, load_caffemodel(src, variant)
    if src.endswith(PTH):
        from ..train.step import STATE_FORMAT
        try:
            blob = torch.load(src, map_location="cpu", weights_only=True)
        except pickle.UnpicklingError:
            raise SystemExit(
                f"{src} is not a plain state dict (a pickled module?): save "
                f"its state_dict() with torch.save and convert that file")
        if isinstance(blob, dict) and blob.get("format") == STATE_FORMAT:
            blob = blob["params"]                    # a train state
        arrays = {k: v.numpy() for k, v in blob.items()
                  if "num_batches_tracked" not in k}
    elif src.endswith(".npz"):
        with np.load(src) as z:
            arrays = {k: z[k] for k in z.files}
    else:
        raise SystemExit(f"unsupported input {src}: convert a .pth/.pt, a "
                         f".caffemodel or an .npz")
    if "model1.0.weight" in arrays:
        sd = siggraph.state_dict_from_params(arrays)
        siggraph.SIGGRAPHGenerator.from_state_dict(sd)     # strict load
        return "siggraph", sd
    try:
        graph = caffe_net.variant_of(arrays)
    except ValueError:
        raise SystemExit(f"{src} holds neither a SIGGRAPH nor a Caffe-family "
                         f"checkpoint")
    return graph, caffe_net.state_dict_from_params(arrays, graph)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ideepcolor_tpu_torch.apps.convert",
        description="convert a checkpoint: .pth -> .npz, .caffemodel -> "
                    ".npz, SIGGRAPH .npz / train state -> .pth")
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--variant", default="main",
                    choices=list(caffe_net.VARIANTS),
                    help="the Caffe graph of a .caffemodel input")
    args = ap.parse_args(argv)
    if not args.dst.endswith(PTH + (".npz",)):
        raise SystemExit(f"unsupported output {args.dst}: write an .npz, or "
                         f"a .pth/.pt for SIGGRAPH weights")
    if args.dst.endswith(PTH) and args.src.endswith(".caffemodel"):
        raise SystemExit(_caffe_pth(args.src, args.variant, args.dst))
    graph, sd = read_checkpoint(args.src, args.variant)
    if args.dst.endswith(PTH):
        if graph != "siggraph":
            raise SystemExit(_caffe_pth(args.src, graph, args.dst))
        torch.save(sd, args.dst)
        print(f"exported {len(sd)} tensors -> {args.dst}")
        return 0
    out = {k: v for k, v in sd.items() if "num_batches_tracked" not in k}
    save_params_npz(args.dst, out)
    print(f"wrote {len(out)} tensors ({graph}) -> {args.dst}")
    return 0


def _caffe_pth(src: str, graph: str, dst: str) -> str:
    return (f"{src} holds the Caffe {graph} graph, which the reference loads "
            f"only from a .caffemodel (it has no torch model of it to take "
            f"{dst}): convert to an .npz, which ColorizeImageCaffe*.prep_net "
            f"loads")

if __name__ == "__main__":
    raise SystemExit(main())
