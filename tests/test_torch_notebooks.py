"""The port's demo notebooks (``notebooks/torch/``) run cell by cell on the
CPU: each in a child process, in order, with ``DEVICE = "cpu"`` in place
of the card, IPython's magics dropped and matplotlib's Agg backend, on
seeded PNG images written at the paths the cells read (the reference's
``./test_imgs/...``; the port's codec knows a PNG by its signature, whatever
the file's suffix). Checked: every code cell ran, the frames' shapes, that a
hint changes the frame, and that no JAX module was loaded."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from ideepcolor_tpu_torch.utils.imageio import encode_png
from ideepcolor_tpu_torch.utils.notebook import code_cells

from _torch_caffe import smooth_image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOTEBOOKS = {
    "interactive": "notebooks/torch/DemoInteractiveColorization.ipynb",
    "global": "notebooks/torch/DemoGlobalHistogramTransfer.ipynb",
}
IMAGE_HW = (300, 400)           # mortar_pestle.jpg
GRAY_HW = (320, 240)            # bird_gray.jpg
REF_HW = (375, 500)             # the global reference image

# the child: run the cells, keep the frames each cell leaves, report
_CHILD = r"""
import json, sys
import numpy as np
from ideepcolor_tpu_torch.utils.notebook import run_cells
nb, out = sys.argv[1], sys.argv[2]
keep = ("img_out", "img_out_fullres", "img_gray_fullres", "mask_fullres",
        "img_in_fullres", "img_pred", "img_pred_auto_fullres",
        "img_pred_withref_fullres", "glob_dist_ref")
frames, cells = {}, 0
for i, ns in run_cells(nb, {"DEVICE": "cpu"}):
    cells += 1
    for k in keep:
        if k in ns:
            frames[f"{k}@{i}"] = np.asarray(ns[k])
np.savez(out + ".npz", **frames)
model = ns.get("colorModel", ns.get("cid"))
with open(out + ".json", "w") as f:
    json.dump({"cells": cells, "device": str(model.device),
               "backend": __import__("matplotlib").get_backend(),
               "jax": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "ideepcolor_tpu"))},
              f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both notebooks, each in its own child process, at once."""
    work = tmp_path_factory.mktemp("notebooks")
    imgs = work / "test_imgs"
    (imgs / "global_ref_bird").mkdir(parents=True)
    (imgs / "mortar_pestle.jpg").write_bytes(
        encode_png(smooth_image(1, *IMAGE_HW)))
    gray = smooth_image(2, *GRAY_HW).mean(-1).astype(np.uint8)
    (imgs / "bird_gray.jpg").write_bytes(
        encode_png(np.repeat(gray[..., None], 3, -1)))
    (imgs / "global_ref_bird" / "ILSVRC2012_val_00002383.JPEG").write_bytes(
        encode_png(smooth_image(3, *REF_HW)))
    env = {**os.environ, "MPLBACKEND": "Agg", "PYTHONPATH": ROOT}
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", _CHILD, os.path.join(ROOT, path),
         str(work / name)], cwd=work, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, path in NOTEBOOKS.items()}
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=240)
        assert p.returncode == 0, stderr[-3000:]
        with open(work / f"{name}.json") as f:
            report = json.load(f)
        with np.load(work / f"{name}.npz") as z:
            report["frames"] = {k: z[k] for k in z.files}
        out[name] = report
    return out


def _last(frames, name):
    """The value ``name`` had after the last cell that set it."""
    cells = [int(k.split("@")[1]) for k in frames if k.split("@")[0] == name]
    return frames[f"{name}@{max(cells)}"]


@pytest.mark.parametrize("name", sorted(NOTEBOOKS))
def test_first_cell_sets_the_device_and_constructors_take_it(name):
    cells = code_cells(os.path.join(ROOT, NOTEBOOKS[name]))
    assert 'DEVICE = "cuda"' in cells[0].splitlines()
    ctors = [line for src in cells for line in src.splitlines()
             if re.search(r"api\.ColorizeImage\w*\(", line)]
    assert ctors and all("device=DEVICE" in line for line in ctors)
    assert not any(line.lstrip().startswith("%") for src in cells
                   for line in src.splitlines())


@pytest.mark.parametrize("name", sorted(NOTEBOOKS))
def test_every_cell_runs_on_the_cpu(runs, name):
    nb = os.path.join(ROOT, NOTEBOOKS[name])
    assert runs[name]["cells"] == len(code_cells(nb))
    assert runs[name]["device"] == "cpu"
    assert runs[name]["backend"].lower() == "agg"


@pytest.mark.parametrize("name", sorted(NOTEBOOKS))
def test_no_jax_module_is_loaded(runs, name):
    assert runs[name]["jax"] == []


def test_interactive_shapes(runs):
    f = runs["interactive"]["frames"]
    full = IMAGE_HW + (3,)
    assert _last(f, "img_out").shape == (256, 256, 3)
    assert _last(f, "img_out").dtype == np.uint8
    for k in ("img_out_fullres", "img_gray_fullres", "mask_fullres",
              "img_in_fullres"):
        assert _last(f, k).shape == full, k
        assert _last(f, k).dtype == np.uint8, k
    gray = _last(f, "img_gray_fullres")
    assert np.array_equal(gray[..., 0], gray[..., 1])


def test_interactive_hint_changes_the_frame(runs):
    """The code cells colorize with no hint, then with a blue point, then
    with a gray one added: each hint moves the frame, and the mask shows
    the points."""
    f = runs["interactive"]["frames"]
    auto, blue, gray = f["img_out@2"], f["img_out@4"], f["img_out@5"]
    assert not np.array_equal(auto, blue)
    assert not np.array_equal(blue, gray)
    assert not np.array_equal(f["img_out_fullres@2"], f["img_out_fullres@4"])
    mask = f["mask_fullres@4"]
    points = np.any(mask != mask[0, 0], -1)     # the corner is background
    assert 0 < np.mean(points) < 0.05


def test_global_shapes_and_histogram(runs):
    f = runs["global"]["frames"]
    assert _last(f, "img_pred").shape == (256, 256, 3)
    for k in ("img_pred_auto_fullres", "img_pred_withref_fullres",
              "img_gray_fullres"):
        assert _last(f, k).shape == GRAY_HW + (3,), k
    glob = _last(f, "glob_dist_ref")
    assert glob.shape == (313,)
    assert abs(float(glob.sum()) - 1.0) < 1e-4
    assert glob.min() >= 0
