"""The port's train and eval CLIs with ``--device cpu`` on a seeded PNG
corpus: fine-tune, resume, distill, export (read by both packages'
loaders), and the refusals."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ideepcolor_tpu.models import siggraph as jsig
from ideepcolor_tpu_torch.api import ColorizeImageTorch
from ideepcolor_tpu_torch.apps import eval as eval_cli
from ideepcolor_tpu_torch.apps import train as train_cli
from ideepcolor_tpu_torch.models import siggraph as tsig
from ideepcolor_tpu_torch.ops.hints import points_json_to_table
from ideepcolor_tpu_torch.train import distill
from ideepcolor_tpu_torch.train import step as tstep
from ideepcolor_tpu_torch.utils import imageio
from ideepcolor_tpu_torch.utils.imageio import UnsupportedImage, encode_png

torch.set_num_threads(2)
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "weights")
STUDENT = os.path.join(WEIGHTS, "student_w025.npz")


def smooth_image(seed, H, W):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / max(H, W)
    base = np.stack([np.sin(6 * yy + c) * np.cos(5 * xx - 2 * c)
                     for c in range(3)], -1)
    return np.clip(127.5 + 100 * base + rng.normal(0, 12, (H, W, 3)),
                   0, 255).astype(np.uint8)


@pytest.fixture
def data(tmp_path):
    d = tmp_path / "data"
    d.mkdir()
    for i, (H, W) in enumerate([(72, 60), (64, 64), (50, 90)]):
        (d / f"im{i}.png").write_bytes(encode_png(smooth_image(i, H, W)))
    return d


def base_args(data, tmp_path, *extra):
    return [str(data), "--batch", "2", "--size", "32", "--ckpt",
            str(tmp_path / "ck"), "--log-every", "1", "--device", "cpu",
            *extra]


def click(path, size=32):
    m = ColorizeImageTorch(Xd=size, device="cpu")
    m.prep_net(path=path)
    m.set_image(smooth_image(9, size, size))
    out = m.net_forward_table(*points_json_to_table(
        [{"y": 5, "x": 7, "ab": [20, -30], "radius": 2}], size))
    assert out.shape == (size, size, 3) and out.dtype == np.uint8
    return m


@pytest.mark.parametrize("data_mode", ["device", "host"])
def test_finetune_export_and_resume(data, tmp_path, data_mode, capsys):
    """Fine-tune the w0.25 student for 2 steps, export, resume to a total
    of 3: one more step, the count and schedule carried on; the export is
    a torch-layout .npz that the port's prep_net loads and the JAX
    package's load_params reads to the same forward (ab within 1e-3,
    measured 7.5e-6)."""
    args = base_args(data, tmp_path, "--data-mode", data_mode,
                     "--init-from", STUDENT, "--lr-schedule", "cosine",
                     "--warmup-steps", "1")
    export = str(tmp_path / "ft.npz")
    assert train_cli.main(args + ["--steps", "2", "--ckpt-every", "2",
                                  "--export", export]) == 0
    out = capsys.readouterr().out
    assert "params initialized from" in out and "step 2: loss=" in out
    ft = dict(np.load(export))
    assert ft["model1.0.weight"].shape == (16, 4, 3, 3)     # OIHW
    assert not any("num_batches" in k for k in ft)
    with np.load(STUDENT) as z:
        assert not np.allclose(ft["model1.0.weight"],
                               tsig.state_dict_from_params(
                                   dict(z))["model1.0.weight"].numpy())
    m = click(export)
    jp = jsig.load_params(export)
    rng = np.random.default_rng(1)
    A = rng.uniform(-50, 50, (1, 32, 32, 1)).astype(np.float32)
    want = np.asarray(jsig.apply(jp, A, jnp.zeros((1, 32, 32, 2)),
                                 jnp.zeros((1, 32, 32, 1))))
    with torch.no_grad():
        got = m.net(torch.from_numpy(A).permute(0, 3, 1, 2),
                    torch.zeros(1, 2, 32, 32), torch.zeros(1, 1, 32, 32))
    assert np.abs(got.permute(0, 2, 3, 1).numpy() - want).max() <= 1e-3
    # --steps is a total: resuming the step-2 state runs one step
    assert train_cli.main(args[:-6] + ["--lr-schedule", "cosine",
                                       "--warmup-steps", "1", "--steps",
                                       "3", "--ckpt-every", "1", "--resume",
                                       str(tmp_path / "ck_2.pt")]) == 0
    out = capsys.readouterr().out
    assert "resumed at step 2" in out and "1 steps remaining" in out
    cfg = tstep.TrainConfig(schedule="cosine", warmup_steps=1,
                            total_steps=3)
    st = tstep.load_train_state(str(tmp_path / "ck_3.pt"), cfg, "cpu")
    assert st["step"] == 3
    assert not os.path.exists(tmp_path / "ck_4.pt")
    assert all(int(s["step"]) == 3
               for s in st["opt"].state_dict()["state"].values())


def test_distill_from_random_teacher(data, tmp_path):
    """--distill-from random --width 0.125: a student of the seeded
    full-width teacher, exported, served, and resumed from its state."""
    export = str(tmp_path / "student.npz")
    args = base_args(data, tmp_path, "--distill-from", "random", "--width",
                     "0.125", "--ckpt-every", "2")
    assert train_cli.main(args + ["--steps", "2", "--export", export]) == 0
    m = click(export)
    assert m.net.model1[0].weight.shape == (8, 4, 3, 3)
    st = distill.load_student_state(str(tmp_path / "ck_2.pt"),
                                    distill.DistillConfig(width=0.125),
                                    "cpu")
    assert st["step"] == 2


def test_export_pth_loads_strictly(data, tmp_path):
    """``--export w.pth``: a state dict, BatchNorm's
    ``num_batches_tracked`` included, that the port's ``SIGGRAPHGenerator``
    at the student's width loads with ``strict=True``, holding the trained
    params of the run's last train state; the package's loaders read it as
    they read the ``.npz``."""
    export = str(tmp_path / "w.pth")
    assert train_cli.main(base_args(data, tmp_path, "--steps", "1",
                                    "--init-from", STUDENT,
                                    "--export", export)) == 0
    sd = torch.load(export, map_location="cpu", weights_only=True)
    net = tsig.SIGGRAPHGenerator(tsig.scaled_channels(0.25))
    net.load_state_dict(sd, strict=True)
    state = tstep.load_train_state(str(tmp_path / "ck_1.pt"),
                                   tstep.TrainConfig(), "cpu")
    assert set(sd) - set(state["params"]) == {
        k for k in sd if k.endswith("num_batches_tracked")}
    assert all(torch.equal(sd[k], state["params"][k].detach())
               for k in state["params"])
    assert all(torch.equal(a, b) for a, b in zip(
        tsig.load_state_dict_file(export).values(), sd.values()))
    click(export)


def test_refusals(data, tmp_path, monkeypatch):
    """--model-parallel 2 on one device fails with make_mesh's ValueError
    (JAX fails there too, with too few devices for the mesh); --resume
    with --init-from, and an export that is neither .npz nor .pth (JAX's
    other form is an orbax directory), are refused before
    any work; a corpus with a JPEG and no OpenCV raises instead of
    shrinking; without a card and without --device cpu the CLIs raise."""
    args = base_args(data, tmp_path, "--steps", "1")
    with pytest.raises(ValueError, match="devices"):
        train_cli.main(args + ["--model-parallel", "2"])
    with pytest.raises(SystemExit, match="mutually"):
        train_cli.main(args + ["--resume", "x.pt", "--init-from", STUDENT])
    with pytest.raises(SystemExit, match=r"\.npz or \.pth"):
        train_cli.main(args + ["--export", str(tmp_path / "w_orbax")])
    (data / "photo.jpg").write_bytes(b"\xff\xd8\xff\xe0" + b"\x00" * 64)
    monkeypatch.setattr(imageio, "_cv2", lambda: None)
    for mode in ("device", "host"):
        with pytest.raises(UnsupportedImage, match="OpenCV"):
            train_cli.main(args + ["--data-mode", mode, "--batch", "8"])
    with pytest.raises(UnsupportedImage):
        eval_cli.main([str(data), "--size", "32", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main([str(data), "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_cli.main([str(data)])


def test_eval_cli(data, tmp_path, capsys):
    """The eval CLI on the CPU: the curve, AUC, fidelity, JSON and the
    contact sheet, with the JAX app's output keys."""
    out_json = tmp_path / "curve.json"
    grid = tmp_path / "grid.png"
    assert eval_cli.main([str(data), "--weights", STUDENT, "--size", "32",
                          "--batch", "2", "--hints", "0,2,5", "--fidelity",
                          "--out", str(out_json), "--save-grid", str(grid),
                          "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "hints=  5" in printed and "AUC" in printed
    res = json.loads(out_json.read_text())
    assert set(res) == {"size", "n_images", "weights", "psnr_by_hints",
                        "auc_db", "auc_spread", "psnr_per_image_by_hints",
                        "fidelity"}
    assert res["n_images"] == 3 and set(res["psnr_by_hints"]) == {"0", "2",
                                                                  "5"}
    assert "radius_r50_px" in res["fidelity"]
    sheet = imageio.decode_image(grid.read_bytes())
    assert sheet.shape == (3 * 32, 4 * 32, 3)
