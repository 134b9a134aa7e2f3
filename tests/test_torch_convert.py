"""The port's checkpoint converter (``ideepcolor_tpu_torch/apps/convert.py``)
against the JAX package's (``scripts/convert_checkpoint.py``, run
in-process), direction by direction, on the same inputs: a seeded w0.25
SIGGRAPH net (reference-style ``.pth`` with ``num_batches_tracked``), the
bundled ``weights/student_w025.npz``, a train state of the port's trainer
and seeded ``.caffemodel`` files of the three Caffe graphs.

Held: both converters' ``.npz`` load into the port as identical tensors;
both exports are the same tensors, load with ``strict=True`` into
``SIGGRAPHGenerator``, and a round trip through ``.npz`` gives the same
bytes; each refusal exits non-zero with one line that names the way out."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ideepcolor_tpu_torch.apps import convert
from ideepcolor_tpu_torch.apps.train import export_params
from ideepcolor_tpu_torch.models import caffe_net, caffemodel_io, siggraph
from ideepcolor_tpu_torch.train import step as tstep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "convert_checkpoint.py")
STUDENT = os.path.join(ROOT, "weights", "student_w025.npz")


def _jax_convert(args):
    spec = importlib.util.spec_from_file_location("jax_convert_cli", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(args) == 0


def _port_convert(args):
    assert convert.main(args) == 0


def _same_tensors(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


def _same_bytes(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].numpy().tobytes() == b[k].numpy().tobytes(), k


@pytest.fixture(scope="module")
def reference_pth(tmp_path_factory):
    """A reference-style state dict of a seeded w0.25 net: torch layout,
    ``num_batches_tracked`` included, as ``SIGGRAPHGenerator.state_dict()``
    saves it."""
    path = tmp_path_factory.mktemp("convert") / "pytorch.pth"
    torch.save(siggraph.SIGGRAPHGenerator.from_state_dict(
        siggraph.init_state_dict(0.25, seed=11)).state_dict(), path)
    return str(path)


def test_pth_to_npz_matches_jax(reference_pth, tmp_path):
    _port_convert([reference_pth, str(tmp_path / "port.npz")])
    _jax_convert([reference_pth, str(tmp_path / "jax.npz")])
    port = siggraph.load_state_dict_file(str(tmp_path / "port.npz"))
    _same_tensors(port, siggraph.load_state_dict_file(
        str(tmp_path / "jax.npz")))
    with np.load(tmp_path / "port.npz") as z:      # torch layout, no counts
        assert z["model1.0.weight"].shape[1] == 4
        assert not any("num_batches_tracked" in k for k in z.files)
    ref = torch.load(reference_pth, weights_only=True)
    _same_tensors(port, {k: ref[k] for k in port})


@pytest.mark.parametrize("variant", caffe_net.VARIANTS)
def test_caffemodel_to_npz_matches_jax(variant, tmp_path):
    sd = caffe_net.init_state_dict(variant, seed=5)
    src = str(tmp_path / "model.caffemodel")
    with open(src, "wb") as f:
        f.write(caffemodel_io.encode_caffemodel(
            caffemodel_io.layers_from_state_dict(sd)))
    _port_convert([src, str(tmp_path / "port.npz"), "--variant", variant])
    _jax_convert([src, str(tmp_path / "jax.npz"), "--variant", variant])
    port = caffe_net.load_state_dict_file(str(tmp_path / "port.npz"),
                                          variant)
    _same_tensors(port, caffe_net.load_state_dict_file(
        str(tmp_path / "jax.npz"), variant))
    _same_tensors(port, sd)
    caffe_net.CaffeColorNet.from_state_dict(port, variant)


def _exports_agree(src, tmp_path):
    """Both converters export ``src`` to .pth: the same tensors, loaded
    strictly; the port's round trip .pth -> .npz -> .pth is byte for byte
    the same. Returns the port's export."""
    _port_convert([src, str(tmp_path / "port.pth")])
    _jax_convert([src, str(tmp_path / "jax.pth")])
    port = torch.load(tmp_path / "port.pth", weights_only=True)
    _same_tensors(port, torch.load(tmp_path / "jax.pth", weights_only=True))
    net = siggraph.SIGGRAPHGenerator(
        tuple(int(port[f"model{i}.0.weight"].shape[0]) for i in (1, 2, 3, 4)))
    net.load_state_dict(port, strict=True)
    _port_convert([str(tmp_path / "port.pth"), str(tmp_path / "back.npz")])
    _port_convert([str(tmp_path / "back.npz"), str(tmp_path / "again.pth")])
    _same_bytes(port, torch.load(tmp_path / "again.pth", weights_only=True))
    return port


@pytest.mark.parametrize("layout", ["torch", "jax"])
def test_npz_to_pth_matches_jax(reference_pth, layout, tmp_path):
    src = str(tmp_path / f"{layout}.npz")
    (_port_convert if layout == "torch" else _jax_convert)(
        [reference_pth, src])
    port = _exports_agree(src, tmp_path)
    ref = torch.load(reference_pth, weights_only=True)
    _same_bytes(port, ref)


def test_bundled_student_exports_and_round_trips(tmp_path):
    """The student is stored in the JAX package's layout as f16: its round
    trip is the port's reading of it, in torch layout as f32."""
    port = _exports_agree(STUDENT, tmp_path)
    want = siggraph.load_state_dict_file(STUDENT)
    with np.load(tmp_path / "back.npz") as back:
        assert set(back.files) == {k for k in want
                                   if "num_batches_tracked" not in k}
        for k in back.files:
            assert back[k].tobytes() == want[k].numpy().tobytes(), k
    assert all(int(port[k]) == 0 for k in port if "num_batches_tracked" in k)


def test_train_state_exports_as_the_trainer_does(tmp_path):
    """A train state of the port's trainer -> .pth: its params, the same
    tensors as ``apps/train.py --export``."""
    cfg = tstep.TrainConfig()
    state = tstep.init_state(cfg, siggraph.init_state_dict(0.25, seed=3),
                             device="cpu")
    path = str(tmp_path / "CKPT_0.pt")
    tstep.save_train_state(path, state)
    _port_convert([path, str(tmp_path / "state.pth")])
    export_params(str(tmp_path / "trainer.pth"), state["params"])
    _same_bytes(torch.load(tmp_path / "state.pth", weights_only=True),
                torch.load(tmp_path / "trainer.pth", weights_only=True))
    _port_convert([path, str(tmp_path / "state.npz")])
    with np.load(tmp_path / "state.npz") as z:
        assert set(z.files) == set(state["params"])


def _caffe_npz(tmp_path):
    path = str(tmp_path / "caffe_main.npz")
    np.savez(path, **{k: v.numpy() for k, v in
                      caffe_net.init_state_dict("main", seed=2).items()})
    return path


@pytest.mark.parametrize("case", ["caffemodel_to_pth", "caffe_npz_to_pth",
                                  "orbax_dir", "unknown_input",
                                  "unknown_output", "pickled_module"])
def test_refusals_name_the_way_out(case, tmp_path):
    caffemodel = str(tmp_path / "m.caffemodel")
    with open(caffemodel, "wb") as f:
        f.write(caffemodel_io.encode_caffemodel({}))
    module = str(tmp_path / "module.pth")
    torch.save(torch.nn.Linear(2, 2), module)
    pth, npz = str(tmp_path / "x.pth"), str(tmp_path / "x.npz")
    args, way_out = {
        "caffemodel_to_pth": ([caffemodel, pth], ".npz"),
        "caffe_npz_to_pth": ([_caffe_npz(tmp_path), pth], ".npz"),
        "orbax_dir": ([str(tmp_path), npz], "save_params_npz"),
        "unknown_input": ([str(tmp_path / "w.bin"), npz], ".npz"),
        "unknown_output": ([STUDENT, str(tmp_path / "x.bin")], ".npz"),
        "pickled_module": ([module, npz], "state_dict()"),
    }[case]
    with pytest.raises(SystemExit) as e:
        convert.main(args)
    msg = e.value.code
    assert isinstance(msg, str) and "\n" not in msg and way_out in msg
    assert not os.path.exists(pth) and not os.path.exists(npz)


def test_command_line(tmp_path):
    """``python -m ...apps.convert``: a refusal exits 1 with its one line on
    stderr; a conversion exits 0."""
    cmd = [sys.executable, "-m", "ideepcolor_tpu_torch.apps.convert"]
    env = {**os.environ, "PYTHONPATH": ROOT}
    bad = subprocess.run(cmd + [STUDENT, str(tmp_path / "x.bin")],
                         capture_output=True, text=True, env=env, timeout=120)
    assert bad.returncode == 1
    assert bad.stderr.strip().startswith("unsupported output")
    assert len(bad.stderr.strip().splitlines()) == 1
    good = subprocess.run(cmd + [STUDENT, str(tmp_path / "s.pth")],
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert good.returncode == 0, good.stderr
    assert os.path.exists(tmp_path / "s.pth")
