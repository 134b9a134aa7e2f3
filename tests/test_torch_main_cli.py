"""The port's front door ``python -m ideepcolor_tpu_torch`` (mirroring
tests/test_main_cli.py), its fidelity runner, and the GUI launcher
``apps/ideepcolor.py`` without a display, on the CPU."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from ideepcolor_tpu_torch import __main__ as umain
from ideepcolor_tpu_torch import __version__
from ideepcolor_tpu_torch.apps import fidelity
from ideepcolor_tpu_torch.apps import ideepcolor as launcher
from ideepcolor_tpu_torch.utils.imageio import encode_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDENT = os.path.join(ROOT, "weights", "student_w025.npz")


def test_help_and_version(capsys):
    assert umain.main([]) == 0
    out = capsys.readouterr().out
    for cmd in ("gui", "serve", "train", "eval", "video", "demos",
                "fidelity"):
        assert f"  {cmd}" in out
    assert __version__ == "0.1.0" and __version__ in out
    assert umain.main(["--help"]) == 0
    capsys.readouterr()
    assert umain.main(["--version"]) == 0
    out = capsys.readouterr().out.strip()
    assert out == f"ideepcolor-tpu-torch {__version__}"


def test_unknown_command(capsys):
    assert umain.main(["frobnicate"]) == 2
    assert "frobnicate" in capsys.readouterr().err


def test_commands_are_the_jax_front_doors():
    from ideepcolor_tpu import __main__ as jmain
    assert list(umain._COMMANDS) == list(jmain._COMMANDS)
    for name, (module, _) in umain._COMMANDS.items():
        assert module == jmain._COMMANDS[name][0].replace(
            "ideepcolor_tpu.", "ideepcolor_tpu_torch.")


def test_module_runs_as_a_program():
    r = subprocess.run([sys.executable, "-m", "ideepcolor_tpu_torch",
                        "--help"], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and "fidelity" in r.stdout


def test_dispatches_to_eval(tmp_path):
    """A real dispatch through the front door: the eval app runs a tiny
    sweep end to end on the CPU (2 PNG images, 2 hint counts)."""
    rng = np.random.default_rng(0)
    for i in range(2):
        (tmp_path / f"im{i}.png").write_bytes(encode_png(
            (rng.random((40, 40, 3)) * 255).astype(np.uint8)))
    assert umain.main(["eval", str(tmp_path), "--weights", STUDENT,
                       "--size", "32", "--batch", "2", "--hints", "0,2",
                       "--device", "cpu"]) == 0


def test_fidelity_lists_artifacts_whose_targets_exist(capsys):
    """--list names every artifact; each target is a test of the port's
    suite that exists. The golden-frame artifacts have no counterpart."""
    assert umain.main(["fidelity", "--list"]) == 0
    out = capsys.readouterr().out
    from ideepcolor_tpu.apps import fidelity as jfid
    names = [a[0] for a in fidelity.ARTIFACTS]
    assert names == [a[0] for a in jfid.ARTIFACTS
                     if not a[0].startswith("goldens")]
    for name, target, _ in fidelity.ARTIFACTS:
        assert name in out
        path, test = target.split("::")
        assert os.path.basename(path).startswith("test_torch_")
        with open(os.path.join(ROOT, path)) as f:
            assert re.search(rf"^def {test}\(", f.read(), re.M), target


class _R:
    def __init__(self, rc, stdout):
        self.returncode = rc
        self.stdout = stdout
        self.stderr = ""


def test_fidelity_reports_pass_fail_and_skip(monkeypatch, capsys):
    """One line per artifact; nonzero exit iff one failed; exit 5 (nothing
    collected) is a FAIL; a target whose every test skipped is SKIP with
    pytest's reason, and alone exits 0."""
    calls = []
    replies = {
        "test_main_session_matches_jax": _R(0, "3 passed in 1.0s"),
        "test_loader_takes_both_layouts_and_pth": _R(1, "1 failed in 0.1s"),
        "test_dist_session_matches_jax": _R(5, "no tests ran in 0.01s"),
        "test_demos_run_on_arrays": _R(
            0, "s\nSKIPPED [1] tests/test_torch_caffe_api.py:327: no "
               "weights here\n1 skipped in 0.1s"),
    }

    def fake_run(cmd, **kw):
        calls.append(cmd)
        assert "-rs" in cmd and kw["cwd"] == ROOT
        return replies[cmd[3].split("::")[1]]

    monkeypatch.setattr(subprocess, "run", fake_run)
    rc = fidelity.main(["--only", "caffemodel-main-256,pth-modern,"
                        "caffemodel-dist-256,notebooks"])
    out = capsys.readouterr().out
    assert rc == 1 and len(calls) == 4
    assert "PASS  caffemodel-main-256" in out
    assert "FAIL  pth-modern" in out
    assert "FAIL  caffemodel-dist-256" in out
    assert "SKIP  notebooks" in out and "no weights here" in out
    assert "2 FAILED" in out

    calls.clear()
    assert fidelity.main(["--only", "notebooks"]) == 0
    out = capsys.readouterr().out
    assert "SKIP  notebooks" in out and "ALL PASS" in out
    assert fidelity.main(["--only", "caffemodel-main-256"]) == 0


def test_launcher_flags_and_cpu_models(capsys):
    """The reference launcher's flags; --cpu_mode builds the models on the
    CPU, --gpu N names cuda:N; the default dtype is bfloat16."""
    args = launcher.parse_args([])
    assert (args.win_size, args.load_size, args.backend, args.dtype,
            args.gpu, args.cpu_mode) == (512, 256, "siggraph", "bfloat16",
                                         0, False)
    from ideepcolor_tpu.apps import ideepcolor as jlauncher
    assert vars(args) == vars(jlauncher.parse_args([]))
    args = launcher.parse_args(["--cpu_mode", "--color_model", STUDENT,
                                "--load_size", "32", "--dtype", "float32"])
    color, dist = launcher.build_models(args)
    assert color.device.type == dist.device.type == "cpu"
    assert type(color).__name__ == "ColorizeImageTorch"
    assert type(dist).__name__ == "ColorizeImageTorchDist"
    assert color.Xd == 32 and color.net_set and dist.net_set
    args = launcher.parse_args(["--cpu_mode", "--backend", "caffe",
                                "--no_dist", "--load_size", "32"])
    color, dist = launcher.build_models(args)
    assert type(color).__name__ == "ColorizeImageTorchCaffe"
    assert dist is None
    args = launcher.parse_args(["--gpu", "3", "--color_model", STUDENT])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.build_models(args)


def test_launcher_without_pyqt5_returns_1(monkeypatch, capsys):
    for name in ("PyQt5", "PyQt5.QtWidgets"):
        monkeypatch.setitem(sys.modules, name, None)
    rc = launcher.main(["--cpu_mode", "--color_model", STUDENT,
                        "--load_size", "32", "--no_dist"])
    assert rc == 1
    assert "PyQt5 is not installed" in capsys.readouterr().out
