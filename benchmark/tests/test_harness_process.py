"""The command as a process: without a card it exits with another code
than 0 and prints no result; without the program (a directory holding
only BENCHMARK.json and the benchmark) it does too; a run loads nothing
of JAX or the JAX package, by whole top-level names."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import SMALL
from harness import device as devrec
from harness.spec import ROOT


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_no_card_exits_nonzero_without_a_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run(["benchmark/run.py", "--workload", "siggraph.click", "--seed",
              "1", "--seconds", "1", "--trace", "0"], ROOT, env)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_benchmark_alone_fails_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, 'benchmark');"
            "from harness import runner;"
            "runner.run('siggraph.click', 1, 1, False, device='cpu')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _run(["-c", code], tmp_path, env)
    assert p.returncode != 0
    assert "ideepcolor_tpu_torch" in p.stderr


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("ideepcolor_tpu_torch_x", "ideepcolor_tpu_torch.api",
                 "jaxtyping_like"):
        monkeypatch.setitem(sys.modules, name, sys)
        assert name not in devrec.forbidden_modules()
    for name in ("ideepcolor_tpu.api", "ideepcolor_tpu", "jax.numpy",
                 "jaxlib", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, sys)
        assert name in devrec.forbidden_modules()


def test_a_run_loads_no_jax():
    ov = json.dumps(SMALL["siggraph.click"])
    code = ("import sys, json; sys.path[:0] = ['benchmark', '.'];"
            "from harness import runner, device;"
            f"r = runner.run('siggraph.click', 5, 1, False, device='cpu',"
            f" overrides=json.loads({ov!r}));"
            "print(json.dumps([r['correct'], device.forbidden_modules(),"
            " 'ideepcolor_tpu_torch' in sys.modules]))")
    p = _run(["-c", code], ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    correct, bad, port = json.loads(p.stdout.strip().splitlines()[-1])
    assert correct and bad == [] and port


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_command_on_the_card(card, cell):
    p = _run(["benchmark/run.py", "--workload", cell, "--seed",
              str(2 ** 31 + 5), "--seconds", "5", "--trace", "0"], ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "check"
