"""K5, the suggestion chain's kernel, on the CPU: the rule by which
``ops.kmeans.ab_recommendations`` takes it, the wiring of its result and
draws, and the binding's refusals before it builds or launches anything.

The kernel itself is held to the plain chain on the card
(``tests/test_torch_card_kmeans_kernel.py``, marked ``card``). On the CPU
the chain runs as it did, and the JAX-agreement tests of
``tests/test_torch_kmeans.py`` hold it.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ideepcolor_tpu_torch.engine import pipeline as tP
from ideepcolor_tpu_torch.ops import kmeans as tkm
from ideepcolor_tpu_torch.ops.cuda import build
from ideepcolor_tpu_torch.ops.cuda import kmeans_kernel as k5

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Meta:
    """What the rule reads of a tensor: its device, dtype and shape."""

    def __init__(self, shape, dtype=torch.float32, device="cuda:0"):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = torch.device(device)

    def dim(self):
        return len(self.shape)


class _OnCuda:
    """A CPU tensor that reports a CUDA device: what a wrapper sees when it
    is handed a card tensor."""

    device = torch.device("cuda", 0)

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


# (pdf (Q,) dtype and device, points (P, 2) dtype and device, K) -> K5?
# The dtype does not decide: the chain takes both as float32 either way.
CASES = [
    ((529, torch.float32, "cuda:0"), (529, torch.float32, "cuda:0"), 9, True),
    ((313, torch.float32, "cuda:0"), (313, torch.float32, "cuda:0"), 9, True),
    ((529, torch.float32, "cuda:0"), (529, torch.float32, "cuda:0"), 1, True),
    ((529, torch.float32, "cuda:0"), (529, torch.float32, "cuda:0"), 32,
     True),
    ((768, torch.float32, "cuda:0"), (768, torch.float32, "cuda:0"), 9, True),
    ((529, torch.float32, "cuda:0"), (529, torch.float32, "cuda:0"), 33,
     False),
    ((529, torch.float32, "cuda:0"), (529, torch.float32, "cuda:0"), 0,
     False),
    ((769, torch.float32, "cuda:0"), (769, torch.float32, "cuda:0"), 9,
     False),
    ((529, torch.float32, "cuda:0"), (313, torch.float32, "cuda:0"), 9,
     False),
    ((529, torch.float64, "cuda:0"), (529, torch.float32, "cuda:0"), 9,
     True),
    ((529, torch.bfloat16, "cuda:0"), (529, torch.float32, "cuda:0"), 9,
     True),
    ((529, torch.float32, "cuda:0"), (529, torch.float64, "cuda:0"), 9,
     True),
    ((529, torch.float32, "cuda:0"), (529, torch.float32, "cpu"), 9, False),
    ((529, torch.float32, "cuda:0"), (529, torch.float32, "cuda:1"), 9,
     False),
    ((529, torch.float32, "cpu"), (529, torch.float32, "cpu"), 9, False),
    ((313, torch.float32, "cpu"), (313, torch.float32, "cpu"), 5, False),
]


@pytest.mark.parametrize("pdf,pts,K,want", CASES)
def test_k5_engages_by_device_dtype_palette_and_table(pdf, pts, K, want):
    (Q, pdf_dtype, pdf_dev), (P, pts_dtype, pts_dev) = pdf, pts
    assert k5.engages(_Meta((Q,), pdf_dtype, pdf_dev),
                      _Meta((P, 2), pts_dtype, pts_dev), K) is want


@pytest.mark.parametrize("pdf_shape,pts_shape", [((529, 1), (529, 2)),
                                                 ((529,), (529, 3)),
                                                 ((529,), (529,)),
                                                 ((0,), (0, 2))])
def test_k5_engages_only_a_pdf_vector_and_a_table_of_ab_pairs(pdf_shape,
                                                               pts_shape):
    assert not k5.engages(_Meta(pdf_shape), _Meta(pts_shape), 9)


def _pdf(Q=313, seed=4):
    rng = np.random.default_rng(seed)
    p = rng.random(Q).astype(np.float32) ** 8 + 1e-6
    return torch.from_numpy(p / p.sum())


def _pts():
    from ideepcolor_tpu_torch.data.color_bins import get_bins
    return torch.as_tensor(get_bins().pts_in_hull, dtype=torch.float32)


@pytest.mark.parametrize("K", [1, 9])
def test_cpu_chain_never_asks_for_k5(monkeypatch, K):
    """On the CPU the plain chain runs: its answer is its cores' on the
    numbers it drew, and K5 is neither built nor launched."""
    def refuse(*_a, **_k):
        raise AssertionError("K5 asked for on the CPU")

    monkeypatch.setattr(k5, "suggest", refuse)
    monkeypatch.setattr(k5.KERNEL, "load", refuse)
    before = k5.KERNEL.launches
    gen = torch.Generator().manual_seed(3)
    c, conf, u_bins, u_seeds = tkm.ab_recommendations(
        _pdf(), _pts(), gen, K=K, N=4000, return_draws=True)
    want_c, want_conf = tkm.kmeans_from_uniform(
        _pts(), tkm.bins_from_uniform(_pdf(), u_bins), u_seeds)
    assert torch.equal(c, want_c) and torch.equal(conf, want_conf)
    assert k5.KERNEL.launches == before


def test_where_k5_engages_the_chain_is_one_call_on_the_same_draws(
        monkeypatch):
    """Where the rule holds, ``ab_recommendations`` draws as before (the
    sampler's N numbers, then the seeding's (RESTARTS, K), from the one
    generator), hands both to K5 with the pdf and table, and splits the
    (K, 3) rows into centers and confidences."""
    K, N = 5, 3000
    seen = {}

    def fake(pdf, points, u_bins, u_seeds, iters=30):
        seen.update(pdf=pdf, points=points, u_bins=u_bins, u_seeds=u_seeds,
                    iters=iters)
        c, f = tkm.kmeans_from_uniform(
            points, tkm.bins_from_uniform(pdf, u_bins), u_seeds, iters)
        return torch.cat([c, f[:, None]], 1)

    monkeypatch.setattr(k5, "engages", lambda pdf, points, K: True)
    monkeypatch.setattr(k5, "suggest", fake)
    pdf, pts = _pdf(), _pts()
    c, conf, u_bins, u_seeds = tkm.ab_recommendations(
        pdf, pts, torch.Generator().manual_seed(9), K=K, N=N, iters=12,
        return_draws=True)
    gen = torch.Generator().manual_seed(9)
    assert torch.equal(u_bins, torch.rand(N, generator=gen))
    assert torch.equal(u_seeds, torch.rand((tkm.RESTARTS, K), generator=gen))
    assert seen["pdf"] is pdf and seen["points"] is pts
    assert seen["u_bins"] is u_bins and seen["u_seeds"] is u_seeds
    assert seen["iters"] == 12
    want_c, want_conf = tkm.kmeans_from_uniform(
        pts, tkm.bins_from_uniform(pdf, u_bins), u_seeds, 12)
    assert torch.equal(c, want_c) and torch.equal(conf, want_conf)


@pytest.mark.parametrize("pdf_dtype,pts_dtype", [
    (torch.bfloat16, torch.float32), (torch.float64, torch.float64),
    (torch.float16, torch.bfloat16)])
def test_k5_takes_the_pdf_and_table_as_float32_like_the_chain(
        monkeypatch, pdf_dtype, pts_dtype):
    """A pdf or table of another dtype (a bf16 session's map) goes to K5
    as the float32 values the plain chain computes with, so the answer is
    the chain's on the same draws."""
    seen = {}

    def fake(pdf, points, u_bins, u_seeds, iters=30):
        seen.update(pdf=pdf, points=points)
        c, f = tkm.kmeans_from_uniform(
            points, tkm.bins_from_uniform(pdf, u_bins), u_seeds, iters)
        return torch.cat([c, f[:, None]], 1)

    monkeypatch.setattr(k5, "engages", lambda pdf, points, K: True)
    monkeypatch.setattr(k5, "suggest", fake)
    pdf, pts = _pdf().to(pdf_dtype), _pts().to(pts_dtype)
    c, conf, u_bins, u_seeds = tkm.ab_recommendations(
        pdf, pts, torch.Generator().manual_seed(5), K=6, N=3000,
        return_draws=True)
    assert seen["pdf"].dtype == seen["points"].dtype == torch.float32
    assert torch.equal(seen["pdf"], pdf.to(torch.float32))
    assert torch.equal(seen["points"], pts.to(torch.float32))
    want_c, want_conf = tkm.kmeans_from_uniform(
        pts, tkm.bins_from_uniform(pdf, u_bins), u_seeds)
    assert torch.equal(c, want_c) and torch.equal(conf, want_conf)


def test_the_binding_imports_and_registers_without_nvcc():
    """Importing the port needs no CUDA toolkit: a fresh interpreter with
    no nvcc on its path imports the chain and the binding, K5 is one of the
    kernels ``build_all`` builds, and nothing is loaded."""
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME="",
               CUDA_PATH="")
    code = ("import shutil\n"
            "from ideepcolor_tpu_torch.ops import kmeans\n"
            "from ideepcolor_tpu_torch.ops.cuda import build\n"
            "k = kmeans.k5.KERNEL\n"
            "assert shutil.which('nvcc') is None\n"
            "assert k in build.KERNELS and k._fn is None\n"
            "assert k.source == 'kmeans_kernel.cu'\n"
            "assert (build.CSRC / k.source).exists()\n"
            "print(k.library_path().name)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("kmeans_kernel-")


def test_k5_raises_on_cuda_without_the_kernel(monkeypatch):
    """On a CUDA tensor the binding launches or raises; without a toolkit
    to build the kernel it raises, and counts no launch."""
    monkeypatch.setattr(build, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("no nvcc")))
    monkeypatch.setattr(k5.KERNEL, "_fn", None)
    monkeypatch.setattr(k5.KERNEL, "library_path",
                        lambda: build.BUILD_DIR / "missing.so")
    before = k5.KERNEL.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        k5.suggest(_OnCuda(_pdf()), _OnCuda(_pts()),
                   _OnCuda(torch.rand(100)), _OnCuda(torch.rand(4, 9)))
    assert k5.KERNEL.launches == before


@pytest.mark.parametrize("case", ["cpu", "K33", "restarts3", "u_f64",
                                  "u_2d", "iters", "table", "pdf_bf16"])
def test_k5_refuses_before_it_builds(monkeypatch, case):
    """What the kernel does not take is refused before any build."""
    def refuse(*_a, **_k):
        raise AssertionError("built or launched")

    monkeypatch.setattr(k5.KERNEL, "load", refuse)
    cuda = _OnCuda
    pdf, pts = cuda(_pdf()), cuda(_pts())
    u_bins, u_seeds, iters = cuda(torch.rand(100)), cuda(torch.rand(4, 9)), 30
    if case == "cpu":
        pdf, pts = _pdf(), _pts()
    elif case == "K33":
        u_seeds = cuda(torch.rand(4, 33))
    elif case == "restarts3":
        u_seeds = cuda(torch.rand(3, 9))
    elif case == "u_f64":
        u_bins = cuda(torch.rand(100, dtype=torch.float64))
    elif case == "u_2d":
        u_bins = cuda(torch.rand(10, 10))
    elif case == "iters":
        iters = -1
    elif case == "pdf_bf16":
        pdf = cuda(_pdf().to(torch.bfloat16))
    else:
        pts = cuda(_pts()[:300])
    with pytest.raises(ValueError, match="kmeans"):
        k5.suggest(pdf, pts, u_bins, u_seeds, iters)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("hw", [(0, 0), (3, 5), (6, 4), (6, 7)])
def test_pixel_at_gathers_with_index_tensors_of_either_type(dtype, hw):
    """A captured program's pixel arrives as one-element index tensors:
    the gather is ``t[h, w]`` for int32 (the stage's) and int64 alike."""
    t = torch.arange(7 * 8 * 3, dtype=torch.float32).reshape(7, 8, 3)
    h, w = hw
    got = tP.pixel_at(t, torch.tensor([h], dtype=dtype),
                      torch.tensor([w], dtype=dtype))
    assert torch.equal(got, t[h, w])
    zero_d = tP.pixel_at(t, torch.tensor(h, dtype=dtype),
                         torch.tensor(w, dtype=dtype))
    assert torch.equal(zero_d, t[h, w])
