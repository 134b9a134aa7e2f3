"""The port's native host runtime (ideepcolor_tpu_torch/ops/host.py and
native/hostops.cpp) against the JAX package's (ideepcolor_tpu/ops/host.py),
on the same numpy-seeded inputs.

Native against native: the two C++ sources differ only in their comments
and are built with the same g++ flags, so every entry point gives the same
bytes (the JAX library is built here from its own source into a temporary
directory, never into its package). Numpy forms against numpy forms (the
native library switched off on both sides): equal. Native against the
numpy forms: within the bounds of tests/test_host_native.py (Lab 1e-3,
RGB 1e-4, uint8 1 LSB, zoom 2e-3 on |ab| <= 110, bilinear 1e-4); the hint
rasterizer exactly, and exactly K1's plain version.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from ideepcolor_tpu.ops import host as jhost
from ideepcolor_tpu_torch.ops import hints as thints
from ideepcolor_tpu_torch.ops import host
from ideepcolor_tpu_torch.ops.resize import (cubic_resize_matrix_np,
                                             linear_resize_matrix_np)

from _jax_host import use_jax_native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's host module with its library built from its own
    source (the JAX flags) into a temporary directory; restored after."""
    mp = pytest.MonkeyPatch()
    use_jax_native(mp, tmp_path_factory.mktemp("jax_hostops"))
    assert host.available()
    yield jhost
    mp.undo()


@pytest.fixture
def numpy_forms(monkeypatch):
    """Both packages with the native library switched off."""
    monkeypatch.setattr(jhost, "get_lib", lambda: None)
    monkeypatch.setattr(host, "get_lib", lambda: None)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    S, H, W = 48, 70, 53
    boxes = np.zeros((256, 4), np.int32)
    values = np.zeros((256, 2), np.float32)
    for i in range(40):
        y, x = rng.integers(-6, S + 6, 2)
        r = rng.integers(0, 5)
        boxes[i] = [y - r, x - r, y + r, x + r]     # some past the edges
        values[i] = rng.uniform(-110, 110, 2)
    return {
        "rgb": rng.random((37, 29, 3)).astype(np.float32),
        "rgb_u8": rng.integers(0, 256, (37, 29, 3)).astype(np.uint8),
        "lab": np.stack([rng.uniform(0, 100, (31, 23)),
                         rng.uniform(-110, 110, (31, 23)),
                         rng.uniform(-110, 110, (31, 23))],
                        -1).astype(np.float32),
        "boxes": boxes, "values": values, "S": S,
        "a": rng.uniform(-110, 110, (S, S)).astype(np.float32),
        "b": rng.uniform(-110, 110, (S, S)).astype(np.float32),
        "rh": cubic_resize_matrix_np(S, H), "rw": cubic_resize_matrix_np(S, W),
        "x": rng.random((20, 17, 2)).astype(np.float32),
    }


# each entry point as a function of a host module and the inputs
ENTRY_POINTS = {
    "rgb2lab_f32": lambda h, d: h.rgb2lab(d["rgb"]),
    "rgb2lab_u8f": lambda h, d: h.rgb2lab_u8(d["rgb_u8"]),
    "lab2rgb_f32": lambda h, d: h.lab2rgb(d["lab"]),
    "lab2rgb_u8": lambda h, d: h.lab2rgb_u8(d["lab"]),
    "lab2rgb_u8_planar": lambda h, d: h.lab2rgb_u8_planar(
        d["lab"][..., 0], d["lab"][..., 1], d["lab"][..., 2]),
    "rgb2lab_u8_ab_planar": lambda h, d: h.rgb2lab_u8_ab(d["rgb_u8"]),
    "rasterize_hints": lambda h, d: h.rasterize_hints(
        d["boxes"], d["values"], 40, d["S"]),
    "zoom_bilinear_f32": lambda h, d: h.zoom_bilinear(d["x"], (63, 41)),
    "zoom2_banded_f32": lambda h, d: h.zoom2_matrices(
        d["a"], d["b"], d["rh"], d["rw"]),
}


def _as_list(out):
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS) + ["num_threads"])
def test_native_entry_points_byte_equal_jax(jax_native, name):
    """Each of the ten exported symbols, port library against JAX's, on
    the same inputs: the same bytes."""
    if name == "num_threads":
        assert host.get_lib().num_threads() == \
            jax_native.get_lib().num_threads() >= 1
        return
    d = _inputs()
    for got, want in zip(_as_list(ENTRY_POINTS[name](host, d)),
                         _as_list(ENTRY_POINTS[name](jax_native, d))):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), name


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS)
                         + ["_np_rgb2lab", "_np_lab2rgb"])
def test_numpy_forms_equal_jax(numpy_forms, name):
    """With the native library off on both sides, each public function's
    numpy form and the two numpy converters equal JAX's."""
    d = _inputs(1)
    if name.startswith("_np"):
        arg = d["rgb"] if name == "_np_rgb2lab" else d["lab"]
        pairs = [(getattr(host, name)(arg), getattr(jhost, name)(arg))]
    else:
        if name == "rasterize_hints":
            # JAX's numpy form wraps negative box ends around; keep the
            # boxes inside the frame for the comparison
            d["boxes"] = np.clip(d["boxes"], 0, d["S"] - 1)
        pairs = zip(_as_list(ENTRY_POINTS[name](host, d)),
                    _as_list(ENTRY_POINTS[name](jhost, d)))
    for got, want in pairs:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,bound", [
    ("rgb2lab_f32", 1e-3), ("rgb2lab_u8f", 1e-3), ("lab2rgb_f32", 1e-4),
    ("lab2rgb_u8", 1), ("lab2rgb_u8_planar", 1), ("rgb2lab_u8_ab_planar",
                                                   1e-3),
    ("rasterize_hints", 0), ("zoom_bilinear_f32", 1e-4),
    ("zoom2_banded_f32", 2e-3)])
def test_native_against_numpy_forms(name, bound, monkeypatch):
    """The port's native library against its own numpy forms, within the
    bounds of tests/test_host_native.py; the rasterizer exactly, boxes past
    the edges included."""
    d = _inputs(2)
    native = _as_list(ENTRY_POINTS[name](host, d))
    monkeypatch.setattr(host, "get_lib", lambda: None)
    plain = _as_list(ENTRY_POINTS[name](host, d))
    for got, want in zip(native, plain):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.abs(got.astype(np.float64)
                      - want.astype(np.float64)).max() <= bound


@pytest.mark.parametrize("count", [0, 1, 10, 200, 256, 300, -3])
def test_rasterizer_equals_k1_plain(count):
    """host.rasterize_hints against the port's plain K1 on the same table:
    bit-exact, with boxes across the edges and counts past both ends
    (clamped to [0, M] on both)."""
    rng = np.random.default_rng(count + 5)
    S = 64
    boxes = np.zeros((256, 4), np.int32)
    values = rng.uniform(-110, 110, (256, 2)).astype(np.float32)
    c = rng.integers(-4, S + 4, (256, 2))
    r = rng.integers(0, 6, (256, 1))
    boxes[:] = np.concatenate([c - r, c + r], 1)
    ab, mask = host.rasterize_hints(boxes, values, count, S)
    n = min(max(count, 0), 256)
    want_ab, want_mask = thints.rasterize_hints(
        torch.from_numpy(boxes), torch.from_numpy(values), n, S)
    np.testing.assert_array_equal(ab, want_ab.numpy())
    np.testing.assert_array_equal(mask, want_mask.numpy())


def test_library_builds_into_build_dir_by_hash():
    """The library lies under build/hostops of the checkout, named by a hash
    of the source, the flags and the compiler's target; never in the
    package."""
    lib = host.get_lib()
    path = host.library_path("g++")
    assert lib is not None and path.exists()
    assert path.parent == host.BUILD_DIR
    assert host.BUILD_DIR == __import__("pathlib").Path(ROOT) / "build" / \
        "hostops"
    assert path.name.startswith("libhostops-") and len(path.stem) == 27
    assert not list((host.SRC.parent).glob("*.so"))
    assert lib.num_threads() >= 1


def test_concurrent_builds_each_load_a_whole_library(tmp_path):
    """Two processes that build into one empty directory at the same moment
    both load the library (each writes a temporary file and renames it), and
    no temporary file is left."""
    build = tmp_path / "build"
    go = tmp_path / "go"
    script = textwrap.dedent(f"""
        import os, sys, time
        from pathlib import Path
        sys.path.insert(0, {ROOT!r})
        from ideepcolor_tpu_torch.ops import host
        host.BUILD_DIR = Path({str(build)!r})
        while not os.path.exists({str(go)!r}):
            time.sleep(0.005)
        lib = host.get_lib()
        import numpy as np
        out = host.rgb2lab(np.full((4, 3), 0.5, np.float32))
        print(lib.num_threads() >= 1, round(float(out[0, 0]), 3))
    """)
    procs = [subprocess.Popen([sys.executable, "-c", script],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    go.touch()
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == ["True", "53.389"], out
    assert [f.suffix for f in build.iterdir()] == [".so"]


def test_without_gpp_the_numpy_forms_run(monkeypatch):
    """No g++ on the machine: get_lib is None, available() says so, and the
    functions run their numpy forms."""
    monkeypatch.setattr(host, "_lib", None)
    monkeypatch.setattr(host, "_checked", False)
    monkeypatch.setattr(host.shutil, "which", lambda name: None)
    assert host.get_lib() is None and not host.available()
    rgb = np.random.default_rng(3).random((5, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(host.rgb2lab(rgb), host._np_rgb2lab(rgb))


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    """g++ present but the build fails: get_lib raises with the compiler's
    message and does not drop to numpy."""
    bad = tmp_path / "hostops.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(host, "_lib", None)
    monkeypatch.setattr(host, "_checked", False)
    monkeypatch.setattr(host, "SRC", bad)
    monkeypatch.setattr(host, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="error"):
        host.get_lib()
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_zoom2_refuses_mismatched_shapes():
    a = np.zeros((8, 8), np.float32)
    with pytest.raises(ValueError):
        host.zoom2_matrices(a, a, linear_resize_matrix_np(9, 16),
                            linear_resize_matrix_np(8, 16))
