"""The port's API end to end against the JAX API, on the CPU: a scripted
session through ColorizeImageJax and ColorizeImageTorch(device="cpu") on
the bundled width-0.25 student, plus sentinels, the device default and the
port's isolation from JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ideepcolor_tpu import api as japi
from ideepcolor_tpu_torch import device as tdevice
from ideepcolor_tpu_torch.api import ColorizeImageTorch
from ideepcolor_tpu_torch.ops.hints import points_json_to_table, put_point

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDENT = os.path.join(ROOT, "weights", "student_w025.npz")
XD = 64


def _image(seed, H, W):
    """A seeded smooth color field with noise: image-like, not flat."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / max(H, W)
    base = np.stack([np.sin(6 * yy + c) * np.cos(5 * xx - 2 * c)
                     for c in range(3)], -1)
    return np.clip(127.5 + 100 * base + rng.normal(0, 12, (H, W, 3)),
                   0, 255).astype(np.uint8)


def _hints(n, seed):
    rng = np.random.default_rng(seed)
    return [{"y": int(rng.integers(0, XD)), "x": int(rng.integers(0, XD)),
             "ab": rng.uniform(-80, 80, 2).tolist(),
             "radius": int(rng.integers(0, 4))} for _ in range(n)]


def _session(m, load):
    """load_image_array of a 150x97 image (or set_image of a net-sized
    one), table clicks with 0, 1 and 5 hints, a dense click, getters."""
    out = {}
    if load == "array":
        m.load_image_array(_image(3, 150, 97))
    else:
        m.set_image(_image(4, XD, XD))
    out["gray"] = m.get_img_gray()
    out["gray_fullres"] = m.get_img_gray_fullres()
    for n in (0, 1, 5):
        out[f"table{n}"] = m.net_forward_table(
            *points_json_to_table(_hints(n, n), XD))
        out[f"ab_table{n}"] = m.output_ab.copy()
    out["input_ab"], out["input_mask"] = m.input_ab, m.input_mask
    out["fullres_table"] = m.get_img_fullres()
    ab = np.zeros((2, XD, XD), np.float32)
    mask = np.zeros((1, XD, XD), np.float32)
    for h in _hints(7, 9):
        put_point(ab, mask, [max(h["y"], 3), max(h["x"], 3)], 3, h["ab"])
    out["dense"] = m.net_forward(ab, mask)
    out["ab_dense"] = m.output_ab.copy()
    for g in ("get_img_fullres", "get_img_mask", "get_img_mask_fullres",
              "get_sup_img", "get_sup_fullres", "get_input_img"):
        out[g] = getattr(m, g)()
    out["psnr"] = m.get_result_PSNR()
    return out


@pytest.mark.parametrize("load", ["array", "set"])
def test_session_matches_jax(load):
    """Frames: <= 1 LSB on < 1% of the pixels (measured: 1 LSB on at most
    0.041% of a frame's pixels, most frames identical). output_ab is the
    ab of the frame's own Lab, so it agrees to 1e-3 wherever the frame
    agrees (measured 9e-5) and moves by up to ~0.6 at a pixel whose frame
    byte flipped. The hint mirrors of the table click are K1's output and
    equal the JAX host rasterizer's exactly."""
    jm = japi.ColorizeImageJax(Xd=XD)
    jm.prep_net(path=STUDENT)
    tm = ColorizeImageTorch(Xd=XD, device="cpu")
    tm.prep_net(path=STUDENT)
    want, got = _session(jm, load), _session(tm, load)
    assert set(want) == set(got)
    frames = {}
    for k, w in want.items():
        w, g = np.asarray(w), np.asarray(got[k])
        assert g.shape == w.shape, k
        if w.dtype == np.uint8:
            d = np.abs(g.astype(int) - w.astype(int)).max(-1)
            assert d.max() <= 1 and np.mean(d != 0) < 0.01, k
            frames[k] = d
    assert np.array_equal(got["input_ab"], want["input_ab"])
    assert np.array_equal(got["input_mask"], want["input_mask"])
    for ab_key, frame_key in (("ab_table0", "table0"), ("ab_table1", "table1"),
                              ("ab_table5", "table5"), ("ab_dense", "dense")):
        same = frames[frame_key] == 0
        d = np.abs(got[ab_key] - want[ab_key]).max(0)
        assert d[same].max() <= 1e-3, ab_key
    assert abs(got["psnr"] - want["psnr"]) < 1e-2


def test_table_click_equals_dense_click():
    """The K1 table click and the dense click with the same hints give the
    same frame (the rasterized planes are the dense hints)."""
    m = ColorizeImageTorch(Xd=XD, device="cpu")
    m.prep_net(path=STUDENT)
    m.set_image(_image(5, XD, XD))
    table = m.net_forward_table(*points_json_to_table(_hints(6, 2), XD))
    ab, mask = m.input_ab.copy(), m.input_mask.copy()
    assert mask.sum() > 0
    assert np.array_equal(m.net_forward(ab, mask), table)


def test_sentinels_and_shape_errors_match_jax():
    for cls, kw in ((japi.ColorizeImageJax, {}),
                    (ColorizeImageTorch, {"device": "cpu"})):
        m = cls(Xd=XD, **kw)
        z_ab, z_mask = np.zeros((2, XD, XD)), np.zeros((1, XD, XD))
        table = points_json_to_table([], XD)
        assert m.net_forward(z_ab, z_mask) == -1            # no image
        assert m.net_forward_table(*table) == -1
        m.set_image(_image(6, XD, XD))
        assert m.net_forward(z_ab, z_mask) == -1            # no net
        assert m.net_forward_table(*table) == -1
        with pytest.raises(ValueError):
            m.set_image(_image(6, XD + 1, XD))
        m.prep_net(path=STUDENT)
        with pytest.raises(ValueError):
            m.net_forward(np.zeros((XD, XD, 2)), z_mask)    # channel-last
        with pytest.raises(ValueError):
            m.net_forward(z_ab, np.zeros((XD, XD)))
        assert m.net_forward(z_ab, z_mask).shape == (XD, XD, 3)


def test_load_image_decodes_file_like_load_image_array(tmp_path):
    cv2 = pytest.importorskip("cv2")
    im = _image(7, 80, 120)
    path = str(tmp_path / "im.png")
    cv2.imwrite(path, cv2.cvtColor(im, cv2.COLOR_RGB2BGR))
    a, b = (ColorizeImageTorch(Xd=XD, device="cpu") for _ in range(2))
    a.load_image(path)
    b.load_image_array(im)
    assert np.array_equal(a.img_rgb, b.img_rgb)
    assert np.array_equal(a.get_img_gray_fullres(), b.get_img_gray_fullres())


def _dense_hints():
    ab = np.zeros((2, XD, XD), np.float32)
    mask = np.zeros((1, XD, XD), np.float32)
    for h in _hints(5, 12):
        put_point(ab, mask, [max(h["y"], 3), max(h["x"], 3)], 3, h["ab"])
    return ab, mask


def test_fullres_getters_async_equal_sync_and_match_jax():
    """net_forward_fullres is net_forward then get_img_fullres; the async
    forms return a function that gives the same frame, byte for byte, and
    owns it: loading another image before calling it changes nothing.
    Against the JAX class: <= 1 LSB on < 1% of the pixels, the session
    test's bar."""
    jm = japi.ColorizeImageJax(Xd=XD)
    jm.prep_net(path=STUDENT)
    tm = ColorizeImageTorch(Xd=XD, device="cpu")
    tm.prep_net(path=STUDENT)
    ab, mask = _dense_hints()
    for m in (jm, tm):
        m.load_image_array(_image(3, 150, 97))
    want = jm.net_forward_fullres(ab, mask)
    got = tm.net_forward_fullres(ab, mask)
    assert got.shape == want.shape == (150, 97, 3) and got.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int)).max(-1)
    assert d.max() <= 1 and np.mean(d != 0) < 0.01
    tm.net_forward(ab, mask)
    assert np.array_equal(tm.get_img_fullres(), got)
    assert np.abs(tm.get_img_forward().astype(int)
                  - jm.get_img_forward().astype(int)).max() <= 1
    finish = tm.get_img_fullres_async()
    finish2 = tm.net_forward_fullres_async(ab, mask)
    tm.load_image_array(_image(8, 40, 60))       # the state moves on
    assert np.array_equal(finish(), got)
    assert np.array_equal(finish2(), got)


def test_async_getters_sentinels_match_jax():
    """-1 for an unset image or net, and for a dist backend, which has no
    dense click program (``_dispatch_click`` gives None)."""
    from ideepcolor_tpu_torch.api import ColorizeImageTorchDist
    ab, mask = _dense_hints()
    for cls, dcls, kw in (
            (japi.ColorizeImageJax, japi.ColorizeImageJaxDist, {}),
            (ColorizeImageTorch, ColorizeImageTorchDist, {"device": "cpu"})):
        m = cls(Xd=XD, **kw)
        assert m.net_forward_fullres(ab, mask) == -1
        assert m.net_forward_fullres_async(ab, mask) == -1
        m.set_image(_image(6, XD, XD))
        assert m.net_forward_fullres_async(ab, mask) == -1      # no net
        d = dcls(Xd=XD, **kw)
        d.prep_net(path=STUDENT)
        d.set_image(_image(6, XD, XD))
        assert d._dispatch_click() is None
        assert d.net_forward_fullres_async(ab, mask) == -1
        assert d.net_forward_fullres(ab, mask) == -1


def test_cpu_programs_are_plain_functions_and_reach_no_graph_code(
        monkeypatch):
    """On the CPU every program of the API is the plain function its
    factory wraps: no GraphProgram, no TableStage, no pinned memory, no
    CUDA call. A session runs with all of them made to raise."""
    from ideepcolor_tpu_torch.api import ColorizeImageTorchDist
    from ideepcolor_tpu_torch.engine import graphs

    def boom(*a, **k):
        raise AssertionError("graph code reached on the CPU")

    for name in ("GraphProgram", "TableStage"):
        monkeypatch.setattr(getattr(graphs, name), "__init__", boom)
    for name in ("CUDAGraph", "Stream", "Event", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, boom)
    m = ColorizeImageTorch(Xd=XD, device="cpu")
    m.prep_net(path=STUDENT)
    d = ColorizeImageTorchDist(Xd=XD, device="cpu")
    d.prep_net(path=STUDENT)
    for prog in (m._click, m._click_tbl, m._click_tbl_win,
                 m._click_tbl_win_suggest, d._predict_tbl,
                 d.ensure_suggest_program(3, 1000)):
        assert not isinstance(prog, graphs.GraphProgram)
        assert callable(prog) and not hasattr(prog, "replays")
    assert graphs.program(len, "cpu") is len and graphs.program(len) is len
    im = _image(5, XD, XD)
    m.set_image(im)
    d.set_image(im)
    table = points_json_to_table(_hints(4, 3), XD)
    assert d.predict_dist_table(*table) == 0
    assert m.net_forward_table(*table).shape == (XD, XD, 3)
    rh = np.eye(XD, dtype=np.float32)
    out = m.net_forward_table_win_suggest(
        *table, np.full((XD, XD, 1), 50, np.float32), rh, rh, d, 10, 20,
        K=3, N=1000)
    assert out[0].shape == (XD, XD, 3) and out[1].shape == (4, 3)
    assert d.suggest_table(*table, 10, 20, K=3, N=1000)[0].shape == (3, 3)
    assert m.net_forward_fullres(*_dense_hints()).shape == (XD, XD, 3)
    assert m._stage is None and d._stage is None


def test_table_stage_packing_and_program_signatures():
    """What surrounds a captured program, in Python the CPU reaches: the
    staging buffer's layout (boxes, values, then count and pixel; a short
    table padded with dead slots over stale bytes; the count clamped to the
    table's rows), and the signature a graph is keyed by."""
    from ideepcolor_tpu_torch.engine import graphs
    slots = 8
    row = np.full(slots * 24 + 16, 0xAB, np.uint8)         # stale bytes
    boxes = np.arange(12, dtype=np.int32).reshape(3, 4)
    values = np.linspace(-5, 5, 6, dtype=np.float32).reshape(3, 2)
    graphs.pack_table(row, slots, boxes, values, 7, 11, 13)
    got_b = row[:slots * 16].view(np.int32).reshape(slots, 4)
    got_v = row[slots * 16:slots * 24].view(np.float32).reshape(slots, 2)
    assert np.array_equal(got_b[:3], boxes) and not got_b[3:].any()
    assert np.array_equal(got_v[:3], values) and not got_v[3:].any()
    assert row[slots * 24:].view(np.int32).tolist() == [3, 11, 13, 0]
    graphs.pack_table(row, slots, boxes, values, -2)
    assert row[slots * 24:].view(np.int32).tolist() == [0, 0, 0, 0]
    with pytest.raises(ValueError, match="at most 8"):
        graphs.pack_table(row, slots, np.zeros((9, 4)), np.zeros((9, 2)), 1)
    with pytest.raises(ValueError):
        graphs.pack_table(row, slots, boxes, values[:2], 1)
    t = torch.zeros(2, 3)
    gen = torch.Generator()
    assert graphs._signature(t) == ((2, 3), torch.float32)
    assert graphs._signature(graphs.Fixed(t))[:2] == ("fixed", t.data_ptr())
    assert graphs._signature(gen) == ("generator", id(gen))
    with pytest.raises(TypeError, match="by keyword"):
        graphs._signature(3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        graphs.GraphProgram(lambda x: x)(t)


def test_suggest_program_cache_is_bounded_fifo():
    """The JAX class's bound: at most 8 suggest programs, the oldest goes
    first; out-of-range K and N raise ValueError before anything is made."""
    from ideepcolor_tpu_torch.api import ColorizeImageTorchDist
    d = ColorizeImageTorchDist(Xd=XD, device="cpu")
    d.prep_net(path=STUDENT)
    jd = japi.ColorizeImageJaxDist
    assert (d._SUGGEST_CACHE_MAX, d.MAX_SUGGEST_K, d.MAX_SUGGEST_N) == (
        jd._SUGGEST_CACHE_MAX, jd.MAX_SUGGEST_K, jd.MAX_SUGGEST_N)
    first = d.ensure_suggest_program(1, 1000)
    assert d.ensure_suggest_program(1, 1000) is first
    for k in range(2, 10):
        d.ensure_suggest_program(k, 1000)
    assert len(d._suggest_tbl_cache) == 8
    assert (1, 1000) not in d._suggest_tbl_cache
    assert list(d._suggest_tbl_cache)[0] == (2, 1000)
    for K, N in ((0, 1000), (26, 1000), (5, 999), (5, 100_001)):
        with pytest.raises(ValueError):
            d.ensure_suggest_program(K, N)


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a usable CUDA device, an entry point that did not ask for
    the CPU raises instead of running there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ColorizeImageTorch(Xd=XD)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdevice.resolve_device("cuda")
    assert ColorizeImageTorch(Xd=XD, device="cpu").device.type == "cpu"


def test_port_imports_nothing_of_jax():
    """A fresh interpreter imports ideepcolor_tpu_torch and every module in
    it (the Qt GUI under the fake Qt of tests/_fake_qt.py, which imports
    nothing else); no jax* and no ideepcolor_tpu.* module may enter
    sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.path.insert(0, 'tests')\n"
        "import _fake_qt\n"
        "_fake_qt.install()\n"
        "import ideepcolor_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'ideepcolor_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] == 'jax' or "
        "k.startswith(('jaxlib', 'ideepcolor_tpu.')) or "
        "k == 'ideepcolor_tpu')\n"
        "assert len(names) >= 49, names\n"
        "new = {'data.color_bins', 'data.lab_gamut', 'ops.quantize', "
        "'ops.kmeans', 'ops.gamut', 'engine.graphs', 'engine.interactive', "
        "'engine.streaming', 'engine.batch', 'config', 'apps.serve', "
        "'apps.webui', 'utils', 'utils.imageio', 'utils.ndarray', "
        "'utils.profiling', 'utils.session', 'utils.soakload', "
        "'utils.visualize', 'train', 'train.losses', 'train.hints_sim', "
        "'train.data', 'train.device_data', 'train.step', 'train.distill', "
        "'apps.train', 'apps.eval', 'ui', 'ui.control', 'ui.qt_gui', "
        "'apps.ideepcolor', 'apps.video', 'apps.fidelity', '__main__', "
        "'ops.host'}\n"
        "assert {'ideepcolor_tpu_torch.' + n for n in new} <= set(names)\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


@pytest.mark.parametrize("load", ["array", "set"])
def test_lab_mirrors_match_jax(load):
    """The base class's lazy numpy mirrors, the mean-centered ones and
    ``img_ab_fullres`` included, against the JAX values; ``_set_img_l_`` is
    the alias of ``_set_img_lab_mc_`` and clears the centered mirror."""
    mirrors = {}
    for name, m in (("jax", japi.ColorizeImageJax(Xd=XD)),
                    ("port", ColorizeImageTorch(Xd=XD, device="cpu"))):
        if load == "array":
            m.load_image_array(_image(3, 150, 97))
        else:
            m.set_image(_image(4, XD, XD))
        mirrors[name] = {k: np.asarray(getattr(m, k)) for k in (
            "img_lab_fullres", "img_l_fullres", "img_ab_fullres", "img_lab",
            "img_l", "img_ab", "img_lab_mc", "img_l_mc", "img_ab_mc")}
        assert type(m)._set_img_l_ is type(m)._set_img_lab_mc_
        first = m.img_lab_mc
        m._set_img_l_()
        assert m.img_lab_mc is not first
        assert np.array_equal(m.img_lab_mc, first)
    want, got = mirrors["jax"], mirrors["port"]
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert np.abs(got[k] - w).max() <= 1e-4, k
    full = got["img_lab_fullres"]
    assert np.array_equal(got["img_ab_fullres"], full[1:])
    assert np.array_equal(got["img_lab_mc"][0], got["img_lab"][0] - 50.0)
    assert np.array_equal(got["img_ab_mc"], got["img_lab"][1:])


def test_checkpoint_forms_refused_with_a_way_out(tmp_path):
    """Two forms the JAX loader takes and the port refuses (ROADMAP Queue
    3, accepted): an orbax directory (ValueError naming the npz export) and
    a pickled module (torch.load with weights_only=True)."""
    import pickle
    from ideepcolor_tpu_torch.models import siggraph
    orbax_dir = tmp_path / "ckpt"
    orbax_dir.mkdir()
    with pytest.raises(ValueError, match="save_params_npz"):
        siggraph.load_state_dict_file(str(orbax_dir))
    m = ColorizeImageTorch(Xd=XD, device="cpu")
    with pytest.raises(ValueError, match="orbax"):
        m.prep_net(path=str(orbax_dir))
    net = siggraph.SIGGRAPHGenerator.from_state_dict(
        siggraph.load_state_dict_file(STUDENT))
    pth = str(tmp_path / "module.pth")
    torch.save(net, pth)
    with pytest.raises(pickle.UnpicklingError):
        siggraph.load_state_dict_file(pth)
    torch.save(net.state_dict(), pth)         # the state dict loads
    sd = siggraph.load_state_dict_file(pth)
    assert all(torch.equal(sd[k], v) for k, v in net.state_dict().items())


@pytest.mark.parametrize("raises", [False, True], ids=["ok", "raises"])
def test_capture_holds_the_garbage_collector(monkeypatch, raises):
    """A collection inside a capture may free another graph, a call the
    capture does not permit: the collector is off from ``capture_begin`` to
    ``capture_end`` (not in the warm-up), and as it was afterwards, also
    when the captured function raises."""
    import contextlib
    import gc

    from ideepcolor_tpu_torch.engine import graphs

    seen = []

    class FakeGraph:
        def capture_begin(self, **kw):
            seen.append(("begin", gc.isenabled()))

        def capture_end(self):
            seen.append(("end", gc.isenabled()))

    class FakeStream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream", FakeStream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    was = gc.isenabled()
    calls = []

    def fn():
        calls.append(gc.isenabled())
        if raises and len(calls) > graphs._WARMUP:
            raise ValueError("in the capture")
        return torch.zeros(1)

    prog = graphs.GraphProgram(fn)
    if raises:
        with pytest.raises(ValueError, match="in the capture"):
            prog.prepare()
    else:
        prog.prepare()
        assert prog.captures == 1
    assert calls == [was] * graphs._WARMUP + [False]
    assert seen == [("begin", False), ("end", False)]
    assert gc.isenabled() == was
