"""The port's spans (``utils.profiling.annotate``): which spans a click and a
batch open under a profiler and how they nest, that an untraced process
opens none, the stage timer's span, the graph program's copy and capture
spans, and ``device_op_summary``'s union of device time and its refusal of
a card trace without device events."""

import collections
import json
import os
import weakref

import numpy as np
import pytest
import torch

from ideepcolor_tpu_torch.api.colorize import (
    ColorizeImageTorch, ColorizeImageTorchCaffeDist,
    ColorizeImageTorchCaffeGlobDist)
from ideepcolor_tpu_torch.engine import batch as tb
from ideepcolor_tpu_torch.engine import graphs
from ideepcolor_tpu_torch.models import global_stats
from ideepcolor_tpu_torch.models.siggraph import (SIGGRAPHGenerator,
                                                  init_state_dict)
from ideepcolor_tpu_torch.utils import profiling as tprof

XD = 32


def _image(h=40, w=30, seed=0):
    return (np.random.default_rng(seed).random((h, w, 3)) * 255).astype(
        np.uint8)


def _table(n=3):
    boxes = np.array([[2 + 4 * i, 3, 4 + 4 * i, 6] for i in range(n)],
                     np.int32)
    values = np.array([[20.0 - 10 * i, 5.0 * i] for i in range(n)],
                      np.float32)
    return boxes, values, n


def _spans(tmp_path, fn):
    """The user spans that ``fn`` opens under a device_trace: (name, start,
    end) in the trace's order."""
    with tprof.device_trace(str(tmp_path)):
        fn()
    with open(tmp_path / tprof.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _check_nested(spans, root, want):
    """Exactly ``want`` (a name -> count dict) and each span inside the
    one ``root`` span."""
    assert collections.Counter(n for n, _s, _e in spans) == want
    (r0, r1), = [(s, e) for n, s, e in spans if n == root]
    for n, s, e in spans:
        assert r0 <= s <= e <= r1, (n, s, e, r0, r1)


def test_table_click_spans(tmp_path):
    m = ColorizeImageTorch(Xd=XD, device="cpu")
    m.prep_net(width=0.25)
    m.load_image_array(_image())
    m.net_forward_table(*_table())                  # untraced warm call
    spans = _spans(tmp_path, lambda: m.net_forward_table(*_table()))
    _check_nested(spans, "click", {"click": 1, "click.hints": 1,
                                   "click.upload": 1, "click.readback": 1})


def test_caffe_dist_dense_click_spans(tmp_path):
    m = ColorizeImageTorchCaffeDist(Xd=XD, device="cpu")
    m.prep_net()
    m.load_image_array(_image())
    ab = np.zeros((2, XD, XD), np.float32)
    mask = np.zeros((1, XD, XD), np.float32)
    ab[:, 4:8, 5:9] = [[[30.0]], [[-20.0]]]
    mask[:, 4:8, 5:9] = 1.0
    spans = _spans(tmp_path, lambda: m.net_forward(ab, mask))
    # on the CPU the click program is a plain function: no graph copies
    _check_nested(spans, "click", {"click": 1, "click.hints": 1,
                                   "click.upload": 1, "click.readback": 1})


def _global_click():
    """A global-hints model on the CPU, its zero hint planes and the (313,)
    histogram of another image."""
    m = ColorizeImageTorchCaffeGlobDist(Xd=XD, device="cpu")
    m.prep_net()
    m.load_image_array(_image())
    ref = torch.from_numpy(_image(XD, XD, seed=1)).to(torch.float32) / 255.0
    hist = global_stats.extract(ref)["glob_ab_313"].numpy()
    return (m, np.zeros((2, XD, XD), np.float32),
            np.zeros((1, XD, XD), np.float32), hist)


def test_caffe_global_click_spans(tmp_path, monkeypatch):
    m, ab, mask, hist = _global_click()
    glob_array = m._glob_array

    def probed(glob_dist):
        with tprof.annotate("probe.glob"):
            return glob_array(glob_dist)

    monkeypatch.setattr(m, "_glob_array", probed)
    spans = _spans(tmp_path, lambda: m.net_forward(ab, mask, hist))
    # the hint planes and the histogram blob each go up under click.upload
    _check_nested(spans, "click", {"click": 1, "click.hints": 1,
                                   "click.upload": 2, "click.readback": 1,
                                   "probe.glob": 1})
    (p0, p1), = [(s, e) for n, s, e in spans if n == "probe.glob"]
    assert any(n == "click.upload" and s <= p0 <= p1 <= e
               for n, s, e in spans)


def test_global_stats_span(tmp_path):
    rgb = torch.from_numpy(_image(XD, XD)).to(torch.float32) / 255.0
    spans = _spans(tmp_path, lambda: global_stats.extract(rgb))
    _check_nested(spans, "glob.stats", {"glob.stats": 1})


def test_untraced_global_click_and_stats_open_no_span(monkeypatch):
    m, ab, mask, hist = _global_click()

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called untraced")

    monkeypatch.setattr(tprof, "record_function", refuse)
    assert tprof.annotate("glob.stats") is tprof.annotate("click")
    rgb = torch.from_numpy(_image(XD, XD)).to(torch.float32) / 255.0
    assert global_stats.extract(rgb)["glob_ab_313"].shape == (313,)
    assert m.net_forward(ab, mask, hist).shape == (XD, XD, 3)


def test_batch_spans(tmp_path):
    net = SIGGRAPHGenerator.from_state_dict(init_state_dict(0.25))
    net.requires_grad_(False)
    n, s = 2, 32
    imgs = np.stack([_image(s, s, i) for i in range(n)])
    boxes = np.zeros((n, 4, 4), np.int32)
    values = np.zeros((n, 4, 2), np.float32)
    boxes[:, 0] = [3, 3, 6, 6]
    values[:, 0] = [25.0, -15.0]
    counts = np.array([1, 0], np.int32)
    spans = _spans(tmp_path, lambda: tb.colorize_batch_table(
        net, imgs, boxes, values, counts, device="cpu"))
    # the images, then the tables: the L plane is prepared between them
    _check_nested(spans, "batch", {"batch": 1, "batch.upload": 2,
                                   "batch.readback": 1})
    spans = _spans(tmp_path, lambda: tb.colorize_batch(
        net, imgs, device="cpu"))
    _check_nested(spans, "batch", {"batch": 1, "batch.upload": 1,
                                   "batch.readback": 1})


def test_untraced_annotate_is_one_shared_object(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called untraced")

    monkeypatch.setattr(tprof, "record_function", refuse)
    first = tprof.annotate("click")
    assert all(tprof.annotate(n) is first
               for n in ("click", "click.hints", "graph.copy", "batch"))
    with first as entered:
        assert entered is None

    @tprof.spanned("click")
    def f(x, *, y=1):
        """doc"""
        return x + y

    assert f(1, y=2) == 3 and f.__name__ == "f" and f.__doc__ == "doc"
    # a whole untraced click opens no span either
    m = ColorizeImageTorch(Xd=XD, device="cpu")
    m.prep_net(width=0.25)
    m.load_image_array(_image())
    assert m.net_forward_table(*_table()).shape == (XD, XD, 3)


def test_stage_timer_stage_is_a_span(tmp_path):
    st = tprof.StageTimer()

    def work():
        with st.stage("png"):
            torch.ones(4).sum()

    spans = _spans(tmp_path, work)
    assert [n for n, _s, _e in spans] == ["png"]
    with st.stage("png"):                       # untraced: timed only
        pass
    assert st.summary()["png"]["n"] == 2


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_graph_program_spans_one_copy_per_changed_argument(tmp_path):
    """A held capture (as ``_capture`` leaves it) replayed on the CPU: a
    changed or new tensor is copied under ``graph.copy``, the unchanged
    one and a fixed argument open no span."""
    prog = graphs.GraphProgram(lambda *a: a)
    same, fixed = torch.ones(3), graphs.Fixed(torch.zeros(2))
    fresh = [torch.full((3,), float(i)) for i in range(3)]
    args = (same, fresh[0], fixed)
    bufs = [same.clone(), torch.zeros(3), fixed.t]
    # as captured on ``same``; the second buffer holds nothing copied yet
    last = [(weakref.ref(same), same._version), (lambda: None, -1), None]
    key = (tuple(graphs._signature(a) for a in args), ())
    prog._cache[key] = graphs._Captured(_FakeGraph(), bufs, last,
                                        ("out",), [])
    prog(*args)
    assert torch.equal(bufs[1], fresh[0])
    spans = _spans(tmp_path, lambda: prog(same, fresh[1], fixed))
    assert [n for n, _s, _e in spans] == ["graph.copy"]
    assert torch.equal(bufs[1], fresh[1])
    spans = _spans(tmp_path, lambda: prog(same, fresh[1], fixed))
    assert spans == []                          # nothing changed
    same.add_(1.0)                              # modified in place
    spans = _spans(tmp_path, lambda: prog(same, fresh[2], fixed))
    assert [n for n, _s, _e in spans] == ["graph.copy", "graph.copy"]
    assert prog.replays == 4


def test_graph_program_capture_is_a_span(tmp_path):
    """The capture's span closes when the capture fails (a CPU tensor is
    refused before any CUDA call)."""
    prog = graphs.GraphProgram(lambda a: a)

    def call():
        with pytest.raises(ValueError, match="CUDA tensors"):
            prog(torch.ones(2))

    assert [n for n, _s, _e in _spans(tmp_path, call)] == ["graph.capture"]


def _write_trace(tmp_path, events):
    with open(os.path.join(tmp_path, tprof.TRACE_FILE), "w") as f:
        json.dump({"traceEvents": events}, f)


def _ev(cat, name, ts, dur, tid=7):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def test_device_op_summary_counts_overlapping_streams_once(tmp_path):
    _write_trace(tmp_path, [
        _ev("cuda_runtime", "cudaLaunchKernel", 0.0, 5.0, tid=1),
        _ev("kernel", "sm90_xmma_fprop_implicit_gemm", 0.0, 200.0, tid=7),
        _ev("kernel", "raster_batch_kernel", 100.0, 200.0, tid=8),
        _ev("kernel", "raster_batch_kernel", 250.0, 100.0, tid=9),
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 500.0, 100.0),
    ])
    out = tprof.device_op_summary(str(tmp_path), reps=2)
    # [0, 350] + [500, 600] us busy, over 2 reps
    assert out["total_ms_per_rep"] == pytest.approx(0.225)
    assert dict(out["top_ops"])["raster_batch_kernel"] == pytest.approx(0.125)
    assert out["groups"] == pytest.approx({"conv": 0.1, "other": 0.125,
                                           "copy": 0.05})


def test_device_op_summary_refuses_a_card_trace_without_device_events(
        tmp_path):
    _write_trace(tmp_path, [
        _ev("cpu_op", "aten::conv2d", 0.0, 300.0, tid=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 10.0, 5.0, tid=1),
    ])
    with pytest.raises(ValueError, match="no device events"):
        tprof.device_op_summary(str(tmp_path))
