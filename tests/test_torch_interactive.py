"""The port's InteractiveSession against the JAX package's, on the CPU: the
scripts of tests/test_interactive.py through both, on a seeded image, with
the bundled width-0.25 student at Xd=64. Counters must be identical; frames
within 1 LSB on < 1e-3 of the pixels (the session test's bar is 1%; measured
here: at most 4.1e-4)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ideepcolor_tpu import api as japi
from ideepcolor_tpu.engine.interactive import \
    InteractiveSession as JaxSession
from ideepcolor_tpu.ops import resize as jresize
from ideepcolor_tpu_torch.api import (ColorizeImageTorch,
                                      ColorizeImageTorchDist)
from ideepcolor_tpu_torch.engine.interactive import InteractiveSession
from ideepcolor_tpu_torch.ops.hints import MAX_HINTS
from ideepcolor_tpu_torch.ops.resize import linear_resize_matrix_np

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDENT = os.path.join(ROOT, "weights", "student_w025.npz")
XD = 64


def _image(seed, H, W):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / max(H, W)
    base = np.stack([np.sin(6 * yy + c) * np.cos(5 * xx - 2 * c)
                     for c in range(3)], -1)
    return np.clip(127.5 + 100 * base + rng.normal(0, 12, (H, W, 3)),
                   0, 255).astype(np.uint8)


def _table(*hints):
    """hints: (y1, x1, y2, x2, a, b) tuples -> (boxes, vals, n)."""
    boxes = np.zeros((MAX_HINTS, 4), np.int32)
    vals = np.zeros((MAX_HINTS, 2), np.float32)
    for i, (y1, x1, y2, x2, a, b) in enumerate(hints):
        boxes[i] = [y1, x1, y2, x2]
        vals[i] = [a, b]
    return boxes, vals, len(hints)


def _close(got, want):
    d = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    assert d.max() <= 1 and np.mean(d.max(-1) != 0) < 1e-3


def _models():
    jm = japi.ColorizeImageJax(Xd=XD)
    jm.prep_net(path=STUDENT)
    tm = ColorizeImageTorch(Xd=XD, device="cpu")
    tm.prep_net(path=STUDENT)
    for m in (jm, tm):
        m.load_image_array(_image(3, 150, 97))
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _models()


def test_latest_matches_sync_path_and_jax(models):
    jm, tm = models
    t1 = _table((10, 10, 14, 14, 40.0, -30.0))
    t2 = _table((10, 10, 14, 14, 40.0, -30.0), (40, 40, 44, 44, -20.0, 55.0))
    out = []
    for cls, m in ((JaxSession, jm), (InteractiveSession, tm)):
        sess = cls(m)
        sess.submit(*t1)
        seq = sess.submit(*t2)
        got_seq, frame = sess.latest()
        assert got_seq == seq == 2
        out.append((frame, sess.frames_submitted, sess.frames_materialized,
                    sess.frames_dropped, sess.pending))
    assert out[0][1:] == out[1][1:] == (2, 1, 1, 0)
    _close(out[1][0], out[0][0])
    # the port's own synchronous click gives the same frame exactly
    assert np.array_equal(out[1][0], tm.net_forward_table(*t2))


def test_drop_accounting_is_identical():
    jm, tm = _models()
    trace = []
    for cls, m in ((JaxSession, jm), (InteractiveSession, tm)):
        sess = cls(m, depth=2)
        log = []
        for i in range(5):
            sess.submit(*_table((i, i, i + 3, i + 3, 10.0, 10.0)))
            log.append((sess.pending, sess.frames_dropped))
        _, frame = sess.latest()
        assert frame is not None
        log.append((sess.pending, sess.frames_materialized,
                    sess.frames_dropped))
        seq, none = sess.latest()                 # empty queue
        assert none is None and seq == sess.frames_submitted == 5
        log.append((sess.pending, sess.frames_materialized,
                    sess.frames_dropped))
        trace.append((log, frame))
    assert trace[0][0] == trace[1][0]
    assert trace[1][0][4] == (2, 3) and trace[1][0][5] == (0, 1, 4)
    _close(trace[1][1], trace[0][1])


def test_state_consistent_after_latest(models):
    jm, tm = models
    t = _table((20, 20, 25, 25, 60.0, 20.0))
    frames = []
    for cls, m in ((JaxSession, jm), (InteractiveSession, tm)):
        sess = cls(m)
        sess.submit(*t)
        _, frame = sess.latest()
        assert m.input_mask.sum() == 6 * 6
        assert np.allclose(m.input_ab[:, 22, 22], [60.0, 20.0])
        # the net-size display frame doubles as output_rgb
        np.testing.assert_array_equal(m.get_img_forward(), frame)
        full = m.get_img_fullres()
        assert full.shape == m.img_rgb_fullres.shape == (150, 97, 3)
        frames.append((frame, full, m.input_ab.copy(), m.input_mask.copy(),
                       np.asarray(m.output_ab).copy()))
    _close(frames[1][0], frames[0][0])
    _close(frames[1][1], frames[0][1])
    # the mirrors come from the plain rasterizer on the host table
    assert np.array_equal(frames[1][2], frames[0][2])
    assert np.array_equal(frames[1][3], frames[0][3])
    same = (frames[1][0] == frames[0][0]).all(-1)
    assert np.abs(frames[1][4] - frames[0][4]).max(0)[same].max() <= 1e-3


def test_window_frame_variant(models):
    """The window frame composed in the same dispatch; JAX pads the window
    to its 128 bucket, the port takes the exact 100x120."""
    jm, tm = models
    t = _table((5, 5, 9, 9, -40.0, 40.0))
    l_win = np.random.default_rng(2).uniform(
        0, 100, (100, 120, 1)).astype(np.float32)
    l_pad = np.zeros((128, 128, 1), np.float32)
    l_pad[:100, :120] = l_win
    js = JaxSession(jm)
    js.submit(*t, win_args=(
        jnp.asarray(l_pad),
        jnp.asarray(jresize.linear_resize_matrix_np(XD, 100, 128)),
        jnp.asarray(jresize.linear_resize_matrix_np(XD, 120, 128))))
    _, jwin = js.latest()
    ts = InteractiveSession(tm)
    ts.submit(*t, win_args=(l_win, linear_resize_matrix_np(XD, 100),
                            linear_resize_matrix_np(XD, 120)))
    _, win = ts.latest()
    assert win.shape == (100, 120, 3) and win.dtype == np.uint8
    _close(win, jwin[:100, :120])
    # the net-size frame stays on the device and materializes lazily to
    # the pixels the synchronous program gives
    assert isinstance(tm._dev_output_rgb, torch.Tensor)
    np.testing.assert_array_equal(tm.output_rgb, tm.net_forward_table(*t))
    _close(tm.output_rgb, jm.output_rgb)


def test_flush_drops_everything(models):
    for cls, m in zip((JaxSession, InteractiveSession), models):
        sess = cls(m)
        sess.submit(*_table((1, 1, 3, 3, 5.0, 5.0)))
        sess.submit(*_table((1, 1, 3, 3, 5.0, 5.0)))
        sess.flush()
        assert sess.pending == 0 and sess.frames_dropped == 2
        seq, frame = sess.latest()
        assert frame is None and seq == 2


def test_empty_table_and_depth_floor(models):
    """A table without live hints materializes (its mirrors are all zero);
    depth below 1 is 1."""
    _, tm = models
    sess = InteractiveSession(tm, depth=0)
    assert sess.depth == 1
    sess.submit(*_table())
    sess.submit(*_table())
    assert sess.pending == 1 and sess.frames_dropped == 1
    _, frame = sess.latest()
    assert frame.shape == (XD, XD, 3)
    assert tm.input_mask.sum() == 0 and not tm.input_ab.any()


def test_rejects_backend_without_table_program_or_state():
    d = ColorizeImageTorchDist(Xd=XD, device="cpu")
    d.prep_net(path=STUDENT)
    with pytest.raises(ValueError):
        InteractiveSession(d)
    m = ColorizeImageTorch(Xd=XD, device="cpu")
    m.prep_net(path=STUDENT)
    with pytest.raises(RuntimeError):             # no image yet
        InteractiveSession(m).submit(*_table())
