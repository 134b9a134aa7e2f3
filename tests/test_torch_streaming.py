"""The port's streaming engine against the JAX package's, on the CPU: the
same numpy-seeded frames and hints and the same width-0.25 weights through
``ideepcolor_tpu.engine.streaming`` (at its ``default`` precision) and its
counterpart, at size 32. Frames are compared by ``frame_delta_stats``:
at most 1 LSB, at least 99.9% of the pixels equal (the JAX package's own
bound between two runs whose convs may differ in the last float bits;
measured here: identical). The map is held to 1e-5. Against the port's own
direct step the session must agree exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ideepcolor_tpu.engine import streaming as jst
from ideepcolor_tpu.models import siggraph as jsig
from ideepcolor_tpu_torch.engine import streaming as tst
from ideepcolor_tpu_torch.engine.batch import frame_delta_stats
from ideepcolor_tpu_torch.models.siggraph import (SIGGRAPHGenerator,
                                                  state_dict_from_params)
from ideepcolor_tpu_torch.ops.hints import MAX_HINTS

torch.set_num_threads(2)
S = 32


@pytest.fixture(scope="module")
def weights():
    params = jsig.init_params(jax.random.key(1), width=0.25)
    sd = state_dict_from_params({k: np.asarray(v) for k, v in params.items()})
    return params, sd


def _hints():
    ab = np.zeros((S, S, 2), np.float32)
    mask = np.zeros((S, S, 1), np.float32)
    ab[10:12, 10:12] = [30.0, -40.0]
    mask[10:12, 10:12] = 1.0
    return ab, mask


def _run(sess, frames, **kw):
    outs = []
    for f in frames:
        r = sess.submit(f, **kw)
        if r is not None:
            outs.append(r)
    outs.extend(sess.drain())
    return outs


def _held(got, want):
    max_lsb, equal = frame_delta_stats(got, want)
    assert max_lsb <= 1 and equal >= 0.999, (max_lsb, equal)


def test_session_pipelines_and_matches_jax_and_direct(weights):
    params, sd = weights
    rng = np.random.default_rng(11)
    frames = [rng.uniform(0, 100, (S, S)).astype(np.float32)
              for _ in range(5)]
    ab, mask = _hints()
    js = jst.StreamingSession(params, size=S, depth=2)
    ts = tst.StreamingSession(sd, size=S, depth=2, device="cpu")
    for s in (js, ts):
        s.set_hints(ab, mask)
    primed = [ts.submit(f) is not None for f in frames[:3]]
    assert primed == [False, False, True]         # depth 2: the third gives
    ts = tst.StreamingSession(sd, size=S, depth=2, device="cpu")
    ts.set_hints(ab, mask)
    jouts, touts = _run(js, frames), _run(ts, frames)
    assert len(touts) == 5 and ts.frames_in == ts.frames_out == 5
    for (jrgb, jdist), (rgb, dist) in zip(jouts, touts):
        assert rgb.shape == (S, S, 3) and rgb.dtype == np.uint8
        assert isinstance(dist, torch.Tensor)     # stays on the device
        assert tuple(dist.shape) == (S // 4, S // 4, 529)
        _held(rgb, jrgb)
        assert np.abs(dist.numpy() - np.asarray(jdist)).max() <= 1e-5
    # the direct, unpipelined step gives frame 0 exactly
    l = torch.from_numpy(frames[0])[None, ..., None]
    rgb_d, dist_d = tst._stream_step(
        ts.net, l, torch.from_numpy(ab)[None], torch.from_numpy(mask)[None])
    assert np.array_equal(touts[0][0], rgb_d.numpy())
    assert torch.equal(touts[0][1], dist_d)


def test_step_runs_at_default_precision_and_undoes_the_dist_rescale(weights):
    """The step asks the module for ``precision_name="default"``; with the
    dist head on, its frame is the one without it (reg2 / 110 undone)."""
    _, sd = weights
    net = SIGGRAPHGenerator.from_state_dict(sd).requires_grad_(False)
    seen = []
    net.model1[0].register_forward_hook(
        lambda *a: seen.append(torch.backends.cudnn.allow_tf32))
    ab, mask = _hints()
    l = torch.rand(1, S, S, 1) * 100
    args = (net, l, torch.from_numpy(ab)[None], torch.from_numpy(mask)[None])
    rgb, dist = tst._stream_step(*args, with_dist=True)
    rgb0, none = tst._stream_step(*args, with_dist=False)
    assert seen == [True, True] and none is None
    assert frame_delta_stats(rgb.numpy(), rgb0.numpy())[0] <= 1
    assert abs(float(dist.sum(-1).mean()) - 1) < 1e-5


def test_hint_swap_changes_output_like_jax(weights):
    params, sd = weights
    frame = np.random.default_rng(2).uniform(0, 100, (S, S)).astype(
        np.float32)
    outs = []
    for sess in (jst.StreamingSession(params, size=S, depth=1,
                                      with_dist=False),
                 tst.StreamingSession(sd, size=S, depth=1, with_dist=False,
                                      device="cpu")):
        sess.submit(frame)
        out1, d1 = sess.submit(frame)
        sess.set_hints(np.full((S, S, 2), 50.0, np.float32),
                       np.ones((S, S, 1), np.float32))
        sess.submit(frame)
        out2, _ = sess.submit(frame)
        assert d1 is None and not np.array_equal(out1, out2)
        outs.append((np.asarray(out1), np.asarray(out2)))
    _held(outs[1][0], outs[0][0])
    _held(outs[1][1], outs[0][1])


@pytest.mark.parametrize("srgb", [False, True])
def test_uint8_frames_match_jax_and_the_float_path(weights, srgb):
    """uint8 gray submission, linear and sRGB: against JAX, and in the port
    equal to the float path fed the same dequantized L."""
    params, sd = weights
    g = np.random.default_rng(21).integers(0, 256, (S, S), dtype=np.uint8)
    ab, mask = _hints()
    sessions = [jst.StreamingSession(params, size=S, depth=1,
                                     with_dist=False)] + [
        tst.StreamingSession(sd, size=S, depth=1, with_dist=False,
                             device="cpu") for _ in range(2)]
    for s in sessions:
        s.set_hints(ab, mask)
    sessions[0].submit(g, srgb=srgb)
    sessions[1].submit(g, srgb=srgb)
    l = (tst._l_srgb if srgb else tst._l_linear)(
        torch.from_numpy(g)[..., None])[..., 0].numpy()
    sessions[2].submit(l)
    (jrgb, _), = sessions[0].drain()
    (rgb8, _), = sessions[1].drain()
    (rgbf, _), = sessions[2].drain()
    assert rgb8.dtype == np.uint8
    assert np.array_equal(rgb8, rgbf)
    _held(rgb8, np.asarray(jrgb))


@pytest.mark.parametrize("with_dist", [True, False])
def test_hint_table_form_matches_jax_and_dense_hints(weights, with_dist):
    """set_hint_table: K1 (its plain version here) rasterizes each frame;
    equal to JAX's table step, and exactly the dense-hint session fed the
    rasterized planes."""
    params, sd = weights
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (S, S), dtype=np.uint8) for _ in range(3)]
    boxes = np.array([[3, 3, 8, 8], [10, 12, 20, 30], [18, 2, 22, 14]],
                     np.int32)
    values = np.array([[40, -30], [-20, 55], [10, 10]], np.float32)
    js = jst.StreamingSession(params, size=S, depth=1, with_dist=with_dist)
    ts = tst.StreamingSession(sd, size=S, depth=1, with_dist=with_dist,
                              device="cpu")
    for s in (js, ts):
        s.set_hint_table(boxes, values, 2)        # the third slot is dead
    jouts, touts = _run(js, frames, srgb=True), _run(ts, frames, srgb=True)
    for (jrgb, jd), (rgb, d) in zip(jouts, touts):
        _held(rgb, np.asarray(jrgb))
        assert (d is None) == (jd is None) == (not with_dist)
        if with_dist:
            assert np.abs(d.numpy() - np.asarray(jd)).max() <= 1e-5
    ab = np.zeros((S, S, 2), np.float32)
    mask = np.zeros((S, S, 1), np.float32)
    for (y1, x1, y2, x2), v in zip(boxes[:2], values[:2]):
        ab[y1:y2 + 1, x1:x2 + 1] = v
        mask[y1:y2 + 1, x1:x2 + 1] = 1
    dense = tst.StreamingSession(sd, size=S, depth=1, with_dist=with_dist,
                                 device="cpu")
    dense.set_hints(ab, mask)
    for (rgb, _), (want, _) in zip(touts, _run(dense, frames, srgb=True)):
        assert np.array_equal(rgb, want)


def test_table_rules_match_jax(weights):
    params, sd = weights
    for sess in (jst.StreamingSession(params, size=S, with_dist=False),
                 tst.StreamingSession(sd, size=S, with_dist=False,
                                      device="cpu")):
        with pytest.raises(ValueError, match="MAX_HINTS"):
            sess.set_hint_table(np.zeros((MAX_HINTS + 1, 4), np.int32),
                                np.zeros((MAX_HINTS + 1, 2), np.float32))
        sess.set_hint_table(np.zeros((1, 4), np.int32),
                            np.zeros((1, 2), np.float32))
        with pytest.raises(ValueError, match="uint8"):
            sess.submit(np.zeros((S, S), np.float32))
        sess.set_hints(*_hints())                 # dense hints lift it
        assert sess.submit(np.zeros((S, S), np.float32)) is None
        assert sess.depth == 4 and sess.frames_in == 1


def test_session_takes_the_module_or_a_state_dict_and_defaults_to_the_card(
        weights, monkeypatch):
    _, sd = weights
    net = SIGGRAPHGenerator.from_state_dict(sd)
    sess = tst.StreamingSession(net, size=S, device="cpu")
    assert sess.net is net and not any(
        p.requires_grad for p in net.parameters())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tst.StreamingSession(sd, size=S)
