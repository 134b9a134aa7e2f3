"""The port's video app (ideepcolor_tpu_torch/apps/video.py) against the
JAX one, on the CPU: ``run`` of both over one seeded PNG frame directory and
one weights file (the width-0.25 student at --size 32), with and without
static hints and with tracked hints (OpenCV's Farneback flow in both);
then the runs that need OpenCV, with ``cv2`` made unimportable.

Output frames are held to the port's f32 frame bound, <= 1 LSB on < 1e-3 of
the pixels (both streaming steps at their ``default`` precision; measured
identical). The gray frames the port decodes and resizes without OpenCV
equal cv2's byte for byte.
"""

import json
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from ideepcolor_tpu.apps import video as jvideo
from ideepcolor_tpu_torch.apps import video as tvideo
from ideepcolor_tpu_torch.utils.imageio import encode_png, read_image

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDENT = os.path.join(ROOT, "weights", "student_w025.npz")
SIZE = 32


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A directory of 6 seeded 48x64 PNG frames in which a bright square
    slides right over a noisy background, and a hints file."""
    d = tmp_path_factory.mktemp("clip")
    frames = d / "frames"
    frames.mkdir()
    rng = np.random.default_rng(17)
    for i in range(6):
        img = (rng.random((48, 64, 3)) * 120).astype(np.uint8)
        img[10:22, 8 + 5 * i:20 + 5 * i] = (230, 200, 40)
        (frames / f"f{i:03d}.png").write_bytes(encode_png(img))
    (frames / "notes.txt").write_text("not a frame")
    hints = d / "hints.json"
    hints.write_text(json.dumps(
        [{"y": 8, "x": 9, "ab": [40.0, -50.0], "radius": 2},
         {"y": 24, "x": 20, "ab": [-20.0, 30.0], "radius": 1}]))
    return str(frames), str(hints)


def _outputs(out):
    names = sorted(os.listdir(out))
    return [cv2.cvtColor(cv2.imread(os.path.join(out, n)), cv2.COLOR_BGR2RGB)
            for n in names]


def _frames_agree(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape == (SIZE, SIZE, 3)
        d = np.abs(g.astype(int) - w.astype(int)).max(-1)
        assert d.max() <= 1 and np.mean(d != 0) < 1e-3


def _run_both(tmp_path, frames, extra, tag):
    outs = []
    for mod, dev in ((jvideo, []), (tvideo, ["--device", "cpu"])):
        out = str(tmp_path / f"{tag}_{mod.__name__.split('.')[0]}")
        rc = mod.main([frames, "--out", out, "--size", str(SIZE),
                       "--weights", STUDENT, "--depth", "2"] + extra + dev)
        assert rc == 0
        outs.append(_outputs(out))
    return outs


def test_gray_frames_equal_cv2s(clip):
    """The port's frame source (its codec, its RGB2GRAY) and its net-size
    resize give JAX's cv2 frames byte for byte; a file that is no image is
    skipped by both."""
    from ideepcolor_tpu_torch.ops.resize import resize_u8_half_pixel
    frames, _ = clip
    got = list(tvideo._frame_source(frames))
    want = list(jvideo._frame_source(frames))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            resize_u8_half_pixel(torch.from_numpy(g)[..., None],
                                 (SIZE, SIZE))[..., 0].numpy(),
            cv2.resize(w, (SIZE, SIZE)))


@pytest.mark.parametrize("with_hints", [False, True])
def test_run_matches_jax(clip, tmp_path, with_hints):
    frames, hints = clip
    extra = ["--hints", hints] if with_hints else []
    jax_frames, port_frames = _run_both(tmp_path, frames, extra, "static")
    _frames_agree(port_frames, jax_frames)


def test_tracked_hints_match_jax(clip, tmp_path):
    """--track-hints with OpenCV's flow: the trackers give equal tables at
    every frame, the hints move with the square, and the runs' frames
    agree."""
    frames, hints = clip
    pts = json.load(open(hints))
    jt, tt = jvideo.HintTracker(pts, SIZE), tvideo.HintTracker(pts, SIZE)
    for g in jvideo._frame_source(frames):
        g = cv2.resize(g, (SIZE, SIZE))
        for a, b in zip(tt.step(g), jt.step(g)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tt.hints[0]["x"] > pts[0]["x"] + 3       # moved with the square
    jax_frames, port_frames = _run_both(
        tmp_path, frames, ["--hints", hints, "--track-hints"], "tracked")
    _frames_agree(port_frames, jax_frames)


def test_translation_flow_drives_the_tracked_path(clip, tmp_path):
    """run(args, flow=...) takes another flow function (no OpenCV needed):
    a field of +1 px in x per frame moves every hint by one pixel a frame,
    and the run writes every frame."""
    frames, hints = clip
    seen = []

    def shift(prev, cur):
        seen.append(cur.shape)
        f = np.zeros(cur.shape + (2,), np.float32)
        f[..., 0] = 1.0
        return f

    args = tvideo.parse_args([frames, "--out", str(tmp_path / "o"),
                              "--size", str(SIZE), "--weights", STUDENT,
                              "--hints", hints, "--track-hints",
                              "--device", "cpu"])
    assert tvideo.run(args, flow=shift) == 0
    assert seen == [(SIZE, SIZE)] * 5
    tr = tvideo.HintTracker(json.load(open(hints)), SIZE, flow=shift)
    for _ in range(6):
        tr.step(np.zeros((SIZE, SIZE), np.uint8))
    assert [h["x"] for h in tr.hints] == [14, 25]
    assert len(os.listdir(tmp_path / "o")) == 6


def test_runs_that_need_opencv_exit_2_without_it(clip, tmp_path,
                                                 monkeypatch, capsys):
    """Without cv2: --track-hints (with hints) and a video file exit 2
    naming the package, before any output is made; an .avi output falls
    back to a PNG directory of the same stem, printed; a frame directory
    runs."""
    frames, hints = clip
    monkeypatch.setitem(sys.modules, "cv2", None)
    common = ["--size", str(SIZE), "--weights", STUDENT, "--device", "cpu"]
    out = str(tmp_path / "tracked")
    assert tvideo.main([frames, "--out", out, "--hints", hints,
                        "--track-hints"] + common) == 2
    assert "cv2" in capsys.readouterr().err and not os.path.exists(out)
    movie = tmp_path / "clip.mp4"
    movie.write_bytes(b"\x00" * 64)
    assert tvideo.main([str(movie), "--out", out] + common) == 2
    assert "video file" in capsys.readouterr().err
    assert not os.path.exists(out)
    avi = str(tmp_path / "o.avi")
    assert tvideo.main([frames, "--out", avi, "--limit", "4"] + common) == 0
    assert "o/" in capsys.readouterr().out
    assert not os.path.exists(avi)
    names = sorted(os.listdir(tmp_path / "o"))
    assert names == [f"frame_{i:06d}.png" for i in range(4)]
    frame = read_image(str(tmp_path / "o" / names[0]))
    assert frame.shape == (SIZE, SIZE, 3)


def test_avi_output_with_opencv(clip, tmp_path):
    frames, _ = clip
    out = str(tmp_path / "o.avi")
    assert tvideo.main([frames, "--out", out, "--size", str(SIZE),
                        "--weights", STUDENT, "--limit", "4",
                        "--device", "cpu"]) == 0
    if os.path.exists(out):            # MJPG opened
        cap = cv2.VideoCapture(out)
        n = 0
        while cap.read()[0]:
            n += 1
        cap.release()
        assert n == 4
    else:
        assert len(os.listdir(str(tmp_path / "o"))) == 4


def test_seeded_net_without_weights(clip, tmp_path):
    """--weights "" is the port's seeded net (init_state_dict(seed=0)): two
    runs give the same frames."""
    frames, _ = clip
    outs = []
    for k in range(2):
        out = str(tmp_path / f"seeded{k}")
        assert tvideo.main([frames, "--out", out, "--size", str(SIZE),
                            "--limit", "2", "--device", "cpu"]) == 0
        outs.append([read_image(os.path.join(out, n))
                     for n in sorted(os.listdir(out))])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
