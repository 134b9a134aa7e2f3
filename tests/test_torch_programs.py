"""The standalone device programs of the port (``engine/pipeline.py``'s
load, getter, suggest and entropy factories, ``ops/gamut.py``'s fixed-trip
snap, ``ops/resize.py``'s padded matrix builders and the API that drives
them) against the JAX package's, on the CPU. Frames are held to 1 LSB on
< 1e-3 of the pixels, the JAX click's bar (``tests/test_pallas_resize.py``);
the snap to the byte."""

import os
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ideepcolor_tpu import api as japi
from ideepcolor_tpu.engine import pipeline as jP
from ideepcolor_tpu.ops import gamut as jgamut
from ideepcolor_tpu.ops import resize as jresize
from ideepcolor_tpu_torch.api import ColorizeImageTorch
from ideepcolor_tpu_torch.api import colorize as tcolorize
from ideepcolor_tpu_torch.data import lab_gamut as tlab_gamut
from ideepcolor_tpu_torch.engine import graphs
from ideepcolor_tpu_torch.engine import pipeline as tP
from ideepcolor_tpu_torch.ops import gamut as tgamut
from ideepcolor_tpu_torch.ops import resize as tresize
from ideepcolor_tpu_torch.ops.cuda import build
from ideepcolor_tpu_torch.ops.hints import points_json_to_table, put_point

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDENT = os.path.join(ROOT, "weights", "student_w025.npz")
XD = 64
FRAME_BAR = (1, 1e-3)
SIZES = [(250, 333), (256, 256), (257, 511)]   # in a bucket, on, across


def _image(seed, H, W):
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


def _frames_agree(got, want, label=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8, \
        label
    d = np.abs(got.astype(int) - want.astype(int)).max(-1)
    assert d.max() <= FRAME_BAR[0] and np.mean(d != 0) < FRAME_BAR[1], \
        (label, int(d.max()), float(np.mean(d != 0)))
    return d


@pytest.mark.parametrize("kind", ["linear", "nearest"])
@pytest.mark.parametrize("n_out,n_rows", [(750, 768), (1000, 1024),
                                          (1100, 1280), (256, 256),
                                          (1, 256), (257, 512)])
def test_padded_matrix_builders_equal_jax(kind, n_out, n_rows):
    """(n_rows, Xd) with zero rows past n_out, equal to JAX's builder."""
    name = f"{kind}_resize_matrix_np"
    got = getattr(tresize, name)(XD, n_out, n_rows)
    want = getattr(jresize, name)(XD, n_out, n_rows)
    assert got.shape == (n_rows, XD) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert not got[n_out:].any()
    np.testing.assert_array_equal(got[:n_out],
                                  getattr(tresize, name)(XD, n_out))


@pytest.mark.parametrize("n,want", [(1, 256), (256, 256), (257, 512),
                                    (750, 768), (1000, 1024), (1025, 1280)])
def test_bucket_size_equals_jax(n, want):
    assert tP.FULLRES_BUCKET == jP.FULLRES_BUCKET == 256
    assert tP.bucket_size(n) == jP.bucket_size(n) == want


def _padded_inputs(H, W, dtype=np.uint8):
    Hb, Wb = tP.bucket_size(H), tP.bucket_size(W)
    pad = np.zeros((Hb, Wb, 3), dtype)
    im = _image(H + W, H, W)
    pad[:H, :W] = im if dtype == np.uint8 else im / 255.0
    rng = np.random.default_rng(H * W)
    mats = {f"{k}{ax}": getattr(tresize, f"{k}_resize_matrix_np")(XD, n, nb)
            for k in ("linear", "nearest")
            for ax, n, nb in (("h", H, Hb), ("w", W, Wb))}
    ab = rng.uniform(-90, 90, (XD, XD, 2)).astype(np.float32)
    mask = (rng.uniform(size=(XD, XD, 1)) < 0.2).astype(np.float32)
    return pad, mats, ab, mask


@pytest.mark.parametrize("H,W", SIZES + [(1000, 750)])
@pytest.mark.parametrize("program", ["load_u8", "load_f32", "fullres",
                                     "gray", "mask", "sup"])
def test_bucketed_programs_match_jax(H, W, program):
    """The load program (uint8 and float sources) against JAX's
    rgb_to_lab_dev(_u8) on the same padded frame: Lab within 1e-3, the L
    plane the Lab's first channel, contiguous; the getters against JAX's
    *_bucketed functions (the gray getter against its compose of zero ab)
    on the same padded inputs: <= 1 LSB on < 1e-3 of the pixels, and the
    pad is black (Lab 0) in the full-res frame, white in the mask frame."""
    dtype = np.float32 if program == "load_f32" else np.uint8
    pad, mats, ab, mask = _padded_inputs(H, W, dtype)
    if program.startswith("load"):
        lab, l = tP.make_load_program()(torch.from_numpy(pad))
        jfn = jP.rgb_to_lab_dev if dtype == np.float32 else \
            jP.rgb_to_lab_dev_u8
        want = np.asarray(jfn(jnp.asarray(pad)))
        assert lab.shape == pad.shape and l.shape == pad.shape[:2] + (1,)
        assert l.is_contiguous() and torch.equal(l[..., 0], lab[..., 0])
        assert np.abs(lab.numpy() - want).max() <= 1e-3
        assert not lab.numpy()[H:].any() and not lab.numpy()[:, W:].any()
        return
    lab = jP.rgb_to_lab_dev_u8(jnp.asarray(pad))
    l_pad = np.ascontiguousarray(np.asarray(lab)[..., :1])
    t = torch.from_numpy
    progs = tP.make_getter_programs()
    if program == "fullres":
        got = progs["fullres"](t(l_pad), t(ab), t(mats["linearh"]),
                               t(mats["linearw"]))
        want = jP.fullres_fuse_bucketed(jnp.asarray(l_pad), jnp.asarray(ab),
                                        jnp.asarray(mats["linearh"]),
                                        jnp.asarray(mats["linearw"]))
    elif program == "gray":
        got = progs["gray"](t(l_pad))
        want = jP.compose_rgb_u8(jnp.asarray(l_pad),
                                 jnp.zeros(l_pad.shape[:2] + (2,)))
    else:
        planes = mask if program == "mask" else np.concatenate(
            [mask, ab * mask], -1)
        got = progs[program](t(planes), t(mats["nearesth"]),
                             t(mats["nearestw"]))
        jfn = jP.mask_fullres_bucketed if program == "mask" else \
            jP.sup_fullres_bucketed
        want = jfn(jnp.asarray(planes), jnp.asarray(mats["nearesth"]),
                   jnp.asarray(mats["nearestw"]))
    got, want = got.numpy(), np.asarray(want)
    _frames_agree(got, want, program)
    # the pad: black (L 0) in the full-res frames, white (L 100, no hint)
    # in the mask frame
    if got.shape[:2] != (H, W):
        pad_value = want[-1, -1]
        assert (pad_value == 0).all() != (program == "mask")
        assert (got[H:] == pad_value).all()
        assert (got[:, W:] == pad_value).all()


def _api_session(m, H, W):
    """load a seeded HxW image, every full-res getter around a table click
    and a dense click."""
    out = {}
    m.load_image_array(_image(7, H, W))
    out["gray_fullres"] = m.get_img_gray_fullres()
    out["table"] = m.net_forward_table(*points_json_to_table(_hints(5, 1),
                                                             XD))
    out["ab_table"] = m.output_ab.copy()
    out["fullres_table"] = m.get_img_fullres()
    out["fullres_async"] = m.get_img_fullres_async()()
    out["input_fullres"] = m.get_input_img_fullres()
    out["mask_fullres"] = m.get_img_mask_fullres()
    out["sup_fullres"] = m.get_sup_fullres()
    ab = np.zeros((2, XD, XD), np.float32)
    mask = np.zeros((1, XD, XD), np.float32)
    for h in _hints(6, 9):
        put_point(ab, mask, [max(h["y"], 3), max(h["x"], 3)], 3, h["ab"])
    out["fullres_dense"] = m.net_forward_fullres(ab, mask)
    out["dense"] = m.output_rgb
    out["ab_dense"] = m.output_ab.copy()
    out["lab_fullres"] = m.img_lab_fullres
    return out


@pytest.mark.parametrize("H,W", SIZES)
def test_api_getters_match_jax_across_buckets(H, W):
    """ColorizeImageTorch(device="cpu") against ColorizeImageJax on one
    session at three sizes (inside a bucket, on its edge, across two):
    frames <= 1 LSB on < 1e-3 of the pixels, output_ab within 1e-3 where
    the frames agree, the full-res Lab within 1e-3; the port keeps its
    planes and matrices padded to the bucket, as JAX does."""
    jm = japi.ColorizeImageJax(Xd=XD)
    jm.prep_net(path=STUDENT)
    tm = ColorizeImageTorch(Xd=XD, device="cpu")
    tm.prep_net(path=STUDENT)
    want, got = _api_session(jm, H, W), _api_session(tm, H, W)
    Hb, Wb = tP.bucket_size(H), tP.bucket_size(W)
    assert tuple(tm._dev_l_fullres_pad.shape) == (Hb, Wb, 1)
    assert tuple(tm._dev_rh.shape) == (Hb, XD)
    assert tuple(tm._dev_rw0.shape) == (Wb, XD)
    d = {}
    for k in want:
        if k.startswith("ab_"):
            continue
        if k == "lab_fullres":
            assert got[k].shape == (3, H, W)
            assert np.abs(got[k] - want[k]).max() <= 1e-3
            continue
        d[k] = _frames_agree(got[k], want[k], k)
    np.testing.assert_array_equal(got["fullres_async"], got["fullres_table"])
    for key in ("table", "dense"):
        same = d[key] == 0
        assert np.abs(got["ab_" + key] - want["ab_" + key]).max(0)[
            same].max() <= 1e-3


def test_oversized_image_is_shrunk_then_padded():
    """An image past Xfullres_max is shrunk as JAX shrinks it, and the
    shrunk image is what is padded and kept."""
    jm = japi.ColorizeImageJax(Xd=XD)
    jm.Xfullres_max = 300
    jm.prep_net(path=STUDENT)
    tm = ColorizeImageTorch(Xd=XD, device="cpu")
    tm.Xfullres_max = 300
    tm.prep_net(path=STUDENT)
    im = _image(11, 620, 410)
    for m in (jm, tm):
        m.load_image_array(im)
        m.net_forward_table(*points_json_to_table(_hints(3, 4), XD))
    assert tm._fullres_hw == jm._fullres_hw == (300, 198)
    assert tuple(tm._dev_l_fullres_pad.shape) == (512, 256, 1)
    _frames_agree(tm.get_img_fullres(), jm.get_img_fullres())
    _frames_agree(tm.img_rgb, jm.img_rgb)


def _colors(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 3)).astype(
        np.float32)


def _iterations(l_in, color):
    """Round trips the snap of one color takes before its delta drops
    below 1 (20 at most): where it converges."""
    from ideepcolor_tpu_torch.ops import colorspace as cs
    lab = cs.rgb_to_lab(torch.from_numpy(color) / 255.0)
    for i in range(20):
        old = torch.cat([torch.tensor([l_in]), lab[1:]])
        lab = cs.rgb_to_lab(cs.lab_to_rgb(old))
        if (lab - old).abs().sum() < 1.0:
            return i + 1
    return 20


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("l_in", [5.0, 35.0, 65.0, 95.0])
def test_fixed_trip_snap_equals_jax_while_loop(seed, l_in):
    """The 20 masked iterations against JAX's while_loop, byte for byte:
    batches of 1, 5 and 48 colors whose colors converge after different
    numbers of round trips (the batch freezes at its slowest), and each
    color alone."""
    c = _colors(48, seed)
    its = {_iterations(l_in, x) for x in c}
    assert len(its) > 1, its
    for batch in (c[:1], c[:5], c):
        want = np.asarray(jgamut.snap_ab(jnp.float32(l_in),
                                         jnp.asarray(batch)))
        got = tgamut.snap_ab(l_in, torch.from_numpy(batch)).numpy()
        assert got.tobytes() == want.astype(np.float32).tobytes()
    for x in c[:8]:
        want = np.asarray(jgamut.snap_ab(jnp.float32(l_in), jnp.asarray(x)))
        assert tgamut.snap_ab(l_in, torch.from_numpy(x)).numpy().tobytes() \
            == want.astype(np.float32).tobytes()


def test_fixed_trip_snap_runs_every_iteration_off_the_cpu(monkeypatch):
    """Off the CPU the loop never reads its flag back and runs all 20
    masked round trips: forced here, the bytes are those of the CPU's
    early stop and of JAX's while_loop."""
    calls = []
    real = tgamut.cs.lab_to_rgb
    c = _colors(12, 7)
    want = np.asarray(jgamut.snap_ab(jnp.float32(50.0), jnp.asarray(c)))
    stopped = tgamut.snap_ab(50.0, torch.from_numpy(c))
    monkeypatch.setattr(tgamut, "_stop_on_host", lambda active: False)
    monkeypatch.setattr(tgamut.cs, "lab_to_rgb",
                        lambda lab: calls.append(1) or real(lab))
    got = tgamut.snap_ab(50.0, torch.from_numpy(c))
    assert len(calls) == 21             # 20 round trips, then the output
    assert got.numpy().tobytes() == stopped.numpy().tobytes() \
        == want.astype(np.float32).tobytes()


@pytest.mark.parametrize("l_in", [0.0, 37.5, 50.0, 100.0])
def test_gamut_mask_with_device_lightness_equals_number(l_in):
    """ab_gamut_mask with L as a one-element tensor (what a graph reads)
    equals the Python-number form, and JAX's mask."""
    rgb_t, mask_t = tgamut.ab_gamut_mask(torch.tensor([l_in]))
    rgb_n, mask_n = tgamut.ab_gamut_mask(l_in, device="cpu")
    assert torch.equal(rgb_t, rgb_n) and torch.equal(mask_t, mask_n)
    _, jmask = jgamut.ab_gamut_mask(jnp.float32(l_in))
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(jmask))


@pytest.mark.parametrize("map_div", [1, 4])
def test_suggest_program_with_tensor_pixel_equals_int_form(map_div):
    """suggest_at with one-element index tensors (a TableStage's h, w)
    gives what the int form gives from the same seed; the suggest program
    packs its centers and confidences into one (K, 3) buffer, hands back
    the uniform numbers it drew beside it and takes the pixel in net
    coordinates."""
    rng = np.random.default_rng(3)
    dist = torch.from_numpy(rng.dirichlet(np.ones(529) * 0.05, (16, 16))
                            .astype(np.float32))
    pts = torch.from_numpy(np.stack(np.meshgrid(
        np.arange(-110, 111, 10), np.arange(-110, 111, 10), indexing="ij"),
        -1).reshape(-1, 2).astype(np.float32))
    h, w = 9 * map_div, 13 * map_div
    gen = torch.Generator()
    as_t = lambda v: torch.tensor([v], dtype=torch.int32)  # noqa: E731
    gen.manual_seed(5)
    c_int, conf_int = tP.suggest_at(dist, h // map_div, w // map_div, pts,
                                    gen, K=7, N=5000)
    gen.manual_seed(5)
    c_t, conf_t = tP.suggest_at(dist, as_t(h // map_div), as_t(w // map_div),
                                pts, gen, K=7, N=5000)
    assert torch.equal(c_int, c_t) and torch.equal(conf_int, conf_t)
    gen.manual_seed(5)
    out, u_bins, u_seeds = tP.make_suggest_program()(
        dist, as_t(h), as_t(w), pts, gen, K=7, N=5000, map_div=map_div)
    assert out.shape == (7, 3)
    assert u_bins.shape == (5000,) and u_seeds.shape == (4, 7)
    assert torch.equal(out[:, :2], c_int) and torch.equal(out[:, 2],
                                                          conf_int)


@pytest.mark.parametrize("cls", ["ColorizeImageTorchDist",
                                 "ColorizeImageTorchCaffeDist"])
def test_get_ab_reccs_and_entropy_through_programs(cls):
    """get_ab_reccs replays the suggest program on the map's pixel (h //
    dist_map_div, w // dist_map_div): equal to suggest_at on that pixel
    from the same seed; compute_entropy equals dist_entropy of the map;
    compile_now is accepted on the CPU and captures nothing."""
    d = getattr(tcolorize, cls)(Xd=XD, device="cpu")
    d.prep_net() if "Caffe" in cls else d.prep_net(path=STUDENT)
    d.set_image(_image(2, XD, XD))
    assert d.predict_dist_table(*points_json_to_table(_hints(4, 2), XD)) == 0
    h, w = 37, 21
    d._generator.manual_seed(9)
    centers, conf = d.get_ab_reccs(h, w, K=6, N=4000, return_conf=True)
    d._generator.manual_seed(9)
    want_c, want_conf = tP.suggest_at(
        d._dev_dist, h // d.dist_map_div, w // d.dist_map_div, d._dev_pts(),
        d._generator, K=6, N=4000)
    np.testing.assert_array_equal(centers, want_c.numpy())
    np.testing.assert_array_equal(conf, want_conf.numpy())
    d.compute_entropy()
    lo = tP.dist_entropy(d._dev_dist).numpy()
    if d.dist_map_div == 4:
        lo = lo.repeat(4, axis=0).repeat(4, axis=1)
    np.testing.assert_array_equal(d.dist_entropy, lo)
    prog = d.ensure_suggest_program(5, 2000, compile_now=True)
    assert not isinstance(prog, graphs.GraphProgram) and d._stage is None


@pytest.mark.parametrize("call", ["get_ab_reccs", "suggest_table",
                                  "snap_ab", "update_gamut"])
def test_shared_program_callers_wait_on_their_lock(call):
    """Callers of state that other threads share wait while its lock is
    held: the dist model's suggestions on its generator lock (which a
    capture ahead holds: on the card PyTorch refuses to replay a graph
    drawing from a generator that a capture has registered), the gamut
    snap and redraw on lab_gamut's (each replay returns the graph's own
    output buffer)."""
    if call in ("snap_ab", "update_gamut"):
        lock = tlab_gamut._LOCK
        fn = {"snap_ab": lambda: tlab_gamut.snap_ab(
                  50.0, [10, 200, 30], device="cpu"),
              "update_gamut": lambda: tlab_gamut.abGrid(
                  device="cpu").update_gamut(42.0)}[call]
    else:
        d = tcolorize.ColorizeImageTorchDist(Xd=XD, device="cpu")
        d.prep_net(path=STUDENT)
        d.set_image(_image(4, XD, XD))
        table = points_json_to_table(_hints(3, 4), XD)
        assert d.predict_dist_table(*table) == 0
        lock = d._generator_lock
        fn = {"get_ab_reccs": lambda: d.get_ab_reccs(9, 11, K=3, N=2000),
              "suggest_table": lambda: d.suggest_table(*table, 9, 11, K=3,
                                                       N=2000)}[call]
    done = threading.Event()

    def run():
        fn()
        done.set()

    t = threading.Thread(target=run)
    with lock:
        t.start()
        assert not done.wait(0.5)
    t.join(60)
    assert done.is_set()


def test_capture_counts_nodes_per_thread(monkeypatch):
    """A launch made while this thread records a capture counts as a node
    of it; another thread's launches meanwhile count as launches."""
    k = build.Kernel("probe", "none.cu", "probe", [], "none")
    monkeypatch.setattr(build, "KERNELS", [x for x in build.KERNELS
                                           if x is not k])
    k._fn = lambda *a: 0
    monkeypatch.setattr(k, "load", lambda: k)
    recorded, other = threading.Event(), threading.Event()

    def launcher():
        recorded.wait(5)
        for _ in range(3):
            k.launch()
        other.set()

    t = threading.Thread(target=launcher)
    t.start()
    with build.recording_nodes() as nodes:
        k.launch()
        k.launch()
        recorded.set()
        other.wait(5)
    t.join()
    k.launch()
    assert nodes == {k: 2} and k.launches == 4
