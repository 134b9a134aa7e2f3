"""utils/ of the port against the JAX package's: the numpy helpers
(ndarray, visualize), StageTimer's summary and report, device_op_summary on
a torch.profiler trace, session dumps (the same .npy files, PNGs that decode
to the frames), replay, the weight npz round trip and rss_mb."""

import json
import os
import pickle

import cv2
import numpy as np
import pytest
import torch

from ideepcolor_tpu import api as japi
from ideepcolor_tpu.utils import ndarray as jnd
from ideepcolor_tpu.utils import profiling as jprof
from ideepcolor_tpu.utils import session as jsession
from ideepcolor_tpu.utils import soakload as jsoak
from ideepcolor_tpu.utils import visualize as jvis
from ideepcolor_tpu_torch.api import ColorizeImageTorch
from ideepcolor_tpu_torch.models.siggraph import load_state_dict_file
from ideepcolor_tpu_torch.ops.hints import put_point
from ideepcolor_tpu_torch.utils import ndarray as tnd
from ideepcolor_tpu_torch.utils import profiling as tprof
from ideepcolor_tpu_torch.utils import session as tsession
from ideepcolor_tpu_torch.utils import soakload as tsoak
from ideepcolor_tpu_torch.utils import visualize as tvis

from _torch_caffe import smooth_image

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDENT = os.path.join(ROOT, "weights", "student_w025.npz")
XD = 64


@pytest.mark.parametrize("shape,axis", [((2, 3, 4, 5), 1), ((6, 7), 0),
                                        ((3, 4, 2), 2)])
def test_ndarray_helpers_match_jax(shape, axis):
    x = np.random.default_rng(1).normal(size=shape)
    flat_t, flat_j = (m.flatten_nd_array(x, axis) for m in (tnd, jnd))
    assert np.array_equal(flat_t, flat_j)
    assert np.array_equal(tnd.unflatten_2d_array(flat_t, x, axis),
                          jnd.unflatten_2d_array(flat_j, x, axis))
    one = flat_t[:, :1]
    assert np.array_equal(
        tnd.unflatten_2d_array(one, x, axis, squeeze=True),
        jnd.unflatten_2d_array(one, x, axis, squeeze=True))
    for inds, val in ((3, 3), (np.array([3]), 3), (np.array([1, 2]), 1),
                      (2, 5)):
        assert tnd.check_value(inds, val) == jnd.check_value(inds, val)
    assert tnd.na() is jnd.na()
    with tnd.Timer() as t:
        pass
    assert t.calls == 1 and t.diff >= 0


@pytest.mark.parametrize("n,nh,nw,c", [(4, 2, 2, 3), (3, 2, 2, 3),
                                       (5, 1, 5, 1), (6, 3, 2, 0)])
def test_visualize_helpers_match_jax(n, nh, nw, c, tmp_path):
    rng = np.random.default_rng(n)
    shape = (n, 5, 7) + ((c,) if c else ())
    x = rng.integers(0, 255, shape, np.uint8)
    assert np.array_equal(tvis.grid_vis(x, nh, nw), jvis.grid_vis(x, nh, nw))
    assert np.array_equal(tvis.average_image(x), jvis.average_image(x))
    obj = {"x": x, "k": [1, "a"]}
    path = str(tmp_path / "sub" / "o.pkl")
    tvis.save_pickle(obj, path)
    back = jvis.load_pickle(path)
    assert np.array_equal(back["x"], x) and back["k"] == [1, "a"]
    assert pickle.dumps(tvis.load_pickle(path)) == pickle.dumps(back)


def test_stage_timer_summary_and_report_match_jax():
    rng = np.random.default_rng(3)
    timers = [tprof.StageTimer(maxlen=10), jprof.StageTimer(maxlen=10)]
    unbounded = [tprof.StageTimer(), jprof.StageTimer()]
    for name in ("click", "suggest", "fullres"):
        for s in rng.exponential(0.01, 25):
            for t in timers + unbounded:
                t.record(name, float(s))
    assert timers[0].summary() == timers[1].summary()
    assert unbounded[0].summary() == unbounded[1].summary()
    assert timers[0].report() == timers[1].report()
    assert timers[0].summary()["click"]["n"] == 10
    with timers[0].stage("ctx"):
        pass
    assert timers[0].summary()["ctx"]["n"] == 1


def test_device_op_summary_of_a_cpu_trace(tmp_path):
    """On the CPU the trace has no kernels: the CPU is the device, and its
    outermost ops are summed (nested ops counted once). The dict has the
    JAX function's shape."""
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3, padding=1),
                              torch.nn.ReLU()).eval()
    x = torch.randn(1, 3, 32, 32)
    with torch.no_grad(), tprof.device_trace(str(tmp_path)):
        for _ in range(3):
            with tprof.annotate("step"):
                net(x)
    assert os.path.exists(tmp_path / tprof.TRACE_FILE)
    out = tprof.device_op_summary(str(tmp_path), reps=3)
    assert set(out) == {"total_ms_per_rep", "groups", "top_ops"}
    assert out["total_ms_per_rep"] > 0
    assert abs(sum(out["groups"].values()) - out["total_ms_per_rep"]) < 1e-6
    assert set(out["groups"]) <= {"conv", "copy", "elementwise", "other"}
    assert all(isinstance(n, str) and ms >= 0 for n, ms in out["top_ops"])
    # nested aten ops are counted once, under their outermost op; the
    # annotation is a span of the trace, not an op of the device
    assert {n for n, _ in out["top_ops"]} == {"aten::conv2d", "aten::relu"}
    assert set(out["groups"]) == {"conv", "other"}
    with open(tmp_path / tprof.TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "step" in names and "aten::convolution" in names
    with pytest.raises(FileNotFoundError):
        tprof.device_op_summary(str(tmp_path / "none"))


@pytest.mark.parametrize("name,group", [
    ("sm90_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nhwckrsc_nchw",
     "conv"),
    ("void cudnn::detail::dgrad_engine<float, 512, 6, 5, 3, 3, 3, false>",
     "conv"),
    ("Memcpy DtoD (Device -> Device)", "copy"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>>", "elementwise"),
    ("lab_to_rgb_u8_hwc_kernel", "other"),
])
def test_kernel_names_group_as_on_the_card(name, group):
    assert tprof._group(name) == group


def _dense_hints():
    ab = np.zeros((2, XD, XD), np.float32)
    mask = np.zeros((1, XD, XD), np.float32)
    for y, x, v in ((10, 12, [30.0, -20.0]), (40, 50, [-45.0, 10.0])):
        put_point(ab, mask, [y, x], 3, v)
    return ab, mask


def _decode(path):
    im = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    return im if im.ndim == 2 else cv2.cvtColor(im, cv2.COLOR_BGR2RGB)


def test_save_session_writes_the_jax_dump(tmp_path):
    """The same .npy files as the JAX dump of the same session (the hint
    planes exactly, L within 1e-4), PNG frames that decode to the port's
    own getters exactly and to JAX's within 1 LSB on < 1% of the pixels;
    load_session and replay_session read either dump."""
    ab, mask = _dense_hints()
    img = smooth_image(4, 90, 70)
    dirs = {}
    for name, m in (("jax", japi.ColorizeImageJax(Xd=XD)),
                    ("port", ColorizeImageTorch(Xd=XD, device="cpu"))):
        m.prep_net(path=STUDENT)
        m.load_image_array(img)
        result = m.net_forward(ab, mask)
        mod = jsession if name == "jax" else tsession
        dirs[name] = (mod.save_session(str(tmp_path / name), m, ab, mask,
                                       result, timestamp=False), m)
    (jdir, jm), (tdir, tm) = dirs["jax"], dirs["port"]
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for f in ("im_ab.npy", "im_mask.npy"):
        assert np.array_equal(np.load(os.path.join(tdir, f)),
                              np.load(os.path.join(jdir, f)))
    assert np.abs(np.load(os.path.join(tdir, "im_l.npy"))
                  - np.load(os.path.join(jdir, "im_l.npy"))).max() < 1e-4
    own = {"ours.png": tm.get_img_forward(),
           "ours_fullres.png": tm.get_img_fullres(),
           "input_fullres.png": tm.get_input_img_fullres(),
           "input.png": tm.get_input_img(), "input_ab.png": tm.get_sup_img(),
           "input_mask.png": (mask[0] * 255).astype(np.uint8)}
    for f, want in own.items():
        got = _decode(os.path.join(tdir, f))
        assert np.array_equal(got, want), f
        jgot = _decode(os.path.join(jdir, f))
        assert jgot.shape == got.shape, f
        d = np.abs(got.astype(int) - jgot.astype(int))
        d = d.max(-1) if d.ndim == 3 else d
        assert d.max() <= 1 and np.mean(d != 0) < 1e-2, f
    for d in (tdir, jdir):
        loaded = tsession.load_session(d)
        assert set(loaded) == {"im_l", "im_ab", "im_mask"}
        assert np.array_equal(tsession.replay_session(d, tm),
                              tm.net_forward(ab, mask))


def test_create_temp_directory(tmp_path):
    np.random.seed(0)
    a = tsession.create_temp_directory(str(tmp_path / "run_%d"))
    np.random.seed(0)
    b = tsession.create_temp_directory(str(tmp_path / "run_%d"))
    assert os.path.isdir(a) and os.path.isdir(b) and a != b


def test_params_npz_round_trip(tmp_path):
    """A state dict through save_params_npz / load_params_npz is the same
    tensors, and the file is one the JAX package's load_params_npz and
    the port's checkpoint loader read."""
    sd = load_state_dict_file(STUDENT)
    path = str(tmp_path / "sd.npz")
    tsession.save_params_npz(path, sd)
    back = tsession.load_params_npz(path)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v) and back[k].dtype == v.dtype
    again = load_state_dict_file(path)
    assert all(torch.equal(again[k], sd[k]) for k in sd)
    jparams = jsession.load_params_npz(path)
    assert np.array_equal(np.asarray(jparams["model1.0.weight"]),
                          sd["model1.0.weight"].numpy())
    tsession.save_params_npz(path, {"a": np.arange(3)})
    assert torch.equal(tsession.load_params_npz(path)["a"],
                       torch.arange(3))


def test_rss_mb_and_soak_load_are_the_jax_ones():
    a, b = tsoak.rss_mb(), jsoak.rss_mb()
    assert a > 0 and abs(a - b) < 64
    for name in ("_request", "open_warm_session", "run_clients"):
        assert getattr(tsoak, name).__code__.co_code == getattr(
            jsoak, name).__code__.co_code
    with pytest.raises(ValueError, match="unknown request kind"):
        tsoak._request(None, "bogus", "", b"", 0, 0)
