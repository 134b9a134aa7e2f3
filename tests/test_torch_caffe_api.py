"""The port's three Caffe backends against the JAX API classes, on the CPU,
at Xd=32: ``ColorizeImageTorchCaffe`` / ``...CaffeGlobDist`` /
``...CaffeDist(device="cpu")`` and their JAX counterparts load the same
weights, made once from a seed with numpy (the calibrated init, so that
``tanh`` is not saturated) and written as a ``.caffemodel`` (main), a
JAX-layout ``.npz`` (global) and both (dist).

Bounds: frames within 1 LSB on at most 5e-3 of a frame's pixels, five of
the 1024 at Xd=32 (measured: one pixel, 9.8e-4, in the worst frame; the
net's f32 last bits reach ab at up to 3e-3, ``tests/test_torch_caffe_net.py``,
and a uint8 step is about 0.4 ab units); ``output_ab`` within 1e-3 where the
frames agree (measured 6.1e-5); the distribution map within 1e-5. The suggestions' random numbers differ
between the packages; they are held by their contract."""

import numpy as np
import pytest
import torch

from ideepcolor_tpu import api as japi
from ideepcolor_tpu.models import global_stats as jstats
from ideepcolor_tpu_torch import api as tapi
from ideepcolor_tpu_torch.apps import demos as tdemos
from ideepcolor_tpu_torch.models import caffe_net as tcaffe
from ideepcolor_tpu_torch.models import caffemodel_io as tio
from ideepcolor_tpu_torch.models import global_stats as tstats
from ideepcolor_tpu_torch.ops.hints import points_json_to_table, put_point

from _torch_caffe import jax_params_from_state_dict, smooth_image

torch.set_num_threads(2)
XD = 32
FULL_HW = (80, 56)
FRAME_SHARE = 5e-3
MAP_BOUND = 1e-5


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory):
    """{variant: {suffix: path}}: one seeded weight set per variant, in the
    formats ``prep_net`` takes."""
    root = tmp_path_factory.mktemp("caffe_weights")
    files = {}
    for variant in ("main", "global", "dist"):
        sd = tcaffe.init_state_dict(variant, seed=12, calibrate=True)
        paths = {}
        paths["npz"] = str(root / f"{variant}.npz")
        np.savez(paths["npz"], **jax_params_from_state_dict(sd, variant))
        files[variant] = paths
        if variant == "global":
            continue
        paths["pth"] = str(root / f"{variant}.pth")
        torch.save(sd, paths["pth"])
        paths["caffemodel"] = str(root / f"{variant}.caffemodel")
        with open(paths["caffemodel"], "wb") as f:
            f.write(tio.encode_caffemodel(tio.layers_from_state_dict(sd)))
    return files


def _dense(n, seed=2):
    ab = np.zeros((2, XD, XD), np.float32)
    mask = np.zeros((1, XD, XD), np.float32)
    rng = np.random.default_rng(seed)
    for _ in range(n):
        put_point(ab, mask, [int(rng.integers(3, XD - 3)),
                             int(rng.integers(3, XD - 3))], 2,
                  rng.uniform(-70, 70, 2))
    return ab, mask


def _table(n, seed=1):
    rng = np.random.default_rng(seed)
    return points_json_to_table(
        [{"y": int(rng.integers(0, XD)), "x": int(rng.integers(0, XD)),
          "ab": rng.uniform(-80, 80, 2).tolist(),
          "radius": int(rng.integers(0, 3))} for _ in range(n)], XD)


def _held(got, want, got_ab=None, want_ab=None):
    d = np.abs(got.astype(int) - want.astype(int)).max(-1)
    assert d.max() <= 1 and np.mean(d != 0) <= FRAME_SHARE, \
        (d.max(), np.mean(d != 0))
    if got_ab is not None:
        same = d == 0
        assert np.abs(got_ab - want_ab).max(0)[same].max() <= 1e-3


def _pair(jcls, tcls, path, **kw):
    jm, tm = jcls(Xd=XD), tcls(Xd=XD, device="cpu")
    jm.prep_net(0, caffemodel_path=path, **kw)
    tm.prep_net(0, caffemodel_path=path, **kw)
    return jm, tm


def test_exports_and_reference_aliases():
    assert tapi.ColorizeImageCaffe is tapi.ColorizeImageTorchCaffe
    assert tapi.ColorizeImageCaffeDist is tapi.ColorizeImageTorchCaffeDist
    assert tapi.ColorizeImageCaffeGlobDist is \
        tapi.ColorizeImageTorchCaffeGlobDist
    for name in ("ColorizeImageTorchCaffe", "ColorizeImageTorchCaffeDist",
                 "ColorizeImageTorchCaffeGlobDist", "ColorizeImageCaffe"):
        assert name in tapi.__all__
    jm, tm = japi.ColorizeImageJaxCaffe(Xd=XD), \
        tapi.ColorizeImageTorchCaffe(Xd=XD, device="cpu")
    for field in ("l_mean", "l_norm", "ab_mean", "ab_norm", "mask_mult",
                  "pred_ab_layer", "variant"):
        assert getattr(tm, field) == getattr(jm, field), field
    assert np.array_equal(tm.pts_in_hull, jm.pts_in_hull)
    assert tm.mask_mult == 110.0


def test_sentinels_before_image_and_net():
    tm = tapi.ColorizeImageTorchCaffe(Xd=XD, device="cpu")
    ab, mask = _dense(0)
    assert tm.net_forward(ab, mask) == -1
    assert tm.net_forward_table(*_table(0)) == -1
    assert tm.net_forward_fullres(ab, mask) == -1
    tg = tapi.ColorizeImageTorchCaffeGlobDist(Xd=XD, device="cpu")
    assert tg.net_forward(ab, mask, -1) == -1
    assert tg.net_forward_fullres(ab, mask, -1) == -1
    td = tapi.ColorizeImageTorchCaffeDist(Xd=XD, device="cpu")
    assert td.net_forward(ab, mask) == -1
    assert td.predict_dist_table(*_table(0)) == -1
    assert td.suggest_table(*_table(0), 3, 3) == -1
    assert td.get_ab_reccs(3, 3) == 0


@pytest.mark.parametrize("suffix", ["caffemodel", "npz"])
def test_main_session_matches_jax(weight_files, suffix):
    """Dense click without and with hints, table clicks, the window click,
    the full-res getters and the fused forward + full-res."""
    jm, tm = _pair(japi.ColorizeImageJaxCaffe, tapi.ColorizeImageTorchCaffe,
                   weight_files["main"][suffix])
    im = smooth_image(4, *FULL_HW)
    for m in (jm, tm):
        m.load_image_array(im)
    for n in (0, 3):
        ab, mask = _dense(n)
        _held(tm.net_forward(ab, mask), jm.net_forward(ab, mask),
              tm.output_ab, jm.output_ab)
        assert tm.output_rgb.shape == (XD, XD, 3)
    _held(tm.get_img_fullres(), jm.get_img_fullres())
    assert tm.get_img_fullres().shape == FULL_HW + (3,)
    assert np.array_equal(tm.get_img_mask_fullres(),
                          jm.get_img_mask_fullres())
    _held(tm.get_input_img_fullres(), jm.get_input_img_fullres())
    assert np.array_equal(tm.input_mask_mult, 110.0 * tm.input_mask)
    for n in (0, 4):
        _held(tm.net_forward_table(*_table(n)),
              jm.net_forward_table(*_table(n)), tm.output_ab, jm.output_ab)
        assert np.array_equal(tm.input_ab, jm.input_ab)
        assert np.array_equal(tm.input_mask, jm.input_mask)
    # the table click scales the mask inside; the dense click gets it
    # scaled: the same hints must give the same frame by both routes
    table = _table(4)
    by_table = tm.net_forward_table(*table).copy()
    by_dense = tm.net_forward(tm.input_ab, tm.input_mask)
    assert np.array_equal(by_table, by_dense)
    two_step = tm.get_img_fullres()
    assert np.array_equal(tm.net_forward_fullres(tm.input_ab, tm.input_mask),
                          two_step)
    finish = tm.net_forward_fullres_async(tm.input_ab, tm.input_mask)
    assert np.array_equal(finish(), two_step)


def test_main_window_click_and_pth_and_seeded_init(weight_files):
    """The window click returns the window frame of the table click's ab;
    a ``.pth`` state dict loads to the same net as the ``.npz``; without a
    path the init is the seeded one, the same for every model."""
    from ideepcolor_tpu_torch.engine import pipeline as P
    from ideepcolor_tpu_torch.ops.resize import cubic_resize_matrix_np
    tm = tapi.ColorizeImageTorchCaffe(Xd=XD, device="cpu")
    tm.prep_net(0, caffemodel_path=weight_files["main"]["pth"])
    other = tapi.ColorizeImageTorchCaffe(Xd=XD, device="cpu")
    other.prep_net(0, caffemodel_path=weight_files["main"]["npz"])
    for (k, v), w in zip(tm.net.state_dict().items(),
                         other.net.state_dict().values()):
        assert torch.equal(v, w), k
    tm.load_image_array(smooth_image(4, *FULL_HW))
    l_win = torch.rand(48, 40, 1) * 100
    rh, rw = cubic_resize_matrix_np(XD, 48), cubic_resize_matrix_np(XD, 40)
    win = tm.net_forward_table_win(*_table(3), l_win, rh, rw)
    assert win.shape == (48, 40, 3) and win.dtype == np.uint8
    frame = tm.output_rgb.copy()
    assert np.array_equal(tm.net_forward_table(*_table(3)), frame)
    want = P.compose_rgb_u8(l_win, torch.einsum(
        "Ww,Hwc->HWc", torch.from_numpy(rw), torch.einsum(
            "Hh,hwc->Hwc", torch.from_numpy(rh),
            torch.from_numpy(tm.output_ab.transpose(1, 2, 0)))))
    assert np.array_equal(win, want.numpy())
    a = tapi.ColorizeImageTorchCaffe(Xd=XD, device="cpu")
    a.prep_net()
    assert torch.equal(a.net.conv4_2.weight,
                       tcaffe.init_state_dict("main")["conv4_2.weight"])
    assert a.net_set and float(a.net.pred_ab.scale) == 100.0
    with pytest.raises(ValueError):
        a.prep_net(0, caffemodel_path="weights.bin")


def test_global_session_matches_jax(weight_files):
    """``glob_dist=-1`` equals an all-zero blob, a histogram changes the
    frame, ``net_forward_fullres`` equals the two-step form, and the
    histogram travels per call (two different ones in turn)."""
    jm, tm = _pair(japi.ColorizeImageJaxCaffeGlobDist,
                   tapi.ColorizeImageTorchCaffeGlobDist,
                   weight_files["global"]["npz"])
    im = smooth_image(4, *FULL_HW)
    ref = smooth_image(9, XD, XD).astype(np.float32) / 255.0
    for m in (jm, tm):
        m.load_image_array(im)
    glob = tstats.extract(ref, device="cpu")["glob_ab_313"].numpy()
    assert np.abs(glob - np.asarray(
        jstats.extract(ref)["glob_ab_313"])).max() <= 1e-6
    glob2 = np.roll(glob, 40)
    ab, mask = _dense(0)
    frames = {}
    for key, g in (("none", -1), ("ref", glob), ("ref2", glob2),
                   ("ref_again", glob)):
        frames[key] = tm.net_forward(ab, mask, g).copy()
        _held(frames[key], jm.net_forward(ab, mask, g),
              tm.output_ab, jm.output_ab)
    assert np.array_equal(frames["ref"], frames["ref_again"])
    assert not np.array_equal(frames["ref"], frames["none"])
    assert not np.array_equal(frames["ref"], frames["ref2"])
    assert np.array_equal(tm.net_forward(ab, mask), frames["none"])
    assert np.array_equal(tm.net_forward(ab, mask, np.zeros(313) - 1),
                          frames["none"])
    # -1 zeroes the whole blob, the mask channel included
    assert np.array_equal(tm._glob_array(-1), np.zeros((1, 314), np.float32))
    assert np.array_equal(tm._glob_array(-1), jm._glob_array(-1))
    assert np.array_equal(tm._glob_array(glob), jm._glob_array(glob))
    assert tm._glob_array(glob)[0, 313] == 1.0
    tm.net_forward(ab, mask, glob)
    two_step = tm.get_img_fullres()
    assert np.array_equal(tm.net_forward_fullres(ab, mask, glob), two_step)
    _held(two_step, jm.net_forward_fullres(ab, mask, glob))
    finish = tm.net_forward_fullres_async(ab, mask, glob)
    tm.net_forward(ab, mask, -1)                    # the state moves on
    assert np.array_equal(finish(), two_step)
    # the dense click only: the base class's fused and table paths say -1
    assert tm._dispatch_click() is None
    assert tm.net_forward_table(*_table(2)) == -1
    assert jm.net_forward_table(*_table(2)) == -1


@pytest.mark.parametrize("suffix", ["caffemodel", "npz"])
def test_dist_session_matches_jax(weight_files, suffix):
    jm, tm = _pair(japi.ColorizeImageJaxCaffeDist,
                   tapi.ColorizeImageTorchCaffeDist,
                   weight_files["dist"][suffix])
    im = smooth_image(4, XD, XD)
    for m in (jm, tm):
        m.set_image(im)
    ab, mask = _dense(2)
    _held(tm.net_forward(ab, mask), jm.net_forward(ab, mask),
          tm.output_ab, jm.output_ab)
    assert tm.dist_ab_set and tuple(tm._dev_dist.shape) == (XD, XD, 313)
    assert tm.dist_ab.shape == jm.dist_ab.shape == (313, XD, XD)
    assert np.abs(tm.dist_ab - jm.dist_ab).max() <= MAP_BOUND
    assert np.abs(tm.dist_ab.sum(0) - 1).max() <= 1e-5
    assert tm.dist_ab_full.shape == (529, XD, XD)
    assert np.abs(tm.dist_ab_full - jm.dist_ab_full).max() <= MAP_BOUND
    assert np.array_equal(tm.dist_ab_full[tm.in_hull], tm.dist_ab)
    assert not tm.dist_ab_full[~tm.in_hull].any()
    assert tm.dist_ab_grid.shape == (23, 23, XD, XD)
    for m in (jm, tm):
        m.compute_entropy()
    assert tm.dist_entropy.shape == (XD, XD)
    assert np.abs(tm.dist_entropy - jm.dist_entropy).max() <= 1e-4
    # the table forward: the same map as the dense one from K1's planes
    for m in (jm, tm):
        assert m.predict_dist_table(*_table(3)) == 0
    assert np.abs(tm.dist_ab - jm.dist_ab).max() <= MAP_BOUND
    assert np.array_equal(tm.input_mask, jm.input_mask)
    assert tm.input_mask.any()
    table_map = tm.dist_ab.copy()
    tm.net_forward(tm.input_ab, tm.input_mask)
    assert np.abs(tm.dist_ab - table_map).max() <= 1e-7
    # the three-output click has no fused full-res and no table click
    assert tm._dispatch_click() is None
    assert tm.net_forward_fullres(ab, mask) == -1
    assert tm.net_forward_table(*_table(2)) == -1


def test_dist_S_and_suggestions_keep_their_contract(weight_files):
    td = tapi.ColorizeImageTorchCaffeDist(Xd=XD, device="cpu")
    td.prep_net(0, caffemodel_path=weight_files["dist"]["pth"], S=0.5)
    jd = japi.ColorizeImageJaxCaffeDist(Xd=XD)
    jd.prep_net(0, caffemodel_path=weight_files["dist"]["npz"], S=0.5)
    assert td.S == 0.5 and float(td.net.scale_S.scale) == 0.5
    im = smooth_image(4, XD, XD)
    for m in (jd, td):
        m.set_image(im)
        m.net_forward(*_dense(1))
    assert np.abs(td.dist_ab - jd.dist_ab).max() <= MAP_BOUND
    centers, conf = td.get_ab_reccs(5, 7, K=5, N=5000, return_conf=True)
    assert centers.shape == (5, 2) and np.abs(centers).max() <= 110
    assert abs(conf.sum() - 1) < 1e-5 and (np.diff(conf) <= 0).all()
    assert td.get_ab_reccs(5, 7, K=3, N=5000).shape == (3, 2)
    # the weighted mean of the suggestions is the pdf's mean (sampling
    # noise of N=25000 draws aside), as it is for JAX's
    pdf = td.dist_ab[:, 5, 7]
    mean = pdf @ td.pts_in_hull
    c, w = td.get_ab_reccs(5, 7, K=5, return_conf=True)
    assert np.abs(w @ c - mean).max() < 2.0
    jc, jw = jd.get_ab_reccs(5, 7, K=5, return_conf=True)
    assert np.abs(jw @ jc - mean).max() < 2.0
    colors, conf = td.suggest_table(*_table(2), 9, 11, K=4, N=5000)
    assert colors.shape == (4, 3) and colors.dtype == np.uint8
    assert abs(conf.sum() - 1) < 1e-5 and (np.diff(conf) <= 0).all()
    assert tuple(td._dev_dist.shape) == (XD, XD, 313) and td.input_mask.any()
    with pytest.raises(ValueError):
        td.suggest_table(*_table(2), 9, 11, K=0)
    assert td.dist_map_div == jd.dist_map_div == 1


def test_demos_run_on_arrays(weight_files):
    """The two notebook sessions over the port's classes, on arrays (no
    cv2): the histogram demo's frames differ with and without the reference
    and match the JAX classes driven the same way."""
    im, ref = smooth_image(4, *FULL_HW), smooth_image(9, 70, 50)
    out = tdemos.demo_global_histogram(
        im, ref, weights=weight_files["global"]["npz"], Xd=XD, device="cpu")
    assert set(out) == {"auto", "with_ref", "glob_dist", "gray"}
    assert out["auto"].shape == out["with_ref"].shape == FULL_HW + (3,)
    assert not np.array_equal(out["auto"], out["with_ref"])
    assert out["glob_dist"].shape == (313,)
    jm = japi.ColorizeImageJaxCaffeGlobDist(Xd=XD)
    jm.prep_net(0, caffemodel_path=weight_files["global"]["npz"])
    jm.load_image_array(im)
    zeros = np.zeros((2, XD, XD)), np.zeros((1, XD, XD))
    jm.net_forward(*zeros, out["glob_dist"])
    _held(out["with_ref"], jm.get_img_fullres())
    res = tdemos.demo_local_hints(
        im, weights=weight_files["main"]["caffemodel"], Xd=XD, device="cpu")
    assert set(res) == {"auto", "gray", "hint1", "hint1_input",
                        "hint1_mask", "hint2"}
    assert all(v.shape == FULL_HW + (3,) for v in res.values())
    assert not np.array_equal(res["auto"], res["hint1"])
    res2 = tdemos.demo_local_hints(im, Xd=XD, backend="siggraph",
                                   device="cpu")
    assert res2["auto"].shape == FULL_HW + (3,)
