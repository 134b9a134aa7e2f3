"""config.py of the port against the JAX package's: ``validate`` accepts
and refuses the same configs, ``make_backend`` builds the same role of
class for each of the five backends with the same Xd and Xfullres_max and
one click's output within the API's bounds on shared weights,
``temp_point`` reaches the Caffe dist net's ``scale_T``, and
``bundled_weights`` resolves the same paths."""

import os

import numpy as np
import pytest
import torch

from ideepcolor_tpu import api as japi
from ideepcolor_tpu import config as jconfig
from ideepcolor_tpu_torch import api as tapi
from ideepcolor_tpu_torch import config as tconfig
from ideepcolor_tpu_torch.models import caffe_net as tcaffe
from ideepcolor_tpu_torch.ops.hints import points_json_to_table, put_point

from _torch_caffe import jax_params_from_state_dict, smooth_image

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDENT = os.path.join(ROOT, "weights", "student_w025.npz")
ROLES = {japi.ColorizeImageJax: tapi.ColorizeImageTorch,
         japi.ColorizeImageJaxDist: tapi.ColorizeImageTorchDist,
         japi.ColorizeImageJaxCaffe: tapi.ColorizeImageTorchCaffe,
         japi.ColorizeImageJaxCaffeDist: tapi.ColorizeImageTorchCaffeDist,
         japi.ColorizeImageJaxCaffeGlobDist:
             tapi.ColorizeImageTorchCaffeGlobDist}


@pytest.mark.parametrize("fields,ok", [
    ({}, True),
    ({"backend": "caffe", "variant": "global", "Xd": 32}, True),
    ({"serve_dtype": "bfloat16", "dist": True}, True),
    ({"backend": "tensorflow"}, False),
    ({"variant": "local"}, False),
    ({"serve_dtype": "float16"}, False),
    ({"Xd": 100}, False),
])
def test_validate_accepts_and_refuses_what_jax_does(fields, ok):
    jcfg, tcfg = jconfig.ColorizeConfig(**fields), tconfig.ColorizeConfig(
        **fields)
    assert {f: getattr(tcfg, f) for f in vars(tcfg)} == {
        f: getattr(jcfg, f) for f in vars(jcfg)}
    if ok:
        assert jcfg.validate() is jcfg and tcfg.validate() is tcfg
        return
    with pytest.raises(AssertionError):
        jcfg.validate()
    with pytest.raises(ValueError):   # a check that raises, not an assert
        tcfg.validate()


@pytest.fixture(scope="module")
def caffe_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("cfg_caffe")
    out = {}
    for variant in ("main", "dist", "global"):
        sd = tcaffe.init_state_dict(variant, seed=13, calibrate=True)
        out[variant] = str(root / f"{variant}.npz")
        np.savez(out[variant], **jax_params_from_state_dict(sd, variant))
    return out


def _hints(xd):
    ab = np.zeros((2, xd, xd), np.float32)
    mask = np.zeros((1, xd, xd), np.float32)
    put_point(ab, mask, [xd // 2, xd // 3], 2, [35.0, -40.0])
    return ab, mask


def _frames_close(got, want, share):
    d = np.abs(got.astype(int) - want.astype(int)).max(-1)
    assert d.max() <= 1 and np.mean(d != 0) < share, (d.max(),
                                                      np.mean(d != 0))


@pytest.mark.parametrize("fields", [
    {"Xd": 64},
    {"Xd": 64, "dist": True},
    {"backend": "caffe", "variant": "main", "Xd": 32,
     "Xfullres_max": 500},
    {"backend": "caffe", "variant": "dist", "Xd": 32, "temp_point": 1.7},
    {"backend": "caffe", "variant": "global", "Xd": 32},
], ids=["siggraph", "siggraph_dist", "caffe_main", "caffe_dist",
        "caffe_global"])
def test_make_backend_matches_jax(fields, caffe_files):
    """The same class role, Xd and Xfullres_max; one dense click on shared
    weights within the API's bounds (SIGGRAPH frames 1 LSB on < 1% of the
    pixels, as tests/test_torch_api.py; Caffe 1 LSB on < 5e-3, as
    tests/test_torch_caffe_api.py; the dist regression output within 1e-2
    of 110^2-scaled ab and the map within 1e-5)."""
    ckpt = (caffe_files[fields["variant"]] if fields.get("backend")
            == "caffe" else STUDENT)
    jm = jconfig.make_backend(jconfig.ColorizeConfig(checkpoint=ckpt,
                                                     **fields))
    tm = tconfig.make_backend(tconfig.ColorizeConfig(checkpoint=ckpt,
                                                     **fields), device="cpu")
    assert type(tm) is ROLES[type(jm)]
    assert (tm.Xd, tm.Xfullres_max) == (jm.Xd, jm.Xfullres_max)
    assert tm.device.type == "cpu"
    img = smooth_image(9, 50, 70)
    jm.load_image_array(img)
    tm.load_image_array(img)
    want, got = jm.net_forward(*_hints(jm.Xd)), tm.net_forward(
        *_hints(tm.Xd))
    if fields.get("dist"):
        assert np.abs(got - np.asarray(want)).max() <= 1e-2
        assert np.abs(tm.dist_ab - np.asarray(jm.dist_ab)).max() <= 1e-5
        return
    share = 5e-3 if fields.get("backend") == "caffe" else 1e-2
    _frames_close(got, np.asarray(want), share)
    if fields.get("variant") == "dist":
        assert float(tm.net.scale_T.scale) == pytest.approx(1.7)
        assert float(jm.params["scale_T.scale"]) == pytest.approx(1.7)
        assert float(tm.net.scale_S.scale) == pytest.approx(0.2)


def test_temp_point_moves_the_caffe_dist_frame(caffe_files):
    """scale_T is the annealed mean's temperature: another temp_point,
    another frame, on the port as on JAX."""
    frames = []
    for temp in (2.6, 0.5):
        m = tconfig.make_backend(tconfig.ColorizeConfig(
            backend="caffe", variant="dist", Xd=32, temp_point=temp,
            checkpoint=caffe_files["dist"]), device="cpu")
        m.load_image_array(smooth_image(9, 32, 32))
        frames.append(m.net_forward(*_hints(32)))
    assert not np.array_equal(*frames)


def test_make_backend_bf16_and_table_click():
    """serve_dtype="bfloat16" reaches prep_net(dtype=) (convs stored in
    bf16), and the built model serves table clicks."""
    m = tconfig.make_backend(tconfig.ColorizeConfig(
        Xd=64, checkpoint=STUDENT, serve_dtype="bfloat16"), device="cpu")
    assert m.net.model1[0].weight.dtype == torch.bfloat16
    m.load_image_array(smooth_image(2, 64, 64))
    out = m.net_forward_table(*points_json_to_table(
        [{"y": 5, "x": 6, "ab": [10, 20]}], 64))
    assert out.shape == (64, 64, 3) and out.dtype == np.uint8


@pytest.mark.parametrize("name", ["teacher", "student_w05", "student_w025",
                                  "no_such_checkpoint"])
def test_bundled_weights_same_paths(name):
    assert tconfig.bundled_weights(name) == jconfig.bundled_weights(name)
    assert bool(tconfig.bundled_weights(name)) == (name !=
                                                   "no_such_checkpoint")


def test_default_backend_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tconfig.make_backend(tconfig.ColorizeConfig(Xd=64,
                                                    checkpoint=STUDENT))
