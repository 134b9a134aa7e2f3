"""The port's drop-in root (``ideepcolor_tpu_torch/compat``) against the JAX
package's (the repository root's ``data/`` and ``caffe.py``).

The reference's code patterns of ``tests/test_reference_compat.py`` -- the
local-hints notebook, ``lab_gamut``, the global-histogram notebook with
``import caffe`` -- plus a ``ColorizeImageTorch`` session run verbatim in two
child processes: one with the port's drop-in root first on ``sys.path``
(asking for the CPU the reference's way, ``gpu_id=-1``), one with the
repository root first (the JAX drop-in). Seeded PNG images stand in for the
reference's test images, and both children read the same weight files: a
seeded, calibrated Caffe state of each graph written as a raw
``.caffemodel`` (both packages' ``prep_net`` parse it) and a seeded w0.25
SIGGRAPH net as a torch-layout ``.npz``. The two packages' seeded nets
differ, so weights travel by file.

Bounds: Caffe frames <= 1 LSB on < 1e-2 of a frame's pixels and
``output_ab`` within 1e-3 where the frames agree (the ``CAFFE_*`` bounds of
the port's Caffe tests); the global histogram within 1e-6 with the same
argmax (``tests/test_torch_global_stats.py``); SIGGRAPH frames <= 1 LSB on
< 1e-3 of the pixels; ``lab_gamut`` equal. A full-res frame fused from a
net frame is held to the share alone (see ``_fused_share``). In-process cases pin where the
port's drop-in differs from the JAX one: the device contract of
``gpu_id`` and ``caffe.io`` without OpenCV."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ideepcolor_tpu_torch import api, compat
from ideepcolor_tpu_torch.compat import caffe as tcaffe
from ideepcolor_tpu_torch.compat.data import colorize_image as TCI
from ideepcolor_tpu_torch.compat.data import lab_gamut as tgamut
from ideepcolor_tpu_torch.models import caffe_net, caffemodel_io, siggraph
from ideepcolor_tpu_torch.utils.imageio import encode_png

from _torch_caffe import smooth_image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPAT = os.path.join(ROOT, "ideepcolor_tpu_torch", "compat")
CAFFE_LSB, CAFFE_SHARE, CAFFE_AB = 1, 1e-2, 1e-3
SIGGRAPH_SHARE = 1e-3
GLOB_BOUND = 1e-6
SEED = 13
PORT_CLASSES = {"ColorizeImageTorch": "ColorizeImageTorch",
                "ColorizeImageTorchDist": "ColorizeImageTorchDist",
                "ColorizeImageCaffe": "ColorizeImageTorchCaffe",
                "ColorizeImageCaffeDist": "ColorizeImageTorchCaffeDist",
                "ColorizeImageCaffeGlobDist":
                    "ColorizeImageTorchCaffeGlobDist"}

# the reference's patterns (tests/test_reference_compat.py), with the seeded
# weight files for the missing caffemodels and GPU for the gpu_id
_PATTERNS = r'''
import json, sys
root, GPU, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
sys.path.insert(0, root)
import numpy as np
try:        # OpenCV's own arithmetic, which the port's resizes copy
    import cv2
    cv2.ipp.setUseIPP(False)
except ImportError:
    pass
IMG = "./test_imgs/mortar_pestle.jpg"
res = {}

# the local-hints notebook
from data import colorize_image as CI

colorModel = CI.ColorizeImageCaffe(Xd=64)
colorModel.prep_net(
    GPU, './models/reference_model/deploy_nodist.prototxt', 'main.caffemodel')
colorModel.load_image(IMG)

mask = np.zeros((1, 64, 64))
input_ab = np.zeros((2, 64, 64))
img_out = colorModel.net_forward(input_ab, mask)
assert img_out.shape == (64, 64, 3)
res["auto"], res["auto_ab"] = img_out.copy(), colorModel.output_ab.copy()

img_gray_fullres = colorModel.get_img_gray_fullres()
img_out_fullres = colorModel.get_img_fullres()
assert img_out_fullres.shape == img_gray_fullres.shape
res["gray_fullres"], res["auto_fullres"] = img_gray_fullres, img_out_fullres

def put_point(input_ab, mask, loc, p, val):
    # verbatim from the notebook (cell 7)
    input_ab[:, loc[0] - p:loc[0] + p + 1, loc[1] - p:loc[1] + p + 1] \
        = np.array(val)[:, np.newaxis, np.newaxis]
    mask[:, loc[0] - p:loc[0] + p + 1, loc[1] - p:loc[1] + p + 1] = 1
    return (input_ab, mask)

(input_ab, mask) = put_point(input_ab, mask, [33, 40], 3, [23, -69])
img_out = colorModel.net_forward(input_ab, mask)
mask_fullres = colorModel.get_img_mask_fullres()
img_in_fullres = colorModel.get_input_img_fullres()
img_out_fullres2 = colorModel.get_img_fullres()
assert not np.array_equal(img_out_fullres, img_out_fullres2)
assert mask_fullres.shape == img_in_fullres.shape
res["hinted"], res["hinted_ab"] = img_out.copy(), colorModel.output_ab.copy()
res["hinted_fullres"], res["mask_fullres"] = img_out_fullres2, mask_fullres
res["input_fullres"] = img_in_fullres

# lab_gamut
from data import lab_gamut
snapped = lab_gamut.snap_ab(50.0, np.array([255, 0, 0], np.uint8))
assert snapped.dtype == np.uint8
grid = lab_gamut.abGrid(gamut_size=110, D=1)
rgb, m = grid.update_gamut(50.0)
assert m.shape == (221, 221)
res["snapped"], res["gamut_rgb"], res["gamut_mask"] = snapped, rgb, m

# the global-histogram notebook
import os
import caffe

ref_dir = "./test_imgs/global_ref_bird"
Xd = 64
cid = CI.ColorizeImageCaffeGlobDist(Xd)
cid.prep_net(GPU, prototxt_path='./models/global_model/'
             'deploy_nodist.prototxt', caffemodel_path='global.caffemodel')
gt_glob_net = caffe.Net('./models/global_model/global_stats.prototxt',
                        './models/global_model/dummy.caffemodel',
                        caffe.TEST)
cid.load_image(IMG)
input_ab = np.zeros((2, Xd, Xd))
input_mask = np.zeros((1, Xd, Xd))
img_pred_auto = cid.net_forward(input_ab, input_mask)
res["glob_auto"], res["glob_auto_ab"] = (img_pred_auto.copy(),
                                         cid.output_ab.copy())

ref_path = os.path.join(ref_dir, sorted(os.listdir(ref_dir))[0])
ref_img_fullres = caffe.io.load_image(ref_path)
img_glob_dist = (255 * caffe.io.resize_image(
    ref_img_fullres, (256, 256))).astype('uint8')
gt_glob_net.blobs['img_bgr'].data[...] = \
    img_glob_dist[:, :, ::-1].transpose((2, 0, 1))
gt_glob_net.forward()
glob_dist_in = gt_glob_net.blobs['gt_glob_ab_313_drop'] \
    .data[0, :-1, 0, 0].copy()

assert abs(glob_dist_in.sum() - 1) < 1e-4
img_pred = cid.net_forward(input_ab, input_mask, glob_dist_in)
assert img_pred.shape == (Xd, Xd, 3)
assert not np.array_equal(img_pred_auto, img_pred)
res["glob_dist_in"], res["img_glob_dist"] = glob_dist_in, img_glob_dist
res["glob_pred"], res["glob_pred_ab"] = img_pred.copy(), cid.output_ab.copy()

# the reference's torch backend on a narrow SIGGRAPH net
model = CI.ColorizeImageTorch(Xd=64)
model.prep_net(GPU, path='siggraph_w025.npz')
model.load_image(IMG)
res["torch_auto"] = model.net_forward(np.zeros((2, 64, 64)),
                                      np.zeros((1, 64, 64))).copy()
(input_ab, mask) = put_point(np.zeros((2, 64, 64)), np.zeros((1, 64, 64)),
                             [20, 30], 2, [-40, 50])
res["torch_hinted"] = model.net_forward(input_ab, mask).copy()
res["torch_ab"] = model.output_ab.copy()
res["torch_fullres"] = model.get_img_fullres()

np.savez(out + ".npz", **res)
with open(out + ".json", "w") as f:
    json.dump({"files": {"data.colorize_image": CI.__file__,
                         "data.lab_gamut": lab_gamut.__file__,
                         "caffe": caffe.__file__},
               "device": str(getattr(colorModel, "device", "")),
               "jax": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "ideepcolor_tpu"))},
              f)
'''

NET_FRAMES = ("auto", "hinted", "glob_auto", "glob_pred")
INPUT_FRAMES = ("gray_fullres", "mask_fullres", "input_fullres")
FUSED_FRAMES = ("auto_fullres", "hinted_fullres")


def _write_caffemodel(path, variant):
    sd = caffe_net.init_state_dict(variant, seed=SEED, calibrate=True)
    with open(path, "wb") as f:
        f.write(caffemodel_io.encode_caffemodel(
            caffemodel_io.layers_from_state_dict(sd)))


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """The patterns in the port's child and the JAX package's, at once."""
    work = tmp_path_factory.mktemp("reference_compat")
    (work / "test_imgs" / "global_ref_bird").mkdir(parents=True)
    (work / "test_imgs" / "mortar_pestle.jpg").write_bytes(
        encode_png(smooth_image(21, 90, 120)))
    (work / "test_imgs" / "global_ref_bird" /
     "ILSVRC2012_val_00002383.JPEG").write_bytes(
        encode_png(smooth_image(22, 300, 400)))
    for variant in ("main", "global"):
        _write_caffemodel(str(work / f"{variant}.caffemodel"), variant)
    sd = siggraph.init_state_dict(0.25, seed=SEED)
    np.savez(work / "siggraph_w025.npz",
             **{k: v.numpy() for k, v in sd.items()
                if "num_batches_tracked" not in k})
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    runs = {"port": (COMPAT, -1), "jax": (ROOT, 0)}
    procs = {}
    for name, (first, gpu) in runs.items():
        # the child's own sys.path starts with ``first``; the repository
        # root follows it, for the packages themselves
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", _PATTERNS, first, str(gpu),
             str(work / name)], cwd=work, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env={**env, "PYTHONPATH": ROOT, "JAX_PLATFORMS": "cpu"})
    out = {}
    for name, p in procs.items():
        _stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, f"{name} child: {stderr[-3000:]}"
        with open(work / f"{name}.json") as f:
            report = json.load(f)
        with np.load(work / f"{name}.npz") as z:
            report.update({k: z[k] for k in z.files})
        out[name] = report
    return out


def _held(got, want, share, got_ab=None, want_ab=None):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int)).max(-1)
    assert d.max() <= CAFFE_LSB and np.mean(d != 0) < share, \
        (d.max(), np.mean(d != 0))
    if got_ab is not None:
        same = d == 0
        assert np.abs(got_ab - want_ab).max(0)[same].max() <= CAFFE_AB


def test_the_drop_ins_resolve_to_each_package(children):
    for mod, path in children["port"]["files"].items():
        assert os.path.dirname(path).startswith(COMPAT), (mod, path)
    for mod, path in children["jax"]["files"].items():
        assert not path.startswith(COMPAT), (mod, path)
        assert path.startswith(ROOT), (mod, path)


def test_no_jax_module_in_the_port_child(children):
    assert children["port"]["jax"] == []
    assert children["port"]["device"] == "cpu"
    assert "jax" in children["jax"]["jax"]          # the control


@pytest.mark.parametrize("frame", NET_FRAMES)
def test_caffe_net_frames_within_the_caffe_bounds(children, frame):
    t, j = children["port"], children["jax"]
    _held(t[frame], j[frame], CAFFE_SHARE, t[f"{frame}_ab"], j[f"{frame}_ab"])


@pytest.mark.parametrize("frame", INPUT_FRAMES)
def test_caffe_input_getters_within_the_caffe_bounds(children, frame):
    assert children["port"][frame].shape == (90, 120, 3)
    _held(children["port"][frame], children["jax"][frame], CAFFE_SHARE)


def _fused_share(got, want, share):
    """A full-res frame fuses the full-res L with the upsampled ab
    requantized from the net frame: a net byte one LSB off moves its ab by
    a few units over the pixels it covers, so only the share of pixels
    that differ is bounded here (the net frames hold the LSB bound)."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert np.mean(np.any(got != want, -1)) < share


@pytest.mark.parametrize("frame", FUSED_FRAMES)
def test_caffe_fullres_frames_within_the_share(children, frame):
    assert children["port"][frame].shape == (90, 120, 3)
    _fused_share(children["port"][frame], children["jax"][frame],
                 CAFFE_SHARE)


@pytest.mark.parametrize("name", ["snapped", "gamut_mask"])
def test_lab_gamut_equal(children, name):
    t, j = children["port"][name], children["jax"][name]
    assert t.dtype == j.dtype and np.array_equal(t, j)


def test_lab_gamut_colors_within_one_lsb(children):
    """The gamut's colors are a truncating Lab -> RGB compose: the port's
    f32 arithmetic and XLA's part in the last bit on a few cells (one at
    L=50), as ``tests/test_torch_gamut.py`` holds them."""
    t, j = children["port"]["gamut_rgb"], children["jax"]["gamut_rgb"]
    inside = children["port"]["gamut_mask"]
    d = np.abs(t.astype(int) - j.astype(int)).max(-1)
    assert d.max() <= 1 and np.mean(d[inside] != 0) < SIGGRAPH_SHARE
    assert np.array_equal(t[~inside], j[~inside])


def test_global_histogram_within_bound(children):
    t, j = children["port"], children["jax"]
    # caffe.io's resize: the port's torch arithmetic and cv2 give one image
    assert np.array_equal(t["img_glob_dist"], j["img_glob_dist"])
    assert np.abs(t["glob_dist_in"] - j["glob_dist_in"]).max() <= GLOB_BOUND
    assert t["glob_dist_in"].argmax() == j["glob_dist_in"].argmax()
    assert abs(float(t["glob_dist_in"].sum()) - 1.0) < 1e-4


@pytest.mark.parametrize("frame", ["torch_auto", "torch_hinted"])
def test_siggraph_frames_within_one_lsb(children, frame):
    _held(children["port"][frame], children["jax"][frame], SIGGRAPH_SHARE)


def test_siggraph_fullres_within_the_share(children):
    _fused_share(children["port"]["torch_fullres"],
                 children["jax"]["torch_fullres"], SIGGRAPH_SHARE)


def test_siggraph_hint_moves_the_frame(children):
    t = children["port"]
    assert not np.array_equal(t["torch_auto"], t["torch_hinted"])


# ----- where the port's drop-in differs from the JAX one (ROADMAP Queue 3)

@pytest.fixture
def no_card(monkeypatch):
    """A machine without a card, and the drop-in root's device unset."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setitem(compat._root, "device", None)


@pytest.mark.parametrize("gpu_id", [0, None])
@pytest.mark.parametrize("cls", sorted(PORT_CLASSES))
def test_prep_net_without_the_cpu_id_raises_without_a_card(no_card, cls,
                                                           gpu_id):
    """No fallback: ``None`` and any id but -1 ask for the card. (The
    reference's torch class ran on the CPU with ``gpu_id=None``: the port
    keeps the card its default.)"""
    model = getattr(TCI, cls)(Xd=32)
    with pytest.raises(RuntimeError, match="gpu_id=-1"):
        model.prep_net(gpu_id)


@pytest.mark.parametrize("cls", sorted(PORT_CLASSES))
def test_cpu_id_builds_the_model_on_the_cpu(no_card, cls):
    model = getattr(TCI, cls)(Xd=32)
    with pytest.raises(AttributeError, match="prep_net"):
        model.device                     # nothing is built before prep_net
    model.prep_net(-1)
    assert model.device == torch.device("cpu") and model.net_set
    assert compat.root_device() == torch.device("cpu")
    assert isinstance(model, getattr(api, PORT_CLASSES[cls]))


def test_gpu_ids_name_cards(monkeypatch):
    """``None`` is the current card and ``n`` is ``cuda:n``, resolved
    without touching a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert compat.device_for(None) == torch.device("cuda")
    assert compat.device_for(1) == torch.device("cuda", 1)
    assert compat.device_for(-1) == torch.device("cpu")


def test_helpers_follow_the_root_device(no_card):
    """``lab_gamut``, the transposes and ``caffe.Net`` have no ``gpu_id``:
    they run on the card until ``prep_net(-1)`` or ``set_mode_cpu``
    choose the CPU."""
    rgb = np.array([255, 0, 0], np.uint8)
    with pytest.raises(RuntimeError, match="set_mode_cpu"):
        tgamut.snap_ab(50.0, rgb)
    net = tcaffe.Net("global_stats.prototxt")
    net.blobs["img_bgr"].data[...] = smooth_image(4, 256, 256) \
        .transpose(2, 0, 1)[::-1]
    with pytest.raises(RuntimeError, match="set_mode_cpu"):
        net.forward()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcaffe.set_mode_gpu()
    tcaffe.set_mode_cpu()
    net.forward()
    glob = net.blobs["gt_glob_ab_313_drop"].data[0, :, 0, 0]
    assert abs(glob[:-1].sum() - 1) < 1e-4 and glob[-1] == 1.0
    assert tgamut.snap_ab(50.0, rgb).dtype == np.uint8
    lab = TCI.rgb2lab_transpose(smooth_image(5, 8, 8))
    assert TCI.lab2rgb_transpose(lab[:1], lab[1:]).shape == (8, 8, 3)


def test_caffe_net_emulates_only_global_stats():
    with pytest.raises(NotImplementedError):
        tcaffe.Net("./models/reference_model/deploy_nodist.prototxt")


@pytest.mark.parametrize("ipp", [True, False])
@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("shape,dims", [
    ((300, 400, 3), (256, 256)), ((512, 512, 3), (256, 256)),
    ((512, 512, 4), (256, 256)), ((100, 80, 3), (256, 256)),
    ((257, 255), (256, 256)), ((64, 96, 2), (32, 48)),
    ((64, 64, 1), (32, 48))])
def test_caffe_io_resize_is_cv2s(shape, dims, order, ipp):
    """``caffe.io.resize_image`` without OpenCV: cv2's float32
    INTER_LINEAR (2x shrinks included) and INTER_NEAREST, bit for bit with
    OpenCV's own arithmetic and to 1e-5 of the IPP path a pip cv2 takes by
    default."""
    cv2 = pytest.importorskip("cv2")
    im = np.random.default_rng(7).random(shape)
    old = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(ipp)
    try:
        want = cv2.resize(im.astype(np.float32), dims[::-1], interpolation=(
            cv2.INTER_LINEAR if order == 1 else cv2.INTER_NEAREST))
    finally:
        cv2.ipp.setUseIPP(old)
    got = tcaffe.io.resize_image(im, dims, order)
    assert got.dtype == np.float64 and got.shape == want.shape
    if ipp:
        assert np.abs(got - want).max() <= 1e-5
    else:
        assert np.array_equal(got, want)


def test_caffe_io_load_image_needs_no_cv2(tmp_path, monkeypatch):
    img = smooth_image(6, 40, 30)
    path = tmp_path / "ref.JPEG"          # a PNG: the codec sniffs it
    path.write_bytes(encode_png(img))
    monkeypatch.setitem(sys.modules, "cv2", None)      # import cv2 fails
    got = tcaffe.io.load_image(str(path))
    assert got.dtype == np.float64 and got.shape == (40, 30, 3)
    assert np.array_equal(got, img / 255.0)
