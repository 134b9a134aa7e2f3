"""The port's ``.caffemodel`` reader, converter and encoder
(``models/caffemodel_io.py``) against the JAX package's, on the CPU: the
same bytes, written by the JAX package's encoders in the modern
(``LayerParameter``) and the V1 (``V1LayerParameter``, legacy blob dims)
forms, parsed by both give equal arrays; the port's encoders write the same
bytes; and a whole main graph loaded from one file by each package computes
the same output (bounds of ``tests/test_torch_caffe_net.py``: max 5e-2,
mean 1e-3; measured max 2.6e-3)."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ideepcolor_tpu.models import caffe_net as jcaffe
from ideepcolor_tpu.models import caffemodel_io as jio
from ideepcolor_tpu_torch.models import caffe_net as tcaffe
from ideepcolor_tpu_torch.models import caffemodel_io as tio

from _torch_caffe import blob

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _layers(variant, seed=8, calibrate=False):
    """{caffe layer name: blobs} of a whole graph in Caffe's own layouts,
    from the port's seeded init (with seeded BatchNorm statistics, or the
    calibrated ones): conv (O,I,kh,kw) and deconv (I,O,kh,kw) weights with
    biases, BatchNorm as (sum, sumsq, count) with a count of 4, the scale
    layers, and structural layers to skip."""
    sd = tcaffe.init_state_dict(variant, seed=seed, calibrate=calibrate)
    if not calibrate:
        rng = np.random.default_rng(seed)
        for name, channels in tcaffe._bns_for(variant):
            sd[f"{name}.mean"] = torch.from_numpy(
                rng.normal(0, 1, channels).astype(np.float32))
            sd[f"{name}.var"] = torch.from_numpy(
                rng.uniform(0.5, 2, channels).astype(np.float32))
    layers = {}
    for name, *_ in tcaffe._convs_for(variant):
        layers[name] = [sd[f"{name}.weight"].numpy(),
                        sd[f"{name}.bias"].numpy()]
    for name, _ in tcaffe._bns_for(variant):
        layers[name] = [sd[f"{name}.mean"].numpy() * 4.0,
                        sd[f"{name}.var"].numpy() * 4.0,
                        np.array([4.0], np.float32)]
    for name, _ in tcaffe._SCALES[variant]:
        layers[name] = [np.array([float(sd[f"{name}.scale"]) * 0.5],
                                 np.float32)]
    layers["conv1_2norm_ss"] = [np.ones((64, 1, 1, 1), np.float32)]
    layers["pred_313_us"] = [np.ones((313, 1, 4, 4), np.float32)]
    return sd, layers


# a slice of a graph that has every kind of layer: the wire-format tests need
# no more (a whole graph is 130 MB of bytes through a pure-Python scanner)
_SOME = ("bw_conv1_1", "conv1_2", "conv4_2", "conv8_1", "conv1_2norm",
         "conv8_3norm", "conv1_2norm_ss", "pred_313_us")


def _some(variant):
    sd, layers = _layers(variant)
    extra = {"main": ("conv10_ab", "conv9_2norm", "pred_ab"),
             "dist": ("conv4_pred", "pred_313", "scale_S", "scale_T"),
             "global": ("glob_conv1", "s_conv1", "glob_conv4norm",
                        "pred_ab")}[variant]
    return sd, {k: layers[k] for k in _SOME + extra}


def _specs(layers):
    return [{"name": n, "type": "Convolution", "blobs": b,
             "bottom": ["data"], "top": [n], "lr_mults": [1.0, 2.0]}
            for n, b in layers.items()] + [
        {"name": "relu1", "type": "ReLU", "blobs": []}]


@pytest.mark.parametrize("form", ["layer", "netparameter", "v1"])
def test_the_same_bytes_parse_to_equal_arrays_in_both_packages(form):
    _, layers = _some("dist")
    if form == "layer":
        raw = jio.encode_caffemodel(layers)
    else:
        raw = jio.encode_netparameter(_specs(layers), net_name="colornet",
                                      v1=(form == "v1"))
    want, got = jio.parse_caffemodel(raw), tio.parse_caffemodel(raw)
    assert list(got) == list(want) == list(layers)   # blob-less layers skipped
    for name, blobs in want.items():
        assert len(got[name]) == len(blobs) == len(layers[name])
        for g, w, src in zip(got[name], blobs, layers[name]):
            assert g.shape == w.shape and np.array_equal(g, w), name
            assert np.array_equal(g.ravel(), src.ravel()), name
    if form == "v1":                 # legacy dims: 4-D, leading ones
        assert got["conv1_2"][1].shape == (1, 1, 1, 64)


def test_the_ports_encoders_write_the_jax_packages_bytes():
    _, layers = _layers("main")
    small = {k: layers[k] for k in ("bw_conv1_1", "conv8_1", "conv1_2norm",
                                    "pred_ab")}
    assert tio.encode_caffemodel(small) == jio.encode_caffemodel(small)
    for v1 in (False, True):
        assert tio.encode_netparameter(_specs(small), "n", v1=v1) == \
            jio.encode_netparameter(_specs(small), "n", v1=v1)
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    assert tio.encode_blob(a) == jio.encode_blob(a)
    assert tio.encode_blob_legacy(a) == jio.encode_blob_legacy(a)


@pytest.mark.parametrize("variant", ["main", "dist", "global"])
def test_convert_gives_the_state_dict_without_a_flip(variant):
    """Caffe's blob layouts are torch's: the converted state dict is the one
    the file was written from. BatchNorm's triplet is divided by its stored
    count; the scale layers are read; '_ss' / '_us' layers are skipped; the
    result loads strictly."""
    sd, layers = _some(variant)
    got = tio.convert_to_params(
        tio.parse_caffemodel(tio.encode_caffemodel(layers)), variant)
    assert set(got) == set(sd)
    init = tcaffe.init_state_dict(variant)
    for key, value in sd.items():
        if key.split(".")[0] not in layers:     # not in the file: the init
            assert torch.equal(got[key], init[key]), key
        elif key.endswith(".scale"):
            assert float(got[key]) == pytest.approx(float(value) * 0.5)
        elif key.endswith((".mean", ".var")):
            assert torch.allclose(got[key], value, rtol=1e-6, atol=0), key
        else:
            assert torch.equal(got[key], value), key
    tcaffe.CaffeColorNet.from_state_dict(got, variant)


def test_batchnorm_scale_of_zero_reads_as_one_and_missing_layers_keep_init():
    layers = {"conv1_2norm": [np.full(64, 3.0, np.float32),
                              np.full(64, 5.0, np.float32),
                              np.zeros(1, np.float32)],
              "conv2_2norm": [np.full(128, 3.0, np.float32),
                              np.full(128, 5.0, np.float32)],
              "conv1_1": [np.ones((64, 1, 3, 3), np.float32)],
              "glob_conv2norm": [np.ones(512, np.float32)] * 3}
    got = tio.convert_to_params(layers, "main")
    assert float(got["conv1_2norm.mean"][0]) == 3.0
    assert float(got["conv1_2norm.var"][0]) == 5.0
    assert float(got["conv2_2norm.var"][0]) == 5.0
    init = tcaffe.init_state_dict("main")
    assert set(got) == set(init)            # nothing foreign was added
    assert torch.equal(got["bw_conv1_1.weight"], init["bw_conv1_1.weight"])
    want = jio.convert_to_params(layers, "main")
    assert float(want["conv1_2norm.var"][0]) == 5.0


def test_load_caffemodel_and_forward_match_jax(tmp_path):
    """One file, written by the JAX package's encoder in the V1 form, loaded
    by each package's ``load_caffemodel``, one forward each."""
    _, layers = _layers("main", calibrate=True)
    path = str(tmp_path / "main.caffemodel")
    with open(path, "wb") as f:
        f.write(jio.encode_netparameter(_specs(layers), v1=True))
    params = jio.load_caffemodel(path, "main")
    net = tcaffe.CaffeColorNet.from_state_dict(
        tio.load_caffemodel(path, "main"))
    assert float(net.pred_ab.scale) == 50.0
    x = blob(3, 1, 32)
    with torch.no_grad():
        got = net.apply_main(torch.from_numpy(x).permute(0, 3, 1, 2)
                             ).permute(0, 2, 3, 1).numpy()
    want = np.asarray(jcaffe.apply_main(params, jnp.asarray(x)))
    d = np.abs(got - want)
    assert d.max() <= 5e-2 and d.mean() <= 1e-3, (d.max(), d.mean())
    assert np.abs(want).max() <= 50.0 + 1e-4
