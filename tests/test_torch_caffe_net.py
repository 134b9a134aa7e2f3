"""The port's Caffe graphs (``models/caffe_net.py``) against the JAX
package's, on the CPU: weights made from a seed with numpy go into both (the
port's state dict as it is, the JAX params after the relayout to HWIO), and
the same seeded blobs through ``apply_main`` / ``apply_dist`` /
``apply_global`` at 32 and 64 pixels (the widths are the prototxts').

Two inits are held. The plain He init, which is what ``prep_net`` without a
path gives in both packages, saturates ``tanh`` almost everywhere; the
calibrated one (``init_state_dict(calibrate=True)``) has outputs spread over
[-100, 100]. Either way the last-bit differences of 30 f32 convs reach the
output at its scale of 100, and the plain init, whose pre-tanh values are
tens of units, amplifies them most on the few pixels that cross tanh's
middle. So the 1e-3 that holds for the SIGGRAPH net holds here for the mean,
not the maximum. Measured max |d ab| (mean) over two seeds and both sizes:
plain init 1.3e-2 (3.1e-5), calibrated 2.9e-3 (2.4e-4) main, 5.7e-3 global,
4.4e-3 dist ``pred_ab``. Bounds: max 5e-2, about 2e-4 of the output's range
(a wrong layer gives units to tens), and mean 1e-3; the distribution map
<= 1e-5 in both inits (measured 9.2e-7)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ideepcolor_tpu.models import caffe_net as jcaffe
from ideepcolor_tpu_torch.models import caffe_net as tcaffe
from ideepcolor_tpu_torch.models.caffe_net import CaffeColorNet

from _torch_caffe import blob, jax_params_from_state_dict

torch.set_num_threads(2)
VARIANTS = ("main", "dist", "global")
AB_MAX_BOUND, AB_MEAN_BOUND, MAP_BOUND = 5e-2, 1e-3, 1e-5


@pytest.fixture(scope="module")
def nets():
    out = {}
    for variant in VARIANTS:
        for calibrate in (False, True):
            sd = tcaffe.init_state_dict(variant, seed=3, calibrate=calibrate)
            params = {k: jnp.asarray(v) for k, v in
                      jax_params_from_state_dict(sd, variant).items()}
            out[variant, calibrate] = (
                CaffeColorNet.from_state_dict(sd, variant), params)
    return out


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _held(got, want):
    d = np.abs(got - want)
    assert d.max() <= AB_MAX_BOUND and d.mean() <= AB_MEAN_BOUND, \
        (d.max(), d.mean())


def _glob(n, seed=5):
    rng = np.random.default_rng(seed)
    g = np.zeros((n, 314), np.float32)
    for i in range(n):
        bins = rng.integers(0, 313, 9)
        g[i, bins] = rng.random(9)
        g[i, :313] /= g[i, :313].sum()
        g[i, 313] = 1.0
    return g


@pytest.mark.parametrize("variant", VARIANTS)
def test_layer_tables_and_state_dict_keys_are_the_jax_params(variant):
    """The same layers, in the same order, with the same shapes after the
    relayout; ``ab_conv1_1`` absent in the global graph."""
    assert tcaffe._convs_for(variant) == jcaffe._convs_for(variant)
    assert [n for n, _ in tcaffe._bns_for(variant)] == \
        jcaffe._bns_for(variant)
    jparams = jcaffe.init_params(jax.random.key(0), variant)
    sd = tcaffe.init_state_dict(variant)
    assert set(sd) == set(jparams)
    assert set(CaffeColorNet(variant).state_dict()) == set(jparams)
    assert ("ab_conv1_1.weight" in sd) == (variant != "global")
    relaid = jax_params_from_state_dict(sd, variant)
    for key, value in jparams.items():
        assert relaid[key].shape == value.shape, key
        if key.endswith((".bias", ".mean", ".var", ".scale")):
            assert np.array_equal(relaid[key], np.asarray(value)), key


@pytest.mark.parametrize("variant", VARIANTS)
def test_state_dict_from_params_carries_jax_weights_across(variant):
    """JAX ``init_params`` -> the port's state dict -> back: the same
    arrays; an already torch-layout dict passes through unchanged; the
    variant is read off the keys."""
    jparams = {k: np.asarray(v) for k, v in
               jcaffe.init_params(jax.random.key(2), variant).items()}
    sd = tcaffe.state_dict_from_params(jparams)
    assert tcaffe.variant_of(sd) == tcaffe.variant_of(jparams) == variant
    back = jax_params_from_state_dict(sd, variant)
    for key, value in jparams.items():
        assert np.array_equal(back[key], value), key
    again = tcaffe.state_dict_from_params({k: v.numpy()
                                           for k, v in sd.items()})
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert sd["conv8_1.weight"].shape == (512, 256, 4, 4)      # IOHW
    assert sd["conv1_2.weight"].shape == (64, 64, 3, 3)        # OIHW
    CaffeColorNet.from_state_dict(sd)                # strict load


@pytest.mark.parametrize("calibrate", [False, True])
@pytest.mark.parametrize("size", [32, 64])
def test_apply_main_matches_jax(nets, calibrate, size):
    net, params = nets["main", calibrate]
    x = blob(size, 2, size)
    with torch.no_grad():
        got = _nhwc(net.apply_main(_nchw(x)))
    want = np.asarray(jcaffe.apply_main(params, jnp.asarray(x)))
    assert got.shape == want.shape == (2, size, size, 2)
    _held(got, want)
    assert np.abs(want).max() <= 100.0 + 1e-4
    # the plain init saturates tanh; the calibrated one uses its middle
    assert (np.median(np.abs(want)) < 95.0) == calibrate


@pytest.mark.parametrize("calibrate", [False, True])
def test_apply_dist_matches_jax(nets, calibrate):
    """(pred_ab, dist_S): the map bins-last as in JAX, rows summing to 1;
    ``dist_map`` is ``apply_dist``'s second output."""
    net, params = nets["dist", calibrate]
    x = blob(7, 1, 32)
    with torch.no_grad():
        pred, dist = net.apply_dist(_nchw(x))
        only_map = net.dist_map(_nchw(x))
    jpred, jdist = jcaffe.apply_dist(params, jnp.asarray(x))
    assert tuple(dist.shape) == jdist.shape == (1, 32, 32, 313)
    assert np.abs(dist.numpy() - np.asarray(jdist)).max() <= MAP_BOUND
    assert np.abs(dist.numpy().sum(-1) - 1).max() <= 1e-5
    _held(_nhwc(pred), np.asarray(jpred))
    assert torch.equal(only_map, dist)


@pytest.mark.parametrize("calibrate", [False, True])
def test_apply_global_matches_jax(nets, calibrate):
    """With a histogram, with the all-zero blob, and with ``s_avg_mask``
    given; the calibrated net's output must move with the histogram."""
    net, params = nets["global", calibrate]
    x = blob(9, 2, 32)
    g = _glob(2)
    s = np.array([[0.4, 1.0], [0.1, 1.0]], np.float32)
    outs = []
    for glob, sat in ((g, None), (np.zeros_like(g), None), (g, s)):
        with torch.no_grad():
            got = _nhwc(net.apply_global(
                _nchw(x), torch.from_numpy(glob),
                None if sat is None else torch.from_numpy(sat)))
        want = np.asarray(jcaffe.apply_global(
            params, jnp.asarray(x), jnp.asarray(glob),
            None if sat is None else jnp.asarray(sat)))
        _held(got, want)
        outs.append(got)
    if calibrate:
        assert np.abs(outs[0] - outs[1]).mean() > 1.0
        assert np.abs(outs[0] - outs[2]).mean() > 1e-3
    with torch.no_grad():       # forward() is the variant's own apply
        assert torch.equal(net(_nchw(x), torch.from_numpy(g)),
                           net.apply_global(_nchw(x), torch.from_numpy(g)))


def test_make_blob_matches_jax():
    rng = np.random.default_rng(1)
    l = rng.uniform(-50, 50, (16, 16, 1)).astype(np.float32)
    ab = rng.uniform(-80, 80, (16, 16, 2)).astype(np.float32)
    m = (rng.random((16, 16, 1)) < 0.2).astype(np.float32)
    want = np.asarray(jcaffe.make_blob(jnp.asarray(l), jnp.asarray(ab),
                                       jnp.asarray(m)))
    chw = lambda a: torch.from_numpy(a).permute(2, 0, 1)  # noqa: E731
    got = tcaffe.make_blob(chw(l), chw(ab), chw(m))
    assert tuple(got.shape) == (1, 4, 16, 16)
    assert np.array_equal(_nhwc(got), want)
    assert tcaffe.make_blob(chw(l)[None], chw(ab)[None],
                            chw(m)[None], 2.0).shape == (1, 4, 16, 16)


def test_init_state_dict_is_seeded_numpy_he_init():
    """The same seed gives the same bytes, another seed other weights; conv
    weights have the He standard deviation; scales are the prototxts'."""
    a = tcaffe.init_state_dict("dist", seed=4)
    b = tcaffe.init_state_dict("dist", seed=4)
    c = tcaffe.init_state_dict("dist", seed=5)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv4_2.weight"], c["conv4_2.weight"])
    w = a["conv4_2.weight"]
    assert abs(float(w.std()) / np.sqrt(2.0 / (512 * 9)) - 1) < 0.01
    w = a["conv5_pred.weight"]                     # deconv: fan-in is dim 0
    assert abs(float(w.std()) / np.sqrt(2.0 / (512 * 16)) - 1) < 0.01
    assert float(a["scale_S.scale"]) == pytest.approx(0.2)
    assert float(a["scale_T.scale"]) == pytest.approx(2.6)
    assert float(tcaffe.init_state_dict("main")["pred_ab.scale"]) == 100.0
    assert all(float(v.abs().max()) == 0 for k, v in a.items()
               if k.endswith((".bias", ".mean")))


def test_calibrated_init_sets_every_batchnorm_and_is_deterministic():
    """``calibrate=True`` leaves no BatchNorm at the identity statistics,
    the histogram MLP's included, and gives the same bytes every time."""
    sd = tcaffe.init_state_dict("global", seed=6, calibrate=True)
    for name, channels in tcaffe._bns_for("global"):
        mean, var = sd[f"{name}.mean"], sd[f"{name}.var"]
        assert mean.shape == var.shape == (channels,)
        assert float(var.min()) >= 0 and float(mean.abs().max()) > 0, name
        assert not torch.equal(var, torch.ones(channels)), name
    assert all(torch.equal(v, w) for v, w in zip(
        sd.values(), tcaffe.init_state_dict("global", seed=6,
                                            calibrate=True).values()))


def test_pred_ab_scale_is_a_stored_factor():
    sd = tcaffe.init_state_dict("main", seed=3)
    net = CaffeColorNet.from_state_dict(sd)
    x = _nchw(blob(1, 1, 32))
    with torch.no_grad():
        base = net.apply_main(x)
        net.pred_ab.scale.fill_(50.0)
        assert torch.allclose(net.apply_main(x), base * 0.5, atol=1e-5)


def test_bf16_apply_main_matches_jax_bf16(nets):
    """``cast_weights_("bfloat16")`` against the JAX package's bf16 model
    (every param cast; activations rounded to bf16 between layers, which
    the port's convs reproduce and its f32 BatchNorm and tanh do not).
    Measured on the calibrated net at 32 px: max |d ab| 3.0 against JAX
    bf16, mean 0.30; against the port's own f32 output max 10.9, mean 0.73
    (JAX bf16 against f32: 9.1 and 0.76). Bounds: max 10 and mean 1 against
    JAX bf16, max 30 and mean 3 against f32 (a wrong layer gives a mean of
    tens)."""
    net, params = nets["main", True]
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    bf = CaffeColorNet.from_state_dict(sd).cast_weights_("bfloat16")
    assert bf.conv4_2.weight.dtype == torch.bfloat16
    assert bf.conv4_3norm.var.dtype == torch.float32
    x = blob(11, 1, 32)
    with torch.no_grad():
        got = _nhwc(bf.apply_main(_nchw(x)))
        f32 = _nhwc(net.apply_main(_nchw(x)))
    jparams = {k: v.astype(jnp.bfloat16) for k, v in params.items()}
    want = np.asarray(jcaffe.apply_main(jparams, jnp.asarray(x)).astype(
        jnp.float32))
    assert got.dtype == np.float32
    d = np.abs(got - want)
    assert d.max() <= 10.0 and d.mean() <= 1.0, (d.max(), d.mean())
    d = np.abs(got - f32)
    assert d.max() <= 30.0 and d.mean() <= 3.0, (d.max(), d.mean())
    assert net.conv4_2.weight.dtype == torch.float32     # a copy was cast


def test_unknown_variant_and_foreign_checkpoint_raise():
    with pytest.raises(ValueError):
        CaffeColorNet("siggraph")
    with pytest.raises(ValueError):
        tcaffe.variant_of({"model1.0.weight": 0})
