"""Carrying the SIGGRAPH U-Net's weights across: JAX params -> the port's
nn.Module, held to JAX ``siggraph.apply`` (both heads) on the CPU in f32."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ideepcolor_tpu.models import layers as jL
from ideepcolor_tpu.models import siggraph as jsig
from ideepcolor_tpu_torch.models import layers as tL
from ideepcolor_tpu_torch.models import siggraph as tsig

torch.set_num_threads(2)
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "weights")
STUDENT = os.path.join(WEIGHTS, "student_w025.npz")


def _inputs(seed, n=1, s=64):
    rng = np.random.default_rng(seed)
    A = rng.uniform(-50, 50, (n, s, s, 1)).astype(np.float32)
    mask = (rng.random((n, s, s, 1)) < 0.05).astype(np.float32)
    B = (rng.uniform(-100, 100, (n, s, s, 2)) * mask).astype(np.float32)
    return A, B, mask


def _both(params, A, B, M, maskcent=0.0):
    """JAX runs in f32 (f16 storage cast up, as its checkpoint loader does);
    the port's conversion gets the params as stored."""
    want = np.asarray(jsig.apply({k: jnp.asarray(v, jnp.float32) for k, v in
                                  params.items()}, A, B, M, maskcent,
                                 dist=False))
    net = tsig.SIGGRAPHGenerator.from_state_dict(
        tsig.state_dict_from_params(params))
    nchw = lambda x: torch.from_numpy(x).permute(0, 3, 1, 2)  # noqa: E731
    with torch.no_grad():
        got = net(nchw(A), nchw(B), nchw(M), maskcent)
    return got.permute(0, 2, 3, 1).numpy(), want


@pytest.mark.parametrize("source,maskcent", [("init_w0125", 0.0),
                                             ("student_w025", 0.5)])
def test_unet_matches_jax_apply(source, maskcent):
    """max |d ab| <= 1e-3 at Xd=64 (measured: 4.4e-5 for the random init,
    3.0e-5 for the trained student)."""
    if source == "student_w025":
        with np.load(STUDENT) as z:
            params = {k: z[k] for k in z.files}      # HWIO, stored as f16
    else:
        params = {k: np.asarray(v) for k, v in
                  jsig.init_params(jax.random.key(4), width=0.125).items()}
    A, B, M = _inputs(1)
    got, want = _both(params, A, B, M, maskcent)
    assert got.shape == want.shape == (1, 64, 64, 2)
    assert np.max(np.abs(got - want)) <= 1e-3


def test_deconv_weights_round_trip_exactly():
    """The deconv's flipped HWIO comes back to torch's (I, O, H, W) exactly,
    and matches the JAX package's own inverse converter; a plain transpose
    would not."""
    rng = np.random.default_rng(2)
    w_torch = rng.standard_normal((16, 8, 4, 4)).astype(np.float32)
    hwio = np.asarray(jL.torch_convT_to_hwio(w_torch))
    assert np.array_equal(tL.torch_convT_to_hwio(w_torch), hwio)
    back = tL.hwio_to_torch_convT(hwio)
    assert np.array_equal(back, w_torch)
    assert np.array_equal(back, jL.hwio_to_torch_convT(hwio))
    assert not np.array_equal(hwio.transpose(2, 3, 0, 1), w_torch)
    w = rng.standard_normal((8, 4, 3, 3)).astype(np.float32)
    assert np.array_equal(tL.hwio_to_torch_conv(tL.torch_conv_to_hwio(w)), w)


def test_state_dict_matches_jax_torch_export():
    """The port's conversion of the student equals the JAX package's own
    to_torch_state_dict, tensor for tensor."""
    with np.load(STUDENT) as z:
        params = {k: z[k].astype(np.float32) for k in z.files}
    ours = tsig.state_dict_from_params(params)
    theirs = jsig.to_torch_state_dict(params)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        assert np.array_equal(ours[k].numpy(), np.asarray(v)), k


def test_loader_takes_both_layouts_and_pth(tmp_path):
    """An .npz in HWIO or in torch layout, and a .pth, give one state dict;
    the f16 storage is cast to f32."""
    ref = tsig.load_state_dict_file(STUDENT)
    assert all(v.dtype in (torch.float32, torch.int64) for v in ref.values())
    with np.load(STUDENT) as z:
        torch_layout = jsig.to_torch_state_dict(
            {k: z[k].astype(np.float32) for k in z.files})
    np.savez(tmp_path / "oihw.npz", **torch_layout)
    torch.save({k: torch.from_numpy(np.asarray(v))
                for k, v in torch_layout.items()}, tmp_path / "sd.pth")
    for path in (tmp_path / "oihw.npz", tmp_path / "sd.pth"):
        got = tsig.load_state_dict_file(str(path))
        assert set(got) == set(ref)
        for k in ref:
            assert torch.equal(got[k], ref[k]), (path, k)
    with pytest.raises(ValueError, match="unsupported"):
        tsig.load_state_dict_file(str(tmp_path / "x.ckpt"))


def test_legacy_pre04_pth_loads_like_jax(tmp_path):
    """The pre-0.4 state-dict layout (no num_batches_tracked keys, the
    legacy non-zipfile pickle) loads to the modern file's state dict, and
    the JAX loader reads the same weights from it."""
    from ideepcolor_tpu.api import colorize as jcolorize
    sd = tsig.init_state_dict(width=0.125, seed=4)
    modern, legacy = tmp_path / "modern.pth", tmp_path / "legacy.pth"
    torch.save(sd, modern)
    torch.save({k: v for k, v in sd.items()
                if "num_batches_tracked" not in k}, legacy,
               _use_new_zipfile_serialization=False)
    a = tsig.load_state_dict_file(str(modern))
    b = tsig.load_state_dict_file(str(legacy))
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    params = jsig.params_from_state_dict(
        jcolorize._load_checkpoint(str(legacy)))
    back = tsig.state_dict_from_params(
        {k: np.asarray(v) for k, v in params.items()})
    for k in a:
        assert torch.equal(back[k], a[k]), k


def test_teacher_loads_strictly_at_full_width():
    """The bundled teacher (98 arrays, 34.2 M parameters) loads with
    strict=True into the full-width module, model_class included."""
    sd = tsig.load_state_dict_file(os.path.join(WEIGHTS, "teacher.npz"))
    net = tsig.SIGGRAPHGenerator.from_state_dict(sd)
    n = sum(p.numel() for p in net.parameters())
    assert 34.0e6 < n < 34.5e6
    assert net.model_class[0].out_channels == 529
    assert net.model8up[0].weight.shape == (512, 256, 4, 4)


def test_random_init_is_seeded_and_runs():
    a = tsig.init_state_dict(width=0.125, seed=3)
    b = tsig.init_state_dict(width=0.125, seed=3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    net = tsig.SIGGRAPHGenerator.from_state_dict(a)
    A, B, M = (torch.from_numpy(x).permute(0, 3, 1, 2) for x in _inputs(5))
    with torch.no_grad():
        out = net(A, B, M)
    assert out.shape == (1, 2, 64, 64) and torch.isfinite(out).all()
    assert out.abs().max() <= 110.0


def _params(source):
    if source == "student_w025":
        with np.load(STUDENT) as z:
            return {k: z[k] for k in z.files}        # HWIO, stored as f16
    return {k: np.asarray(v) for k, v in
            jsig.init_params(jax.random.key(4), width=0.125).items()}


@pytest.mark.parametrize("dist_lowres", [True, False])
@pytest.mark.parametrize("source", ["init_w0125", "student_w025"])
def test_dist_head_matches_jax_apply(source, dist_lowres):
    """forward(dist=True) at Xd=64: the 529-bin map within 1e-5 of JAX's
    (measured 2.1e-9 for the random init, 6.7e-8 for the student, whose
    largest p is 0.067: the softmax of logits x 0.2 flattens differences),
    rows sum to 1 within 1e-5 (measured 1.0e-6), at H/4 when dist_lowres and its x4 nearest repeat otherwise.
    reg2 is the double-110 quirk: exactly 110 x the non-dist output of the
    same module, and within 110 x the U-Net's 1e-3 of JAX's (measured
    5.6e-3 and 3.2e-3)."""
    params = _params(source)
    A, B, M = _inputs(3)
    want_reg, want_cl = (np.asarray(x) for x in jsig.apply(
        {k: jnp.asarray(v, jnp.float32) for k, v in params.items()},
        A, B, M, 0.0, dist=True, dist_lowres=dist_lowres))
    net = tsig.SIGGRAPHGenerator.from_state_dict(
        tsig.state_dict_from_params(params))
    nchw = lambda x: torch.from_numpy(x).permute(0, 3, 1, 2)  # noqa: E731
    with torch.no_grad():
        reg2, cl = net(nchw(A), nchw(B), nchw(M), 0.0, dist=True,
                       dist_lowres=dist_lowres)
        reg = net(nchw(A), nchw(B), nchw(M), 0.0)
    side = 16 if dist_lowres else 64
    assert cl.shape == (1, 529, side, side) and reg2.shape == (1, 2, 64, 64)
    got_cl = cl.permute(0, 2, 3, 1).numpy()
    assert got_cl.shape == want_cl.shape
    assert np.abs(got_cl - want_cl).max() <= 1e-5
    assert np.abs(got_cl.sum(-1) - 1.0).max() <= 1e-5
    assert torch.equal(reg2, reg * 110.0)
    assert reg2.abs().max() > 110.0                   # really scaled twice
    assert np.abs(reg2.permute(0, 2, 3, 1).numpy() - want_reg).max() \
        <= 110 * 1e-3
    if not dist_lowres:
        with torch.no_grad():
            _, low = net(nchw(A), nchw(B), nchw(M), 0.0, dist=True,
                         dist_lowres=True)
        assert torch.equal(cl[:, :, 1::4, 2::4], low)
