"""The port's training forward (outputs and every gradient) and losses
against the JAX package's on the CPU, on numpy-seeded inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ideepcolor_tpu.models import siggraph as jsig
from ideepcolor_tpu.ops.quantize import make_pts_grid
from ideepcolor_tpu.train import losses as jlosses
from ideepcolor_tpu_torch.models import siggraph as tsig
from ideepcolor_tpu_torch.train import losses as tlosses

torch.set_num_threads(2)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def jax_params(width, seed=3):
    """JAX init params (HWIO) with BatchNorm statistics and biases moved off
    their identity values, so every gradient is exercised."""
    rng = np.random.default_rng(seed)
    p = {k: np.asarray(v) for k, v in
         jsig.init_params(jax.random.key(seed), width=width).items()}
    for k, v in p.items():
        if k.endswith("running_mean") or k.endswith("bias"):
            p[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        elif k.endswith("running_var") or (v.ndim == 1
                                           and k.endswith("weight")):
            p[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return p


def inputs(seed, n=2, s=32):
    rng = np.random.default_rng(seed)
    A = rng.uniform(-50, 50, (n, s, s, 1)).astype(np.float32)
    mask = (rng.random((n, s, s, 1)) < 0.1).astype(np.float32)
    B = (rng.uniform(-100, 100, (n, s, s, 2)) * mask).astype(np.float32)
    return A, B, mask


def _port_grads(p, A, B, M, r_reg, r_log, dtype):
    tp = {k: v.detach().to(dtype).requires_grad_(True) for k, v in
          tsig.train_params(tsig.state_dict_from_params(p), "cpu").items()}
    c = lambda x: nchw(x).to(dtype)  # noqa: E731
    reg, logits = tsig.forward_train(tp, c(A), c(B), c(M), 0.5, "highest")
    (reg * c(r_reg)).sum().add((logits * c(r_log)).sum()).backward()
    return tp, reg, logits


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("width,size", [(0.25, 64), (1.0, 32)])
def test_forward_train_and_every_gradient_match_jax(width, size):
    """Outputs and the gradient w.r.t. every parameter, BatchNorm's running
    statistics included, within 1e-4 of the tensor's largest magnitude, f32
    against f32 (measured: 3.6e-6 and 2.1e-6).

    A ReLU input that lies within f32 rounding of 0 may fall on the other
    side in one of two f32 runs, which moves the gradients upstream of it
    by about 1e-2 (seen on 3 of 18 seeded inputs, in the port's f32 run
    against its own f64 run as much as against JAX): these inputs have no
    such ReLU, which the port's f64 gradients confirm to 1e-4."""
    p = jax_params(width, seed=4)
    A, B, M = inputs(2, s=size)
    rng = np.random.default_rng(9)
    r_reg = rng.normal(size=(2, size, size, 2)).astype(np.float32)
    r_log = rng.normal(size=(2, size // 4, size // 4, 529)).astype(
        np.float32)

    def jloss(params):
        reg, logits = jsig.apply_train(params, A, B, M, 0.5, "highest")
        return jnp.sum(reg * r_reg) + jnp.sum(logits * r_log), (reg, logits)

    (_, (jreg, jlog)), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()})
    tp, reg, logits = _port_grads(p, A, B, M, r_reg, r_log, torch.float32)
    assert not any("num_batches_tracked" in k for k in tp)
    assert reg.shape == (2, 2, size, size)
    assert logits.shape == (2, 529, size // 4, size // 4)
    assert _rel(nhwc(reg), jreg) <= 1e-4
    assert _rel(nhwc(logits), jlog) <= 1e-4
    want = tsig.state_dict_from_params(
        {k: np.asarray(v) for k, v in jgrad.items()})
    assert {k for k in want if "num_batches" not in k} == set(tp)
    worst = max(_rel(tp[k].grad, want[k]) for k in tp)
    assert worst <= 1e-4, worst
    for k in tp:
        if k.endswith(("running_mean", "running_var")):
            assert float(tp[k].grad.abs().max()) > 0.0, k
    t64, _, _ = _port_grads(p, A, B, M, r_reg, r_log, torch.float64)
    assert max(_rel(tp[k].grad, t64[k].grad) for k in tp) <= 1e-4


def test_forward_train_agrees_with_the_serving_module():
    """The flat-dict forward is the nn.Module's: out_reg equal, the module's
    dist map the softmax of logits x 0.2, nearest-upsampled."""
    sd = tsig.init_state_dict(0.25, seed=2)
    A, B, M = (nchw(x) for x in inputs(4))
    reg, logits = tsig.forward_train(tsig.train_params(sd, "cpu"), A, B, M,
                                     0.0, "highest")
    net = tsig.SIGGRAPHGenerator.from_state_dict(sd)
    with torch.no_grad():
        reg2, dist = net(A, B, M, dist=True, dist_lowres=True)
    assert torch.allclose(reg * 110.0, reg2, rtol=0, atol=1e-3)
    assert torch.allclose(torch.softmax(logits * 0.2, 1), dist, atol=1e-6)


def test_losses_match_jax():
    """smooth_l1 and psnr to 1e-6 relative, class_xent (NCHW logits, the
    529-point grid, nn=10, sigma=5) to 1e-5."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(2, 8, 8, 2)).astype(np.float32) * 2
    b = rng.normal(size=(2, 8, 8, 2)).astype(np.float32) * 2
    assert np.isclose(float(tlosses.smooth_l1(nchw(a), nchw(b))),
                      float(jlosses.smooth_l1(a, b)), rtol=1e-6)
    logits = rng.normal(size=(2, 4, 4, 529)).astype(np.float32)
    ab = rng.uniform(-100, 100, (2, 4, 4, 2)).astype(np.float32)
    centers = make_pts_grid().astype(np.float32)
    want = float(jlosses.class_xent(logits, ab, jnp.asarray(centers)))
    got = float(tlosses.class_xent(nchw(logits), nchw(ab),
                                   torch.from_numpy(centers)))
    assert np.isclose(got, want, rtol=1e-5)
    x = rng.integers(0, 256, (4, 5, 3)).astype(np.uint8)
    y = rng.integers(0, 256, (4, 5, 3)).astype(np.uint8)
    assert np.isclose(float(tlosses.psnr(torch.from_numpy(x),
                                         torch.from_numpy(y))),
                      float(jlosses.psnr(x, y)), rtol=1e-6)
