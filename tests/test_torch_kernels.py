"""Port kernels K1 (hint rasterizer) and K2 (Lab -> uint8 compose) against
the JAX package, on the CPU.

On a CPU tensor each wrapper runs its kernel's plain version, so these tests
hold that plain version to the JAX function and to the Pallas kernel run in
interpret mode (as tests/test_pallas_resize.py runs it). The CUDA kernels
themselves are held to the same plain versions on the card by
chip_smoke.py. Inputs are made from a seed with numpy.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ideepcolor_tpu.ops import colorspace as jcs
from ideepcolor_tpu.ops import hints as jhints
from ideepcolor_tpu.ops.pallas import colorspace_kernel as jck
from ideepcolor_tpu.ops.pallas import hints_kernel as jhk
from ideepcolor_tpu_torch.ops import hints as thints
from ideepcolor_tpu_torch.ops.cuda import build
from ideepcolor_tpu_torch.ops.cuda import colorspace_kernel as tck
from ideepcolor_tpu_torch.ops.cuda import hints_kernel as thk

torch.set_num_threads(1)


def _table(seed, n, size, max_r=7, edge=False):
    rng = np.random.default_rng(seed)
    M = jhints.MAX_HINTS
    boxes = np.zeros((M, 4), np.int32)
    vals = np.zeros((M, 2), np.float32)
    lo, hi = (-10, size + 10) if edge else (0, size)
    for i in range(M):                 # dead slots hold junk too
        y, x = rng.integers(lo, hi, 2)
        r = rng.integers(0, max_r)
        boxes[i] = [y - r, x - r, y + r, x + r]
        vals[i] = rng.uniform(-100, 100, 2)
    return boxes, vals, n


# count 0, a few, overlapping, boxes across every edge, count M, count > M
K1_CASES = [(1, 0, 64, 7, False), (2, 9, 256, 7, False),
            (3, 60, 64, 12, False), (4, 40, 64, 9, True),
            (5, 256, 64, 5, True), (6, 300, 32, 3, True)]


@pytest.mark.parametrize("seed,n,size,max_r,edge", K1_CASES)
def test_k1_plain_bitexact_vs_jax_and_pallas(seed, n, size, max_r, edge):
    boxes, vals, n = _table(seed, n, size, max_r, edge)
    ab_t, m_t = thints.rasterize_hints(torch.from_numpy(boxes),
                                       torch.from_numpy(vals), n, size)
    args = (jnp.asarray(boxes), jnp.asarray(vals), jnp.int32(n))
    ab_j, m_j = jhints.rasterize_hints(*args, size=size)
    ab_p, m_p = jhk.rasterize_hints_pallas(*args, size=size, tile=32)
    for ab, m in ((ab_j, m_j), (ab_p, m_p)):
        assert np.array_equal(ab_t.numpy(), np.asarray(ab))
        assert np.array_equal(m_t.numpy(), np.asarray(m))
    assert ab_t.shape == (size, size, 2) and m_t.shape == (size, size, 1)


def test_k1_wrapper_layouts_on_cpu():
    """The wrapper's planar (3,S,S) output and its JAX-layout views carry
    exactly the plain version's values."""
    boxes, vals, n = _table(11, 30, 64)
    b, v = torch.from_numpy(boxes), torch.from_numpy(vals)
    planes = thk.rasterize_hints_planar(b, v, n, 64)
    ab, m = thk.rasterize_hints_cuda(b, v, n, 64)
    ab_ref, m_ref = thints.rasterize_hints(b, v, n, 64)
    assert planes.shape == (3, 64, 64) and planes.is_contiguous()
    assert torch.equal(planes[:2].permute(1, 2, 0), ab_ref)
    assert torch.equal(ab, ab_ref) and torch.equal(m, m_ref)


def _lab(seed, H, W, ab_range=80):
    rng = np.random.default_rng(seed)
    l = rng.uniform(0, 100, (H, W, 1)).astype(np.float32)
    ab = rng.uniform(-ab_range, ab_range, (H, W, 2)).astype(np.float32)
    return l, ab


def _lsb(got, want):
    d = np.abs(got.astype(int) - want.astype(int))
    return d.max(), np.mean(d != 0)


@pytest.mark.parametrize("H,W", [(5, 7), (100, 128), (64, 64)])
def test_k2_plain_vs_jax_compose(H, W):
    """<= 1 LSB on < 1e-3 of the pixels, against the Pallas kernel
    (interpret) and against ops.colorspace.lab_to_rgb_u8 -- the bar of
    tests/test_pallas_resize.py. Measured: 1 LSB on 8e-5 of the pixels at
    most."""
    l, ab = _lab(H * W, H, W)
    got = tck.compose_frame_u8(torch.from_numpy(l), torch.from_numpy(ab))
    assert got.shape == (H, W, 3) and got.dtype == torch.uint8
    got = got.numpy()
    pallas = np.asarray(jck.compose_frame_u8(jnp.asarray(l), jnp.asarray(ab)))
    jnp_ref = np.asarray(jcs.lab_to_rgb_u8(
        jnp.concatenate([jnp.asarray(l), jnp.asarray(ab)], -1)))
    for want in (pallas, jnp_ref):
        worst, share = _lsb(got, want)
        assert worst <= 1 and share < 1e-3


def test_k2_white_point_follows_the_jax_click_not_pallas():
    """The accepted deviation from the Pallas kernel: K2 takes the JAX
    click's f32 XYZ->RGB inverse, so the white point (L=100, ab=0) gives
    G=255, as the JAX click's jnp compose does, where the Pallas kernel's
    float64 inverse gives 254."""
    l = np.full((4, 4, 1), 100.0, np.float32)
    ab = np.zeros((4, 4, 2), np.float32)
    got = tck.compose_frame_u8(torch.from_numpy(l),
                               torch.from_numpy(ab)).numpy()
    pallas = np.asarray(jck.compose_frame_u8(jnp.asarray(l), jnp.asarray(ab)))
    jnp_ref = np.asarray(jcs.lab_to_rgb_u8(
        jnp.concatenate([jnp.asarray(l), jnp.asarray(ab)], -1)))
    assert np.array_equal(got, jnp_ref)
    assert (got[..., 1] == 255).all() and (pallas[..., 1] == 254).all()


def test_k2_planar_signature_and_strided_planes():
    """lab_to_rgb_u8_planar keeps the JAX (3,H,W) signature; planes read
    through strides give the frame of contiguous planes."""
    l, ab = _lab(3, 33, 17)
    lt, abt = torch.from_numpy(l), torch.from_numpy(ab)
    planar = tck.lab_to_rgb_u8_planar(lt[..., 0].contiguous(),
                                      abt[..., 0].contiguous(),
                                      abt[..., 1].contiguous())
    want = np.asarray(jck.lab_to_rgb_u8_planar(
        jnp.asarray(l[..., 0]), jnp.asarray(ab[..., 0]),
        jnp.asarray(ab[..., 1]), tile=8))[:, :33]
    assert planar.shape == (3, 33, 17)
    worst, share = _lsb(planar.numpy(), want)
    assert worst <= 1 and share < 1e-3
    assert torch.equal(tck.lab_to_rgb_u8_hwc(lt[..., 0], abt[..., 0],
                                             abt[..., 1]),
                       planar.permute(1, 2, 0))


class _OnCuda:
    """A CPU tensor that reports a CUDA device: what a wrapper sees when it
    is handed a card tensor."""

    device = torch.device("cuda", 0)

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


def test_wrappers_raise_on_cuda_without_kernel(monkeypatch):
    """On a CUDA tensor a wrapper launches its kernel or raises; with no
    toolkit to build the kernel it raises instead of returning the plain
    result."""
    monkeypatch.setattr(build, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("no nvcc")))
    for k in (thk.KERNEL, tck.KERNEL):
        monkeypatch.setattr(k, "_fn", None)
        monkeypatch.setattr(k, "library_path",
                            lambda: build.BUILD_DIR / "missing.so")
    boxes, vals, n = _table(1, 3, 16)
    before = (thk.KERNEL.launches, tck.KERNEL.launches)
    with pytest.raises(RuntimeError, match="nvcc"):
        thk.rasterize_hints_planar(_OnCuda(torch.from_numpy(boxes)),
                                   _OnCuda(torch.from_numpy(vals)), n, 16)
    plane = _OnCuda(torch.zeros(4, 4))
    with pytest.raises(RuntimeError, match="nvcc"):
        tck.lab_to_rgb_u8_hwc(plane, plane, plane)
    assert (thk.KERNEL.launches, tck.KERNEL.launches) == before


def test_wrappers_reject_bad_inputs_before_launch():
    cuda = lambda t: _OnCuda(t)  # noqa: E731
    with pytest.raises(ValueError, match="int32"):
        thk.rasterize_hints_planar(cuda(torch.zeros(4, 4)),
                                   cuda(torch.zeros(4, 2)), 1, 8)
    with pytest.raises(ValueError, match="float32"):
        p = cuda(torch.zeros(4, 4, dtype=torch.float64))
        tck.lab_to_rgb_u8_hwc(p, p, p)
    with pytest.raises(ValueError, match="one CUDA device"):
        tck.lab_to_rgb_u8_hwc(cuda(torch.zeros(4, 4)), torch.zeros(4, 4),
                              torch.zeros(4, 4))
