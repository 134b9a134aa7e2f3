"""Port kernels K1 (hint rasterizer), K2 (Lab -> uint8 compose, and its
fused click entry with the requantized ab) and K3 (the global color
statistics) against the JAX package, on the CPU.

On a CPU tensor each wrapper runs its kernel's plain version, so these tests
hold that plain version to the JAX function and to the Pallas kernel run in
interpret mode (as tests/test_pallas_resize.py runs it). The CUDA kernels
themselves are held to the same plain versions on the card by
chip_smoke.py; what the wrappers decide before a launch (K2's load modes,
input checks) is tested here. Inputs are made from a seed with numpy.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ideepcolor_tpu.engine import pipeline as jP
from ideepcolor_tpu.ops import colorspace as jcs
from ideepcolor_tpu.ops import hints as jhints
from ideepcolor_tpu.ops.pallas import colorspace_kernel as jck
from ideepcolor_tpu.ops.pallas import hints_kernel as jhk
from ideepcolor_tpu_torch.models import global_stats as tstats
from ideepcolor_tpu_torch.ops import colorspace as tcs
from ideepcolor_tpu_torch.ops import hints as thints
from ideepcolor_tpu_torch.ops.cuda import build
from ideepcolor_tpu_torch.ops.cuda import colorspace_kernel as tck
from ideepcolor_tpu_torch.ops.cuda import global_stats_kernel as tgk
from ideepcolor_tpu_torch.ops.cuda import hints_kernel as thk
from ideepcolor_tpu_torch.ops.quantize import soft_encode

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


@pytest.mark.parametrize("H,W", [(5, 7), (100, 128), (64, 64)])
def test_k2_fused_entry_plain_vs_jax_click(H, W):
    """The fused click entry's CPU path against the JAX click's two outputs,
    compose_rgb_u8 then requantized_ab: frame <= 1 LSB on < 1e-3 of the
    pixels, ab within 1e-3 where the frames agree."""
    l, ab = _lab(H * W + 1, H, W, ab_range=110)
    lt, abt = torch.from_numpy(l), torch.from_numpy(ab)
    rgb, out_ab = tck.lab_to_rgb_u8_ab(lt[..., 0], abt[..., 0], abt[..., 1])
    assert rgb.shape == (H, W, 3) and rgb.dtype == torch.uint8
    assert out_ab.shape == (H, W, 2) and out_ab.dtype == torch.float32
    rgb_j = jP.compose_rgb_u8(jnp.asarray(l), jnp.asarray(ab))
    ab_j = np.asarray(jP.requantized_ab(rgb_j))
    rgb_j = np.asarray(rgb_j)
    d = np.abs(rgb.numpy().astype(int) - rgb_j.astype(int)).max(-1)
    assert d.max() <= 1 and np.mean(d != 0) < 1e-3
    same = d == 0
    assert np.abs(out_ab.numpy() - ab_j).max(-1)[same].max() <= 1e-3
    assert torch.equal(rgb, tck.lab_to_rgb_u8_hwc(lt[..., 0], abt[..., 0],
                                                  abt[..., 1]))


def test_k2_srgb_lut_is_the_plain_dequantization():
    """The fused entry's table holds, for each uint8 value, exactly what
    requantized_ab computes for it before the 3x3."""
    v = torch.arange(256, dtype=torch.uint8)
    lut = tck.srgb_lut(torch.device("cpu"))
    assert lut.shape == (256,) and lut.dtype == torch.float32
    assert torch.equal(lut, tcs.srgb_to_linear(v.to(torch.float32) / 255.0))
    assert tck.srgb_lut(torch.device("cpu")) is lut


def _planes(case):
    """(L, a, b) CPU planes of one layout, and the load modes K2 takes for
    its compose and its fused entry."""
    V, A, Z = tck.VEC, tck.ANY, tck.ZERO
    H, W = 6, 10                                   # W not a multiple of 4
    lab = torch.rand(H, W, 3)
    l = lab[..., 0].contiguous()
    ab = lab[..., 1:].permute(2, 0, 1).contiguous()
    if case == "contiguous":
        return (l, ab[0], ab[1]), (V, V), (V, V)
    if case == "stride-2 ab":
        hwc = lab[..., 1:].contiguous()
        return (l, hwc[..., 0], hwc[..., 1]), (V, A), (A, A)
    if case == "stride-3 L":
        return (lab[..., 0], ab[0], ab[1]), (A, A), (A, A)
    if case == "stride-0 ab":
        zero = torch.zeros(()).expand(H, W)
        return (l, zero, zero), (V, Z), (A, A)
    if case == "misaligned a":                     # 4 bytes off 16
        a = torch.empty(H * W + 4)[1:H * W + 1].view(H, W)
        return (l, a, ab[1]), (V, A), (A, A)
    if case == "planar ab, odd plane size":        # b starts at 15 * 4 B
        ab = torch.rand(2, 3, 5)
        return (torch.rand(3, 5), ab[0], ab[1]), (V, A), (A, A)
    if case == "row crop, drift 2":
        # rows 12 elements apart, the output's 10: a 4-aligned output group
        # is not 16-byte aligned in these planes on every row
        big = torch.rand(3, H, W + 2)
        return (big[0, :, :W], big[1, :, :W], big[2, :, :W]), (A, A), (A, A)
    if case == "row crop, drift 4":
        big = torch.rand(3, H, W + 4)
        return (big[0, :, :W], big[1, :, :W], big[2, :, :W]), (V, V), (V, V)
    raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "contiguous", "stride-2 ab", "stride-3 L", "stride-0 ab", "misaligned a",
    "planar ab, odd plane size", "row crop, drift 2", "row crop, drift 4"])
def test_k2_load_modes_follow_strides_and_alignment(case):
    """K2's wrapper picks the kernel instantiation from the planes' strides
    and alignment: float4 loads only where every full group of four
    pixels lands on 16 bytes, one load of a stride-0 plane, scalar loads
    otherwise; a scalar-load L takes (ANY, ANY), and so does the fused
    entry unless all three planes take float4 loads."""
    planes, compose, fused = _planes(case)
    if case == "planar ab, odd plane size":
        assert planes[2].data_ptr() % 16 == 12
    assert tck.load_modes(*planes) == compose
    assert tck.load_modes(*planes, fused=True) == fused


class _OnCuda:
    """A CPU tensor that reports a CUDA device: what a wrapper sees when it
    is handed a card tensor."""

    device = torch.device("cuda", 0)

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


@pytest.mark.parametrize("N,size,counts", [
    (1, 64, [9]), (3, 32, [0, 40, 256]), (8, 48, [0, 1, 5, 60, 255, 256,
                                                   300, -2])])
def test_k1_batch_plain_bitexact_vs_jax_vmap(N, size, counts):
    """The batched entry's plain version (and so the wrapper on CPU tensors)
    against ``jax.vmap(rasterize_hints)``, the batch engine's rasterize in
    the JAX package: bit-exact, counts past M and below 0 included."""
    tabs = [_table(20 + i, counts[i], size, 9, edge=True) for i in range(N)]
    boxes = np.stack([t[0] for t in tabs])
    vals = np.stack([t[1] for t in tabs])
    cnt = np.asarray(counts, np.int32)
    got = thk.rasterize_hints_batch(torch.from_numpy(boxes),
                                    torch.from_numpy(vals),
                                    torch.from_numpy(cnt), size)
    assert got.shape == (N, 3, size, size) and got.dtype == torch.float32
    ab_j, m_j = jax.vmap(
        lambda b, v, c: jhints.rasterize_hints(b, v, c, size=size))(
        jnp.asarray(boxes), jnp.asarray(vals), jnp.asarray(cnt))
    assert np.array_equal(got[:, :2].permute(0, 2, 3, 1).numpy(),
                          np.asarray(ab_j))
    assert np.array_equal(got[:, 2:].permute(0, 2, 3, 1).numpy(),
                          np.asarray(m_j))
    assert torch.equal(got, thk.rasterize_hints_batch_plain(
        torch.from_numpy(boxes), torch.from_numpy(vals),
        torch.from_numpy(cnt), size))


@pytest.mark.parametrize("n", [0, 7, 256])
def test_k1_count_as_tensor_equals_count_as_int(n):
    """A captured program hands K1 its count as a one-element int32
    tensor; on the CPU that is the plain version with the same result."""
    boxes, vals, _ = _table(31, n, 64)
    b, v = torch.from_numpy(boxes), torch.from_numpy(vals)
    want = thk.rasterize_hints_planar(b, v, n, 64)
    got = thk.rasterize_hints_planar(b, v, torch.tensor([n],
                                                        dtype=torch.int32), 64)
    assert torch.equal(got, want)


@pytest.mark.parametrize("N,H,W", [(1, 5, 7), (4, 32, 32), (3, 33, 17)])
def test_k2_batch_plain_vs_jax_batched_compose(N, H, W):
    """The batched compose on the CPU against ``lab_to_rgb_u8`` of the
    (N,H,W,3) Lab batch, what the JAX batch engine composes with: <= 1 LSB
    on < 1e-3 of the values; each frame equals the single-frame entry's."""
    rng = np.random.default_rng(N * H * W)
    l = rng.uniform(0, 100, (N, 1, H, W)).astype(np.float32)
    ab = rng.uniform(-110, 110, (N, 2, H, W)).astype(np.float32)
    lt, abt = torch.from_numpy(l), torch.from_numpy(ab)
    got = tck.lab_to_rgb_u8_batch(lt[:, 0], abt[:, 0], abt[:, 1])
    assert got.shape == (N, H, W, 3) and got.dtype == torch.uint8
    want = np.asarray(jcs.lab_to_rgb_u8(jnp.asarray(
        np.concatenate([l, ab], 1).transpose(0, 2, 3, 1))))
    worst, share = _lsb(got.numpy(), want)
    assert worst <= 1 and share < 1e-3
    for i in range(N):
        assert torch.equal(got[i], tck.lab_to_rgb_u8_hwc(
            lt[i, 0], abt[i, 0], abt[i, 1]))


def test_k2_batch_load_modes_follow_the_batch_stride():
    """float4 loads of a batch need every frame's plane to start on 16
    bytes relative to the output's flat index: a batch stride that drifts
    from H * W by a multiple of 4 elements."""
    V, A, Z = tck.VEC, tck.ANY, tck.ZERO
    N, H, W = 3, 6, 8
    l = torch.rand(N, 1, H, W)
    ab = torch.rand(N, 2, H, W)                   # batch stride 2 * H * W
    assert tck.load_modes(l[:, 0], ab[:, 0], ab[:, 1]) == (V, V)
    hwc = torch.rand(N, H, W, 2)
    assert tck.load_modes(l[:, 0], hwc[..., 0], hwc[..., 1]) == (V, A)
    zero = torch.zeros(()).expand(N, H, W)
    assert tck.load_modes(l[:, 0], zero, zero) == (V, Z)
    odd = torch.rand(N, 2, 5, 6)                  # H * W = 30: drift 30
    assert tck.load_modes(odd[:, 0], odd[:, 0], odd[:, 1]) == (A, A)
    flat = torch.rand(N, 5, 6)                    # drift 0 whatever H * W
    assert tck.load_modes(flat, flat, flat) == (V, V)


def test_wrappers_raise_on_cuda_without_kernel(monkeypatch):
    """On a CUDA tensor a wrapper launches its kernel or raises; with no
    toolkit to build the kernel it raises instead of returning the plain
    result."""
    monkeypatch.setattr(build, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("no nvcc")))
    for k in build.KERNELS:
        monkeypatch.setattr(k, "_fn", None)
        monkeypatch.setattr(k, "library_path",
                            lambda: build.BUILD_DIR / "missing.so")
    boxes, vals, n = _table(1, 3, 16)
    before = (thk.KERNEL.launches, tck.KERNEL.launches,
              tck.KERNEL_AB.launches)
    with pytest.raises(RuntimeError, match="nvcc"):
        thk.rasterize_hints_planar(_OnCuda(torch.from_numpy(boxes)),
                                   _OnCuda(torch.from_numpy(vals)), n, 16)
    plane = _OnCuda(torch.zeros(4, 4))
    with pytest.raises(RuntimeError, match="nvcc"):
        tck.lab_to_rgb_u8_hwc(plane, plane, plane)
    with pytest.raises(RuntimeError, match="nvcc"):
        tck.lab_to_rgb_u8_ab(plane, plane, plane)
    planes = _OnCuda(torch.zeros(2, 4, 4))
    with pytest.raises(RuntimeError, match="nvcc"):
        tck.lab_to_rgb_u8_batch(planes, planes, planes)
    with pytest.raises(RuntimeError, match="nvcc"):
        thk.rasterize_hints_batch(
            _OnCuda(torch.from_numpy(boxes)[None]),
            _OnCuda(torch.from_numpy(vals)[None]),
            _OnCuda(torch.zeros(1, dtype=torch.int32)), 16)
    with pytest.raises(RuntimeError, match="nvcc"):
        tgk.global_stats(_OnCuda(torch.zeros(8, 12, 3)))
    assert thk.KERNEL_BATCH.launches == tck.KERNEL_BATCH.launches == 0
    assert tgk.KERNEL.launches == 0
    assert (thk.KERNEL.launches, tck.KERNEL.launches,
            tck.KERNEL_AB.launches) == before


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
    for entry in (tck.lab_to_rgb_u8_hwc, tck.lab_to_rgb_u8_ab):
        with pytest.raises(ValueError, match="float32"):
            p = cuda(torch.zeros(4, 4, dtype=torch.float64))
            entry(p, p, p)
        with pytest.raises(ValueError, match="one CUDA device"):
            entry(cuda(torch.zeros(4, 4)), torch.zeros(4, 4),
                  torch.zeros(4, 4))
        with pytest.raises(ValueError, match=r"\(H, W\) planes"):
            entry(cuda(torch.zeros(4, 4)), cuda(torch.zeros(4, 5)),
                  cuda(torch.zeros(4, 4)))
        with pytest.raises(ValueError, match="32-bit"):  # 65536 rows
            p = cuda(torch.zeros(()).expand(65536, 1))
            entry(p, p, p)
    with pytest.raises(ValueError, match="size"):
        thk.rasterize_hints_planar(cuda(torch.zeros(4, 4, dtype=torch.int32)),
                                   cuda(torch.zeros(4, 2)), 1, 30000)
    with pytest.raises(ValueError, match=r"\(N, H, W\) planes"):
        p = cuda(torch.zeros(4, 4))
        tck.lab_to_rgb_u8_batch(p, p, p)
    b3 = cuda(torch.zeros(2, 4, 4, dtype=torch.int32))
    v3 = cuda(torch.zeros(2, 4, 2))
    with pytest.raises(ValueError, match="counts"):
        thk.rasterize_hints_batch(b3, v3, cuda(torch.zeros(2)), 8)
    with pytest.raises(ValueError, match="counts"):
        thk.rasterize_hints_batch(
            b3, v3, cuda(torch.zeros(3, dtype=torch.int32)), 8)
    with pytest.raises(ValueError, match=r"\(N,M,4\)"):
        thk.rasterize_hints_batch(
            b3, cuda(torch.zeros(2, 5, 2)),
            cuda(torch.zeros(2, dtype=torch.int32)), 8)


@pytest.mark.parametrize("rgb,match", [
    (torch.zeros(6, 8, 3), "multiples of 4"),            # H
    (torch.zeros(8, 10, 3), "multiples of 4"),           # W
    (torch.zeros(0, 8, 3), "multiples of 4"),            # empty
    (torch.zeros(8, 8, 4), r"\(H, W, 3\)"),              # channels
    (torch.zeros(8, 8), r"\(H, W, 3\)"),
    (torch.zeros(8, 8, 3, dtype=torch.float64), "float32"),
    (torch.zeros(8, 8, 3).transpose(0, 1), "contiguous"),
    (torch.zeros(8 * 8 * 3 + 1)[1:].view(8, 8, 3), "16-byte"),
])
def test_k3_wrapper_rejects_before_launch(monkeypatch, rgb, match):
    """K3's wrapper raises on what the kernel does not take, before it
    loads the library or launches."""
    def never(*a):
        raise AssertionError("K3 reached its library")
    monkeypatch.setattr(tgk.KERNEL, "load", never)
    monkeypatch.setattr(tgk.KERNEL, "launch", never)
    before = tgk.KERNEL.launches
    with pytest.raises(ValueError, match=match):
        tgk.global_stats(_OnCuda(rgb))
    assert tgk.KERNEL.launches == before


def _stats_chain(rgb):
    """``extract``'s chain of torch ops before K3, written out."""
    rgb = rgb.to(torch.float32)
    ab = tcs.rgb_to_lab(rgb)[..., 1:]
    h, w = ab.shape[0], ab.shape[1]
    ab_rs = ab.reshape(h // 4, 4, w // 4, 4, 2).mean(dim=(1, 3))
    glob = soft_encode(ab_rs, nn=1).mean(dim=(0, 1))
    s_avg = tcs.rgb_to_hsv(rgb)[..., 1].mean()
    bgr_avg = rgb.mean(dim=(0, 1)).flip(0)
    return {"glob_ab_313": glob, "s_avg": s_avg, "bgr_avg": bgr_avg}


def _stats_input(kind):
    rng = np.random.default_rng(31)
    if kind == "noise":
        return torch.from_numpy(rng.random((32, 40, 3)).astype(np.float32))
    if kind == "ref_256":
        return torch.from_numpy(rng.random((256, 256, 3)).astype(np.float32))
    if kind == "float64":
        return torch.from_numpy(rng.random((16, 24, 3)))
    if kind == "transposed":
        return torch.from_numpy(rng.random((24, 16, 3)).astype(
            np.float32)).transpose(0, 1)
    return torch.zeros(8, 8, 3)                          # black


@pytest.mark.parametrize("kind", ["noise", "ref_256", "float64",
                                  "transposed", "black"])
def test_k3_extract_on_the_cpu_is_the_chain(kind):
    """On a CPU tensor ``extract`` (and K3's wrapper) run the plain chain:
    bit for bit the chain of torch ops that ``extract`` was before K3, on
    contiguous, transposed and float64 inputs alike."""
    rgb = _stats_input(kind)
    want = _stats_chain(rgb)
    got = tstats.extract(rgb)
    assert set(got) == set(want)
    for key in want:
        assert got[key].device.type == "cpu"
        assert got[key].dtype == torch.float32
        assert torch.equal(got[key], want[key]), key
    glob, s_avg, bgr_avg = tgk.global_stats(rgb.to(torch.float32))
    assert torch.equal(glob, want["glob_ab_313"])
    assert torch.equal(s_avg, want["s_avg"])
    assert torch.equal(bgr_avg, want["bgr_avg"])


def test_k3_grid_and_centers():
    """The partials kernel's grid follows the shape alone (a block for each
    64 pooled pixels, at most 528), and the bin centers it reads are the
    plain chain's."""
    assert tgk.blocks_for(256, 256) == 64
    assert tgk.blocks_for(4, 4) == 1
    assert tgk.blocks_for(1000, 752) == 528
    c = tgk.bin_centers(torch.device("cpu"))
    assert c is tgk.bin_centers(torch.device("cpu"))      # made once
    assert c.dtype == torch.float32 and tuple(c.shape) == (313, 2)
    assert c.is_contiguous()
    one_hot = soft_encode(c[None], nn=1)[0]
    assert torch.equal(one_hot.argmax(1), torch.arange(313))
