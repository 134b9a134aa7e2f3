"""The port's global color-statistics extractor
(``models/global_stats.py``) against the JAX package's, on the CPU, on
seeded images: the 313-bin histogram within 1e-6 with its argmax equal; the
mean saturation and the BGR means within 2e-5. The means of the two
packages differ by how each sums f32: on a flat image of 0.8 the JAX mean is
0.79999226 and the port's 0.80000013 (measured 7.9e-6 apart, the largest
seen), so 1e-6 holds for the histogram only."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ideepcolor_tpu.models import global_stats as jstats
from ideepcolor_tpu_torch.models import global_stats as tstats

from _torch_caffe import smooth_image

torch.set_num_threads(2)


def _images():
    rng = np.random.default_rng(23)
    flat = np.zeros((32, 32, 3), np.float32)
    flat[:] = (0.8, 0.3, 0.1)
    gray = np.repeat(rng.random((32, 48, 1)).astype(np.float32), 3, -1)
    return {"smooth": smooth_image(3, 64, 64).astype(np.float32) / 255.0,
            "noise": rng.random((32, 40, 3)).astype(np.float32),
            "flat": flat, "gray": gray,
            "black": np.zeros((16, 16, 3), np.float32)}


@pytest.mark.parametrize("kind", ["smooth", "noise", "flat", "gray", "black"])
def test_extract_matches_jax(kind):
    rgb = _images()[kind]
    want = jstats.extract(jnp.asarray(rgb))
    got = tstats.extract(rgb, device="cpu")
    assert set(got) == set(want)
    assert tuple(got["glob_ab_313"].shape) == (313,)
    assert tuple(got["bgr_avg"].shape) == (3,) and got["s_avg"].dim() == 0
    for key, bound in (("glob_ab_313", 1e-6), ("s_avg", 2e-5),
                       ("bgr_avg", 2e-5)):
        assert np.abs(got[key].numpy()
                      - np.asarray(want[key])).max() <= bound, key
    assert int(got["glob_ab_313"].argmax()) == \
        int(np.asarray(want["glob_ab_313"]).argmax())
    assert float(got["glob_ab_313"].sum()) == pytest.approx(1.0, abs=1e-5)
    if kind in ("gray", "black"):
        assert float(got["s_avg"]) == 0.0


def test_extract_takes_a_tensor_where_it_lies():
    rgb = _images()["smooth"]
    a = tstats.extract(torch.from_numpy(rgb))
    b = tstats.extract(rgb, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["glob_ab_313"].device.type == "cpu"
    assert np.allclose(a["bgr_avg"].numpy(), rgb.mean((0, 1))[::-1],
                       atol=1e-6)


def test_extract_without_a_card_raises_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError):
        tstats.extract(_images()["flat"])
