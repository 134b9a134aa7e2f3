"""The reference against the port on the CPU at small sizes: each frozen
piece against the program's plain version, both nets against the
program's modules, and whole runs of every cell with ``correct`` true."""

import numpy as np
import pytest
import torch

from conftest import SMALL
from harness import runner
from harness.spec import Cell
from reference import bins, color, hints, resize


def test_color_pieces_match_the_program():
    from ideepcolor_tpu_torch.ops import colorspace as cs
    from ideepcolor_tpu_torch.ops.cuda import colorspace_kernel as k2
    g = torch.Generator().manual_seed(0)
    rgb = torch.rand((64, 64, 3), generator=g)
    assert torch.equal(color.rgb_to_lab(rgb), cs.rgb_to_lab(rgb))
    lab = cs.rgb_to_lab(rgb)
    lab[..., 1:] += torch.randn((64, 64, 2), generator=g) * 20
    ours = color.lab_to_rgb_u8(lab[..., 0], lab[..., 1], lab[..., 2])
    theirs = k2.lab_to_rgb_u8_plain(lab[..., 0], lab[..., 1], lab[..., 2])
    assert torch.equal(ours, theirs)
    assert torch.equal(color.frame_ab(ours), cs.requantized_ab(ours))


def test_hints_resize_and_bins_match_the_program():
    from ideepcolor_tpu_torch.data.color_bins import get_bins
    from ideepcolor_tpu_torch.ops import hints as ph
    from ideepcolor_tpu_torch.ops.resize import resize_u8_half_pixel
    r = np.random.default_rng(3)
    boxes = r.integers(-5, 70, (12, 4)).astype(np.int32)
    boxes[:, 2:] = boxes[:, :2] + r.integers(0, 6, (12, 2))
    values = r.uniform(-80, 80, (12, 2)).astype(np.float32)
    ab, mask = hints.rasterize(boxes, values, 9, 64)
    pab, pmask = ph.rasterize_hints(torch.from_numpy(boxes),
                                    torch.from_numpy(values), 9, 64)
    assert np.array_equal(ab, pab.permute(2, 0, 1).numpy())
    assert np.array_equal(mask, pmask.permute(2, 0, 1).numpy())
    im = torch.from_numpy(r.integers(0, 256, (250, 190, 3), dtype=np.uint8))
    assert torch.equal(resize.resize_u8(im, 64, 64),
                       resize_u8_half_pixel(im, (64, 64)))
    assert np.array_equal(bins.pts_in_hull(), get_bins().pts_in_hull)


def test_siggraph_net_matches_the_program():
    from ideepcolor_tpu_torch.models.siggraph import (SIGGRAPHGenerator,
                                                      load_state_dict_file)
    cell = Cell("siggraph.click")
    cfg, mod = cell.config, cell.model()
    w = mod.load_weights(cfg, 0, "cpu")
    net = SIGGRAPHGenerator.from_state_dict(
        load_state_dict_file(cfg["weights"]["file"]))
    g = torch.Generator().manual_seed(1)
    l = torch.rand((2, 1, 32, 32), generator=g) * 100
    ab = torch.randn((2, 2, 32, 32), generator=g) * 30
    mask = (torch.rand((2, 1, 32, 32), generator=g) > 0.9).float()
    with torch.no_grad():
        ref = mod.reference(w, cfg, l, ab * mask, mask, "float32")["pred"]
        prog = net(l - 50.0, ab * mask, mask)
        _, dist = mod.forward(w, cfg, l, ab * mask, mask, dist=True)
        _, pdist = net(l - 50.0, ab * mask, mask, dist=True,
                       dist_lowres=True)
    assert torch.allclose(ref, prog, atol=1e-3)
    assert torch.allclose(dist, pdist, atol=1e-6)


def test_caffe_dist_net_matches_the_program():
    from ideepcolor_tpu_torch.models.caffe_net import CaffeColorNet
    cell = Cell("caffe_dist.click")
    cfg, mod = cell.config, cell.model()
    w = mod.load_weights(cfg, 5, "cpu")
    net = CaffeColorNet("dist")
    net.load_state_dict(w, strict=True)
    net.eval()
    g = torch.Generator().manual_seed(2)
    l = torch.rand((1, 1, 32, 32), generator=g) * 100
    mask = (torch.rand((1, 1, 32, 32), generator=g) > 0.9).float()
    ab = torch.randn((1, 2, 32, 32), generator=g) * 30 * mask
    with torch.no_grad():
        r = mod.reference(w, cfg, l, ab, mask, "float32")
        pred, dist = net.apply_dist(torch.cat([l - 50, ab, mask * 110], 1))
    # seeded weights carry float32 rounding up to a few 1e-3 of ab
    assert torch.allclose(r["pred"], pred, atol=1e-2)
    assert torch.allclose(r["map"], dist, atol=1e-5)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_whole_run_on_the_cpu_is_correct(cell):
    res = runner.run(cell, 2 ** 31 + 99, 1.5, False, device="cpu",
                     overrides=SMALL[cell])
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res["check"]) == list(Cell(cell).limits)
