"""Each configuration's FLOP count, from the layer shapes of its file,
against torch's own counter over the reference forward at 256 x 256."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from harness.spec import Cell


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _meta_siggraph(cfg):
    c1, c2, c3, c4 = cfg["widths"]
    shapes = {}
    mod = Cell("siggraph.click").model()
    for block, convs, bn, _relu, _div in mod._spec(cfg["widths"]):
        idx, bn_i = mod._indices(block, len(convs), bn)
        for (cin, cout, k, _d), i in zip(convs, idx):
            cout = cfg["class_bins"] if cout is None else cout
            shp = ((cin, cout, k, k) if block in mod._DECONV
                   else (cout, cin, k, k))
            shapes[f"{block}.{i}.weight"] = shp
            shapes[f"{block}.{i}.bias"] = (cout,)
        if bn:
            for s in ("weight", "bias", "running_mean", "running_var"):
                shapes[f"{block}.{bn_i}.{s}"] = (convs[-1][1],)
    return mod, {k: torch.empty(v, device="meta") for k, v in shapes.items()}


@pytest.mark.parametrize("dist", [False, True])
def test_siggraph_flops_match_the_counter(dist):
    cfg = Cell("siggraph.click").config
    mod, w = _meta_siggraph(cfg)
    S = 256
    x = [torch.empty((1, c, S, S), device="meta") for c in (1, 2, 1)]
    counted = _count(lambda: mod.forward(w, cfg, *x, dist=dist))
    assert mod.flops(cfg, S, dist=dist) == counted
    # 150.4 GFLOP per forward, 1.1 more for the class head
    assert abs(mod.flops(cfg, S) / 1e9 - 150.4) < 0.1


def test_caffe_dist_flops_match_the_counter():
    cfg = Cell("caffe_dist.click").config
    mod = Cell("caffe_dist.click").model()
    w = {}
    for name, cin, cout, k, _d, tr in mod._layers(cfg):
        w[f"{name}.weight"] = torch.empty(
            (cin, cout, k, k) if tr else (cout, cin, k, k), device="meta")
        w[f"{name}.bias"] = torch.empty((cout,), device="meta")
    for name, c in mod._NORMS:
        w[f"{name}.mean"] = torch.empty((c,), device="meta")
        w[f"{name}.var"] = torch.empty((c,), device="meta")
    w["scale_S.scale"] = torch.empty((), device="meta")
    w["scale_T.scale"] = torch.empty((), device="meta")
    S = 256
    x = [torch.empty((1, c, S, S), device="meta") for c in (1, 2, 1)]
    counted = _count(lambda: mod.forward(w, cfg, *x))
    assert mod.flops(cfg, S) == counted
