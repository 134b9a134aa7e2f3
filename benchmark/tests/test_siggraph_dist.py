"""The distribution cell, ``siggraph_dist.suggest``: its plain references
against the program on the CPU at small sizes (the map on seeded random
weights, the suggestion chain given the program's pdf and draws), its FLOP
count, a whole run with ``correct`` true, each planted fault coming out not
correct, the check's handling of ties, the readers of the chain's three
metrics on a synthetic trace, and on a card the TF32 control failing the
check."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import runner
from harness.spec import Cell
from harness.trace import WINDOW_SPAN, Trace

CELL = "siggraph_dist.suggest"
# small sizes for whole runs on the CPU: the bundled width-0.25 student
SMALL = {"config": {"Xd": 64, "weights": {"file": "weights/student_w025.npz"},
                    "widths": [16, 32, 64, 128]},
         "mix": {"image_hw": [250, 190], "warmup_actions": 3,
                 "sample_every": 2, "trace_actions": 4}}


def _parts():
    cell = Cell(CELL)
    return cell, cell.config, cell.model(), cell.driver()


def test_dist_map_matches_the_program():
    from ideepcolor_tpu_torch.models.siggraph import (SIGGRAPHGenerator,
                                                      init_state_dict)
    _cell, cfg, mod, _drv = _parts()
    sd = init_state_dict(0.25, seed=3)
    g = torch.Generator().manual_seed(4)
    for k, v in sd.items():          # biases and norms off their defaults
        if k.endswith(("bias", "running_mean")):
            sd[k] = 0.1 * torch.randn(v.shape, generator=g)
        elif k.endswith("running_var"):
            sd[k] = 0.5 + torch.rand(v.shape, generator=g)
    net = SIGGRAPHGenerator.from_state_dict(sd).eval()
    l = torch.rand((2, 1, 64, 64), generator=g) * 100
    ab = torch.zeros((2, 2, 64, 64))
    mask = torch.zeros((2, 1, 64, 64))
    ab[:, :, 10:14, 20:23] = torch.tensor([40.0, -25.0])[:, None, None]
    mask[:, :, 10:14, 20:23] = 1.0
    w = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    with torch.no_grad():
        _reg, dist = net(l - 50, ab, mask, 0.0, dist=True, dist_lowres=True)
        ref = mod.reference(w, cfg, l, ab, mask, "float32")["map"]
    assert ref.shape == (2, 16, 16, 529)
    # float32 rounding of the same convs in another order, through a
    # softmax of probabilities below 1
    assert float((dist.permute(0, 2, 3, 1) - ref).abs().max()) < 1e-6
    assert float((ref.sum(-1) - 1).abs().max()) < 1e-5


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_chain_given_the_programs_draws_matches_it(seed):
    from ideepcolor_tpu_torch.ops import kmeans as km
    from ideepcolor_tpu_torch.ops.quantize import make_pts_grid
    _cell, cfg, mod, drv = _parts()
    pts = torch.from_numpy(mod.grid())
    assert np.array_equal(mod.grid(), make_pts_grid().astype(np.float32))
    rng = np.random.default_rng(seed)
    pdf = torch.from_numpy(rng.dirichlet(np.full(529, 0.05)).astype(
        np.float32))
    s = cfg["suggest"]
    centers, conf, u_bins, u_seeds = km.ab_recommendations(
        pdf, pts, torch.Generator().manual_seed(seed), K=s["K"], N=s["N"],
        iters=s["lloyd_steps"], return_draws=True)
    assert u_seeds.shape == (s["restarts"], s["K"])
    cands = mod.palettes(pdf, pts, u_bins, u_seeds, s["lloyd_steps"])
    assert drv.palette_errors(centers.numpy(), conf.numpy(), cands) == (0, 0)
    # other draws give another palette
    other = mod.palettes(pdf, pts, 1.0 - u_bins, u_seeds, s["lloyd_steps"])
    assert drv.palette_errors(centers.numpy(), conf.numpy(), other)[0] > 1


def test_check_takes_a_tie_as_either_choice():
    """A seeding draw on a boundary follows both bins; restarts that tie
    are each a palette; clusters of equal occupancy match in either
    order."""
    _cell, _cfg, mod, drv = _parts()
    pts = mod.grid()
    w = np.zeros(529, np.float32)
    w[[100, 300]] = 50.0
    # u * 100 = 50 lies on the boundary of the two bins' intervals
    seeds = mod.seedings(pts, w, np.array([0.5, 0.3], np.float32))
    assert {tuple(map(tuple, s)) for s in seeds} == {
        (tuple(pts[100]), tuple(pts[300])), (tuple(pts[300]),
                                             tuple(pts[100]))}
    pdf = torch.from_numpy(w / w.sum())
    cands = mod.palettes(pdf, torch.from_numpy(pts),
                         torch.rand(1000, generator=torch.Generator()
                                    .manual_seed(0)),
                         torch.tensor([[0.5, 0.3], [0.2, 0.9]]), 30)
    c, conf, mass = cands[0]
    assert len(cands) >= 2
    if mass[0] == mass[1]:
        assert drv.palette_errors(c[::-1], conf, cands)[0] == 0
    swapped = (c[::-1], conf, np.array([5.0, 5.0]))
    assert drv.palette_errors(c, conf, [swapped]) == (0.0, 0.0)


def _meta_weights(cfg, mod):
    net = mod.net
    w = {}
    for block, convs, bn, _relu, _div in net._spec(cfg["widths"]):
        idx, bn_i = net._indices(block, len(convs), bn)
        for (cin, cout, k, _d), i in zip(convs, idx):
            cout = cfg["class_bins"] if cout is None else cout
            shp = ((cin, cout, k, k) if block in net._DECONV
                   else (cout, cin, k, k))
            w[f"{block}.{i}.weight"] = torch.empty(shp, device="meta")
            w[f"{block}.{i}.bias"] = torch.empty((cout,), device="meta")
        if bn:
            for s in ("weight", "bias", "running_mean", "running_var"):
                w[f"{block}.{bn_i}.{s}"] = torch.empty((convs[-1][1],),
                                                       device="meta")
    return w


def test_flops_match_the_counter():
    _cell, cfg, mod, _drv = _parts()
    S = 256
    x = [torch.empty((1, c, S, S), device="meta") for c in (1, 2, 1)]
    with FlopCounterMode(display=False) as fc:
        mod.reference(_meta_weights(cfg, mod), cfg, *x, "float32")
    assert mod.flops(cfg, S) == fc.get_total_flops()
    # 150.39 GFLOP the trunk, 1.11 the class head; the chain counts none
    assert abs(mod.flops(cfg, S) / 1e9 - 151.50) < 0.005


def test_whole_run_on_the_cpu_is_correct():
    res = runner.run(CELL, 2 ** 31 + 99, 1.5, False, device="cpu",
                     overrides=SMALL)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 10
    assert list(res["check"]) == list(Cell(CELL).limits)
    assert {"latency_ms_p50", "latency_ms_p95", "setup_s"} <= set(
        res["metrics"])


@pytest.mark.parametrize("fault,number", [
    ("stale_map", "map_err_max"),        # the map of an older table
    ("altered_draws", "center_err_max"),  # draws other than the chain's
    ("wrong_pixel", "center_err_max"),   # the palette of another pixel
])
def test_fault_is_not_correct(fault, number):
    res = runner.run(CELL, 2 ** 31 + 7, 1.5, False, device="cpu",
                     fault=fault, overrides=SMALL)
    assert res["attempted"] > 0
    assert res["correct"] is False, res["check"]
    assert res["check"][number]["value"] > res["check"][number]["limit"]


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1}


def test_suggest_readers_on_a_synthetic_trace():
    """A predicting action ([0, 400]: its ``click`` and then its
    ``suggest`` span, which the readers skip) and two probes ([500, 600]
    with two kernels and a copy, 40 us busy; [700, 800] with one kernel of
    30 us) in a 1000 us window."""
    events = [
        _ev("user_annotation", WINDOW_SPAN, 0.0, 1000.0),
        _ev("user_annotation", "click", 0.0, 300.0),
        _ev("user_annotation", "click.upload", 10.0, 20.0),
        _ev("kernel", "sm80_xmma_fprop", 50.0, 200.0),
        _ev("user_annotation", "suggest", 300.0, 100.0),
        _ev("kernel", "elementwise_kernel", 320.0, 50.0),
        _ev("user_annotation", "suggest", 500.0, 100.0),
        _ev("user_annotation", "click.upload", 500.0, 10.0),
        _ev("gpu_memcpy", "Memcpy HtoD", 505.0, 5.0),
        _ev("kernel", "elementwise_kernel", 520.0, 20.0),
        _ev("kernel", "reduce_kernel", 550.0, 15.0),
        _ev("user_annotation", "suggest", 700.0, 100.0),
        _ev("kernel", "elementwise_kernel", 720.0, 30.0),
        _ev("kernel", "elementwise_kernel", 850.0, 10.0),   # after them
    ]
    c = Cell(CELL)
    busy = c.metric("suggest_busy_ms.suggest").read
    ops = c.metric("suggest_ops.suggest").read
    idle = c.metric("suggest_idle_ms.suggest").read
    ctx = {"trace": Trace(events), "work": [{}] * 3}
    assert busy(ctx) == pytest.approx(1e-3 * (40.0 + 30.0) / 2)
    assert ops(ctx) == 2.0
    assert idle(ctx) == pytest.approx(1e-3 * (60.0 + 70.0) / 2)
    # a program that opens no suggest span reads nothing
    ctx = {"trace": Trace([e for e in events if e["name"] != "suggest"]),
           "work": [{}] * 3}
    assert busy(ctx) is None and ops(ctx) is None and idle(ctx) is None


@pytest.mark.card
@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3])
def test_tf32_control_fails_the_check(card, seed):
    c = Cell(CELL)
    drv = c.driver().Driver(c, c.model(), c.entry(), seed, "cuda")
    # the cell's own sizes; 640 actions sample about 20 of them
    nums = drv.control(640, "tf32", c.limits)
    assert any(v["value"] is not None and v["value"] > v["limit"]
               for v in nums.values()), nums
