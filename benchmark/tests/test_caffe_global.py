"""The global-hints cell, ``caffe_global.transfer``: its plain reference
against the program on the CPU at small sizes (the net, the histogram),
its FLOP count, a whole run with ``correct`` true, each planted fault
coming out not correct, the readers of its two global-stats metrics on a
synthetic trace, and on a card the TF32 control failing the check."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import inputs, runner
from harness.spec import Cell
from harness.trace import WINDOW_SPAN, Trace
from reference import glob_stats, resize

CELL = "caffe_global.transfer"
# small sizes for whole runs on the CPU
SMALL = {"config": {"Xd": 64},
         "mix": {"image_hw": [250, 190], "ref_hw": [94, 125], "refs": 4,
                 "warmup_actions": 2, "sample_every": 2, "trace_actions": 4}}


def test_global_net_matches_the_program():
    from ideepcolor_tpu_torch.models.caffe_net import CaffeColorNet
    cell = Cell(CELL)
    cfg, mod = cell.config, cell.model()
    w = mod.load_weights(cfg, 5, "cpu")
    net = CaffeColorNet("global")
    net.load_state_dict(w, strict=True)
    net.eval()
    g = torch.Generator().manual_seed(2)
    l = torch.rand((2, 1, 32, 32), generator=g) * 100
    hist = glob_stats.histogram(torch.rand((2, 32, 32, 3), generator=g))
    blob = torch.cat([l - 50, torch.zeros((2, 3, 32, 32))], 1)
    with torch.no_grad():
        ref = mod.reference(w, cfg, l, hist, "float32")["pred"]
        prog = net.apply_global(blob, torch.cat([hist, torch.ones((2, 1))],
                                                1))
        none = net.apply_global(blob, torch.zeros((2, 314)))
    # float32 rounding, carried through a calibrated net whose norms
    # amplify small inputs and a x100 output, reaches a few 1e-3 of ab
    assert torch.allclose(ref, prog, atol=1e-2)
    # the calibrated weights let the histogram move the prediction
    assert (prog - none).abs().mean() > 1.0


def test_histogram_matches_the_program():
    from ideepcolor_tpu_torch.models import global_stats
    from ideepcolor_tpu_torch.ops.resize import resize_u8_half_pixel
    r = inputs.rng(11, "pool")
    for _ in range(8):
        im = torch.from_numpy(inputs.image(r, 375, 500))
        small = resize_u8_half_pixel(im, (256, 256))
        assert torch.equal(small, resize.resize_u8(im, 256, 256))
        rgb = small.to(torch.float32) / 255.0
        prog = global_stats.extract(rgb, device="cpu")["glob_ab_313"]
        ref = glob_stats.histogram(rgb)
        assert abs(float(ref.sum()) - 1.0) < 1e-6
        # the program finds the nearest bin by a product expansion, the
        # reference by the direct distance: a pooled pixel within float32
        # rounding of two bins' bisector may take the other bin, moving
        # 1/4096 of the mass; more than one such pixel is no rounding
        assert float((prog - ref).abs().sum()) <= 2 / 4096 + 1e-6


def test_flops_match_the_counter():
    cell = Cell(CELL)
    cfg, mod = cell.config, cell.model()
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    w = {}
    for name, cin, cout, k, _d, tr in mod._LAYERS:
        w[f"{name}.weight"] = meta(*((cin, cout, k, k) if tr
                                     else (cout, cin, k, k)))
        w[f"{name}.bias"] = meta(cout)
    for name, c in mod._NORMS:
        w[f"{name}.mean"], w[f"{name}.var"] = meta(c), meta(c)
    w["pred_ab.scale"] = meta()
    S = 256
    with FlopCounterMode(display=False) as fc:
        mod.reference(w, cfg, meta(1, 1, S, S), meta(1, 313), "float32")
    assert mod.flops(cfg, S) == fc.get_total_flops()
    # trunk 98.59, regression head 51.57, MLP 0.0019 GFLOP
    assert abs(mod.flops(cfg, S) / 1e9 - 150.17) < 0.005


def test_whole_run_on_the_cpu_is_correct():
    res = runner.run(CELL, 2 ** 31 + 99, 1.5, False, device="cpu",
                     overrides=SMALL)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res["check"]) == list(Cell(CELL).limits)


@pytest.mark.parametrize("fault", ["stale", "altered", "no_hist"])
def test_fault_is_not_correct(fault):
    res = runner.run(CELL, 2 ** 31 + 7, 1.5, False, device="cpu",
                     fault=fault, overrides=SMALL)
    assert res["attempted"] > 0
    assert res["correct"] is False, res["check"]
    if fault == "no_hist":
        # the frame itself shows that the histogram never reached the net
        assert any(res["check"][k]["value"] > res["check"][k]["limit"]
                   for k in ("frame_diff_share", "ab_err_mean"))


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1}


def test_global_stats_readers_on_a_synthetic_trace():
    """Two actions in a 1000 us window, each with a ``glob.stats`` span:
    [100, 300] holding two kernel launches and a copy, [600, 700] one
    launch; calls outside the spans, and a synchronize, do not count."""
    events = [
        _ev("user_annotation", WINDOW_SPAN, 0.0, 1000.0),
        _ev("kernel", "elementwise_kernel", 150.0, 50.0),    # 150 us idle
        _ev("kernel", "sm80_xmma_fprop", 650.0, 100.0),      # 50 us idle
        _ev("user_annotation", "glob.stats", 100.0, 200.0),
        _ev("user_annotation", "glob.stats", 600.0, 100.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 110.0, 5.0),
        _ev("cuda_runtime", "cudaMemcpyAsync", 200.0, 5.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 290.0, 5.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 640.0, 5.0),
        _ev("cuda_runtime", "cudaGraphLaunch", 400.0, 5.0),
        _ev("cuda_runtime", "cudaStreamSynchronize", 250.0, 5.0),
    ]
    c = Cell(CELL)
    idle = c.metric("glob_stats_idle_ms.click").read
    launches = c.metric("glob_stats_launches.click").read
    ctx = {"trace": Trace(events), "work": [{}] * 2}
    assert idle(ctx) == pytest.approx(1e3 * 200e-6 / 2)
    assert launches(ctx) == 2.0
    # a program that opens no glob.stats span reads nothing
    ctx = {"trace": Trace([e for e in events if e["name"] != "glob.stats"]),
           "work": [{}] * 2}
    assert idle(ctx) is None and launches(ctx) is None


@pytest.mark.card
@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3])
def test_tf32_control_fails_the_check(card, seed):
    c = Cell(CELL)
    drv = c.driver().Driver(c, c.model(), c.entry(), seed, "cuda")
    # the cell's own sizes; 640 actions sample about 30 of them
    nums = drv.control(640, "tf32", c.limits)
    # the TF32 nearest-bin product flips bins, and the TF32 net the frame
    for k in ("hist_err_max", "frame_diff_share"):
        assert nums[k]["value"] > nums[k]["limit"], nums
