"""The trace reduction on synthetic traces: the device's busy time is the
union of its intervals, a trace without device work is an error, launches
are the runtime's calls, gaps are named by the host op over them."""

import pytest

from harness.trace import WINDOW_SPAN, Trace, union


def _ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def _trace():
    return [
        _ev("user_annotation", WINDOW_SPAN, 0.0, 1000.0),
        # two streams overlapping over 100-200 us: counted once
        _ev("kernel", "sm90_xmma_fprop_conv", 0.0, 200.0, tid=7),
        _ev("kernel", "raster_batch_kernel", 100.0, 200.0, tid=8),
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 500.0, 100.0,
            tid=7),
        # partly outside the window: clipped at 1000
        _ev("kernel", "void lab2rgb_kernel<0, 0, true>", 950.0, 100.0, tid=7),
        _ev("cuda_runtime", "cudaGraphLaunch", 290.0, 5.0),
        _ev("cuda_runtime", "cudaMemcpyAsync", 480.0, 130.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 940.0, 5.0),
        _ev("cuda_runtime", "cudaStreamSynchronize", 700.0, 240.0),
        _ev("cpu_op", "aten::to", 300.0, 200.0),
    ]


def test_union_merges_overlaps():
    assert union([(0, 2), (1, 3), (5, 6), (6, 7)]) == [(0, 3), (5, 7)]


def test_busy_is_the_union_and_idle_its_complement():
    tr = Trace(_trace())
    # [0, 300] + [500, 600] + [950, 1000] = 450 us of 1000
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx(450e-6)
    assert tr.idle_share() == pytest.approx(0.55)


def test_kernel_time_by_name_and_launch_calls():
    tr = Trace(_trace())
    assert tr.kernel_s("raster_kernel", "raster_batch_kernel") == \
        pytest.approx(200e-6)
    assert tr.kernel_s("lab2rgb_kernel") == pytest.approx(50e-6)
    assert tr.launches() == 3          # graph launch, async copy, kernel


def test_breakdown_groups_ops_and_names_gaps():
    tr = Trace(_trace())
    ops = dict(tr.device_ops())
    assert ops["conv: sm90_xmma_fprop_conv"] == pytest.approx(200e-6)
    gaps = tr.idle_gaps()
    assert [round(d * 1e6) for _n, d in gaps] == [350, 200, 0][:len(gaps)]
    assert gaps[0][0] == "cudaStreamSynchronize"   # 600-950
    assert gaps[1][0] == "aten::to"                # 300-500


def test_a_trace_without_device_work_is_refused():
    events = [e for e in _trace() if e["cat"] not in
              ("kernel", "gpu_memcpy")]
    with pytest.raises(ValueError, match="no device operation"):
        Trace(events)


def test_a_trace_without_the_window_span_is_refused():
    with pytest.raises(ValueError, match=WINDOW_SPAN):
        Trace(_trace()[1:])
