"""The program's spans read against the device on synthetic traces: idle
under a span (nested and repeated spans once, two streams once), per
action, nothing where the spans are absent, and the copy and capture
counts; and the per-layer readers that use them, found by name."""

import pytest

from harness import spans
from harness.spec import Cell
from harness.trace import WINDOW_SPAN, Trace


def _ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def _span(name, ts, dur):
    return _ev("user_annotation", name, ts, dur)


def _click_trace():
    """Two clicks in a 1000 us window. Device busy: [100, 300] (two
    streams overlapping over 150-250) and [600, 800]."""
    return [
        _span(WINDOW_SPAN, 0.0, 1000.0),
        _ev("kernel", "sm90_xmma_fprop", 100.0, 150.0, tid=7),
        _ev("kernel", "lab2rgb_kernel", 150.0, 150.0, tid=8),
        _ev("kernel", "sm90_xmma_fprop", 600.0, 200.0, tid=7),
        # click 1: [50, 400]; hints [50, 90] holding a nested [60, 80]
        _span("click", 50.0, 350.0),
        _span("click.hints", 50.0, 40.0),
        _span("click.hints", 60.0, 20.0),
        _span("click.upload", 90.0, 20.0),         # 10 us idle, 10 busy
        _span("graph.copy", 110.0, 5.0),
        _span("graph.copy", 115.0, 5.0),
        _span("click.readback", 280.0, 120.0),     # 100 us idle, 20 busy
        # click 2: [500, 900]; its hints overlap nothing on the device
        _span("click", 500.0, 400.0),
        _span("click.hints", 500.0, 30.0),
        _span("click.upload", 530.0, 20.0),
        _span("click.readback", 790.0, 110.0),     # 100 us idle
    ]


def _ctx(events, actions=2):
    return {"trace": Trace(events), "work": [{}] * actions}


def test_span_intervals_merge_nested_and_repeated_spans():
    tr = Trace(_click_trace())
    assert spans.intervals(tr, "click.hints") == [(50.0, 90.0),
                                                  (500.0, 530.0)]
    assert spans.count(tr, "click.hints") == 3
    assert spans.count(tr, "graph.copy") == 2


def test_covered_is_the_overlap_of_two_unions():
    assert spans.covered([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert spans.covered([(0, 10)], [(10, 20)]) == 0
    assert spans.covered([], [(0, 1)]) == 0


def test_idle_under_a_span_counts_two_streams_once():
    tr = Trace(_click_trace())
    assert tr.busy == [(100.0, 300.0), (600.0, 800.0)]
    # click: [50, 400] + [500, 900] = 750 us, of which 400 busy
    assert spans.idle_under(tr, "click") == pytest.approx(350e-6)
    assert spans.idle_under(tr, "click.hints") == pytest.approx(70e-6)
    assert spans.idle_under(tr, "click.upload") == pytest.approx(30e-6)
    assert spans.idle_under(tr, "click.readback") == pytest.approx(200e-6)


def test_idle_per_action_and_the_parts_within_the_whole():
    ctx = _ctx(_click_trace())
    whole = spans.idle_ms_per_action(ctx, "click")
    assert whole == pytest.approx(0.175)
    parts = [spans.idle_ms_per_action(ctx, n) for n in
             ("click.hints", "click.upload", "click.readback")]
    assert parts == pytest.approx([0.035, 0.015, 0.1])
    assert sum(parts) <= whole
    tr = ctx["trace"]
    assert whole * 2 <= tr.idle_share() * tr.window_s * 1e3
    # a batch of 16 counts as one action
    assert spans.idle_ms_per_action(_ctx(_click_trace(), 1), "click") == \
        pytest.approx(0.35)


def test_a_span_outside_the_trace_reads_nothing():
    ctx = _ctx(_click_trace())
    assert spans.idle_under(ctx["trace"], "batch") is None
    assert spans.idle_ms_per_action(ctx, "batch.upload") is None
    bare = [e for e in _click_trace() if e["cat"] != "user_annotation"
            or e["name"] == WINDOW_SPAN]
    ctx = _ctx(bare)
    assert spans.idle_ms_per_action(ctx, "click") is None
    assert spans.count_under(ctx, "graph.copy", "click") is None


def test_copy_and_capture_counts_read_zero_when_clicks_ran():
    ctx = _ctx(_click_trace())
    assert spans.count_under(ctx, "graph.copy", "click") == 2
    assert spans.count_under(ctx, "graph.capture", "click") == 0


def test_a_span_partly_outside_the_window_is_clipped():
    events = _click_trace() + [_span("batch", 950.0, 200.0)]
    tr = Trace(events)
    assert spans.intervals(tr, "batch") == [(950.0, 1000.0)]
    assert spans.idle_under(tr, "batch") == pytest.approx(50e-6)


@pytest.mark.parametrize("metric,value", [
    ("program_idle_ms.click", 0.175),
    ("hints_idle_ms.click", 0.035),
    ("upload_idle_ms.click", 0.015),
    ("readback_idle_ms.click", 0.1),
    ("input_copies_per_action.click", 1.0),
    ("graph_captures.click", 0),
    ("program_idle_ms.bulk", None),
    ("upload_idle_ms.bulk", None),
    ("readback_idle_ms.bulk", None),
])
def test_span_metric_readers_by_name(metric, value):
    reader = Cell("siggraph.click").metric(metric)
    got = reader.read(_ctx(_click_trace()))
    assert got == (None if value is None else pytest.approx(value))


def test_bulk_readers_read_the_batch_spans():
    events = [
        _span(WINDOW_SPAN, 0.0, 1000.0),
        _ev("kernel", "raster_batch_kernel", 200.0, 500.0, tid=7),
        _span("batch", 0.0, 900.0),
        _span("batch.upload", 0.0, 250.0),      # 200 us idle
        _span("batch.readback", 650.0, 250.0),  # 200 us idle
    ]
    cell = Cell("siggraph.batch")
    ctx = _ctx(events, 1)
    got = {m: cell.metric(m).read(ctx) for m in (
        "program_idle_ms.bulk", "upload_idle_ms.bulk",
        "readback_idle_ms.bulk")}
    assert got == pytest.approx({"program_idle_ms.bulk": 0.4,
                                 "upload_idle_ms.bulk": 0.2,
                                 "readback_idle_ms.bulk": 0.2})
    # no click ran: the click counts read nothing rather than 0
    assert cell.metric("graph_captures.click").read(ctx) is None
