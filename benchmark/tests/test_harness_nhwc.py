"""The channels-last forward count, ``nhwc_forwards_per_action.bulk``, read
on synthetic traces: ``model.nhwc`` spans per traced batch, 0 where the
batches ran without them, and nothing where no ``batch`` span ran."""

import pytest

from harness.spec import Cell
from harness.trace import WINDOW_SPAN, Trace


def _ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def _span(name, ts, dur):
    return _ev("user_annotation", name, ts, dur)


def _ctx(events, actions):
    return {"trace": Trace(events), "work": [{}] * actions}


def _batch_trace(nhwc_spans):
    """Two batches in a 1000 us window, with ``nhwc_spans`` forwards marked
    ``model.nhwc`` inside them."""
    events = [_span(WINDOW_SPAN, 0.0, 1000.0),
              _ev("kernel", "sm90_xmma_fprop", 100.0, 300.0, tid=7),
              _span("batch", 0.0, 450.0), _span("batch", 500.0, 450.0)]
    events += [_span("model.nhwc", 100.0 + 500.0 * i, 300.0)
               for i in range(nhwc_spans)]
    return events


def _click_trace():
    """One click in a 1000 us window: a trace with neither batch spans nor
    channels-last forwards."""
    return [_span(WINDOW_SPAN, 0.0, 1000.0),
            _ev("kernel", "sm80_xmma_fprop", 100.0, 200.0, tid=7),
            _span("click", 50.0, 350.0)]


@pytest.mark.parametrize("nhwc_spans,value", [(2, 1.0), (1, 0.5), (0, 0.0)])
def test_nhwc_forwards_are_counted_per_batch(nhwc_spans, value):
    reader = Cell("siggraph.batch").metric("nhwc_forwards_per_action.bulk")
    assert reader.read(_ctx(_batch_trace(nhwc_spans), 2)) == \
        pytest.approx(value)


def test_nhwc_forwards_read_nothing_without_batch_spans():
    reader = Cell("siggraph.batch").metric("nhwc_forwards_per_action.bulk")
    bare = [e for e in _batch_trace(2) if e["name"] != "batch"]
    assert reader.read(_ctx(bare, 2)) is None
    assert reader.read(_ctx(_click_trace(), 1)) is None
