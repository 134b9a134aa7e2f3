"""Device operations (kernels, copies, sets) that start inside the probe
actions' ``suggest`` spans, per span: the suggestion chain's length in
launches of the device, the graph's nodes included."""

import bisect

from harness.probe_spans import per_span


def _starts_inside(tr, iv) -> int:
    starts = [s for s, _e in iv]
    n = 0
    for _name, s, _t in tr.device:
        k = bisect.bisect_right(starts, s) - 1
        n += k >= 0 and s <= iv[k][1]
    return n


def read(ctx):
    return per_span(ctx["trace"], _starts_inside)
