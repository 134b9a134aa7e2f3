"""Device busy time inside the probe actions' ``suggest`` spans
(``get_ab_reccs`` on a map predicted before: the suggestion chain's graph,
the pixel's upload and the palette's readback), in ms per span: the
chain's device time."""

from harness.probe_spans import busy_ms, per_span


def read(ctx):
    return per_span(ctx["trace"], busy_ms)
