"""Idle device time inside the probe actions' ``suggest`` spans, in ms per
span: the host's part of a suggestion (staging the pixel, the graph's
launch, the readback's wait)."""

from harness.probe_spans import busy_ms, per_span


def read(ctx):
    return per_span(ctx["trace"], lambda tr, iv: sum(
        e - s for s, e in iv) * 1e-3 - busy_ms(tr, iv))
