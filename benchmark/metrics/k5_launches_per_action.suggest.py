"""Device operations of kernel K5 (the suggestion chain after its draws,
``kmeans_kernel``) that start inside the probe actions' ``suggest`` spans,
per span: 1 where the chain runs as K5, 0 where it runs as PyTorch's
launches."""

import bisect

from harness.probe_spans import per_span

KERNEL = "kmeans_kernel"


def _k5_inside(tr, iv) -> int:
    starts = [s for s, _e in iv]
    n = 0
    for name, s, _t in tr.device:
        if KERNEL not in name:
            continue
        k = bisect.bisect_right(starts, s) - 1
        n += k >= 0 and s <= iv[k][1]
    return n


def read(ctx):
    return per_span(ctx["trace"], _k5_inside)
