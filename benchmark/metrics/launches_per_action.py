"""Host calls that put work on a stream (kernel and graph launches,
asynchronous copies, by the CUDA runtime's names) per traced action."""

from harness.readers import per_unit


def read(ctx):
    return per_unit(ctx, ctx["trace"].launches(), "actions")
