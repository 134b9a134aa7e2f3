"""Host calls that put work on a stream per image of the traced batches."""

from harness.readers import per_unit


def read(ctx):
    return per_unit(ctx, ctx["trace"].launches(), "images")
