"""Forwards that ran their activations channels-last (one ``model.nhwc``
span each, opened by the SIGGRAPH forward on that path alone), per traced
batch. 0 is a reading; a program without ``batch`` spans reads nothing."""

from harness.readers import per_unit
from harness.spans import count_under


def read(ctx):
    n = count_under(ctx, "model.nhwc", "batch")
    return None if n is None else per_unit(ctx, n, "actions")
