"""Input copies a captured click program makes before its replay (one
``graph.copy`` span each; an argument passed unchanged is not copied), per
traced click. 0 is a reading; a program without ``click`` spans reads
nothing."""

from harness.readers import per_unit
from harness.spans import count_under


def read(ctx):
    n = count_under(ctx, "graph.copy", "click")
    return None if n is None else per_unit(ctx, n, "actions")
