"""CUDA graph captures (one ``graph.capture`` span each, warm-up included) in
the traced window: after set-up a click should capture nothing. 0 is a
reading; a program without ``click`` spans reads nothing."""

from harness.spans import count_under


def read(ctx):
    return count_under(ctx, "graph.capture", "click")
