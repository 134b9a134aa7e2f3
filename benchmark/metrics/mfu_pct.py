"""The whole step's share of the card's peak: the traced actions' FLOPs,
counted from the configuration's layer shapes, over the traced window, at
the peak of the path's compute type (67 TFLOP/s float32, 495 TF32)."""

from harness.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
