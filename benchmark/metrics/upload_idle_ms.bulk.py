"""Idle device time inside the ``batch.upload`` spans (the uint8 images and
hint tables copied up, the images scaled to float), in ms per traced
batch."""

from harness.spans import idle_ms_per_action


def read(ctx):
    return idle_ms_per_action(ctx, "batch.upload")
