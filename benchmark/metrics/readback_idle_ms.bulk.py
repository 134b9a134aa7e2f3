"""Idle device time inside the ``batch.readback`` spans (the batch's frames
read back to host memory), in ms per traced batch."""

from harness.spans import idle_ms_per_action


def read(ctx):
    return idle_ms_per_action(ctx, "batch.readback")
