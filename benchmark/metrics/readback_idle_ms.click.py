"""Idle device time inside the ``click.readback`` spans (the frame read back
to host memory), in ms per traced click."""

from harness.spans import idle_ms_per_action


def read(ctx):
    return idle_ms_per_action(ctx, "click.readback")
