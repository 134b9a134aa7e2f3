"""Idle device time inside the ``click.hints`` spans (the host's hint mirrors,
rasterized by the native host runtime, and the hints' normalization), in
ms per traced click."""

from harness.spans import idle_ms_per_action


def read(ctx):
    return idle_ms_per_action(ctx, "click.hints")
