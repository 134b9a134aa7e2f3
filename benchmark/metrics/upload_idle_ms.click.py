"""Idle device time inside the ``click.upload`` spans (the hint table staged
through ``TableStage``, ring wait included, or the dense hint planes copied
up), in ms per traced click."""

from harness.spans import idle_ms_per_action


def read(ctx):
    return idle_ms_per_action(ctx, "click.upload")
