"""Idle device time inside the program's ``batch`` spans (each call of
``engine.batch.colorize_batch_table``), in ms per traced batch."""

from harness.spans import idle_ms_per_action


def read(ctx):
    return idle_ms_per_action(ctx, "batch")
