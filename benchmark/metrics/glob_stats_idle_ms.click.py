"""Idle device time inside the ``glob.stats`` spans (``global_stats.extract``:
Lab, the 4x4 pool, the nearest-bin search, the means, HSV, each an eager
launch), in ms per traced action."""

from harness.spans import idle_ms_per_action


def read(ctx):
    return idle_ms_per_action(ctx, "glob.stats")
