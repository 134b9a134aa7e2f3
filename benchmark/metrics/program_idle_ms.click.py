"""Idle device time inside the program's ``click`` spans (each click entry of
``api/colorize.py``, from the call to the frame in host memory), in ms per
traced click: the part of the card's idle time that the program itself
spends, and not the caller between clicks."""

from harness.spans import idle_ms_per_action


def read(ctx):
    return idle_ms_per_action(ctx, "click")
