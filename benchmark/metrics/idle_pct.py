"""Share of the traced window in which no device operation ran: the
complement of the union of kernel, copy and set intervals."""

from harness.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
