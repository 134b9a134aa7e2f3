"""Device operations of kernel K4 (the SIGGRAPH convs' epilogue,
``epilogue_pointwise_kernel``) per traced batch: 26 for each forward that
finishes its convs with K4, 0 where the eager chain runs them."""

from harness.readers import per_unit

KERNEL = "epilogue_pointwise_kernel"


def read(ctx):
    n = sum(1 for name, _s, _t in ctx["trace"].device if KERNEL in name)
    return per_unit(ctx, n, "actions")
