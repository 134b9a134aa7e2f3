"""Kernel K1, the hint rasterizer (``csrc/hints_kernel.cu``: the by-value
``raster_kernel`` and the ``raster_batch_kernel`` of the captured clicks
and the batch engine): its least time over its device time. The work of
one table: its live hints read once (a 16-byte box and an 8-byte ab
each) and the (3, S, S) float32 planes written once."""

from harness.readers import roofline_pct

KERNELS = ("raster_kernel", "raster_batch_kernel")
BYTES_PER_HINT = 24
BYTES_PER_PIXEL = 12


def nbytes(work) -> float:
    return sum(BYTES_PER_HINT * n + BYTES_PER_PIXEL * w["size"] ** 2
               for w in work for n in w["tables"])


def read(ctx):
    return roofline_pct(ctx, KERNELS, nbytes(ctx["work"]))
