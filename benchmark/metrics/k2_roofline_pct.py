"""Kernel K2, the Lab -> uint8 compose (``csrc/colorspace_kernel.cu``,
every instantiation of ``lab2rgb_kernel``): its least time over its
device time. Per pixel, the fused click entry reads L, a and b (12 B) and
writes the frame and the frame's own ab (3 + 8 B), 23 B and 100 float32
operations; the compose and the batched compose write the frame only,
15 B and 60 operations."""

from harness.readers import roofline_pct

KERNELS = ("lab2rgb_kernel",)
FUSED = (23, 100)          # bytes, operations per pixel
COMPOSE = (15, 60)


def work_of(work) -> tuple[float, float]:
    nb = ops = 0.0
    for w in work:
        px = w["size"] ** 2
        for frames, (b, o) in ((w.get("k2_fused_frames", 0), FUSED),
                               (w.get("k2_batch_frames", 0), COMPOSE)):
            nb += frames * px * b
            ops += frames * px * o
    return nb, ops


def read(ctx):
    return roofline_pct(ctx, KERNELS, *work_of(ctx["work"]))
