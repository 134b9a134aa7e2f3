"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W power limit): FLOP/s by the compute type of a path and
the HBM3 bandwidth. A share of a peak divides by these."""

FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
