"""Plain PyTorch and NumPy versions of what the program computes, written
for the benchmark's check. Nothing here imports the program or JAX: each
module is a frozen copy of a published formula or of the program's plain
arithmetic, so the check works everything out again from the same raw
inputs (image, hint table, weights)."""
