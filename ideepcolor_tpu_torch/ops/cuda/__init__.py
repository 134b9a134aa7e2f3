"""Hand-written CUDA kernels of the port (sources in ``csrc/``), the
counterparts of the JAX package's Pallas kernels in ``ops/pallas``."""
