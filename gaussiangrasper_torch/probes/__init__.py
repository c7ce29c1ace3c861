"""Platform probes: the kernels P1-P3 (`kernels.py`) and the two entry
points that drive them, `kernel_probe` and `copy_probe` (counterparts of
the JAX package's dev probes pallas_probe.py and dma_probe.py)."""
