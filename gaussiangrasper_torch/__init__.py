"""PyTorch/CUDA port of the JAX package (TPU) for NVIDIA Hopper (sm_90a).

Mirrors the JAX package's layout (core/, ops/, models/, engine/, scripts/)
and public names. Plain tensor work is PyTorch; every Pallas kernel of the
JAX package becomes a hand-written CUDA kernel under csrc/, built with nvcc
at first use (see `_build.py`) and held against a plain PyTorch version of
the same function. Entry points run on `cuda` unless the caller asks for the
CPU (`_device.resolve_device`).
"""
