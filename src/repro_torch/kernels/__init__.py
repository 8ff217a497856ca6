"""Kernels of the port (CUDA C++ in ``csrc/``), their wrappers, plain
versions, tiling policy and dispatch registry."""
