"""Batched tensor primitives of the Version-A loop detector: image pyramid,
FAST, ORB, descriptor layouts and banded Hamming matching.

Plain PyTorch on any device; the TPU's Pallas kernels on this path are
hand-written CUDA kernels wrapped in :mod:`.cuda_kernels`.
"""
