"""Wrappers of the hand-written CUDA kernels (K1-K3) in ``csrc/``."""
