"""Operators: attention and the hand-written CUDA kernels."""
