"""PyTorch/CUDA port of k8s_distributed_deeplearning_tpu for NVIDIA Hopper.

The JAX package beside this one is the reference; this package imports
nothing of it (and nothing of JAX). Kernels the JAX package wrote in
Pallas for the TPU are hand-written CUDA here (``csrc/``), built with
nvcc at first use; each has a plain PyTorch version beside it that CPU
tensors take.
"""
