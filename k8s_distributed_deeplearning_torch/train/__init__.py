"""Training: data and batchers, optimizers, the loop with checkpoints,
restore-on-start and preemption, the Llama/MoE CLI and the MNIST job
(PyTorch port)."""
