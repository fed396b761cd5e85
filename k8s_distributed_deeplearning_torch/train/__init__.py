"""Training: the token batchers, optimizers, the loop and the CLI
(PyTorch port)."""
