"""Process groups and the data-parallel train step (PyTorch port)."""
