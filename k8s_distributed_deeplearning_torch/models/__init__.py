"""Models: the Llama-family transformer, its weight converter and generation steps."""
