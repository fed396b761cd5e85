"""Utilities: device selection, metrics, checkpoint-directory integrity."""
