"""Utilities: device selection and serving metrics."""
