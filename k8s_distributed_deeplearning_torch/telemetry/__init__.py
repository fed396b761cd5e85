"""Telemetry of the PyTorch port: so far only the tenants' SLO targets."""
