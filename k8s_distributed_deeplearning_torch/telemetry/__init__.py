"""Telemetry of the PyTorch port: the tenants' SLO targets and burn-rate
engine (``slo``), the flight recorder (``flight``) and the health policy
the gateway routes by (``fleet``)."""
