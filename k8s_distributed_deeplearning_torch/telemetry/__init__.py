"""Telemetry of the PyTorch port, each module the port's own copy of its
JAX namesake: the JSONL event registry (``events``), the Prometheus
registry and exposition (``registry``), the span tracer (``trace``),
heartbeat files (``heartbeat``), the HTTP exporter (``exporter``), the
collectors over serving state (``bridge``), the fleet scraper, aggregator
and health policy (``fleet``), the tenants' SLO targets and burn-rate
engine (``slo``) and the flight recorder (``flight``)."""
