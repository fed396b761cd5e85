"""Telemetry of the PyTorch port, each module the port's own copy of its
JAX namesake: the JSONL event registry (``events``), the Prometheus
registry and exposition (``registry``), the span tracer (``trace``),
heartbeat files (``heartbeat``), the HTTP exporter (``exporter``), the train
loop's gauges and the collectors over serving state (``bridge``), the fleet scraper, aggregator
and health policy (``fleet``), the tenants' SLO targets and burn-rate
engine (``slo``), the flight recorder (``flight``), and graftscope, the
offline readers of the JSONL stream (``timeline``, and its CLI
``graftscope``), which import no torch."""
