"""Telemetry (port of ``telemetry/``): the metric registry and its help
catalog (``catalog.py``), the streaming SLO engine (``slo.py``) with its
tick-stamped alerts (``alerts.py``), host spans as Chrome traces
(``tracing.py``), per-request TTFT attribution (``attribution.py``) and
the run-report CLI (``report.py``)."""

from simple_distributed_machine_learning_tpu_torch.telemetry.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    append_jsonl,
)
