"""Telemetry (port of ``telemetry/``): the metric registry, and the
streaming SLO engine (``slo.py``) with its tick-stamped alerts
(``alerts.py``)."""

from simple_distributed_machine_learning_tpu_torch.telemetry.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    append_jsonl,
)
