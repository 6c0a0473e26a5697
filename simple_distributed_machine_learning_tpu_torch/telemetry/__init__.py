"""Telemetry (port of ``telemetry/``): the metric registry."""

from simple_distributed_machine_learning_tpu_torch.telemetry.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    append_jsonl,
)
