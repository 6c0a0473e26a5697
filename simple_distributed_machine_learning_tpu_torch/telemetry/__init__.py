"""Telemetry (port of ``telemetry/``): structured metrics, tracing and step
profiling. Module map:

- ``registry.py`` — :class:`MetricsRegistry`: labeled counters / gauges /
  histograms, Prometheus text exposition, ``append_jsonl``;
- ``timer.py`` — :class:`StepTimer`: fenced timing windows with the
  compile-vs-steady split, p50/p95/max step latency, examples/sec and
  tokens/sec (+ opt-in FLOP counts, ``compiled_cost_stats``);
- ``tracing.py`` — :class:`Tracer`: host spans exported as Chrome-trace
  JSON (each span also lands on a ``torch.profiler`` capture);
- ``memory.py`` — live-tensor byte totals + per-card allocator stats;
- ``bubble.py`` — the GPipe / 1F1B pipeline-bubble schedule model and its
  measured-vs-modeled drift helpers;
- ``session.py`` — :class:`Telemetry`, the training session
  (``metrics.jsonl``, ``trace.json``, ``metrics.prom`` under one
  directory);
- ``ici.py`` — the static collective-bytes gauge: the step traced by the
  program linter (``analysis``), its cost table summed per step;
- ``catalog.py`` — the docstring-sourced metric-help catalog behind the
  exposition's ``# HELP`` lines;
- ``slo.py`` / ``alerts.py`` — the streaming SLO engine and its
  tick-stamped alerts; ``attribution.py`` — per-request TTFT attribution;
- ``report.py`` — the run-report CLI.

Entry points: ``Trainer(..., telemetry=Telemetry(dir))`` and ``cli.py
--telemetry-dir DIR [--telemetry-every N]``.
"""

from simple_distributed_machine_learning_tpu_torch.telemetry.bubble import (
    ideal_step_time,
    schedule_bubble_fraction,
)
from simple_distributed_machine_learning_tpu_torch.telemetry.ici import (
    expected_ici_bytes,
)
from simple_distributed_machine_learning_tpu_torch.telemetry.memory import (
    device_memory_stats,
    live_array_bytes,
)
from simple_distributed_machine_learning_tpu_torch.telemetry.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    append_jsonl,
)
from simple_distributed_machine_learning_tpu_torch.telemetry.session import (
    METRICS_FILE,
    PROM_FILE,
    TRACE_FILE,
    Telemetry,
)
from simple_distributed_machine_learning_tpu_torch.telemetry.timer import (
    StepTimer,
    compiled_cost_stats,
)
from simple_distributed_machine_learning_tpu_torch.telemetry.tracing import (
    Tracer,
)

__all__ = [
    "METRICS_FILE", "PROM_FILE", "TRACE_FILE",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "StepTimer",
    "Telemetry", "Tracer", "append_jsonl", "compiled_cost_stats",
    "device_memory_stats", "expected_ici_bytes", "ideal_step_time",
    "live_array_bytes",
    "schedule_bubble_fraction",
]
