"""The per-run telemetry session: registry + tracer + step timer, wired
(port of ``telemetry/session.py``).

:class:`Telemetry` is the object the trainer and CLI thread through: it
owns one :class:`MetricsRegistry`, one :class:`Tracer` and one
:class:`StepTimer`, drives the fence-every-N-steps sampling discipline, and
emits per-epoch records to ``<dir>/metrics.jsonl`` plus the Chrome trace
(``trace.json``) and Prometheus exposition (``metrics.prom``) — rewritten at
every epoch so the artifacts exist and parse mid-run, not only after a clean
exit.

Sampling discipline (``every``): fencing the device every step serializes
the host's dispatch with the card's execution — correct timing, but it
forfeits the host running ahead of the device. ``every=N`` fences only
every Nth step and attributes the window to all N steps (a weighted
histogram observation), so steady-state telemetry costs one drain per N
steps. ``every=1`` (the default) is exact per-step latency.

Multi-process runs: every process records (spans and timers are host-local),
only process 0 writes files — same rule as the reference-format console.

Not ported: the static ICI-bytes gauge (``set_step_probe``,
``telemetry/ici.py``), which reads the analyzer's cost table (ROADMAP
Queue A item 6); without a probe the epoch record has no ``ici_*`` keys,
as the JAX record has none without one.
"""

from __future__ import annotations

import os
import time

import torch

from simple_distributed_machine_learning_tpu_torch import _roadmap
from simple_distributed_machine_learning_tpu_torch.telemetry import memory
from simple_distributed_machine_learning_tpu_torch.telemetry.bubble import (
    measured_bubble_fraction,
    schedule_bubble_fraction,
)
from simple_distributed_machine_learning_tpu_torch.telemetry.registry import (
    MetricsRegistry,
    append_jsonl,
)
from simple_distributed_machine_learning_tpu_torch.telemetry.timer import (
    StepTimer,
)
from simple_distributed_machine_learning_tpu_torch.telemetry.tracing import (
    Tracer,
)

METRICS_FILE = "metrics.jsonl"
TRACE_FILE = "trace.json"
PROM_FILE = "metrics.prom"


class Telemetry:
    """One training run's telemetry session; see module docstring."""

    def __init__(self, outdir: str, every: int = 1,
                 process_name: str = "sdml") -> None:
        if every < 1:
            raise ValueError(f"telemetry every={every}: must be >= 1")
        self.outdir = outdir
        self.every = int(every)
        self.registry = MetricsRegistry()
        self.tracer = Tracer(process_name=process_name)
        self.timer = StepTimer(registry=self.registry)
        self._steps_seen = 0
        self._mark = time.perf_counter()
        self._win_steps = 0
        self._win_examples = 0.0
        self._win_tokens = 0.0
        self._ideal_step_s = None   # bubble-free reference (set_bubble_reference)
        if self._is_main():
            os.makedirs(outdir, exist_ok=True)

    @staticmethod
    def _is_main() -> bool:
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank() == 0
        return True

    # -- spans -------------------------------------------------------------

    def span(self, name: str, **attrs):
        """Host span: on the Chrome trace, and on ``torch.profiler``'s
        timeline when capturing."""
        return self.tracer.span(name, **attrs)

    # -- step sampling -----------------------------------------------------

    def mark(self) -> None:
        """Reset the timing window start (call when entering a training
        loop, or after untimed work — checkpointing, eval — so the next
        window measures only steps). Any unfenced partial window is
        discarded, not misattributed."""
        self._mark = time.perf_counter()
        self._win_steps = 0
        self._win_examples = 0.0
        self._win_tokens = 0.0

    def on_step(self, fence, *, examples: float = 0, tokens: float = 0,
                force_fence: bool = False) -> None:
        """Account one dispatched training step.

        ``fence`` is a tensor the step returned. Every ``every``-th step
        (or on ``force_fence`` — the trainer forces each epoch's first
        batch; the run's first is the compile window) the device is fenced
        (``torch.cuda.synchronize`` on the fence's card; a CPU tensor is
        already computed) and the whole window is recorded.
        """
        self._steps_seen += 1
        self._win_steps += 1
        self._win_examples += examples
        self._win_tokens += tokens
        if not (force_fence or self._steps_seen % self.every == 0):
            return
        if isinstance(fence, torch.Tensor) and fence.device.type == "cuda":
            torch.cuda.synchronize(fence.device)
        now = time.perf_counter()
        self.timer.record_window(now - self._mark, steps=self._win_steps,
                                 examples=self._win_examples,
                                 tokens=self._win_tokens)
        self._mark = now
        self._win_steps = 0
        self._win_examples = 0.0
        self._win_tokens = 0.0

    # -- bubble drift (measured vs modeled pipeline idle) ------------------

    def set_bubble_reference(self, ideal_step_s: float) -> None:
        """Register a bubble-free step-time reference (a fused/1-stage run
        of the same work, or an analytic estimate). With it, every epoch
        record gains ``bubble_fraction_measured`` and ``bubble_drift``
        (measured − modeled — the schedule model checked against reality,
        the training twin of serving's ``serve_kv_drift_bytes``). Without
        a reference the drift is simply not emitted — never fabricated
        from the model itself, which would be a tautology."""
        if ideal_step_s <= 0:
            raise ValueError(
                f"ideal_step_s must be > 0, got {ideal_step_s}")
        self._ideal_step_s = float(ideal_step_s)

    # -- static step probe (ICI bytes) ------------------------------------

    def set_step_probe(self, fn, *abstract_args, mesh=None,
                       **abstract_kwargs) -> None:
        """The static ICI-bytes gauge reads the analyzer's collective cost
        table, which waits for the port's sharded axes."""
        raise _roadmap.not_ported("the static ICI-bytes gauge "
                                  "(Telemetry.set_step_probe)",
                                  _roadmap.PARALLEL_AXES)

    # -- emission ----------------------------------------------------------

    def epoch_record(self, epoch: int, pipe=None, extra: dict | None = None
                     ) -> dict:
        """Build the per-epoch record: step-latency quantiles + throughput
        (StepTimer), memory sample, schedule bubble estimate, and any
        caller fields (losses, accuracy)."""
        self.registry.counter("epochs_total").inc()
        rec: dict = {"kind": "epoch", "epoch": int(epoch)}
        rec.update(self.timer.summary())
        rec.update(memory.sample(self.registry))
        if pipe is not None:
            frac = schedule_bubble_fraction(pipe.n_stages,
                                            pipe.n_microbatches,
                                            pipe.schedule)
            rec["schedule"] = pipe.schedule
            rec["n_stages"] = pipe.n_stages
            rec["n_microbatches"] = pipe.n_microbatches
            rec["bubble_fraction"] = round(frac, 4)
            self.registry.gauge("bubble_fraction").set(frac)
            p50 = rec.get("step_time_ms_p50")
            if self._ideal_step_s is not None and p50:
                measured = measured_bubble_fraction(p50 / 1e3,
                                                    self._ideal_step_s)
                rec["bubble_fraction_measured"] = round(measured, 4)
                rec["bubble_drift"] = round(measured - frac, 4)
                self.registry.gauge("bubble_fraction_measured").set(measured)
                self.registry.gauge("bubble_drift").set(measured - frac)
        for name in ("examples_per_sec", "tokens_per_sec"):
            if rec.get(name):
                self.registry.gauge(name).set(rec[name])
        if extra:
            rec.update(extra)
        return rec

    def on_epoch(self, epoch: int, pipe=None, extra: dict | None = None
                 ) -> dict:
        """Emit one epoch record and refresh every on-disk artifact."""
        rec = self.epoch_record(epoch, pipe=pipe, extra=extra)
        self.tracer.instant("epoch_end", epoch=epoch)
        if self._is_main():
            rec = append_jsonl(os.path.join(self.outdir, METRICS_FILE), rec)
            self.flush()
        return rec

    def flush(self) -> None:
        """Rewrite trace.json and metrics.prom from current state."""
        if not self._is_main():
            return
        self.tracer.write(os.path.join(self.outdir, TRACE_FILE))
        with open(os.path.join(self.outdir, PROM_FILE), "w") as f:
            f.write(self.registry.prometheus_text())

    def close(self) -> None:
        self.flush()
