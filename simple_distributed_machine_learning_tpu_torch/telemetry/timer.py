"""Step timing: compile-vs-steady split, latency quantiles, throughput
(port of ``telemetry/timer.py``).

PyTorch on the card dispatches asynchronously: ``time.perf_counter()``
around a step call times the ENQUEUE, not the execution — and the first
executed step carries one-time costs (kernel builds, cuBLAS/cuDNN handle
creation, allocator growth) inside its wall time. :class:`StepTimer` owns
both problems:

- a *window* is the wall-clock interval between two device fences
  (``torch.cuda.synchronize`` after something the step returned), covering
  ``steps`` dispatched steps — the only host-side measurement that equals
  device time;
- the FIRST window ever recorded is the compile window (the one-time costs
  + first step) and is kept out of the steady-state histogram, as
  ``Trainer.train_epoch`` keeps its first batch out of the throughput
  meter;
- steady windows feed a weighted histogram of per-step latency
  (p50/p95/max), plus running examples/sec and tokens/sec over the steady
  time only.

``compiled_cost_stats`` is the optional static sibling: the FLOPs of one
call, counted by ``torch.utils.flop_counter.FlopCounterMode``. It runs the
function once, so it is opt-in, never on a hot path.
"""

from __future__ import annotations

from simple_distributed_machine_learning_tpu_torch.telemetry.registry import (
    Histogram,
    MetricsRegistry,
)


class StepTimer:
    """Accumulates fenced timing windows; see module docstring.

    ``registry``: when given, the per-step latency histogram is registered
    there as ``step_time_ms`` (so it rides every snapshot / Prometheus
    export); otherwise a private histogram is used.
    """

    def __init__(self, registry: MetricsRegistry | None = None,
                 name: str = "step_time_ms") -> None:
        self.compile_time_s: float | None = None
        self._hist = (registry.histogram(name) if registry is not None
                      else Histogram(name))
        self._steady_s = 0.0
        self._examples = 0.0
        self._tokens = 0.0

    def record_window(self, seconds: float, steps: int = 1,
                      examples: float = 0, tokens: float = 0) -> None:
        """One fence-to-fence interval covering ``steps`` dispatched steps.

        The first window ever recorded is taken as the compile window and
        excluded from the steady statistics.
        """
        if steps < 1:
            return
        if self.compile_time_s is None:
            self.compile_time_s = float(seconds)
            return
        self._hist.observe(seconds / steps * 1e3, n=steps)
        self._steady_s += float(seconds)
        self._examples += examples
        self._tokens += tokens

    # -- steady-state statistics ------------------------------------------

    @property
    def steps(self) -> int:
        return int(self._hist.count)

    @property
    def examples_per_sec(self) -> float:
        return self._examples / self._steady_s if self._steady_s > 0 else 0.0

    @property
    def tokens_per_sec(self) -> float:
        return self._tokens / self._steady_s if self._steady_s > 0 else 0.0

    def quantile_ms(self, q: float) -> float | None:
        return self._hist.quantile(q)

    def summary(self) -> dict:
        """The metric record block every consumer (trainer epoch emission,
        the CLI's decode record) embeds; ms values rounded to keep JSONL
        lines readable."""
        r3 = (lambda v: None if v is None else round(v, 3))
        return {
            "compile_time_s": r3(self.compile_time_s),
            "steps": self.steps,
            "step_time_ms_p50": r3(self._hist.quantile(0.5)),
            "step_time_ms_p95": r3(self._hist.quantile(0.95)),
            "step_time_ms_max": r3(self._hist.max),
            "examples_per_sec": round(self.examples_per_sec, 1),
            "tokens_per_sec": (round(self.tokens_per_sec, 1)
                               if self._tokens else None),
        }


def compiled_cost_stats(fn, *args, **kwargs) -> dict | None:
    """The FLOPs of one call ``fn(*args, **kwargs)``, counted by
    ``torch.utils.flop_counter.FlopCounterMode``.

    Returns ``{"flops": ...}``, or ``None`` when the count fails or comes
    out zero — an optional signal, never a gate: it never raises. It RUNS
    the function once on the given inputs, so call it off the hot path.
    """
    try:
        from torch.utils.flop_counter import FlopCounterMode

        with FlopCounterMode(display=False) as counter:
            fn(*args, **kwargs)
        flops = float(counter.get_total_flops())
        return {"flops": flops} if flops > 0 else None
    except Exception:  # noqa: BLE001 - strictly best-effort introspection
        return None
