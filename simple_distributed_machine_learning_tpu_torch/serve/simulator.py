"""Open-loop traffic simulator: seeded arrivals driving the engine.

Port of ``serve/simulator.py``. *Open-loop*: requests arrive on their own
clock (exponential inter-arrival gaps at ``rate`` req/s, seeded) whether
or not slots are free — above capacity the queue grows and TTFT absorbs
the wait. The workload — arrival times, prompts, sampling configs and
per-request seeds — is drawn from the same numpy stream as the JAX
package's, so one ``SimConfig`` is one trace in both packages, and each
request's tokens are a pure function of its own (prompt, params, seed).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from simple_distributed_machine_learning_tpu_torch.serve.request import (
    DONE,
    SHED,
)


@dataclasses.dataclass(frozen=True)
class TrafficClass:
    """One tenant/priority class of a multi-class workload: ``weight`` is
    its share of arrivals, ``priority`` feeds the scheduler, the SLO
    targets grade a run, ``max_new_tokens``/``prompt_lens`` override the
    config-wide mix, the deadlines ride on each submission,
    ``shared_prefix=False`` opts out of the shared system prompt, and
    ``adapter`` names the LoRA adapter every request of the class decodes
    under (registered on the target before traffic starts; None = the
    base model)."""

    name: str
    weight: float = 1.0
    priority: int = 0
    ttft_slo_ms: float | None = None
    tpot_slo_ms: float | None = None
    max_new_tokens: int | None = None
    prompt_lens: tuple | None = None
    ttft_deadline_ms: float | None = None
    deadline_ms: float | None = None
    shared_prefix: bool = True
    adapter: str | None = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("traffic class name must be non-empty")
        if self.weight <= 0:
            raise ValueError(f"class {self.name!r}: weight must be > 0, "
                             f"got {self.weight}")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """One traffic run: ``n_requests`` arrivals at mean ``rate`` req/s.

    ``arrival``: ``"poisson"`` (homogeneous), ``"bursty"`` (on/off
    modulated: ``burst_factor`` x the rate for ``burst_duty`` of every
    ``period_s``) or ``"diurnal"`` (sinusoidal, amplitude
    ``diurnal_amplitude``). ``classes`` switches on the multi-class
    workload. Prompt lengths cycle through ``prompt_lens``;
    ``sampled_fraction`` of requests sample at ``temperature`` with
    ``top_k``; ``shared_prefix_len`` prepends one seeded common prefix to
    every prompt (the prefix-sharing case).
    """

    n_requests: int = 16
    rate: float = 8.0
    seed: int = 0
    arrival: str = "poisson"
    burst_factor: float = 5.0
    burst_duty: float = 0.25
    period_s: float = 1.0
    diurnal_amplitude: float = 0.8
    classes: tuple = ()
    prompt_lens: tuple = (4, 8, 12)
    max_new_tokens: int = 16
    sampled_fraction: float = 0.5
    temperature: float = 0.8
    top_k: int | None = 8
    eos_id: int | None = None
    shared_prefix_len: int = 0

    def __post_init__(self):
        if self.n_requests < 1:
            raise ValueError(f"n_requests must be >= 1, got "
                             f"{self.n_requests}")
        if self.rate <= 0:
            raise ValueError(f"rate must be > 0 req/s, got {self.rate}")
        if not self.prompt_lens:
            raise ValueError("prompt_lens must be non-empty")
        if self.shared_prefix_len < 0:
            raise ValueError(f"shared_prefix_len must be >= 0, got "
                             f"{self.shared_prefix_len}")
        if self.arrival not in ("poisson", "bursty", "diurnal"):
            raise ValueError(
                f"arrival must be poisson|bursty|diurnal, got "
                f"{self.arrival!r}")
        if self.burst_factor < 1:
            raise ValueError(f"burst_factor must be >= 1, got "
                             f"{self.burst_factor}")
        if not 0 < self.burst_duty < 1:
            raise ValueError(f"burst_duty must be in (0, 1), got "
                             f"{self.burst_duty}")
        if self.period_s <= 0:
            raise ValueError(f"period_s must be > 0, got {self.period_s}")
        if not 0 <= self.diurnal_amplitude < 1:
            raise ValueError(f"diurnal_amplitude must be in [0, 1), got "
                             f"{self.diurnal_amplitude}")
        names = [c.name for c in self.classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate traffic class names: {names}")


def _rate_fn(sim: SimConfig):
    """The arrival-rate profile ``rate(t)`` and its ceiling (for
    thinning)."""
    rate, period = sim.rate, sim.period_s
    if sim.arrival == "bursty":
        duty, factor = sim.burst_duty, sim.burst_factor
        trough = max(rate * (1 - duty * factor) / (1 - duty), 0.05 * rate)
        peak = factor * rate

        def fn(t):
            return peak if (t % period) < duty * period else trough
        return fn, peak
    if sim.arrival == "diurnal":
        amp = sim.diurnal_amplitude

        def fn(t):
            return rate * (1.0 + amp * np.sin(2.0 * np.pi * t / period))
        return fn, rate * (1.0 + amp)
    return (lambda t: rate), rate


def _arrival_times(sim: SimConfig, rng) -> np.ndarray:
    """Seeded arrival stamps: one vectorised exponential draw for poisson,
    thinning for the modulated patterns."""
    if sim.arrival == "poisson":
        return np.cumsum(rng.exponential(1.0 / sim.rate, sim.n_requests))
    rate_fn, rate_max = _rate_fn(sim)
    times = np.empty(sim.n_requests)
    t, i = 0.0, 0
    while i < sim.n_requests:
        t += rng.exponential(1.0 / rate_max)
        if rng.random() * rate_max <= rate_fn(t):
            times[i] = t
            i += 1
    return times


def build_workload(sim: SimConfig, vocab: int) -> tuple[np.ndarray, list]:
    """Seeded ``(arrival_times [N], request_specs)`` — ``submit`` kwargs;
    request ``i``'s sampling seed is ``sim.seed * 100003 + i``."""
    rng = np.random.default_rng(sim.seed)
    arrivals = _arrival_times(sim, rng)
    prefix = rng.integers(0, vocab, sim.shared_prefix_len).astype(np.int32)
    weights = None
    if sim.classes:
        w = np.asarray([c.weight for c in sim.classes], np.float64)
        weights = w / w.sum()
    specs = []
    for i in range(sim.n_requests):
        cls = (sim.classes[int(rng.choice(len(sim.classes), p=weights))]
               if sim.classes else None)
        lens = (cls.prompt_lens if cls is not None and cls.prompt_lens
                else sim.prompt_lens)
        t0 = int(lens[i % len(lens)])
        body = rng.integers(0, vocab, t0).astype(np.int32)
        prompt = (np.concatenate([prefix, body])
                  if cls is None or cls.shared_prefix else body)
        sampled = rng.random() < sim.sampled_fraction
        spec = dict(
            prompt=prompt,
            max_new_tokens=(cls.max_new_tokens
                            if cls is not None and cls.max_new_tokens
                            else sim.max_new_tokens),
            temperature=sim.temperature if sampled else 0.0,
            top_k=sim.top_k if sampled else None,
            eos_id=sim.eos_id,
            seed=sim.seed * 100003 + i,
        )
        if cls is not None:
            spec["cls"] = cls.name
            spec["priority"] = cls.priority
            if cls.ttft_deadline_ms is not None:
                spec["ttft_deadline_s"] = cls.ttft_deadline_ms / 1e3
            if cls.deadline_ms is not None:
                spec["deadline_s"] = cls.deadline_ms / 1e3
            if cls.adapter is not None:
                spec["adapter"] = cls.adapter
        specs.append(spec)
    return arrivals, specs


def simulate(engine, sim: SimConfig, clock=None, sleep=time.sleep,
             should_stop=None) -> dict:
    """Run the open-loop trace through ``engine`` (an ``InferenceEngine``
    or a ``ServeSupervisor``, which has the same surface); returns the
    report dict (JSON-serialisable; the live handles stay in
    ``engine.requests``). Supervised runs report shed requests under
    ``"shed"``.

    Submits every request whose arrival time has passed, ticks while
    anything is in flight, sleeps briefly only when idle. ``clock``
    defaults to the engine's, so arrival stamps and first-token stamps
    share one origin.

    ``should_stop`` is the graceful-shutdown hook (the CLI's SIGTERM /
    SIGINT handler): once it returns truthy, admission stops and the loop
    drains every in-flight request before returning (``report["stopped"]``
    is True, ``report["submitted"]`` counts what entered the engine)."""
    clock = engine._clock if clock is None else clock
    arrivals, specs = build_workload(sim, engine.cfg.vocab)
    handles = []
    start = clock()
    i = 0
    stopped = False
    while i < sim.n_requests or engine.busy:
        if not stopped and should_stop is not None and should_stop():
            stopped = True
        if stopped:
            if not engine.busy:
                break
            engine.step()
            continue
        t = clock() - start
        while i < sim.n_requests and arrivals[i] <= t:
            handles.append(engine.submit(
                **specs[i], arrival_time=start + float(arrivals[i])))
            i += 1
        if engine.busy:
            engine.step()
        elif i < sim.n_requests:
            sleep(min(max(arrivals[i] - (clock() - start), 0.0), 0.05))
    wall_s = clock() - start
    completed = sum(1 for h in handles if h.state == DONE)
    shed = sum(1 for h in handles if h.state == SHED)
    report = {
        "n_requests": sim.n_requests,
        "rate": sim.rate,
        "submitted": len(handles),
        "completed": completed,
        "shed": shed,
        "all_completed": completed == sim.n_requests,
        "stopped": stopped,
        "wall_s": round(wall_s, 3),
        "requests": [
            {"rid": h.rid, "prompt_len": int(h.prompt.shape[0]),
             "n_tokens": len(h.tokens), "finish_reason": h.finish_reason,
             "ttft_s": None if h.ttft_s is None else round(h.ttft_s, 4),
             "tpot_s": None if h.tpot_s is None else round(h.tpot_s, 5),
             **({"cls": h.cls, "priority": h.priority,
                 "n_preempted": h.n_preempted} if h.cls is not None else {})}
            for h in handles],
    }
    if engine.metrics is not None:
        report.update(engine.metrics.summary())
    return report
