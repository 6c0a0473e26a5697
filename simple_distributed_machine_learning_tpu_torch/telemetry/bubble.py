"""Pipeline-bubble accounting for the GPipe and 1F1B schedules (port of
``telemetry/bubble.py``, copied whole: pure arithmetic).

The schedule model: a pipeline step is a sequence of *slots* (one
microbatch's forward-or-backward on one stage). With ``S`` stages and ``M``
microbatches, both schedules the JAX engine implements fill and drain the
pipeline once per optimizer step:

- GPipe (``parallel/pipeline.py``): a scanned all-forward sweep of
  ``M + S - 1`` ticks, then autodiff runs the transposed sweep — another
  ``M + S - 1`` ticks of backward slots;
- non-interleaved 1F1B / PipeDream-flush (``parallel/onefb.py``): ``S - 1``
  warmup forwards, a steady one-forward-one-backward phase, ``S - 1``
  cooldown backwards — ``M + S - 1`` combined fwd+bwd ticks.

Either way every stage is idle for ``S - 1`` of the ``M + S - 1`` ticks, so
the bubble fraction — idle time over total time, equivalently
``1 - ideal_step_time / measured_step_time`` under the uniform-slot model —
is ``(S - 1) / (M + S - 1)`` for BOTH schedules. Non-interleaved 1F1B's win
is activation MEMORY (O(S) vs O(M) live microbatches), not bubble time, so
callers may rely on ``bubble('1f1b') <= bubble('gpipe')`` holding with
equality; an interleaved (virtual-stage) schedule would strictly shrink it.
"""

from __future__ import annotations


def schedule_bubble_fraction(n_stages: int, n_microbatches: int,
                             schedule: str = "gpipe") -> float:
    """Fraction of a step each stage spends idle under the schedule model.

    ``(S - 1) / (M + S - 1)``; 0.0 for a single-stage (fused) pipeline.
    ``schedule`` is validated against the engine's two schedules so a typo
    cannot silently read as GPipe.
    """
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown schedule {schedule!r}")
    s = max(1, int(n_stages))
    m = max(1, int(n_microbatches))
    if s == 1:
        return 0.0
    return (s - 1) / (m + s - 1)


def ideal_step_time(measured_step_s: float, n_stages: int,
                    n_microbatches: int, schedule: str = "gpipe") -> float:
    """Bubble-free step time implied by a measured one.

    Anchors the slot model to a measurement: the measured step is
    ``M + S - 1`` uniform ticks, the ideal (every stage busy every tick)
    would be ``M`` — i.e. ``measured x (1 - bubble_fraction)``. This is the
    "ideal stage time x stages vs measured step time" estimate: the gap to
    the returned value is what schedule tuning (more microbatches,
    interleaving) can recover; the rest needs faster stages.
    """
    frac = schedule_bubble_fraction(n_stages, n_microbatches, schedule)
    return measured_step_s * (1.0 - frac)


def measured_bubble_fraction(measured_step_s: float,
                             ideal_step_s: float) -> float:
    """The MEASURED bubble: idle share implied by a real step time against
    a bubble-free reference — ``1 - ideal / measured``, clamped to
    ``[0, 1]``.

    ``ideal_step_s`` is a bubble-free calibration of the same work: a
    single-stage (fused) run of the identical model and microbatch count,
    or an analytic estimate. Unlike :func:`ideal_step_time` (which
    *assumes* the schedule model to back the ideal out of one
    measurement), this takes the reference as an independent input — so
    comparing the result to :func:`schedule_bubble_fraction` is a real
    check, not a tautology."""
    if measured_step_s <= 0 or ideal_step_s <= 0:
        raise ValueError(
            f"step times must be > 0, got measured={measured_step_s}, "
            f"ideal={ideal_step_s}")
    return min(1.0, max(0.0, 1.0 - ideal_step_s / measured_step_s))


def bubble_drift(n_stages: int, n_microbatches: int, schedule: str,
                 measured_step_s: float, ideal_step_s: float) -> float:
    """Measured minus modeled bubble fraction — the pipeline twin of the
    serving KV-drift gauge: ~0 when the uniform-slot schedule model holds,
    positive when real stages idle longer than ``(S-1)/(M+S-1)`` predicts
    (imbalanced stages, comm on the critical path), negative when overlap
    hides more than the model credits."""
    return (measured_bubble_fraction(measured_step_s, ideal_step_s)
            - schedule_bubble_fraction(n_stages, n_microbatches, schedule))
