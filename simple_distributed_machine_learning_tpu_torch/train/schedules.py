"""Learning-rate schedules (port of ``train/schedules.py``).

A schedule is a function ``step -> lr`` that the optimizers call once per
update with their own step counter: the k-th update (0-indexed) runs at
``schedule(k)``, torch's ``opt.step(); sched.step()`` convention. The JAX
package evaluates them in f32 inside its compiled step; here they are
plain Python floats (no device work, no host sync).
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def constant(lr: float) -> Schedule:
    def f(t):
        return float(lr)
    return f


def cosine(base_lr: float, total_steps: int,
           final_frac: float = 0.0) -> Schedule:
    """Cosine decay from ``base_lr`` to ``final_frac * base_lr`` over
    ``total_steps`` (clamped there for any later steps)."""
    total = max(int(total_steps), 1)

    def f(t):
        frac = min(max(int(t) / total, 0.0), 1.0)
        cos = 0.5 * (1.0 + math.cos(math.pi * frac))
        return base_lr * (final_frac + (1.0 - final_frac) * cos)
    return f


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.0) -> Schedule:
    """Linear warmup 0 -> base over ``warmup_steps`` (the k-th update at
    ``base * (k+1)/warmup``), then cosine decay over the remaining steps."""
    warm = max(int(warmup_steps), 0)
    decay = cosine(base_lr, max(int(total_steps) - warm, 1), final_frac)

    def f(t):
        t = int(t)
        if t < warm:
            return base_lr * (t + 1.0) / max(warm, 1)
        return decay(t - warm)
    return f


def step_decay(base_lr: float, step_size: int,
               gamma: float = 0.1) -> Schedule:
    """torch ``StepLR``: lr = base * gamma^floor(t / step_size)."""
    size = max(int(step_size), 1)

    def f(t):
        return base_lr * gamma ** (int(t) // size)
    return f
