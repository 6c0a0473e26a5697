"""Throughput metering (port of ``utils/metrics.py``).

A host-clock meter: a caller that times device work synchronises the
device before it resets the meter and before it reads it (the Trainer
does), or the rate measures the host's enqueue.
"""

from __future__ import annotations

import time


class Throughput:
    """Tracks samples/sec over a window of steps (host-side wall clock)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._samples = 0
        self._steps = 0

    def update(self, n_samples: int) -> None:
        self._samples += n_samples
        self._steps += 1

    @property
    def samples_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._samples / dt if dt > 0 else 0.0

    @property
    def steps_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._steps / dt if dt > 0 else 0.0
