"""The tick flight recorder and post-mortem bundles: crash forensics
(port of ``serve/flight.py``).

:class:`FlightRecorder` is a bounded ring of per-tick engine snapshots:
slot occupancy, queue depth and per-class queue composition, the paged
pool's block stats (``PagedKVPool.stats()``, host-side counters only, so
a snap never synchronises the device), prefill backlog, and the caller's
state block (the supervisor's restarts, degraded modes, pool role and
active SLO alerts). The serve supervisor snaps it once per tick at its
monotonic tick.

:func:`write_bundle` dumps one JSON file (atomic rename): the last-N
flight rows, every request's state, a metrics-registry snapshot, the
journal tail and the caller's state block. The serve supervisor writes
one on every engine restart, on a ``DrainTimeout`` and on a shed burst.

Bundles carry tick indices and timestamps already read, never a fresh
clock read, so writing one from a virtual-clock scenario cannot move its
pinned numbers.
"""

from __future__ import annotations

import collections
import json
import os

DEFAULT_CAPACITY = 256
BUNDLE_PREFIX = "postmortem"


class FlightRecorder:
    """Bounded ring of per-tick snapshot rows (oldest evicted first)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._ring: collections.deque[dict] = collections.deque(
            maxlen=self.capacity)
        self.ticks_recorded = 0

    def record(self, row: dict) -> None:
        self.ticks_recorded += 1
        self._ring.append(row)

    def rows(self) -> list[dict]:
        """Oldest-first snapshot list (at most ``capacity`` rows)."""
        return list(self._ring)

    def snap(self, engine, tick: int, emitted: int, **extra) -> dict:
        """Build and record one tick's snapshot row from engine state.

        ``tick`` is the monotonic tick (the supervisor's counter, which
        survives engine rebuilds and which journal records carry, so
        bundle rows and journal lines join exactly); ``extra`` is the
        caller's state block."""
        queue_cls = collections.Counter(
            r.cls for r in engine.scheduler.queue if r.cls is not None)
        row = {
            "tick": int(tick),
            "engine_tick": int(engine._tick_count),
            "emitted": int(emitted),
            "queue_depth": int(engine.scheduler.queue_depth),
            "queue_by_class": dict(sorted(queue_cls.items())),
            "slots_active": int(engine.pool.n_active),
            "slots_total": int(engine.pool.n_slots),
            "prefill_backlog": len(engine._prefilling),
        }
        if engine.kv_layout == "paged":
            row["blocks"] = engine.pool.stats()
        row.update(extra)
        self.record(row)
        return row


def request_states(requests) -> list[dict]:
    """JSON-serialisable state of every request handle, in rid order."""
    out = []
    for rid in sorted(requests):
        r = requests[rid]
        out.append({
            "rid": rid, "state": r.state, "cls": r.cls,
            "priority": r.priority,
            "prompt_len": int(r.prompt.shape[0]),
            "max_new_tokens": int(r.max_new_tokens),
            "tokens_emitted": len(r.tokens),
            "slot": r.slot, "prefill_pos": r.prefill_pos,
            "n_preempted": r.n_preempted,
            "finish_reason": r.finish_reason,
        })
    return out


def write_bundle(path: str, *, trigger: str, cause: str, tick: int,
                 flight: FlightRecorder | None, requests, registry=None,
                 journal_tail=None, **extra) -> str:
    """Write one post-mortem bundle JSON to ``path``; returns the path.

    ``trigger`` is why (``restart`` | ``drain_timeout`` | ``shed_burst``
    | ``restart_budget``), ``cause`` the precipitating exception, ``tick``
    the supervisor's monotonic tick; ``flight`` contributes its last-N
    rows, ``registry`` (a ``MetricsRegistry``)
    contributes its snapshot, ``journal_tail`` the last journal events."""
    bundle = {
        "kind": "postmortem",
        "trigger": trigger,
        "cause": cause,
        "tick": int(tick),
        "flight": flight.rows() if flight is not None else [],
        "flight_ticks_recorded": (flight.ticks_recorded
                                  if flight is not None else 0),
        "requests": request_states(requests),
        **extra,
    }
    if registry is not None:
        bundle["metrics"] = registry.snapshot()
    if journal_tail is not None:
        bundle["journal_tail"] = list(journal_tail)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(bundle, f)
    os.replace(tmp, path)
    return path
