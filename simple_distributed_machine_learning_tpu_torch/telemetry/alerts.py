"""Tick-stamped alert state machines: inactive→pending→firing→resolved.

Port of ``telemetry/alerts.py`` (no JAX; the port keeps its own copy).
The SLO engine (``telemetry/slo.py``) turns windowed latency/shed series
into burn rates; this module turns burn rates into *alerts* the way an
SRE pager pipeline does, with one deliberate twist: **nothing here ever
reads a clock**. Every evaluation is stamped with the engine/fleet tick
the caller passes in, so under ``resilience/scenarios.py``'s virtual
clock the full transition history is exactly reproducible — the scenario
suite pins fire/resolve *ticks*, not wall timestamps.

State machine (one transition per evaluation, never a same-tick cascade,
so ``pending`` is always journaled before ``firing``)::

    inactive --cond--> pending --cond x pending_ticks--> firing
       ^                  |                                 |
       |               !cond                     !cond x resolve_ticks
       +------------------+                                 |
       +---- (next evaluation) <---------- resolved <-------+

``resolved`` is a one-evaluation state — the explicit "this alert just
cleared" journal row — decaying to ``inactive`` (or straight back to
``pending`` if the condition re-trips) on the next evaluation.

Every transition appends one journal dict ``{"tick", "alert", "from",
"to", ...context}`` to :attr:`AlertBook.journal` — the rows
``run_scenario`` lands in ``metrics.jsonl`` as ``kind: "slo_alert"``
records, and what post-mortem bundles replay their active set from.
"""

from __future__ import annotations

STATES = ("inactive", "pending", "firing", "resolved")


class Alert:
    """One alert key's state machine; see module docstring.

    ``pending_ticks`` — consecutive breaching evaluations required in
    ``pending`` before ``firing`` (≥ 1: an alert is never firing before
    its second consecutive breach, so a single-tick blip cannot page);
    ``resolve_ticks`` — consecutive clear evaluations required in
    ``firing`` before ``resolved`` (the un-flap hysteresis).
    """

    def __init__(self, key: str, *, pending_ticks: int = 2,
                 resolve_ticks: int = 4) -> None:
        if pending_ticks < 1 or resolve_ticks < 1:
            raise ValueError(
                f"pending_ticks/resolve_ticks must be >= 1, got "
                f"{pending_ticks}/{resolve_ticks}")
        self.key = key
        self.state = "inactive"
        self.pending_ticks = int(pending_ticks)
        self.resolve_ticks = int(resolve_ticks)
        self._true_streak = 0
        self._false_streak = 0
        self.fired_at: int | None = None     # tick of the last -> firing
        self.resolved_at: int | None = None  # tick of the last -> resolved

    @property
    def firing(self) -> bool:
        return self.state == "firing"

    def evaluate(self, tick: int, breaching: bool) -> tuple | None:
        """One evaluation at ``tick``; returns ``(from, to)`` when the
        state moved, else None. At most one transition per call."""
        if breaching:
            self._true_streak += 1
            self._false_streak = 0
        else:
            self._true_streak = 0
            self._false_streak += 1
        prev = self.state
        if prev == "inactive":
            if breaching:
                self.state = "pending"
        elif prev == "pending":
            if not breaching:
                self.state = "inactive"
            elif self._true_streak >= self.pending_ticks:
                self.state = "firing"
                self.fired_at = int(tick)
        elif prev == "firing":
            if not breaching and self._false_streak >= self.resolve_ticks:
                self.state = "resolved"
                self.resolved_at = int(tick)
        else:                                   # resolved: one-eval state
            self.state = "pending" if breaching else "inactive"
        return (prev, self.state) if self.state != prev else None


class AlertBook:
    """All of one engine's alerts plus their shared transition journal."""

    def __init__(self, *, pending_ticks: int = 2,
                 resolve_ticks: int = 4) -> None:
        self.pending_ticks = int(pending_ticks)
        self.resolve_ticks = int(resolve_ticks)
        self._alerts: dict[str, Alert] = {}
        self.journal: list[dict] = []

    def get(self, key: str) -> Alert:
        a = self._alerts.get(key)
        if a is None:
            a = self._alerts[key] = Alert(
                key, pending_ticks=self.pending_ticks,
                resolve_ticks=self.resolve_ticks)
        return a

    def evaluate(self, key: str, tick: int, breaching: bool,
                 **context) -> dict | None:
        """Evaluate ``key`` at ``tick``; journals and returns the
        transition row when the state moved. ``context`` (burn rates,
        window counts) rides along on the journal row."""
        moved = self.get(key).evaluate(tick, breaching)
        if moved is None:
            return None
        row = {"tick": int(tick), "alert": key,
               "from": moved[0], "to": moved[1], **context}
        self.journal.append(row)
        return row

    def firing(self) -> list[str]:
        """Sorted keys currently in ``firing`` — the ``active_alerts``
        set post-mortem bundles carry."""
        return sorted(k for k, a in self._alerts.items() if a.firing)

    def states(self) -> dict[str, str]:
        return {k: a.state for k, a in sorted(self._alerts.items())}

    def active_at(self, tick: int) -> list[str]:
        """Replay the journal: the firing set as of ``tick`` (inclusive)
        — what a bundle written at that tick must agree with."""
        state: dict[str, str] = {}
        for row in self.journal:
            if row["tick"] > tick:
                break
            state[row["alert"]] = row["to"]
        return sorted(k for k, s in state.items() if s == "firing")
