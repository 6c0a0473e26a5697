"""Streaming SLO engine: windowed quantiles + multi-window burn alerts.

Port of ``telemetry/slo.py`` (no JAX; the port keeps its own copy).
End-of-run attainment (``ServeMetrics.attainment``) answers "did we make
the SLO"; this engine answers "are we burning error budget RIGHT NOW" —
the signal the fleet (``serve/fleet.py``) feeds back into routing and
autoscaling instead of reading post-hoc. Three layers:

- **Windowed quantile tracking** — :class:`WindowHistogram`: fixed-bucket
  latency histograms over a sliding window of the last N *ticks*. The
  bucket bounds are static configuration, never data-dependent (no
  GK/t-digest sketches whose internal state depends on arrival order), so
  two identical runs produce byte-identical windowed quantiles and the
  scenario suite can pin them exactly.
- **Burn rates** — per traffic class (and per fleet replica), each tick
  bucket counts REQUEST-level ``(observations, violations)``: one
  observation per request — its TTFT sample (a violation when over the
  :class:`SLOObjective` target) **or its shed** (a rejected request
  failed its SLO by definition — the SRE error-budget view). Per-token
  TPOT samples deliberately do NOT enter the burn series (hundreds of
  good token observations per request would dilute a shed storm into
  invisibility); they feed the windowed quantile histograms instead.
  Burn rate = violation fraction / error budget where budget =
  ``1 - target`` (target 0.9 → budget 0.1; burn 1.0 = exactly eating the
  budget, sustained burn ≥ threshold pages).
- **Multi-window alerts** — SRE-style fast+slow window pairs: the alert
  condition requires the burn over BOTH the fast window (reacts quickly,
  flappy alone) and the slow window (smooth, slow alone) to clear the
  threshold, then drives ``telemetry/alerts.py``'s tick-stamped state
  machine (inactive→pending→firing→resolved; transitions journaled).

**The engine never reads a clock.** Observations carry latencies the
serving layer already measured; evaluations are stamped with the
engine/fleet tick the caller passes to :meth:`SLOEngine.evaluate`. Under
the virtual-clock scenarios this is what keeps every pinned number
unchanged and makes alert fire/resolve ticks themselves pinnable.

Registry instruments (when constructed with ``registry=``):

- ``serve_slo_burn_rate{class=...}`` (gauge) — the class's fast-window
  burn rate as of the last evaluation: violation fraction over the error
  budget, 0.0 when the window holds fewer than ``min_count`` samples;
- ``serve_alerts_firing`` (gauge) — how many alerts are currently in the
  ``firing`` state across all classes and replicas.
"""

from __future__ import annotations

import bisect
import collections
import math

from simple_distributed_machine_learning_tpu_torch.telemetry.alerts import (
    AlertBook,
)

#: default fixed bucket upper bounds (ms) for windowed latency quantiles
#: — static config, never data-dependent (see module docstring).
DEFAULT_BOUNDS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
                  1000.0, 2000.0, 5000.0)


class SLOObjective:
    """One traffic class's online SLO: TTFT/TPOT targets (ms; None =
    untracked) at an attainment ``target`` (0.9 → 10% error budget)."""

    def __init__(self, cls: str, *, ttft_slo_ms: float | None = None,
                 tpot_slo_ms: float | None = None,
                 target: float = 0.9) -> None:
        if not 0.0 < target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {target}")
        if ttft_slo_ms is None and tpot_slo_ms is None:
            raise ValueError(f"objective for class {cls!r} tracks nothing "
                             f"— give ttft_slo_ms and/or tpot_slo_ms")
        self.cls = cls
        self.ttft_slo_ms = ttft_slo_ms
        self.tpot_slo_ms = tpot_slo_ms
        self.target = float(target)

    @property
    def budget(self) -> float:
        return 1.0 - self.target

    def describe(self) -> dict:
        return {"ttft_slo_ms": self.ttft_slo_ms,
                "tpot_slo_ms": self.tpot_slo_ms, "target": self.target}


class WindowHistogram:
    """Fixed-bucket histogram over a sliding window of the last
    ``window`` ticks. ``observe`` lands in the current (open) tick
    bucket; :meth:`roll` closes it. Quantiles are bucket UPPER bounds
    (nearest-rank over merged window counts) — a deterministic
    overestimate, never an interpolation whose value depends on sample
    order."""

    def __init__(self, bounds=DEFAULT_BOUNDS, window: int = 32) -> None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError("bucket bounds must be strictly increasing")
        self.bounds = tuple(float(b) for b in bounds)
        self.window = int(window)
        # one overflow bucket past the last bound; counts[i] <= bounds[i]
        self._ticks: collections.deque[list[int]] = collections.deque(
            maxlen=self.window)
        self._cur = [0] * (len(self.bounds) + 1)

    def observe(self, value: float) -> None:
        self._cur[bisect.bisect_left(self.bounds, float(value))] += 1

    def roll(self) -> None:
        self._ticks.append(self._cur)
        self._cur = [0] * (len(self.bounds) + 1)

    @property
    def n(self) -> int:
        return sum(sum(t) for t in self._ticks)

    def quantile(self, q: float) -> float | None:
        """Nearest-rank quantile over the window as a bucket upper bound
        (overflow clamps to the last bound); None on an empty window."""
        counts = [sum(t[i] for t in self._ticks)
                  for i in range(len(self.bounds) + 1)]
        total = sum(counts)
        if total == 0:
            return None
        rank = max(1, math.ceil(q * total))
        acc = 0
        for i, c in enumerate(counts):
            acc += c
            if acc >= rank:
                return self.bounds[min(i, len(self.bounds) - 1)]
        return self.bounds[-1]          # pragma: no cover - loop covers


class _Series:
    """One alert scope's per-tick ``(n, violations)`` window."""

    def __init__(self, slow_window: int) -> None:
        self._ticks: collections.deque[tuple[int, int]] = collections.deque(
            maxlen=slow_window)
        self._n = 0
        self._bad = 0

    def observe(self, bad: bool) -> None:
        self._n += 1
        if bad:
            self._bad += 1

    def roll(self) -> None:
        self._ticks.append((self._n, self._bad))
        self._n = 0
        self._bad = 0

    def counts(self, last: int | None = None) -> tuple[int, int]:
        ticks = (list(self._ticks)[-last:] if last is not None
                 else self._ticks)
        return (sum(n for n, _ in ticks), sum(b for _, b in ticks))


class SLOEngine:
    """The streaming SLO engine; see module docstring.

    Observations arrive via ``observe_ttft`` / ``observe_tpot`` /
    ``observe_shed`` (``ServeMetrics`` forwards its hooks when bound via
    ``ServeMetrics.bind_slo``); whoever owns the tick — the serve
    supervisor or the fleet — calls :meth:`evaluate` exactly once per
    tick. Per-replica series (``replica=`` on the observe calls, set by
    the fleet around each replica's step) get their own
    ``slo_burn{replica=N}`` alerts — the router-demotion signal.
    """

    def __init__(self, objectives, *, fast_window: int = 8,
                 slow_window: int = 32, burn_threshold: float = 1.0,
                 pending_ticks: int = 2, resolve_ticks: int = 4,
                 min_count: int = 1, target: float = 0.9,
                 bounds=DEFAULT_BOUNDS, registry=None) -> None:
        if fast_window < 1 or slow_window < fast_window:
            raise ValueError(
                f"windows must satisfy 1 <= fast <= slow, got "
                f"{fast_window}/{slow_window}")
        if min_count < 1:
            raise ValueError(f"min_count must be >= 1, got {min_count}")
        objectives = list(objectives)
        self.objectives: dict[str, SLOObjective] = {
            o.cls: o for o in objectives}
        if len(self.objectives) != len(objectives):
            raise ValueError("duplicate class in objectives")
        self.fast_window = int(fast_window)
        self.slow_window = int(slow_window)
        self.burn_threshold = float(burn_threshold)
        self.min_count = int(min_count)
        self.target = float(target)        # replica-scope error budget
        self.tick = 0                      # last evaluated tick
        self.evaluations = 0
        self.alerts = AlertBook(pending_ticks=pending_ticks,
                                resolve_ticks=resolve_ticks)
        self._class_series = {cls: _Series(slow_window)
                              for cls in self.objectives}
        self._replica_series: dict[int, _Series] = {}
        self._hists = {(cls, sig): WindowHistogram(bounds, slow_window)
                       for cls, o in self.objectives.items()
                       for sig, tgt in (("ttft", o.ttft_slo_ms),
                                        ("tpot", o.tpot_slo_ms))
                       if tgt is not None}
        self._burn: dict[str, float] = dict.fromkeys(self.objectives, 0.0)
        self._burn_gauges = {}
        self._firing_gauge = None
        if registry is not None:
            self._burn_gauges = {
                cls: registry.gauge("serve_slo_burn_rate",
                                    labels={"class": cls})
                for cls in sorted(self.objectives)}
            self._firing_gauge = registry.gauge("serve_alerts_firing")

    @classmethod
    def from_classes(cls, classes, **kw) -> "SLOEngine | None":
        """Build from ``TrafficClass``-shaped records (``.name``,
        ``.ttft_slo_ms``, ``.tpot_slo_ms``) — the scenario wiring. None
        when no class carries an SLO target (nothing to track)."""
        target = kw.get("target", 0.9)
        objectives = [
            SLOObjective(tc.name, ttft_slo_ms=tc.ttft_slo_ms,
                         tpot_slo_ms=tc.tpot_slo_ms, target=target)
            for tc in classes
            if tc.ttft_slo_ms is not None or tc.tpot_slo_ms is not None]
        if not objectives:
            return None
        return cls(objectives, **kw)

    # -- observations ------------------------------------------------------

    def _observe(self, cls, sig: str, ms: float, replica) -> None:
        o = self.objectives.get(cls)
        if o is None:
            return
        target_ms = o.ttft_slo_ms if sig == "ttft" else o.tpot_slo_ms
        if target_ms is None:
            return
        self._hists[(cls, sig)].observe(ms)
        if sig != "ttft":
            # per-token TPOT stays out of the burn series (request-level
            # SLI — see module docstring); quantile window only
            return
        bad = ms > target_ms
        self._class_series[cls].observe(bad)
        if replica is not None:
            self._replica(replica).observe(bad)

    def observe_ttft(self, cls, ttft_ms: float, replica=None) -> None:
        self._observe(cls, "ttft", ttft_ms, replica)

    def observe_tpot(self, cls, tpot_ms: float, replica=None) -> None:
        self._observe(cls, "tpot", tpot_ms, replica)

    def observe_shed(self, cls, replica=None) -> None:
        """A structured rejection: counts as a violated observation — a
        request the system refused failed its SLO by definition."""
        if cls not in self.objectives:
            return
        self._class_series[cls].observe(True)
        if replica is not None:
            self._replica(replica).observe(True)

    def _replica(self, idx) -> _Series:
        s = self._replica_series.get(idx)
        if s is None:
            s = self._replica_series[idx] = _Series(self.slow_window)
        return s

    # -- evaluation --------------------------------------------------------

    def _burn_pair(self, series: _Series, budget: float) -> tuple:
        nf, bf = series.counts(self.fast_window)
        ns, bs = series.counts()
        fast = (bf / nf) / budget if nf >= self.min_count else 0.0
        slow = (bs / ns) / budget if ns >= self.min_count else 0.0
        return fast, slow, nf, ns

    def evaluate(self, tick: int) -> list[dict]:
        """Close the current tick bucket and evaluate every alert;
        returns this tick's journaled transitions. Call exactly once per
        engine/fleet tick — the ONLY timestamps in the alert pipeline are
        the ticks handed in here."""
        self.tick = int(tick)
        self.evaluations += 1
        transitions: list[dict] = []
        for cls in sorted(self.objectives):
            series = self._class_series[cls]
            series.roll()
            fast, slow, nf, ns = self._burn_pair(
                series, self.objectives[cls].budget)
            self._burn[cls] = fast
            breaching = (fast >= self.burn_threshold
                         and slow >= self.burn_threshold)
            row = self.alerts.evaluate(
                f"slo_burn{{class={cls}}}", tick, breaching,
                burn_fast=round(fast, 4), burn_slow=round(slow, 4))
            if row is not None:
                transitions.append(row)
            g = self._burn_gauges.get(cls)
            if g is not None:
                g.set(round(fast, 6))
        budget = 1.0 - self.target
        for idx in sorted(self._replica_series):
            series = self._replica_series[idx]
            series.roll()
            fast, slow, nf, ns = self._burn_pair(series, budget)
            breaching = (fast >= self.burn_threshold
                         and slow >= self.burn_threshold)
            row = self.alerts.evaluate(
                f"slo_burn{{replica={idx}}}", tick, breaching,
                burn_fast=round(fast, 4), burn_slow=round(slow, 4))
            if row is not None:
                transitions.append(row)
        for h in self._hists.values():
            h.roll()
        if self._firing_gauge is not None:
            self._firing_gauge.set(len(self.alerts.firing()))
        return transitions

    # -- read side ---------------------------------------------------------

    def active_alerts(self) -> list[str]:
        return self.alerts.firing()

    def firing_replicas(self) -> set:
        """Replica indices whose per-replica burn alert is firing — the
        fleet's router-demotion signal."""
        out = set()
        for idx in self._replica_series:
            if self.alerts.get(f"slo_burn{{replica={idx}}}").firing:
                out.add(idx)
        return out

    def burn_rates(self) -> dict:
        """Per-class fast-window burn as of the last evaluation (the
        autoscaler's optional scale-out trigger)."""
        return dict(self._burn)

    def window_quantiles(self, q: float = 0.95) -> dict:
        out: dict = {}
        for (cls, sig), h in sorted(self._hists.items()):
            v = h.quantile(q)
            if v is not None:
                out[f"{cls}_{sig}_p{int(q * 100)}_ms"] = v
        return out

    def summary(self) -> dict:
        """The deterministic record block ``run_scenario`` lands in the
        scenario report (and tests pin byte-identically)."""
        return {
            "tick": self.tick,
            "objectives": {cls: o.describe()
                           for cls, o in sorted(self.objectives.items())},
            "windows": {"fast": self.fast_window, "slow": self.slow_window,
                        "burn_threshold": self.burn_threshold},
            "transitions": list(self.alerts.journal),
            "firing": self.alerts.firing(),
            "states": self.alerts.states(),
            "window_quantiles": self.window_quantiles(),
        }
