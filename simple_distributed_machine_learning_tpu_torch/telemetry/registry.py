"""Labeled metric instruments: counters, gauges, histograms.

Port of ``telemetry/registry.py`` (which imports no JAX; the port keeps
its own copy) for what the serving metrics use: named, optionally labeled
series exported as a Prometheus text exposition (``metrics.prom``) beside
the JSONL records ``append_jsonl`` writes:

- :class:`Counter` is monotonic — ``inc`` of a negative amount raises;
- :class:`Gauge` is a settable last-value;
- :class:`Histogram` keeps exact weighted observations (bounded ring of
  the most recent ``max_samples`` observe calls) and answers nearest-rank
  quantiles;
- a name re-registered as another kind or with another label-key set
  raises instead of silently forking the series.

Each name's first series in the exposition is preceded by a ``# HELP``
line when the metric catalog (``telemetry/catalog.py``, parsed from the
port's module docstrings) documents the name, then its ``# TYPE`` line.
"""

from __future__ import annotations

import json
import threading
import time


class Counter:
    """Monotonic counter. ``inc(n)`` with ``n < 0`` raises ``ValueError``."""

    kind = "counter"

    def __init__(self, name: str, labels: dict | None = None) -> None:
        self.name = name
        self.labels = dict(labels or {})
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(
                f"counter {self.name!r} is monotonic: inc({amount}) — use a "
                f"Gauge for values that go down")
        self.value += amount


class Gauge:
    """Last-value instrument."""

    kind = "gauge"

    def __init__(self, name: str, labels: dict | None = None) -> None:
        self.name = name
        self.labels = dict(labels or {})
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Weighted observations with exact nearest-rank quantiles over a
    ring of the most recent ``max_samples`` observe calls; ``count``,
    ``sum`` and ``max`` cover all observations."""

    kind = "histogram"

    def __init__(self, name: str, labels: dict | None = None,
                 max_samples: int = 8192) -> None:
        self.name = name
        self.labels = dict(labels or {})
        self.count = 0.0
        self.sum = 0.0
        self.max = None
        self._ring: list[tuple[float, float]] = []   # (value, weight)
        self._next = 0
        self._max_samples = max_samples

    def observe(self, value: float, n: float = 1.0) -> None:
        if n <= 0:
            raise ValueError(f"histogram {self.name!r}: observe weight {n} "
                             f"must be positive")
        value = float(value)
        self.count += n
        self.sum += value * n
        self.max = value if self.max is None else max(self.max, value)
        if len(self._ring) < self._max_samples:
            self._ring.append((value, n))
        else:
            self._ring[self._next] = (value, n)
            self._next = (self._next + 1) % self._max_samples

    def quantile(self, q: float) -> float | None:
        """Weighted nearest-rank quantile over the ring, ``q in [0, 1]``."""
        if not self._ring:
            return None
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        pairs = sorted(self._ring)
        target = q * sum(w for _, w in pairs)
        cum = 0.0
        for v, w in pairs:
            cum += w
            if cum >= target:
                return v
        return pairs[-1][0]

    def fraction_below(self, threshold: float) -> float | None:
        """Weighted fraction of ring observations ``<= threshold`` — the
        SLO-attainment primitive; None before any observation."""
        if not self._ring:
            return None
        total = sum(w for _, w in self._ring)
        hit = sum(w for v, w in self._ring if v <= threshold)
        return hit / total

    @property
    def mean(self) -> float | None:
        return self.sum / self.count if self.count else None

    def summary(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "max": self.max,
            "p50": self.quantile(0.5),
            "p95": self.quantile(0.95),
        }


class MetricsRegistry:
    """Name -> instrument registry with label-series fan-out; one live
    instrument per (name, labels), one schema per name."""

    def __init__(self) -> None:
        self._series: dict[tuple[str, tuple], Counter | Gauge | Histogram] = {}
        self._schemas: dict[str, tuple[str, tuple[str, ...]]] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, labels: dict | None = None) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, labels: dict | None = None) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, labels: dict | None = None,
                  max_samples: int = 8192) -> Histogram:
        return self._get(Histogram, name, labels, max_samples=max_samples)

    def _get(self, cls, name: str, labels: dict | None, **kw):
        labels = dict(labels or {})
        key = (name, tuple(sorted(labels.items())))
        label_keys = tuple(sorted(labels))
        with self._lock:
            schema = self._schemas.get(name)
            if schema is not None and schema != (cls.kind, label_keys):
                raise ValueError(
                    f"metric {name!r} already registered as {schema[0]} with "
                    f"label keys {schema[1]}; got {cls.kind} with "
                    f"{label_keys} — one name, one schema")
            inst = self._series.get(key)
            if inst is None:
                inst = cls(name, labels, **kw)
                self._series[key] = inst
                self._schemas[name] = (cls.kind, label_keys)
            return inst

    def snapshot(self) -> dict:
        """JSON-serialisable map ``name{k=v,...} -> value`` (histograms map
        to their summary dict)."""
        return {_series_key(inst): (inst.summary()
                                    if isinstance(inst, Histogram)
                                    else inst.value)
                for inst in self._series.values()}

    def prometheus_text(self) -> str:
        """Prometheus text exposition (histograms as summary quantiles):
        ``# HELP`` where the catalog knows the name, then ``# TYPE``; label
        values escaped per the exposition format."""
        from simple_distributed_machine_learning_tpu_torch.telemetry.catalog import (  # noqa: E501
            metric_help,
        )
        help_catalog = metric_help()
        lines = []
        seen_type: set[str] = set()
        for inst in sorted(self._series.values(), key=_series_key):
            if inst.name not in seen_type:
                seen_type.add(inst.name)
                doc = help_catalog.get(inst.name)
                if doc:
                    lines.append(f"# HELP {inst.name} {_escape_help(doc)}")
                kind = "summary" if isinstance(inst, Histogram) else inst.kind
                lines.append(f"# TYPE {inst.name} {kind}")
            if isinstance(inst, Histogram):
                for q in (0.5, 0.95):
                    v = inst.quantile(q)
                    if v is not None:
                        lines.append(f"{inst.name}"
                                     f"{_labels(inst.labels, quantile=q)} "
                                     f"{_num(v)}")
                lines.append(f"{inst.name}_count{_labels(inst.labels)} "
                             f"{_num(inst.count)}")
                lines.append(f"{inst.name}_sum{_labels(inst.labels)} "
                             f"{_num(inst.sum)}")
            else:
                lines.append(f"{inst.name}{_labels(inst.labels)} "
                             f"{_num(inst.value)}")
        return "\n".join(lines) + "\n"


def _series_key(inst) -> str:
    if not inst.labels:
        return inst.name
    inner = ",".join(f"{k}={v}" for k, v in sorted(inst.labels.items()))
    return f"{inst.name}{{{inner}}}"


def _escape_label_value(v) -> str:
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _escape_help(text: str) -> str:
    """HELP-line escaping (backslash only; quotes are legal in help text),
    collapsed to one line."""
    return " ".join(str(text).split()).replace("\\", r"\\")


def _labels(labels: dict, **extra) -> str:
    items = {**labels, **extra}
    if not items:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"'
                     for k, v in sorted(items.items()))
    return "{" + inner + "}"


def _num(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


def append_jsonl(path: str, record: dict, schema: int = 2) -> dict:
    """Append one schema-versioned JSON line to ``path``; returns the
    record written."""
    full = {"schema": schema, "time": round(time.time(), 3), **record}
    with open(path, "a") as f:
        f.write(json.dumps(full) + "\n")
    return full
