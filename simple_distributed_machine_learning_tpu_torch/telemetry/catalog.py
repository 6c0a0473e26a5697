"""The metric-help catalog: ``# HELP`` text sourced from module docstrings
(port of ``telemetry/catalog.py``; it parses the PyTorch package's own
docstrings).

The instruments the port emits are already documented — ``serve/metrics.py``'s
module docstring is a maintained per-metric catalog in the

    - ``name`` (kind) — description

bullet format. Rather than duplicating every description into a second
hand-maintained table (which would drift), this module parses those
docstrings into a ``name -> help`` map that
:meth:`~.registry.MetricsRegistry.prometheus_text` turns into ``# HELP``
lines. Parsing happens on the SOURCE file via ``ast`` — no import of the
documented module, so the exposition path never drags ``serve/`` (and with
it torch) into a light context.

Training-side metrics whose docs live in prose rather than bullets get
explicit entries in :data:`EXTRA_HELP` (the JAX catalog's, and the
per-collective ICI gauge the JAX catalog leaves undocumented). Coverage is best-effort by design: a
metric without catalog text simply emits no HELP line (never a wrong
one).
"""

from __future__ import annotations

import ast
import os
import re

# serve/metrics.py documents every serve_* instrument; the SLO engine and
# the attribution module document their own instruments in their module
# docstrings (same bullet grammar). Parsed lazily once.
_DOC_FILES = (("serve", "metrics.py"), ("telemetry", "slo.py"),
              ("telemetry", "attribution.py"))

_NAME_RE = re.compile(r"``([A-Za-z_][A-Za-z0-9_]*)(?:\{[^`]*\})?``")
_cached: dict[str, str] | None = None

#: metrics documented in prose (trainer / session paths) rather than
#: catalog bullets — the explicit side of the catalog.
EXTRA_HELP: dict[str, str] = {
    "epochs_total": "training epochs completed by this session",
    "bubble_fraction": "modeled pipeline-bubble fraction "
                       "(S-1)/(M+S-1) of the schedule that ran",
    "bubble_fraction_measured": "measured pipeline-bubble fraction: "
                                "1 - ideal_step_s / steady p50 step time",
    "bubble_drift": "measured minus modeled pipeline-bubble fraction "
                    "(0 when the schedule model holds)",
    "examples_per_sec": "steady-state training throughput in examples/s",
    "tokens_per_sec": "steady-state training throughput in tokens/s",
    "step_time_ms": "per-step wall latency from fenced timing windows",
    "ici_bytes_per_step": "statically expected collective bytes per step "
                          "between mesh coordinates (the traced step's "
                          "cost table)",
    "ici_collective_bytes_per_step": "statically expected bytes per step "
                                     "of one collective kind over its "
                                     "axes (prim, axes labels)",
    # self-healing training (resilience/sentinel.py)
    "train_anomalies_total": "numeric anomalies the training sentinel "
                             "detected, by verdict kind (nan/inf/spike)",
    "train_rollbacks_total": "in-memory micro-rollbacks to a snapshot-ring "
                             "entry (no disk restore)",
    "train_quarantined_batches_total": "batches journaled as quarantined "
                                       "and deterministically skipped",
    "train_snapshot_ring_bytes": "resident host bytes of the sentinel's "
                                 "bounded snapshot ring",
    "train_preempt_graceful": "1 when the run ended on a graceful "
                              "preemption (SIGTERM): in-flight step "
                              "finished, synchronous checkpoint + "
                              "quarantine-journal flush",
}


def _bullets(doc: str):
    """Yield the ``- ...`` bullet chunks of a docstring (a bullet runs to
    the next bullet or blank line)."""
    chunk: list[str] = []
    for line in doc.splitlines():
        stripped = line.strip()
        if stripped.startswith("- "):
            if chunk:
                yield " ".join(chunk)
            chunk = [stripped[2:]]
        elif chunk and stripped:
            chunk.append(stripped)
        elif chunk:
            yield " ".join(chunk)
            chunk = []
    if chunk:
        yield " ".join(chunk)


def _parse_doc(doc: str) -> dict[str, str]:
    out: dict[str, str] = {}
    for bullet in _bullets(doc):
        head, sep, help_text = bullet.partition("—")
        if not sep:
            continue
        help_text = " ".join(help_text.split()).strip()
        if not help_text:
            continue
        for name in _NAME_RE.findall(head):
            out.setdefault(name, help_text)
    return out


def metric_help() -> dict[str, str]:
    """The merged ``metric name -> help text`` catalog (cached)."""
    global _cached
    if _cached is None:
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        merged = dict(EXTRA_HELP)
        for parts in _DOC_FILES:
            path = os.path.join(pkg_root, *parts)
            try:
                with open(path) as f:
                    doc = ast.get_docstring(ast.parse(f.read())) or ""
            except (OSError, SyntaxError):  # pragma: no cover - env guard
                continue
            for name, text in _parse_doc(doc).items():
                merged.setdefault(name, text)
        _cached = merged
    return _cached
