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

Coverage is best-effort by design: a metric without catalog text simply
emits no HELP line (never a wrong one).
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
        merged: dict[str, str] = {}
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
