"""Structured findings for the analysis passes.

Port of ``analysis/report.py`` (stdlib; the port keeps its own copy). A
pass produces :class:`Finding`s — (severity, rule id, provenance,
message, fix hint) — and :class:`Report` aggregates them and owns the
exit-code policy: ``ok(fail_on)`` is what the CLI keys off. The port's
passes (the protocol checker) report no cost tables, so the JAX
package's ``CollectiveCost``/``HBMCost`` rows are not copied; they come
with the program linter (ROADMAP.md, Queue A, item 7.4).

Rule ids are ``family.check``: ``protocol.double-serve``,
``journal-grammar.unread-event``, ...
"""

from __future__ import annotations

import dataclasses
import enum


class Severity(enum.IntEnum):
    """Ordered so ``max()`` over findings is the report's worst finding."""
    INFO = 1
    WARNING = 2
    ERROR = 3

    def __str__(self) -> str:  # "ERROR" not "Severity.ERROR" in reports
        return self.name


@dataclasses.dataclass(frozen=True)
class Finding:
    """One defect (or hazard) a pass can point at. ``where`` is its
    provenance (a model config, a ``file:line``)."""
    rule: str                 # "family.check", e.g. "protocol.double-serve"
    severity: Severity
    message: str              # what is wrong
    where: str = ""           # provenance
    hint: str = ""            # how to fix it

    @property
    def family(self) -> str:
        return self.rule.split(".", 1)[0]

    def format(self) -> str:
        loc = f"\n    at {self.where}" if self.where else ""
        fix = f"\n    fix: {self.hint}" if self.hint else ""
        return f"[{self.severity}] {self.rule}: {self.message}{loc}{fix}"


class Report:
    """The result of one analysis run: its findings. The protocol checker
    also sets ``exploration`` and ``verdict`` on the report it returns."""

    def __init__(self, name: str = "", findings=None):
        self.name = name
        self.findings: list[Finding] = list(findings or [])

    def ok(self, fail_on: str = "error") -> bool:
        """``fail_on='error'``: only ERROR findings gate (the default).
        ``fail_on='warning'``: any WARNING+ gates."""
        threshold = (Severity.WARNING if fail_on == "warning"
                     else Severity.ERROR)
        return all(f.severity < threshold for f in self.findings)

    def format(self) -> str:
        """The JAX report's text with its cost tables off
        (``format(costs=False)`` there), byte for byte."""
        head = f"analysis: {self.name}" if self.name else "analysis"
        lines = [head]
        if not self.findings:
            lines.append("  no findings: clean")
        for f in sorted(self.findings, key=lambda f: -f.severity):
            lines.extend("  " + ln for ln in f.format().splitlines())
        return "\n".join(lines)
