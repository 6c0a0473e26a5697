"""Structured findings for the analysis passes.

Port of ``analysis/report.py`` (stdlib; the port keeps its own copy). A
pass produces :class:`Finding`s — (severity, rule id, provenance,
message, fix hint) — plus, for the serving passes, the HBM bytes per
tick of each K/V stream (:class:`HBMCost`: the byte model's rows and the
rows the kernel linter derives from a launch's own metadata).
:class:`Report` aggregates both and owns the exit-code policy:
``ok(fail_on)`` is what the CLI keys off. No pass of the port walks
collectives, so the JAX package's ``CollectiveCost`` (bytes over ICI) is
not copied.

Rule ids are ``family.check``: ``protocol.double-serve``,
``journal-grammar.unread-event``, ``kernel-race.parallel-overwrite``, ...
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


@dataclasses.dataclass(frozen=True)
class HBMCost:
    """Device-memory traffic of one serving-program memory stream.

    A decode tick's dominant traffic is K/V cache bytes: the paged path
    reads every table block of every slot each tick, and the scatter
    lands one position per slot. ``bytes_per_tick`` is the static
    program cost (shapes are static, so it does not vary with
    occupancy)."""
    op: str                   # e.g. "decode.kv_gather"
    program: str              # registry program the stream belongs to
    bytes_per_tick: int
    note: str = ""


class Report:
    """The result of one analysis run: findings plus the serving HBM
    bytes-per-tick rows. The protocol checker also sets ``exploration``
    and ``verdict`` on the report it returns."""

    def __init__(self, name: str = "", findings=None, hbm=None):
        self.name = name
        self.findings: list[Finding] = list(findings or [])
        self.hbm: list[HBMCost] = list(hbm or [])

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity >= Severity.ERROR]

    @property
    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == Severity.WARNING]

    def by_family(self, family: str) -> list[Finding]:
        return [f for f in self.findings if f.family == family]

    def ok(self, fail_on: str = "error") -> bool:
        """``fail_on='error'``: only ERROR findings gate (the default).
        ``fail_on='warning'``: any WARNING+ gates."""
        threshold = (Severity.WARNING if fail_on == "warning"
                     else Severity.ERROR)
        return all(f.severity < threshold for f in self.findings)

    def format(self, costs: bool = True) -> str:
        """The JAX report's text, byte for byte: the findings, worst
        first, then (``costs``) the HBM table."""
        head = f"analysis: {self.name}" if self.name else "analysis"
        lines = [head]
        if not self.findings:
            lines.append("  no findings: clean")
        for f in sorted(self.findings, key=lambda f: -f.severity):
            lines.extend("  " + ln for ln in f.format().splitlines())
        if costs and self.hbm:
            lines.append("  HBM bytes per serve tick (KV-cache streams):")
            for h in sorted(self.hbm, key=lambda h: -h.bytes_per_tick):
                note = f"  ({h.note})" if h.note else ""
                lines.append(
                    f"    {h.op:<24} {_human_bytes(h.bytes_per_tick):>10}  "
                    f"{h.program}{note}")
            lines.append(
                f"    total: "
                f"{_human_bytes(sum(h.bytes_per_tick for h in self.hbm))}")
        return "\n".join(lines)


def _human_bytes(n: int) -> str:
    size = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if size < 1024 or unit == "GiB":
            return f"{size:.1f}{unit}" if unit != "B" else f"{int(size)}B"
        size /= 1024
    return f"{size:.1f}GiB"
