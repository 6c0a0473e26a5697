"""The one message for a knob the port keeps in its signature but has not
ported yet: it names the ROADMAP.md item that will port it."""

from __future__ import annotations


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet "
        f"(ROADMAP.md, Queue A: {item})")


PARALLEL_AXES = "item 6, remaining parallel axes (6c-6e)"
ANALYSIS = "item 7, analysis"
HOSTLINT = "item 7.2, hostlint"
PROGRAM_LINTER = "item 7.4, the program linter"
