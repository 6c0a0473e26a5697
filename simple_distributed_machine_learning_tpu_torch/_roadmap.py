"""The one message for a knob the port keeps in its signature but has not
ported yet: it names the ROADMAP.md item that will port it."""

from __future__ import annotations


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet "
        f"(ROADMAP.md, Queue A: {item})")


MULTI_PROCESS = "item 6c, the paths that still run in one process"
