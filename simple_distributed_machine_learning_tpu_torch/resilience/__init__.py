"""Resilience (port of ``resilience/``): fault injection and the serving
scenario suite.

- :mod:`.faults` — seeded, reproducible fault schedules injected at named
  sites (the serving engine's ``serve.tick`` and ``serve.admit``);
- :mod:`.scenarios` — the SLO-gated serving scenarios on a virtual clock
  (the six one-engine entries and the five fleet entries).

The training half (the checkpoint store, the elastic supervisor) waits
for ROADMAP.md, Queue A, item 4d, the sentinel for item 6. Attribute access is
lazy: importing the package pulls in neither torch nor the serving
engine until a symbol that needs them is touched.
"""

from __future__ import annotations

_EXPORTS = {
    "FaultPlan": ".faults",
    "FaultSpec": ".faults",
    "FaultInjected": ".faults",
    "HostLost": ".faults",
    "DeviceWedged": ".faults",
    "CheckpointWriteCrash": ".faults",
    "EngineCrash": ".faults",
    "ReplicaLost": ".faults",
    "NumericFault": ".faults",
    "Preempted": ".faults",
    "Scenario": ".scenarios",
    "SCENARIOS": ".scenarios",
    "VirtualClock": ".scenarios",
    "run_scenario": ".scenarios",
}

__all__ = sorted(_EXPORTS) + ["faults", "scenarios"]


def __getattr__(name: str):
    import importlib

    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod, __name__), name)
