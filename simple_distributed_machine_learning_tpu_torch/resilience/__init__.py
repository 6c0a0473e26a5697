"""Resilience (port of ``resilience/``): fault injection, self-healing
training, the elastic restart and the serving scenario suite.

- :mod:`.faults` — seeded, reproducible fault schedules injected at named
  sites (the Trainer's ``train.step``/``train.grad``/``data.batch``/
  ``train.sigterm``, the checkpoint writer's ``ckpt.write``, the serving
  engine's ``serve.tick``/``serve.admit``, the fleet's ``fleet.tick``/
  ``fleet.handoff``);
- :mod:`.sentinel` — per-step NaN/Inf and EWMA-spike detection, a bounded
  ring of host snapshots for micro-rollback, the quarantine journal, and
  escalation to the supervisor when anomalies repeat (``--sentinel``);
- :mod:`.store` — checksum-validated checkpoint history with a manifest:
  restore picks the latest checkpoint that VERIFIES, never a corrupt one;
- :mod:`.supervisor` — the elastic checkpoint-restart loop: on a
  recoverable failure, restore the latest valid checkpoint (repacked when
  it was written at another stage count) and resume, with bounded
  exponential backoff and a restart budget (``--chaos``);
- :mod:`.scenarios` — the SLO-gated serving scenarios on a virtual clock
  (the six one-engine entries and the five fleet entries).

Attribute access is lazy: importing the package pulls in neither torch
nor the trainer nor the serving engine until a symbol that needs them is
touched.
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
    "CheckpointStore": ".store",
    "Sentinel": ".sentinel",
    "SentinelConfig": ".sentinel",
    "SentinelExhausted": ".sentinel",
    "QuarantineJournal": ".sentinel",
    "SnapshotRing": ".sentinel",
    "ElasticTrainer": ".supervisor",
    "PeerLost": ".supervisor",
    "RestartBudgetExceeded": ".supervisor",
    "RestartPolicy": ".supervisor",
    "make_elastic_trainer": ".supervisor",
    "supervise": ".supervisor",
    "Scenario": ".scenarios",
    "SCENARIOS": ".scenarios",
    "VirtualClock": ".scenarios",
    "run_scenario": ".scenarios",
}

__all__ = sorted(_EXPORTS) + ["faults", "scenarios", "sentinel", "store",
                              "supervisor"]


def __getattr__(name: str):
    import importlib

    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod, __name__), name)
