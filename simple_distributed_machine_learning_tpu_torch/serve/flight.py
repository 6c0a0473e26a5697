"""Post-mortem bundles: crash forensics (port of ``serve/flight.py``'s
bundle half).

:func:`write_bundle` dumps one JSON file (atomic rename): every request's
state, a metrics-registry snapshot, the journal tail and the caller's
state block (restarts, degraded, the active SLO alerts). The serve
supervisor writes one on every engine restart, on a ``DrainTimeout`` and
on a shed burst. The tick flight recorder whose rows the JAX bundle also
carries ports with request tracing (ROADMAP.md, Queue A, item 4b); until
then ``flight`` is an empty list.

Bundles carry tick indices and timestamps already read, never a fresh
clock read, so writing one from a virtual-clock scenario cannot move its
pinned numbers.
"""

from __future__ import annotations

import json
import os

BUNDLE_PREFIX = "postmortem"


def request_states(requests) -> list[dict]:
    """JSON-serialisable state of every request handle, in rid order."""
    out = []
    for rid in sorted(requests):
        r = requests[rid]
        out.append({
            "rid": rid, "state": r.state, "cls": r.cls,
            "priority": r.priority,
            "prompt_len": int(r.prompt.shape[0]),
            "max_new_tokens": int(r.max_new_tokens),
            "tokens_emitted": len(r.tokens),
            "slot": r.slot, "prefill_pos": r.prefill_pos,
            "n_preempted": r.n_preempted,
            "finish_reason": r.finish_reason,
        })
    return out


def write_bundle(path: str, *, trigger: str, cause: str, tick: int,
                 requests, registry=None, journal_tail=None,
                 **extra) -> str:
    """Write one post-mortem bundle JSON to ``path``; returns the path.

    ``trigger`` is why (``restart`` | ``drain_timeout`` | ``shed_burst``
    | ``restart_budget``), ``cause`` the precipitating exception, ``tick``
    the supervisor's monotonic tick; ``registry`` (a ``MetricsRegistry``)
    contributes its snapshot, ``journal_tail`` the last journal events."""
    bundle = {
        "kind": "postmortem",
        "trigger": trigger,
        "cause": cause,
        "tick": int(tick),
        "flight": [],
        "flight_ticks_recorded": 0,
        "requests": request_states(requests),
        **extra,
    }
    if registry is not None:
        bundle["metrics"] = registry.snapshot()
    if journal_tail is not None:
        bundle["journal_tail"] = list(journal_tail)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(bundle, f)
    os.replace(tmp, path)
    return path
