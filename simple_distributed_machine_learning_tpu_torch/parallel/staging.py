"""Stage split rule (port of ``parallel/staging.py``: ``contiguous_split``).

The packed stage buffer and the wire codec exist to shard stages over a
mesh; they wait for the multi-stage pipeline (ROADMAP Queue A item 6).
"""

from __future__ import annotations

from typing import Any, Sequence


def contiguous_split(units: Sequence[Any], n_stages: int) -> list[list]:
    """Assign ``units`` (layers/blocks) contiguously to ``n_stages`` stages,
    earlier stages taking the remainder — the JAX package's rule, so a
    stage split means the same layers in both packages."""
    n = len(units)
    if n < n_stages:
        raise ValueError(f"{n} layers cannot fill {n_stages} stages")
    per = [n // n_stages + (1 if i < n % n_stages else 0)
           for i in range(n_stages)]
    out, start = [], 0
    for p in per:
        out.append(list(units[start:start + p]))
        start += p
    return out
