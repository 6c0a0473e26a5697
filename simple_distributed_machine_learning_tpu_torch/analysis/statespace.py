"""Bounded explicit-state model checking: the exhaustive-interleaving core.

Port of ``analysis/statespace.py`` (pure stdlib; the port keeps its own
copy, line for line in every branch that decides the exploration order).
This module verifies PROTOCOLS — host-side state
machines whose failure modes are schedule-dependent interleavings no
sampled chaos drill reliably hits. It is a deliberately small
explicit-state checker: breadth-first exploration of every transition
interleaving from an initial state, deduplicated on state hash, bounded by
depth, with shortest-counterexample traces reconstructed from parent
pointers.

Design rules the tests pin:

- **Dedup soundness** — two paths reaching one state explore its successors
  once. States must therefore be VALUES (frozen dataclasses / nested
  tuples): equality is state identity, and any ghost bookkeeping a model
  carries (delivered-token counts, crash budgets) is part of the state on
  purpose — two histories that differ in observable effects are different
  states.
- **Depth-bound honesty** — the verdict always says "proved to depth N",
  never a bare "proved": a bounded search that hit its bound is evidence,
  not proof. When the frontier exhausts below the bound the verdict says
  so (the state space was finite and fully explored), still phrased with
  the depth it ran to.
- **Determinism** — transitions are explored in sorted label order and BFS
  order is queue order, so two runs over the same model produce
  byte-identical reports. No wall clock, no RNG, no set-iteration order
  leaks into results.

:func:`explore` is generic: ``transitions(state)`` yields ``(label,
next_state)`` pairs and ``invariants`` maps names to predicates returning
``None`` (holds) or a violation message. ``analysis/protocol.py`` builds
the serve-fleet model on top.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Hashable, Iterable

#: a transition label: a tuple of strings/ints (sortable, hashable) whose
#: first element names the action — e.g. ``("crash", 1, "mid-handoff")``
Label = tuple


@dataclasses.dataclass(frozen=True)
class Violation:
    """One invariant failure with its shortest witnessing schedule."""

    invariant: str            # invariant name ("double-serve", ...)
    message: str              # what is false in the bad state
    trace: tuple[Label, ...]  # transition labels, initial -> bad state
    depth: int                # len(trace)

    def render(self, label_str=None) -> str:
        fmt = label_str or _default_label_str
        lines = [f"invariant '{self.invariant}' violated at depth "
                 f"{self.depth}: {self.message}"]
        for i, lab in enumerate(self.trace):
            lines.append(f"  {i + 1}. {fmt(lab)}")
        return "\n".join(lines)


def _default_label_str(label: Label) -> str:
    head, *rest = label
    return f"{head}({', '.join(str(r) for r in rest)})" if rest else str(head)


@dataclasses.dataclass
class Exploration:
    """What one bounded run established (and how hard it looked)."""

    states: int               # distinct states explored
    transitions: int          # transitions taken (incl. into dedup hits)
    dedup_hits: int           # transitions that landed on a known state
    depth_bound: int
    depth_reached: int        # deepest distinct state seen
    complete: bool            # frontier exhausted BELOW the bound
    truncated: bool           # state cap hit (max_states) — never a proof
    violations: list[Violation] = dataclasses.field(default_factory=list)

    def verdict(self, invariants: Iterable[str]) -> str:
        """The honesty-pinned summary line. Never a bare "proved": a
        depth-bounded search proves properties only up to its bound, and
        the phrasing carries the bound even when the state space was
        exhausted below it."""
        names = ", ".join(invariants)
        if self.violations:
            broken = sorted({v.invariant for v in self.violations})
            return (f"VIOLATED: {', '.join(broken)} — "
                    f"{len(self.violations)} counterexample(s) within "
                    f"depth {self.depth_bound} "
                    f"({self.states} states explored)")
        if self.truncated:
            return (f"inconclusive: state cap hit after {self.states} "
                    f"states — nothing proved")
        scope = ("state space exhausted — every reachable interleaving"
                 if self.complete else
                 "depth bound reached — deeper schedules unexplored")
        return (f"proved to depth {self.depth_bound}: {names} "
                f"({self.states} states, {self.transitions} transitions, "
                f"{scope})")


def explore(initial: Hashable,
            transitions: Callable[[Hashable], Iterable[tuple[Label,
                                                             Hashable]]],
            invariants: dict[str, Callable[[Hashable], str | None]],
            depth: int,
            max_states: int = 500_000) -> Exploration:
    """Breadth-first bounded exploration with state-hash dedup.

    Checks every invariant on every DISTINCT reachable state (including
    the initial one). The first violation of each invariant is recorded
    with its shortest trace (BFS guarantees minimality); exploration
    continues so one run reports every broken invariant. Successors of a
    violating state are still explored — a model may violate one
    invariant on the way to violating another.
    """
    if depth < 0:
        raise ValueError(f"depth must be >= 0, got {depth}")
    seen: dict = {initial: (None, None)}        # state -> (parent, label)
    depth_of = {initial: 0}
    queue = deque([initial])
    result = Exploration(states=0, transitions=0, dedup_hits=0,
                         depth_bound=depth, depth_reached=0,
                         complete=True, truncated=False)
    broken: set[str] = set()

    def _check(state) -> None:
        for name, pred in invariants.items():
            if name in broken:
                continue
            msg = pred(state)
            if msg is not None:
                broken.add(name)
                result.violations.append(Violation(
                    invariant=name, message=msg,
                    trace=_trace_to(state, seen),
                    depth=depth_of[state]))

    _check(initial)
    result.states = 1
    while queue:
        state = queue.popleft()
        d = depth_of[state]
        if d >= depth:
            # a cut frontier: there were unexplored schedules past the
            # bound iff this state has any successor at all
            if next(iter(transitions(state)), None) is not None:
                result.complete = False
            continue
        for label, nxt in sorted(transitions(state), key=lambda t: t[0]):
            result.transitions += 1
            if nxt in seen:
                result.dedup_hits += 1
                continue
            if len(seen) >= max_states:
                result.truncated = True
                result.complete = False
                return result
            seen[nxt] = (state, label)
            depth_of[nxt] = d + 1
            result.states += 1
            result.depth_reached = max(result.depth_reached, d + 1)
            _check(nxt)
            queue.append(nxt)
    return result


def _trace_to(state, seen) -> tuple[Label, ...]:
    labels: list[Label] = []
    while True:
        parent, label = seen[state]
        if parent is None:
            break
        labels.append(label)
        state = parent
    return tuple(reversed(labels))
