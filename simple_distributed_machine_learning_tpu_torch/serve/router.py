"""The fleet router: which replica should serve this request?

Port of ``serve/router.py`` without the host-tier and adapter signals
(ROADMAP.md, Queue A, item 5). One :class:`FleetRouter` sits in front of
the fleet's replicas (``serve/fleet.py``) and answers one question per
submission — *which in-rotation replica gets it*:

- **Prefix-cache affinity** (policy ``"affinity"``, the default): each
  replica's paged pool is probed with ``pool.shared_prefix_len(prompt)``
  (a pure read: no referencing, no memo) and the request routes to the
  replica already holding the LONGEST registered prefix of its prompt, so
  a shared system prompt is prefilled once on one replica instead of on
  every cold one. Ties, the no-prefix cold start included, fall back to
  least-loaded.
- **Least-loaded** (policy ``"least-loaded"``): the minimum of
  ``(queue_depth, occupancy, idx)``; the index breaks exact ties, so a
  virtual-clock scenario routes identically on every run.
- **Round-robin** (policy ``"round-robin"``): cycle over the in-rotation
  replicas in index order — the affinity-blind baseline.

The router never inspects health: the fleet decides which replicas are in
rotation and hands the candidate list in. Alert demotion follows the same
division of labour: the fleet passes the replica indices whose
per-replica SLO burn alert is firing (``demoted``); they are never
*preferred* by affinity and sort after every healthy replica in the
least-loaded fallback. When the demotion changed the answer (the longest
prefix lived on a demoted replica) :attr:`last_suppressed` is set for the
fleet's ``serve_route_alert_demotions_total`` counter.
"""

from __future__ import annotations

import numpy as np

POLICIES = ("affinity", "least-loaded", "round-robin")


class FleetRouter:
    """Routing policy over fleet replicas; see module docstring.

    ``route(prompt, candidates)`` returns ``(replica, affinity_hit)``,
    ``affinity_hit`` True iff a strictly positive prefix match decided.
    Candidates duck-type ``.idx`` and ``.supervisor`` (``scheduler``,
    ``pool``)."""

    def __init__(self, policy: str = "affinity") -> None:
        if policy not in POLICIES:
            raise ValueError(
                f"unknown route policy {policy!r}; known: {POLICIES}")
        self.policy = policy
        self._rr = 0          # round-robin cursor (monotonic, mod applied)
        #: last route() skipped the best affinity candidate because it was
        #: demoted — the fleet reads this to count alert demotions
        self.last_suppressed = False

    @staticmethod
    def _load_key(rep) -> tuple:
        """Least-loaded order: queue depth, then slot occupancy, then the
        index as the deterministic tiebreak."""
        sup = rep.supervisor
        pool = sup.pool
        return (sup.scheduler.queue_depth,
                pool.n_active / pool.n_slots,
                rep.idx)

    def route(self, prompt, candidates: list,
              demoted: frozenset = frozenset()) -> tuple:
        """Pick the replica for ``prompt`` from ``candidates`` (the
        fleet's in-rotation list, index order, non-empty). ``demoted``
        replicas stay legal targets but are never preferred."""
        if not candidates:
            raise ValueError("route over an empty candidate list — the "
                             "fleet must always offer at least one "
                             "alive replica")
        self.last_suppressed = False
        if self.policy == "round-robin":
            rep = candidates[self._rr % len(candidates)]
            self._rr += 1
            return rep, False
        if self.policy == "affinity":
            prompt = np.asarray(prompt, np.int32)
            best, best_len = None, 0
            skipped_len = 0   # longest prefix held by a demoted replica
            for rep in candidates:
                n = rep.supervisor.pool.shared_prefix_len(prompt)
                if rep.idx in demoted:
                    skipped_len = max(skipped_len, n)
                elif n > best_len:
                    best, best_len = rep, n
            if skipped_len > best_len:
                self.last_suppressed = True
            if best is not None:
                return best, True
        # least-loaded: the standalone policy and the affinity cold-start
        # fallback; demoted replicas sort after every healthy one
        return min(candidates,
                   key=lambda rep: (rep.idx in demoted,
                                    *self._load_key(rep))), False
