"""The fleet router: which replica should serve this request?

Port of ``serve/router.py``. One :class:`FleetRouter` sits in front of
the fleet's replicas (``serve/fleet.py``) and answers one question per
submission — *which in-rotation replica gets it*:

- **Prefix-cache affinity** (policy ``"affinity"``, the default): each
  replica's paged pool is probed with ``pool.shared_prefix_len(prompt)``
  (a pure read: no referencing, no memo) and the request routes to the
  replica already holding the LONGEST registered prefix of its prompt, so
  a shared system prompt is prefilled once on one replica instead of on
  every cold one. A prefix in a replica's HOST offload tier
  (``pool.host_prefix_len``) counts too: those blocks are one upload
  away, which the fleet starts at routing time. Ties, the no-prefix cold
  start included, fall back to least-loaded.
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

Multi-tenant adapters add a second affinity signal to ``"affinity"``:
prefix probes are scoped to the request's adapter namespace (a tenant
reuses only K/V its own adapter computed), and when no replica holds a
prefix, a replica where the adapter's current version is already
device-resident (``AdapterStore.is_resident``) is preferred over the
plain least-loaded answer, skipping a bank-row upload. A preference,
never a refusal. A decision made by adapter residency (or a prefix hit
on a replica that also holds the adapter) sets :attr:`last_adapter_hit`
for the fleet's ``serve_route_adapter_affinity_hits_total`` counter. The
baseline policies stay adapter-blind.
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
        #: last route() was decided by (or landed on) a replica holding
        #: the request's adapter — the fleet's adapter-affinity counter
        self.last_adapter_hit = False

    @staticmethod
    def _load_key(rep) -> tuple:
        """Least-loaded order: queue depth, then slot occupancy, then the
        index as the deterministic tiebreak."""
        sup = rep.supervisor
        pool = sup.pool
        return (sup.scheduler.queue_depth,
                pool.n_active / pool.n_slots,
                rep.idx)

    @staticmethod
    def _adapter_state(rep, adapter) -> tuple:
        """``(ns, resident)`` for probing ``rep`` on behalf of a request
        under ``adapter``: the replica's own namespace for the adapter's
        current version (``ns is None``: the replica has no adapter store
        and cannot serve the tenant's cache at all), and whether that
        version is device-resident there."""
        if adapter is None:
            return b"", False
        store = getattr(rep.supervisor.engine, "_adapters", None)
        if store is None:
            return None, False
        return store.namespace_of(adapter), store.is_resident(adapter)

    def route(self, prompt, candidates: list,
              demoted: frozenset = frozenset(), adapter=None) -> tuple:
        """Pick the replica for ``prompt`` from ``candidates`` (the
        fleet's in-rotation list, index order, non-empty). ``demoted``
        replicas stay legal targets but are never preferred. ``adapter``
        (None = the base model) scopes the prefix probes and adds the
        residency preference."""
        if not candidates:
            raise ValueError("route over an empty candidate list — the "
                             "fleet must always offer at least one "
                             "alive replica")
        self.last_suppressed = False
        self.last_adapter_hit = False
        if self.policy == "round-robin":
            rep = candidates[self._rr % len(candidates)]
            self._rr += 1
            return rep, False
        if self.policy == "affinity":
            prompt = np.asarray(prompt, np.int32)
            best, best_len = None, 0
            skipped_len = 0   # longest prefix held by a demoted replica
            resident = []     # healthy replicas holding the adapter
            for rep in candidates:
                pool = rep.supervisor.pool
                ns, res = self._adapter_state(rep, adapter)
                # a device-registered OR a host-resident prefix, in the
                # request's namespace (pools without a host tier answer 0)
                n = 0 if ns is None else max(
                    pool.shared_prefix_len(prompt, ns),
                    pool.host_prefix_len(prompt, ns))
                if rep.idx in demoted:
                    skipped_len = max(skipped_len, n)
                else:
                    if res:
                        resident.append(rep)
                    if n > best_len:
                        best, best_len = rep, n
            if skipped_len > best_len:
                self.last_suppressed = True
            if best is not None:
                self.last_adapter_hit = any(rep is best for rep in resident)
                return best, True
            if resident:
                # no prefix anywhere, but the adapter is uploaded on a
                # healthy replica: least-loaded among those
                self.last_adapter_hit = True
                return min(resident, key=self._load_key), False
        # least-loaded: the standalone policy and the affinity cold-start
        # fallback; demoted replicas sort after every healthy one
        return min(candidates,
                   key=lambda rep: (rep.idx in demoted,
                                    *self._load_key(rep))), False
