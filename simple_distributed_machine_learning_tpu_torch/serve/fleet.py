"""The multi-replica serving fleet: N supervised engines behind one router.

Port of ``serve/fleet.py``. :class:`ServeFleet` runs N
:class:`~.supervisor.ServeSupervisor`-wrapped replicas behind a
:class:`~.router.FleetRouter` and survives the loss of any replica without
losing an in-flight token stream. Every replica's engine lives on the one
device the factory names; a lost or retired replica's engine is dropped at
once, so its K/V pool frees while the fleet serves on.

**Routing.** Submissions go to an in-rotation replica picked by the
router (prefix-cache affinity first, least-loaded otherwise). Rids are
fleet-unique: the fleet owns the id space and seeds the chosen replica's
engine counter before every submit, so journals, traces and metrics of
different replicas never collide on a request id.

**Health-aware rotation.** A replica leaves rotation the tick its
supervisor is anything but cleanly RUNNING (a restart consumed inside the
tick, a degraded mode latched) and re-enters only after
``health_recover_ticks`` consecutive healthy ticks. Out-of-rotation
replicas keep ticking and draining. If rotation empties, routing falls
back to any alive replica.

**Journal-backed migration.** A ``replica-kill@fleet.tick`` fault, or a
replica whose supervisor exhausts its restart budget, kills a whole
replica. The fleet trusts only the dead replica's on-disk journal:
``read_journal`` + ``recover_state`` rebuild the in-flight picture, live
handles rewind to their journaled prefixes, and the survivors adopt the
in-flight requests in rid order through ``ServeSupervisor.adopt``, which
journals each snapshot first. Every migrated stream equals the
uninterrupted single-replica run's.

**Disaggregated prefill/decode** (``prefill_replicas > 0``). New work
boards the prefill replicas only; the tick a request finishes prefill the
fleet hands it to a decode replica in copy-then-tombstone order:
``release(seal=False)`` on the source, ``adopt(reason="handoff")`` on the
destination, then ``seal_handoff`` on the source. Between adopt and seal
the fleet probes the ``fleet.handoff`` fault site; a kill there is the
kill-racing-adopt schedule, and ``_lose_replica``'s live-elsewhere guard
keeps it exactly-once.

**Autoscaling** (:class:`AutoscalePolicy`). A fleet-total queue depth
(or the SLO engine's burn rate) at the high watermark for
``scale_out_ticks`` consecutive fleet ticks spawns a replica, up to
``max_replicas``; a replica observed idle for ``retire_idle_s`` retires,
down to ``min_replicas``. Both land in :attr:`ServeFleet.replica_log`.

The fleet duck-types the engine surface the simulator and the scenario
runner drive and reads the clock NEVER: its timestamps come from arrival
times and the replicas' own engine reads, so the virtual-clock scenario
numbers are exact.

**The host offload tier and adapters.** The router knows a request's
prompt before admission, so a host-resident prefix on the replica it
picks (on the decode pool when disaggregated) starts its upload at
routing time (``pool.prefetch``), overlapping queueing and prefill.
:meth:`ServeFleet.register_adapter` registers a tenant on every alive
replica (the factory's shared host dict carries it to later spawns and
rebuilds), and the router prefers a replica where a request's adapter
is already resident.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import time

from simple_distributed_machine_learning_tpu_torch.resilience import faults
from simple_distributed_machine_learning_tpu_torch.serve.journal import (
    RequestJournal,
    read_journal,
    recover_state,
)
from simple_distributed_machine_learning_tpu_torch.serve.request import (
    ACTIVE,
    DONE,
    QUEUED,
    Request,
)
from simple_distributed_machine_learning_tpu_torch.serve.router import (
    FleetRouter,
)
from simple_distributed_machine_learning_tpu_torch.serve.supervisor import (
    RUNNING,
    RestartBudgetExceeded,
    ServeSupervisor,
)


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Autoscaler knobs; see the module docstring.

    ``scale_out_queue_depth`` is the fleet-total queued-request high
    watermark; ``scale_out_burn_rate`` optionally adds the SLO engine's
    fast-window burn rate (None disables). Any signal held for ``scale_out_ticks``
    consecutive fleet ticks spawns one replica. ``retire_idle_s`` is how
    long a replica must sit idle before it retires."""

    min_replicas: int = 1
    max_replicas: int = 4
    scale_out_queue_depth: int = 4
    scale_out_ticks: int = 3
    retire_idle_s: float = 0.5
    scale_out_burn_rate: float | None = None

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, got "
                             f"{self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas {self.max_replicas} must be >= min_replicas "
                f"{self.min_replicas}")
        if self.scale_out_queue_depth < 1 or self.scale_out_ticks < 1:
            raise ValueError(
                f"scale_out_queue_depth/scale_out_ticks must be >= 1, got "
                f"{self.scale_out_queue_depth}/{self.scale_out_ticks}")
        if self.retire_idle_s <= 0:
            raise ValueError(f"retire_idle_s must be > 0, got "
                             f"{self.retire_idle_s}")
        if (self.scale_out_burn_rate is not None
                and self.scale_out_burn_rate <= 0):
            raise ValueError(f"scale_out_burn_rate must be > 0, got "
                             f"{self.scale_out_burn_rate}")


@dataclasses.dataclass(eq=False)
class _Replica:
    """One fleet member's bookkeeping (identity-hashed)."""

    idx: int
    supervisor: ServeSupervisor
    journal_path: str
    #: "mixed" (symmetric fleet), or "prefill"/"decode" when disaggregated
    role: str = "mixed"
    alive: bool = True
    in_rotation: bool = True
    healthy_streak: int = 0
    last_restarts: int = 0
    #: when the fleet FIRST OBSERVED this replica idle (None while busy):
    #: an observation anchor, not a clock read, so a wall-clock run's
    #: absolute timestamps cancel out
    idle_since: float | None = None


class ServeFleet:
    """N supervised replicas behind a health-aware router; see the module
    docstring.

    ``factory(degraded) -> InferenceEngine`` is the shared engine factory
    (``supervisor.engine_factory``, which carries ``device=``) every
    replica's supervisor rebuilds through; replicas journal into
    ``journal_dir`` as ``<journal_prefix><idx>.jsonl`` (stale fleet
    journals there are removed first). ``metrics``/``clock``/``trace``/
    ``slo`` are shared by every replica. ``prefill_replicas > 0``
    disaggregates the fleet (exclusive with ``autoscale``)."""

    def __init__(self, factory, journal_dir: str, *, n_replicas: int = 2,
                 prefill_replicas: int = 0,
                 route: str = "affinity", metrics=None,
                 clock=time.monotonic, autoscale: AutoscalePolicy | None
                 = None, max_restarts: int = 3,
                 degrade_after: int | None = None, overload=None,
                 default_ttft_deadline_s: float | None = None,
                 default_deadline_s: float | None = None, trace=None,
                 health_recover_ticks: int = 2,
                 journal_sync: bool = True,
                 journal_prefix: str = "journal-r",
                 postmortem_dir: str | None = None,
                 slo=None, alert_recover_ticks: int = 2) -> None:
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if prefill_replicas and not 0 < prefill_replicas < n_replicas:
            raise ValueError(
                f"prefill_replicas {prefill_replicas} must leave at least "
                f"one decode replica: 0 < prefill_replicas < "
                f"n_replicas={n_replicas} (0 disables disaggregation)")
        if prefill_replicas and autoscale is not None:
            raise ValueError(
                "autoscale and prefill_replicas are mutually exclusive: "
                "the autoscaler sizes ONE symmetric pool, a disaggregated "
                "fleet is fixed-size per role")
        if health_recover_ticks < 1:
            raise ValueError(f"health_recover_ticks must be >= 1, got "
                             f"{health_recover_ticks}")
        if alert_recover_ticks < 1:
            raise ValueError(f"alert_recover_ticks must be >= 1, got "
                             f"{alert_recover_ticks}")
        if autoscale is not None and not (autoscale.min_replicas
                                          <= n_replicas
                                          <= autoscale.max_replicas):
            raise ValueError(
                f"n_replicas {n_replicas} outside the autoscale bounds "
                f"[{autoscale.min_replicas}, {autoscale.max_replicas}]")
        self.factory = factory
        self.journal_dir = journal_dir
        self.metrics = metrics
        self._clock = clock
        self.router = FleetRouter(route)
        self.autoscale = autoscale
        self.health_recover_ticks = int(health_recover_ticks)
        # the fleet owns the one SLO engine: replicas observe into it
        # (replica-tagged), the fleet evaluates it once per fleet tick and
        # turns firing per-replica burn alerts into routing demotions
        self.slo = slo
        self.alert_recover_ticks = int(alert_recover_ticks)
        self._alert_demoted: set[int] = set()
        self._alert_clear_streak: dict[int, int] = {}
        if slo is not None and metrics is not None:
            metrics.bind_slo(slo)
        self.journal_sync = journal_sync
        self._sup_kw = dict(
            max_restarts=max_restarts, degrade_after=degrade_after,
            overload=overload,
            default_ttft_deadline_s=default_ttft_deadline_s,
            default_deadline_s=default_deadline_s,
            # the replicas share one bundle dir; postmortem_tag keeps the
            # names apart
            postmortem_dir=postmortem_dir)
        self.trace = trace
        self.journal_prefix = journal_prefix
        os.makedirs(journal_dir, exist_ok=True)
        for stale in glob.glob(os.path.join(journal_dir,
                                            f"{journal_prefix}*.jsonl")):
            os.unlink(stale)               # each fleet run journals fresh
        self.replicas: list[_Replica] = []
        self._next_idx = 0
        #: the fleet-owned rid space
        self._next_rid = 0
        self.requests: dict[int, Request] = {}
        self._home: dict[int, int] = {}        # rid -> serving replica idx
        self._user_cb: dict[int, object] = {}  # rid -> caller's on_token
        #: monotonic fleet tick (every alive replica steps once per tick)
        self.tick = 0
        self._now = 0.0       # newest timestamp the fleet has SEEN
        self._backlog_ticks = 0
        self.replica_losses = 0
        self.migrations = 0
        self.prefill_replicas = int(prefill_replicas)
        self.disaggregated = prefill_replicas > 0
        #: planned prefill->decode migrations fired (``_handoff_step``)
        self.handoffs = 0
        #: fleet events — (tick, t, event, replica, alive count) — the
        #: trajectory the autoscale and loss scenarios pin exactly
        self.replica_log: list[dict] = []
        for i in range(n_replicas):
            role = "mixed"
            if self.disaggregated:
                role = "prefill" if i < prefill_replicas else "decode"
            self._spawn_replica(log=None, role=role)

    # -- replica lifecycle ---------------------------------------------------

    def _spawn_replica(self, log: str | None,
                       role: str = "mixed") -> _Replica:
        idx = self._next_idx
        self._next_idx += 1
        path = os.path.join(self.journal_dir,
                            f"{self.journal_prefix}{idx}.jsonl")
        sup = ServeSupervisor(
            self.factory, RequestJournal(path, sync=self.journal_sync),
            metrics=self.metrics, clock=self._clock, trace=self.trace,
            postmortem_tag=f"-r{idx}", **self._sup_kw)
        if role != "mixed":
            sup.pool_role = role
        if self.slo is not None:
            # the replica's flight rows carry the active alerts; the
            # evaluation is the fleet's
            sup.slo = self.slo
            sup._drive_slo = False
        rep = _Replica(idx=idx, supervisor=sup, journal_path=path,
                       role=role)
        self.replicas.append(rep)
        if log is not None:
            self._log_event(log, rep)
            if self.metrics is not None and log == "scale-out":
                self.metrics.on_scale_out()
        return rep

    def _drop_engine(self, rep: _Replica) -> None:
        """A dead or retired replica's engine goes now: its device K/V
        pool frees while the fleet serves on (the supervisor record stays
        for its counters)."""
        rep.supervisor.engine = None

    def _log_event(self, event: str, rep: _Replica) -> None:
        self.replica_log.append({
            "tick": self.tick, "t": round(self._now, 6), "event": event,
            "replica": rep.idx, "alive": self.n_alive})

    def _alive(self) -> list[_Replica]:
        return [r for r in self.replicas if r.alive]

    def _rotation(self) -> list[_Replica]:
        return [r for r in self.replicas if r.alive and r.in_rotation]

    def _role_alive(self, role: str) -> list[_Replica]:
        return [r for r in self.replicas if r.alive and r.role == role]

    def _role_rotation(self, role: str) -> list[_Replica]:
        return [r for r in self.replicas
                if r.alive and r.in_rotation and r.role == role]

    def _role_candidates(self, role: str) -> list[_Replica]:
        """Routing candidates for one pool, degrading but never refusing:
        in-rotation same-role, alive same-role, then any in-rotation /
        alive replica."""
        return (self._role_rotation(role) or self._role_alive(role)
                or self._rotation() or self._alive())

    @property
    def n_alive(self) -> int:
        return sum(1 for r in self.replicas if r.alive)

    @property
    def n_in_rotation(self) -> int:
        return len(self._rotation())

    # -- the engine surface --------------------------------------------------

    @property
    def busy(self) -> bool:
        return any(r.supervisor.busy for r in self._alive())

    @property
    def cfg(self):
        return self._alive()[0].supervisor.cfg

    def submit(self, prompt, max_new_tokens: int, temperature: float = 0.0,
               top_k: int | None = None, top_p: float | None = None,
               eos_id: int | None = None, seed: int | None = None,
               on_token=None, arrival_time: float | None = None,
               cls: str | None = None, priority: int = 0,
               ttft_deadline_s: float | None = None,
               deadline_s: float | None = None,
               adapter: str | None = None) -> Request:
        """Route one submission to an in-rotation replica and submit it
        through that replica's supervisor: journaled, admission-controlled
        and deadline-bound exactly as one supervised engine would.
        ``adapter`` names the request's tenant (:meth:`register_adapter`):
        prefix probes scope to its namespace and the router prefers a
        replica where it is already resident."""
        if arrival_time is not None:
            self._now = max(self._now, arrival_time)
            self._retire_idle()   # idle troughs advance via arrivals
        if self.disaggregated:
            # new work boards the prefill pool; the decode pool receives
            # requests only by handoff or loss migration
            candidates = self._role_candidates("prefill")
        else:
            candidates = self._rotation() or self._alive()
        rep, hit = self.router.route(prompt, candidates,
                                     demoted=frozenset(self._alert_demoted),
                                     adapter=adapter)
        if self.metrics is not None:
            if hit:
                self.metrics.on_affinity_hit()
            if self.router.last_adapter_hit:
                self.metrics.on_adapter_affinity_hit()
            if self.router.last_suppressed:
                self.metrics.on_alert_demotion()
        # a host-tier copy of the prefix that beats what the target pool
        # holds on the device starts uploading now, overlapping the queue
        # wait and the prefill
        self._prefetch_host(
            prompt,
            self._role_alive("decode") if self.disaggregated else [rep],
            adapter=adapter)
        rid = self._next_rid
        rep.supervisor.engine._next_rid = rid
        self._user_cb[rid] = on_token
        if self.metrics is not None:
            # admission sheds inside submit() observe into the SLO engine
            # under this replica's index
            self.metrics._slo_replica = rep.idx
        try:
            h = rep.supervisor.submit(
                prompt, max_new_tokens, temperature=temperature,
                top_k=top_k, top_p=top_p, eos_id=eos_id, seed=seed,
                on_token=on_token, arrival_time=arrival_time, cls=cls,
                priority=priority, ttft_deadline_s=ttft_deadline_s,
                deadline_s=deadline_s, adapter=adapter)
        except RestartBudgetExceeded as e:
            # an admission crash with the restart budget spent: a replica
            # LOSS. The submission was journaled before the engine saw
            # it, so the migration re-admits it on a survivor and the
            # journal-recovered handle becomes the caller's
            self._lose_replica(rep, f"RestartBudgetExceeded@submit: {e}")
            self._next_rid += 1
            return self.requests[rid]
        finally:
            if self.metrics is not None:
                self.metrics._slo_replica = None
        self._next_rid += 1
        self.requests[h.rid] = h
        self._home[h.rid] = rep.idx
        return h

    def register_adapter(self, name: str, weights: dict) -> None:
        """Register (or hot-swap) a named LoRA adapter on every alive
        replica, so a tenant is servable wherever routing or a loss
        migration lands it. This is also what bumps each replica's store
        version, so a hot-swap invalidates resident rows and cached
        prefixes fleet-wide."""
        for rep in self._alive():
            rep.supervisor.register_adapter(name, weights)

    def _prefetch_host(self, prompt, candidates: list,
                       adapter: str | None = None) -> None:
        """Start the host->device upload of the longest host-resident
        prefix among ``candidates``, only where the host copy strictly
        beats what that replica already holds on the device. Probes and
        upload scope to the request's adapter namespace; pools without a
        host tier answer 0, so an HBM-only fleet does nothing here."""
        best, best_len, best_ns = None, 0, b""
        for r in candidates:
            pool = r.supervisor.pool
            ns, _ = FleetRouter._adapter_state(r, adapter)
            if ns is None:
                continue
            n = pool.host_prefix_len(prompt, ns)
            if n > pool.shared_prefix_len(prompt, ns) and n > best_len:
                best, best_len, best_ns = r, n, ns
        if best is not None:
            best.supervisor.pool.prefetch(prompt, best_ns)

    def step(self) -> int:
        """One fleet tick: interpret scheduled replica-kill faults, step
        every alive replica once (a supervisor that exhausts its restart
        budget is a replica loss), update rotation with hysteresis,
        evaluate the SLO engine, hand off, autoscale, refresh the fleet
        gauges. Returns the tokens emitted fleet-wide."""
        self.tick += 1
        # the fleet.tick fault site: probed once per alive replica (rank
        # = replica idx) and interpreted here
        for rep in self._alive():
            if not rep.alive:      # died earlier in this probe sweep
                continue
            for spec in faults.check("fleet.tick", step=self.tick,
                                     rank=rep.idx):
                if spec.kind == "replica-kill":
                    self._lose_replica(rep, f"replica-kill@tick{self.tick}")
                    break
        emitted = 0
        for rep in self._alive():
            if self.metrics is not None:
                self.metrics._slo_replica = rep.idx
            try:
                emitted += rep.supervisor.step()
            except RestartBudgetExceeded as e:
                self._lose_replica(rep, f"RestartBudgetExceeded: {e}")
                continue
            finally:
                if self.metrics is not None:
                    self.metrics._slo_replica = None
            self._update_health(rep)
        if self.slo is not None:
            self.slo.evaluate(self.tick)
            self._update_alert_demotions()
        if self.disaggregated:
            self._handoff_step()
        if self.autoscale is not None:
            self._autoscale_step()
        if self.metrics is not None:
            self.metrics.set_fleet_replicas(self.n_in_rotation)
            self.metrics.set_journal_bytes(
                sum(r.supervisor.journal.bytes for r in self._alive()))
            if self.disaggregated:
                for role in ("prefill", "decode"):
                    reps = self._role_alive(role)
                    self.metrics.set_pool_stats(
                        role, replicas=len(reps),
                        queue_depth=sum(
                            r.supervisor.scheduler.queue_depth
                            for r in reps),
                        slots_active=sum(
                            r.supervisor.pool.n_active for r in reps))
        return emitted

    # -- disaggregation: the end-of-prefill handoff --------------------------

    def _handoff_step(self) -> None:
        """Move every request on a prefill replica that finished its
        prefill (seated, first token emitted, still decoding) to the
        decode pool, in copy-then-tombstone order (module docstring).
        The ``fleet.handoff`` probe sits in the adopt->seal window."""
        for src in self._role_alive("prefill"):
            sup = src.supervisor
            ready = sorted(
                rid for rid, h in sup.requests.items()
                if h.state == ACTIVE and h.prefill_pos is None
                and h.tokens)
            src_lost = False
            for rid in ready:
                # recomputed per rid: an adoption crash or a handoff kill
                # earlier in this sweep may have shrunk the decode pool
                decode = self._role_candidates("decode")
                cand = [r for r in decode if r is not src] or decode
                h = sup.requests[rid]
                dst, hit = self.router.route(
                    h.prompt, cand, demoted=frozenset(self._alert_demoted),
                    adapter=h.adapter)
                if dst is src:
                    # every decode replica is dead and the source is the
                    # only survivor: nothing to move to
                    continue
                if self.metrics is not None:
                    if hit:
                        self.metrics.on_affinity_hit()
                    if self.router.last_adapter_hit:
                        self.metrics.on_adapter_affinity_hit()
                if self.trace is not None:
                    self.trace.on_migrate(h, self._now, src.idx, dst.idx)
                h = sup.release(rid, dst=dst.idx, seal=False)
                try:
                    dst.supervisor.adopt(h, on_token=self._user_cb.get(rid),
                                         reason="handoff")
                except RestartBudgetExceeded as e:
                    # adopt() journaled the snap before restore ran, so
                    # the rid recovers from the dead destination's journal
                    # (maybe back onto src, hence the deferred tombstone)
                    self._lose_replica(
                        dst, f"RestartBudgetExceeded@handoff: {e}")
                    continue
                self._home[rid] = dst.idx
                self.handoffs += 1
                if self.metrics is not None:
                    self.metrics.on_handoff()
                for spec in faults.check("fleet.handoff", step=self.tick,
                                         rank=src.idx):
                    if spec.kind == "replica-kill":
                        self._lose_replica(
                            src, f"replica-kill@handoff(rid={rid})")
                        src_lost = True
                        break
                if src_lost:
                    break
                if rid not in sup.requests:
                    # an adoption-crash recovery may have routed the rid
                    # back home; a tombstone after that snap would drop it
                    sup.seal_handoff(rid, dst=dst.idx)

    def drain(self, max_ticks: int | None = None) -> list[Request]:
        from simple_distributed_machine_learning_tpu_torch.serve.engine import (  # noqa: E501
            DrainTimeout,
        )
        ticks = 0
        while self.busy:
            if max_ticks is not None and ticks >= max_ticks:
                exc = DrainTimeout(max_ticks, [
                    r for r in self.requests.values()
                    if r.state in (QUEUED, ACTIVE)])
                # one tagged bundle per alive replica, before the raise
                for rep in self._alive():
                    rep.supervisor._dump_postmortem("drain_timeout",
                                                    str(exc))
                raise exc
            self.step()
            ticks += 1
        return [r for r in self.requests.values() if r.state == DONE]

    def close(self) -> None:
        for rep in self._alive():
            rep.supervisor.close()

    # -- health + rotation ---------------------------------------------------

    def _update_health(self, rep: _Replica) -> None:
        """Healthy this tick iff the supervisor ended RUNNING and consumed
        no restart inside the tick. Unhealthy leaves rotation now;
        re-entry needs ``health_recover_ticks`` healthy ticks in a row."""
        sup = rep.supervisor
        healthy = (sup.state == RUNNING
                   and sup.restarts == rep.last_restarts)
        rep.last_restarts = sup.restarts
        if not healthy:
            if rep.in_rotation:
                self._log_event("drain", rep)
            rep.in_rotation = False
            rep.healthy_streak = 0
        else:
            rep.healthy_streak += 1
            if (not rep.in_rotation
                    and rep.healthy_streak >= self.health_recover_ticks):
                rep.in_rotation = True
                self._log_event("re-enter", rep)
        self._now = max(self._now, sup.engine._now)

    def _update_alert_demotions(self) -> None:
        """A replica whose per-replica burn alert fires loses the router's
        affinity preference; it regains it after ``alert_recover_ticks``
        consecutive non-firing fleet ticks."""
        firing = self.slo.firing_replicas()
        for rep in self._alive():
            if rep.idx in firing:
                if rep.idx not in self._alert_demoted:
                    self._alert_demoted.add(rep.idx)
                    self._log_event("alert-demote", rep)
                self._alert_clear_streak[rep.idx] = 0
            elif rep.idx in self._alert_demoted:
                streak = self._alert_clear_streak.get(rep.idx, 0) + 1
                self._alert_clear_streak[rep.idx] = streak
                if streak >= self.alert_recover_ticks:
                    self._alert_demoted.discard(rep.idx)
                    self._log_event("alert-re-enter", rep)

    # -- replica loss + migration -------------------------------------------

    def _lose_replica(self, rep: _Replica, cause: str) -> None:
        """A whole replica died. Nothing of its memory is trusted: the
        in-flight picture rebuilds from its on-disk journal alone, live
        handles rewind to their journaled prefixes, and survivors adopt
        the in-flight requests in rid order."""
        rep.alive = False
        rep.in_rotation = False
        self.replica_losses += 1
        if self.metrics is not None:
            self.metrics.on_replica_loss()
        prev_now = rep.supervisor.engine._now
        self._drop_engine(rep)
        self._now = max(self._now, prev_now)
        self._log_event("loss", rep)
        try:
            rep.supervisor.journal.close()
        except OSError:                      # pragma: no cover - env guard
            pass
        snapshots = recover_state(read_journal(rep.journal_path)[0])
        inflight = []
        for rid in sorted(snapshots):
            if any(r.alive and rid in r.supervisor.requests
                   for r in self.replicas if r is not rep):
                # the live-elsewhere guard: a handoff adopt landed but the
                # source died before its tombstone — the dead journal's
                # copy is stale; re-adopting it would double-serve
                continue
            h = self.requests.get(rid)
            if h is None:
                # the submission whose admission crash killed this
                # replica: the snapshot becomes the caller's handle
                h = snapshots[rid]
                self.requests[rid] = h
            else:
                ServeSupervisor._apply_snapshot(h, snapshots[rid])
            if h.state == QUEUED:
                inflight.append(h)
        if self.trace is not None:
            self.trace.on_crash(prev_now, [h.rid for h in inflight],
                                "ReplicaLost")
        targets = self._alive()
        if not targets:
            # the last replica died: replace it at once
            targets = [self._spawn_replica(log="replace", role=rep.role)]
        adopted: dict[_Replica, int] = {}
        for h in inflight:
            if self.disaggregated:
                # a request with tokens already finished prefill: it goes
                # to the decode pool; one without still owes its prefill
                role = "decode" if h.tokens else "prefill"
                cand = ([r for r in targets
                         if r.in_rotation and r.role == role]
                        or [r for r in targets if r.role == role]
                        or [r for r in targets if r.in_rotation]
                        or targets)
            else:
                cand = [r for r in targets if r.in_rotation] or targets
            dst, hit = self.router.route(
                h.prompt, cand, demoted=frozenset(self._alert_demoted),
                adapter=h.adapter)
            if self.metrics is not None:
                if hit:
                    self.metrics.on_affinity_hit()
                if self.router.last_adapter_hit:
                    self.metrics.on_adapter_affinity_hit()
            if self.trace is not None:
                self.trace.on_migrate(h, prev_now, rep.idx, dst.idx)
            dst.supervisor.adopt(h, on_token=self._user_cb.get(h.rid))
            self._home[h.rid] = dst.idx
            adopted[dst] = adopted.get(dst, 0) + 1
        self.migrations += len(inflight)
        if self.metrics is not None:
            self.metrics.on_fleet_migrated(len(inflight))
        # every adopting journal records the loss it absorbed (the
        # per-replica restart timeline the report CLI renders)
        for dst in sorted(adopted, key=lambda r: r.idx):
            dst.supervisor.journal.log_restart(
                self.replica_losses, False,
                f"ReplicaLost(r{rep.idx})->adopted={adopted[dst]} "
                f"[{cause}]", tick=self.tick)

    # -- autoscaling ---------------------------------------------------------

    def _autoscale_step(self) -> None:
        pol = self.autoscale
        # the floor binds on the loss side too
        while self.n_alive < pol.min_replicas:
            self._spawn_replica(log="replace")
        alive = self._alive()
        qd = sum(r.supervisor.scheduler.queue_depth for r in alive)
        burn_high = False
        if pol.scale_out_burn_rate is not None and self.slo is not None:
            burn_high = (max(self.slo.burn_rates().values(), default=0.0)
                         >= pol.scale_out_burn_rate)
        if qd >= pol.scale_out_queue_depth or burn_high:
            self._backlog_ticks += 1
        else:
            self._backlog_ticks = 0
        if (self._backlog_ticks >= pol.scale_out_ticks
                and self.n_alive < pol.max_replicas):
            self._spawn_replica(log="scale-out")
            self._backlog_ticks = 0
        self._retire_idle()

    def _retire_idle(self) -> None:
        """Drain-then-retire: a replica observed idle for
        ``retire_idle_s`` retires, newest first, never below
        ``min_replicas``. Runs every fleet tick and at every timestamped
        submit (an idle trough advances time through arrivals)."""
        if self.autoscale is None:
            return
        pol = self.autoscale
        for rep in sorted(self._alive(), key=lambda r: -r.idx):
            if rep.supervisor.busy:
                rep.idle_since = None
                continue
            if rep.idle_since is None:
                rep.idle_since = self._now
                continue
            if self.n_alive <= pol.min_replicas:
                continue
            if self._now - rep.idle_since >= pol.retire_idle_s:
                rep.alive = False
                rep.in_rotation = False
                rep.supervisor.close()
                self._drop_engine(rep)
                self._log_event("retire", rep)
                if self.metrics is not None:
                    self.metrics.on_retire()
