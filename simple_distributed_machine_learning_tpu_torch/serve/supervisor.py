"""The serve supervisor: crash-restartable serving with overload control.

Port of ``serve/supervisor.py``. :class:`ServeSupervisor` wraps an :class:`~.engine.InferenceEngine` behind
the engine's own surface (``submit``/``step``/``drain``/``busy``/
``requests``), adding three things a single engine lacks:

**Crash recovery (RUNNING → RECOVERING → RUNNING | DEGRADED).** Every
submission and every emitted token is journaled (``serve/journal.py``,
fsync'd, each token record carrying the request's live key data). A
recoverable engine failure (:data:`RECOVERABLE`: an injected
``engine-crash`` / ``wedged-device`` / ``host-kill`` at ``serve.tick`` or
``serve.admit``) discards the engine wholesale, rebuilds one through the
caller's ``factory(degraded)`` and re-admits every in-flight request from
the journal alone through ``engine.restore``: re-admission prefills
``resume_seq = prompt + tokens[:-1]`` with the sample and key advance
discarded and reseats on the last journaled token, so a request's full
stream equals the uninterrupted run's across any number of restarts.
``max_restarts`` bounds the loop (:class:`RestartBudgetExceeded`), and
past ``degrade_after`` restarts rebuilds use :func:`engine_factory`'s
fallback: speculation off, dense slot rows.

**Deadlines.** ``submit(..., ttft_deadline_s=, deadline_s=)`` (or the
supervisor-wide defaults) bound time to first token and total latency.
Expired requests are shed at tick boundaries (``state = SHED``,
``finish_reason = "deadline"``) and their slot/block budget refunded.

**Overload control.** :class:`OverloadPolicy` gates admission before the
engine sees a request: per-class token buckets, a queue-depth bound that
sheds the lowest-priority newest queued victim for a higher-priority
arrival (else the arrival), and a load-degraded mode with hysteresis that
refuses best-effort traffic while the backlog is high. Every shed lands in
``serve_shed_total{reason=deadline|backpressure|class}``.

**Observability.** ``trace=`` (a ``serve/tracing.py::ServeTrace``)
outlives engines: it is re-attached to every rebuilt engine, so a
request's spans join across restarts under its rid. ``flight=`` (a
``serve/flight.py::FlightRecorder``, created implicitly when
``postmortem_dir`` is set) snaps once per tick at the monotonic
:attr:`tick`, and every post-mortem bundle carries its rows.

**The fleet's half** (``serve/fleet.py``): :meth:`adopt` takes in a
request migrated from another replica (journaling its snapshot first),
:meth:`release` hands a live request out without journaling, and
:meth:`seal_handoff` journals the source's tombstone once the
destination's snapshot landed — the copy-then-tombstone order of the
disaggregated handoff.

Clock reads: ``submit`` without an arrival stamp reads once, the deadline
check once per tick while any open request carries a deadline; recovery,
tracing and the fleet's half read none (the virtual-clock pins depend on
it).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from simple_distributed_machine_learning_tpu_torch.resilience.faults import (
    DeviceWedged,
    EngineCrash,
    HostLost,
)
from simple_distributed_machine_learning_tpu_torch.resilience.supervisor import (  # noqa: E501,F401 - the one class, re-exported
    RestartBudgetExceeded,
)
from simple_distributed_machine_learning_tpu_torch.serve.journal import (
    RequestJournal,
)
from simple_distributed_machine_learning_tpu_torch.serve.request import (
    ACTIVE,
    DONE,
    QUEUED,
    SHED,
    Request,
    validate_request,
)

# supervisor states
RUNNING = "running"
RECOVERING = "recovering"
DEGRADED = "degraded"
FAILED = "failed"

#: engine failures the supervisor restarts through; anything else is a
#: bug in the serving code and propagates un-retried
RECOVERABLE = (EngineCrash, DeviceWedged, HostLost)


@dataclasses.dataclass(frozen=True)
class OverloadPolicy:
    """Admission-control knobs; ``OverloadPolicy()`` disables them all.

    ``class_rates`` maps a traffic-class name to a ``(rate_per_s, burst)``
    token bucket (submissions beyond it shed, reason ``"class"``).
    ``max_queue_depth`` bounds the scheduler queue: at the bound, an
    arrival strictly higher-priority than some queued request sheds the
    lowest-priority newest-queued victim (reason ``"backpressure"``) and
    boards; otherwise the arrival sheds. ``degrade_queue_depth`` /
    ``recover_queue_depth`` are the load-degraded hysteresis: past the
    high watermark, requests at priority <= ``degraded_priority_floor``
    are refused (reason ``"class"``) until the queue drains to the low
    one."""

    max_queue_depth: int | None = None
    class_rates: dict | None = None
    degrade_queue_depth: int | None = None
    recover_queue_depth: int = 0
    degraded_priority_floor: int = 0

    def __post_init__(self):
        if self.class_rates is not None:
            # a defensive copy: one policy may be shared by several
            # supervisors, each keeping its own bucket fills
            object.__setattr__(
                self, "class_rates",
                {cls: (float(rb[0]), float(rb[1]))
                 for cls, rb in self.class_rates.items()})
        if self.max_queue_depth is not None and self.max_queue_depth < 1:
            raise ValueError(f"max_queue_depth must be >= 1, got "
                             f"{self.max_queue_depth}")
        if self.degrade_queue_depth is not None:
            if self.degrade_queue_depth < 1:
                raise ValueError(f"degrade_queue_depth must be >= 1, got "
                                 f"{self.degrade_queue_depth}")
            if self.recover_queue_depth >= self.degrade_queue_depth:
                raise ValueError(
                    f"recover_queue_depth {self.recover_queue_depth} must "
                    f"sit below degrade_queue_depth "
                    f"{self.degrade_queue_depth} (hysteresis, not a "
                    f"flapping threshold)")
        for cls, rb in (self.class_rates or {}).items():
            rate, burst = rb
            if rate <= 0 or burst < 1:
                raise ValueError(
                    f"class {cls!r}: token bucket needs rate > 0 and "
                    f"burst >= 1, got ({rate}, {burst})")


def engine_factory(stages, cfg, *, metrics=None, clock=time.monotonic,
                   scheduler=None, mesh=None, draft_stages=None,
                   draft_cfg=None, spec_k: int = 0,
                   adapter_rank: int = 0, adapter_host: dict | None = None,
                   device=None, **kw):
    """The standard ``factory(degraded) -> InferenceEngine`` closure.

    Non-degraded builds get the deployment exactly as passed (paged
    knobs, ``attn_kernel``, the speculative draft); ``degraded=True``
    applies the fallback rule — ``spec_k`` -> 0, dense slot rows, and a
    quantised cache widened to f32. Greedy streams are equal on every
    layout. ``scheduler`` must be a class/factory (each rebuilt engine
    builds its own over its own pool); ``metrics``/``clock``/``device``
    are shared by every rebuild.

    ``adapter_rank > 0`` turns on multi-tenant LoRA serving: every build,
    degraded ones included (the fallback drops layout features, never
    tenants), gets a fresh ``AdapterStore`` over one shared
    ``adapter_host`` dict, so registered adapters survive crash rebuilds
    while device residency resets with the engine."""
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        _is_quantized_dtype,
    )
    from simple_distributed_machine_learning_tpu_torch.serve.engine import (
        InferenceEngine,
    )
    from simple_distributed_machine_learning_tpu_torch.serve.adapters import (
        AdapterStore,
    )
    if adapter_rank > 0 and adapter_host is None:
        adapter_host = {}        # one dict across every rebuild

    def _adapter_kw() -> dict:
        if adapter_rank <= 0:
            return {}
        return {"adapters": AdapterStore(cfg, adapter_rank,
                                         kw.get("n_slots", 4),
                                         host=adapter_host, device=device)}

    def factory(degraded: bool) -> InferenceEngine:
        if not degraded:
            return InferenceEngine(
                stages, cfg, metrics=metrics, clock=clock,
                scheduler=scheduler, mesh=mesh, draft_stages=draft_stages,
                draft_cfg=draft_cfg, spec_k=spec_k, device=device,
                **_adapter_kw(), **kw)
        dcfg = cfg
        if getattr(cfg, "n_tensor_parallel", 1) > 1:
            dcfg = dataclasses.replace(cfg, n_tensor_parallel=1)
        dkw = {k: v for k, v in kw.items()
               if k not in ("block_size", "n_blocks", "prefill_chunk",
                            "kv_layout", "attn_kernel",
                            "host_cache_blocks", "prefetch_ticks")}
        if _is_quantized_dtype(dkw.get("cache_dtype")):
            dkw["cache_dtype"] = None
        return InferenceEngine(stages, dcfg, kv_layout="dense",
                               metrics=metrics, clock=clock,
                               scheduler=scheduler, device=device,
                               **_adapter_kw(), **dkw)

    return factory


class ServeSupervisor:
    """Crash-restartable, deadline- and overload-aware serving; see the
    module docstring. ``journal`` is a path or a :class:`RequestJournal`;
    ``slo`` an optional ``telemetry.slo.SLOEngine``, evaluated once per
    supervised tick at :attr:`tick` (never from a clock) unless a fleet
    owns the evaluation."""

    def __init__(self, factory, journal, *, metrics=None,
                 clock=time.monotonic, max_restarts: int = 3,
                 degrade_after: int | None = None,
                 overload: OverloadPolicy | None = None,
                 default_ttft_deadline_s: float | None = None,
                 default_deadline_s: float | None = None,
                 trace=None, flight=None, postmortem_dir: str | None = None,
                 postmortem_tail: int = 64, shed_burst: int = 4,
                 postmortem_tag: str = "", slo=None) -> None:
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got "
                             f"{max_restarts}")
        if degrade_after is not None and degrade_after < 1:
            raise ValueError(f"degrade_after must be >= 1 restarts, got "
                             f"{degrade_after}")
        if shed_burst < 1:
            raise ValueError(f"shed_burst must be >= 1, got {shed_burst}")
        self.factory = factory
        self.journal = (RequestJournal(journal) if isinstance(journal, str)
                        else journal)
        self.metrics = metrics
        self._clock = clock
        self.max_restarts = int(max_restarts)
        self.degrade_after = degrade_after
        self.overload = overload if overload is not None else OverloadPolicy()
        self.default_ttft_deadline_s = default_ttft_deadline_s
        self.default_deadline_s = default_deadline_s
        self.trace = trace
        self.postmortem_dir = postmortem_dir
        self.postmortem_tail = int(postmortem_tail)
        self.postmortem_tag = postmortem_tag
        self.shed_burst = int(shed_burst)
        if flight is None and postmortem_dir is not None:
            from simple_distributed_machine_learning_tpu_torch.serve.flight import (  # noqa: E501
                FlightRecorder,
            )
            flight = FlightRecorder()
        self.flight = flight
        self.slo = slo
        # under a fleet the FLEET evaluates the one SLO engine at its own
        # tick and clears this on every replica
        self._drive_slo = True
        if slo is not None and metrics is not None:
            metrics.bind_slo(slo)
        self.postmortems: list[str] = []     # bundle paths, write order
        self._sheds_since_step = 0
        #: the disaggregated fleet's pool role ("prefill" | "decode"),
        #: stamped onto every flight row; None outside such a fleet
        self.pool_role: str | None = None
        #: monotonic tick counter: survives engine rebuilds; every journal
        #: record carries it
        self.tick = 0
        self.restarts = 0
        self.degraded = False        # fault-driven: rebuilds use the fallback
        self.load_degraded = False   # overload-driven: best-effort lockout
        self.state = RUNNING
        self.requests: dict[int, Request] = {}
        self._open: set[int] = set()           # submitted, not DONE/SHED
        self._user_cb: dict[int, object] = {}  # rid -> caller's on_token
        self._buckets: dict[str, tuple[float, float]] = {}
        self.engine = factory(False)
        self._attach_engine(prev_now=0.0)
        # cold start: a previous process's journal recovers here — its
        # finished streams become readable handles, its in-flight requests
        # re-admit (no restart consumed: the budget guards THIS process)
        snapshots = self.journal.recovered_state()
        if snapshots:
            self._reseat(snapshots, note_recovered=True)

    def _attach_engine(self, prev_now: float) -> None:
        """Wire the (re)built engine into the shared observability state:
        the trace recorder outlives engines, and the dead engine's last
        clock reading seeds the new one (no read)."""
        if self.trace is not None:
            self.engine.trace = self.trace
        self.engine._now = max(self.engine._now, prev_now)

    # -- the engine surface -------------------------------------------------

    @property
    def busy(self) -> bool:
        return self.engine.busy

    @property
    def cfg(self):
        return self.engine.cfg

    @property
    def scheduler(self):
        return self.engine.scheduler

    @property
    def pool(self):
        return self.engine.pool

    def submit(self, prompt, max_new_tokens: int, temperature: float = 0.0,
               top_k: int | None = None, top_p: float | None = None,
               eos_id: int | None = None, seed: int | None = None,
               on_token=None, arrival_time: float | None = None,
               cls: str | None = None, priority: int = 0,
               ttft_deadline_s: float | None = None,
               deadline_s: float | None = None,
               adapter: str | None = None) -> Request:
        """Admission-controlled, journaled submit. The returned handle may
        already be ``SHED`` (a structured rejection that never reached the
        engine); otherwise the submission is journaled BEFORE the engine
        sees it, so even a crash inside admission recovers it."""
        now = self._clock() if arrival_time is None else arrival_time
        if ttft_deadline_s is None:
            ttft_deadline_s = self.default_ttft_deadline_s
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        prompt = np.asarray(prompt, np.int32)
        # validate BEFORE journaling: a rejected submission must not leave
        # a record recovery would forever fail to re-admit
        validate_request(prompt, max_new_tokens, temperature, top_k, top_p,
                         self.engine.cfg.vocab, self.engine.max_len)
        self.engine._check_adapter(adapter)
        rid = self.engine._next_rid      # the rid engine.submit will assign
        seed = rid if seed is None else seed
        reason = self._admission_check(cls, priority, now)
        if reason is not None:
            return self._shed_at_admission(
                rid, prompt, max_new_tokens, temperature, top_k, top_p,
                eos_id, seed, cls, priority, ttft_deadline_s, deadline_s,
                reason, now, adapter=adapter)
        self._user_cb[rid] = on_token
        self.journal.log_submit(
            rid=rid, prompt=prompt, max_new=max_new_tokens,
            temp=temperature, top_k=top_k, top_p=top_p, eos=eos_id,
            seed=seed, cls=cls, prio=priority, ttft_dl=ttft_deadline_s,
            dl=deadline_s, t=now, tick=self.tick, adapter=adapter)
        try:
            r = self.engine.submit(
                prompt, max_new_tokens, temperature=temperature,
                top_k=top_k, top_p=top_p, eos_id=eos_id, seed=seed,
                on_token=self._on_token, arrival_time=now, cls=cls,
                priority=priority, ttft_deadline_s=ttft_deadline_s,
                deadline_s=deadline_s, adapter=adapter)
        except RECOVERABLE as e:
            # the serve.admit crash: the journal already carries this
            # submission, so recovery rebuilds and re-admits it
            self._recover(e)
            return self.requests[rid]
        assert r.rid == rid, (r.rid, rid)
        self.requests[rid] = r
        self._open.add(rid)
        return r

    def step(self) -> int:
        """One supervised tick: deadline shedding, the engine tick
        (recoverable failures recover in place), completion acks, the SLO
        evaluation and one flight snap at the monotonic :attr:`tick`, and
        a post-mortem bundle when this tick shed a burst."""
        self.tick += 1
        self._shed_expired()
        try:
            emitted = self.engine.step()
        except RECOVERABLE as e:
            self._recover(e)
            emitted = 0
        self._ack_done()
        self._update_load_degraded()   # a draining backlog lifts the mode
        #                                even if no arrival probes it
        if self.metrics is not None:
            self.metrics.set_journal_bytes(self.journal.bytes)
        if self.slo is not None and self._drive_slo:
            # before the snap: the row at tick T carries the alert set as
            # of the evaluation at T
            self.slo.evaluate(self.tick)
        if self.flight is not None:
            self.flight.snap(self.engine, self.tick, emitted,
                             state=self.state, restarts=self.restarts,
                             degraded=self.degraded,
                             load_degraded=self.load_degraded,
                             **({} if self.pool_role is None
                                else {"pool_role": self.pool_role}),
                             **({} if self.slo is None
                                else {"active_alerts":
                                      self.slo.active_alerts()}))
        if self._sheds_since_step >= self.shed_burst:
            self._dump_postmortem(
                "shed_burst", f"{self._sheds_since_step} sheds in one tick")
        self._sheds_since_step = 0
        return emitted

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
                # the bundle exists even when the caller dies on the raise
                self._dump_postmortem("drain_timeout", str(exc))
                raise exc
            self.step()
            ticks += 1
        return [r for r in self.requests.values() if r.state == DONE]

    def close(self) -> None:
        self.journal.close()
        if self.trace is not None:
            self.trace.flush()

    def register_adapter(self, name: str, weights: dict) -> None:
        """Add or hot-swap a named LoRA adapter (host side; the next
        admission of the name uploads it at a tick boundary). It lands in
        the factory's shared host dict, so it survives crash rebuilds: a
        recovered request re-admits onto the same tenant."""
        store = getattr(self.engine, "_adapters", None)
        if store is None:
            raise ValueError(
                "this supervisor's engine was built without an "
                "AdapterStore — pass adapter_rank= to engine_factory")
        store.register(name, weights)

    # -- the fleet's half (serve/fleet.py) ---------------------------------

    def adopt(self, request: Request, on_token=None,
              reason: str = "failure") -> Request:
        """Adopt a request migrated from ANOTHER replica: failure migration
        (``reason="failure"``, the source's host died) or the
        disaggregated fleet's planned handoff (``reason="handoff"``, the
        source ran :meth:`release`). The full snapshot is journaled here
        FIRST (one ``snap`` record with the cause under ``why``), so this
        replica's journal alone recovers the adoptee through any later
        crash; an in-flight snapshot then re-admits through
        ``engine.restore`` (the crash-recovery path, so the continued
        decode stays bit-exact), a DONE/SHED one is kept as a readable
        handle. ``on_token`` is the caller's streaming callback."""
        if request.rid in self.requests:
            raise ValueError(
                f"request {request.rid} already lives in this replica — "
                f"adopt() is for migrated rids, which are fleet-unique")
        if request.state not in (QUEUED, DONE, SHED):
            raise ValueError(
                f"request {request.rid} is {request.state!r} — migration "
                f"adopts journal snapshots (queued/done/shed), never a "
                f"live engine's state")
        request.snap_reason = reason
        self.journal.log_snapshot(request, tick=self.tick, reason=reason)
        self.requests[request.rid] = request
        if request.state == QUEUED:
            request.on_token = self._on_token
            self._user_cb[request.rid] = on_token
            self.engine.restore(request)
            self._open.add(request.rid)
        else:
            # finished exactly at the loss boundary: keep the rid space
            # clear of it (restore() never ran to bump it)
            self.engine._next_rid = max(self.engine._next_rid,
                                        request.rid + 1)
        return request

    def release(self, rid: int, dst=None, seal: bool = True) -> Request:
        """Hand a LIVE request out of this replica (the source half of the
        prefill->decode handoff). An ACTIVE request's slot and blocks free
        now (the preemption release path without its accounting), so the
        handle keeps its tokens and key stream and the destination's
        re-admission continues bit-exact; a QUEUED one leaves the queue.
        Returns the handle (state QUEUED) for the destination to adopt.

        ``seal=True`` journals the terminal ``handoff`` record here;
        ``seal=False`` defers it to :meth:`seal_handoff`, which the fleet
        calls only after the destination's ``adopt`` snap landed — the
        copy-then-tombstone order, under which the rid is recoverable
        from at least one journal at every crash point."""
        r = self.requests.get(rid)
        if r is None:
            raise ValueError(f"request {rid} does not live in this replica")
        if r.state not in (QUEUED, ACTIVE):
            raise ValueError(
                f"request {rid} is {r.state!r} — only live "
                f"(queued/active) requests hand off")
        eng = self.engine
        if r.state == ACTIVE:
            if rid in eng._prefilling:
                eng._prefilling.remove(rid)
            eng.pool.unbind_seq(r.slot)
            eng.pool.release(r.slot)
            r.slot = None
            r.prefill_pos = None
            r.state = QUEUED
        else:
            # identity scan: Request's dataclass __eq__ compares arrays
            for i, q in enumerate(eng.scheduler.queue):
                if q is r:
                    del eng.scheduler.queue[i]
                    break
            else:               # pragma: no cover - state-machine guard
                raise RuntimeError(
                    f"queued request {rid} missing from the scheduler "
                    f"queue — lifecycle bookkeeping corrupted")
        del eng.requests[rid]
        eng._last_emit.pop(rid, None)
        del self.requests[rid]
        self._user_cb.pop(rid, None)
        self._open.discard(rid)
        r.on_token = None        # the destination's adopt() rewires it
        if seal:
            self.journal.log_handoff(rid=rid, dst=dst, tick=self.tick)
        return r

    def seal_handoff(self, rid: int, dst=None) -> None:
        """Journal the ``handoff`` tombstone for a rid already released
        with ``seal=False`` — after the destination's snap landed."""
        if rid in self.requests:
            raise ValueError(
                f"request {rid} still lives in this replica — seal only "
                f"what release() already detached")
        self.journal.log_handoff(rid=rid, dst=dst, tick=self.tick)

    # -- post-mortem bundles ------------------------------------------------

    def _dump_postmortem(self, trigger: str, cause: str) -> str | None:
        """Write one post-mortem bundle (``serve/flight.py``) into
        ``postmortem_dir``; a no-op without one."""
        if self.postmortem_dir is None:
            return None
        from simple_distributed_machine_learning_tpu_torch.serve.flight import (  # noqa: E501
            BUNDLE_PREFIX,
            write_bundle,
        )
        path = os.path.join(
            self.postmortem_dir,
            f"{BUNDLE_PREFIX}{self.postmortem_tag}"
            f"-{len(self.postmortems):03d}-{trigger}.json")
        write_bundle(
            path, trigger=trigger, cause=cause, tick=self.tick,
            flight=self.flight, requests=self.requests,
            registry=(self.metrics.registry
                      if self.metrics is not None else None),
            journal_tail=self.journal.tail(self.postmortem_tail),
            restarts=self.restarts, degraded=self.degraded,
            state=self.state,
            **({} if self.slo is None
               else {"active_alerts": self.slo.active_alerts()}))
        self.postmortems.append(path)
        return path

    # -- overload control ---------------------------------------------------

    def _admission_check(self, cls, priority: int, now: float) -> str | None:
        """The shed reason for this arrival, or None to admit (may shed a
        queued lower-priority victim to make room). The class bucket is
        peeked first and debited only once every other gate passed."""
        ov = self.overload
        self._update_load_degraded()
        if self.load_degraded and priority <= ov.degraded_priority_floor:
            return "class"
        if not self._bucket_peek(cls, now):
            return "class"
        if (ov.max_queue_depth is not None
                and self.engine.scheduler.queue_depth >= ov.max_queue_depth):
            victim = self._backpressure_victim(priority)
            if victim is None:
                return "backpressure"
            self._shed_live(victim, "backpressure")
        self._bucket_debit(cls)
        return None

    def _update_load_degraded(self) -> None:
        """The load-degraded hysteresis from the current queue depth —
        at admission AND every tick, so the mode cannot latch on after
        the backlog drains."""
        ov = self.overload
        if ov.degrade_queue_depth is None:
            return
        qd = self.engine.scheduler.queue_depth
        if not self.load_degraded and qd >= ov.degrade_queue_depth:
            self.load_degraded = True
            self._note_degraded()
        elif self.load_degraded and qd <= ov.recover_queue_depth:
            self.load_degraded = False
            self._note_degraded()

    def _bucket_peek(self, cls, now: float) -> bool:
        """Refill the class's bucket to ``now`` and report affordability
        without consuming."""
        rates = self.overload.class_rates
        if not rates or cls not in rates:
            return True
        rate, burst = rates[cls]
        tokens, last = self._buckets.get(cls, (float(burst), now))
        tokens = min(float(burst), tokens + max(0.0, now - last) * rate)
        self._buckets[cls] = (tokens, now)
        return tokens >= 1.0

    def _bucket_debit(self, cls) -> None:
        rates = self.overload.class_rates
        if not rates or cls not in rates:
            return
        tokens, last = self._buckets[cls]
        self._buckets[cls] = (tokens - 1.0, last)

    def _backpressure_victim(self, priority: int) -> Request | None:
        """Lowest-priority, newest-queued request strictly below the
        arrival's priority."""
        best = None
        for r in self.engine.scheduler.queue:
            if r.priority >= priority:
                continue
            if best is None or (r.priority, -r.rid) < (best.priority,
                                                       -best.rid):
                best = r
        return best

    def _shed_expired(self) -> None:
        """Deadline enforcement at the tick boundary: TTFT deadlines bind
        until the first token, total deadlines until completion."""
        if not any(
                self.requests[rid].deadline_s is not None
                or self.requests[rid].ttft_deadline_s is not None
                for rid in self._open):
            return
        now = self._clock()
        for rid in sorted(self._open):
            r = self.requests[rid]
            if r.state not in (QUEUED, ACTIVE):
                continue
            expired = (
                (r.deadline_s is not None
                 and now - r.submit_time >= r.deadline_s)
                or (r.ttft_deadline_s is not None
                    and r.first_token_time is None
                    and now - r.submit_time >= r.ttft_deadline_s))
            if expired:
                self._shed_live(r, "deadline")

    def _shed_live(self, r: Request, reason: str) -> None:
        self.engine.cancel(r.rid, reason)
        self.journal.log_shed(rid=r.rid, reason=reason, t=r.done_time,
                              tick=self.tick)
        self._open.discard(r.rid)
        self._user_cb.pop(r.rid, None)
        self._sheds_since_step += 1
        if self.metrics is not None:
            self.metrics.on_shed(reason, cls=r.cls)

    def _shed_at_admission(self, rid, prompt, max_new, temperature, top_k,
                           top_p, eos_id, seed, cls, priority, ttft_dl, dl,
                           reason: str, now: float,
                           adapter: str | None = None) -> Request:
        """A structured rejection: the handle exists (``SHED``) but the
        engine never saw it. The rid is consumed, and both records land so
        a cold recovery accounts for it."""
        assert rid == self.engine._next_rid
        self.engine._next_rid = rid + 1
        r = Request(rid=rid, prompt=prompt, max_new_tokens=max_new,
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    eos_id=eos_id, seed=seed, cls=cls, priority=priority,
                    ttft_deadline_s=ttft_dl, deadline_s=dl, adapter=adapter)
        r.submit_time = now
        r.done_time = now
        r.state = SHED
        r.finish_reason = reason
        self.journal.log_submit(
            rid=rid, prompt=prompt, max_new=max_new, temp=temperature,
            top_k=top_k, top_p=top_p, eos=eos_id, seed=seed, cls=cls,
            prio=priority, ttft_dl=ttft_dl, dl=dl, t=now, tick=self.tick,
            adapter=adapter)
        self.journal.log_shed(rid=rid, reason=reason, t=now, tick=self.tick)
        self.requests[rid] = r
        self._sheds_since_step += 1
        if self.metrics is not None:
            self.metrics.on_submit()
            self.metrics.on_shed(reason, cls=cls)
        if self.trace is not None:
            # the engine never saw this request: open and close its span
            # here so the timeline still accounts for the rejection
            self.trace.on_submit(r, now)
            self.trace.on_shed(r, now, reason)
        return r

    # -- crash recovery -----------------------------------------------------

    def _on_token(self, request: Request, token: int) -> None:
        """Every engine token flows through here: journal first (the
        durability point), then the caller's callback."""
        self.journal.log_token(request, token, tick=self.tick)
        cb = self._user_cb.get(request.rid)
        if cb is not None:
            cb(request, token)

    def _ack_done(self) -> None:
        for rid in list(self._open):
            r = self.requests[rid]
            if r.state == DONE:
                self.journal.log_done(rid=rid, reason=r.finish_reason,
                                      t=r.done_time, tick=self.tick)
                self._open.discard(rid)
                self._user_cb.pop(rid, None)

    def _note_degraded(self) -> None:
        if self.metrics is not None:
            self.metrics.set_degraded(self.degraded or self.load_degraded)
        if self.state in (RUNNING, DEGRADED):
            self.state = (DEGRADED if (self.degraded or self.load_degraded)
                          else RUNNING)

    def _recover(self, exc: BaseException) -> None:
        """RECOVERING: count the restart against the budget, rebuild the
        engine (degraded once past ``degrade_after``) and re-admit every
        in-flight request from the journal alone. Reads no clock."""
        self.state = RECOVERING
        self.restarts += 1
        # the dead engine's last clock reading stamps every crash-boundary
        # trace event and seeds the rebuilt engine
        prev_now = self.engine._now
        if self.restarts > self.max_restarts:
            self.state = FAILED
            self._dump_postmortem("restart_budget",
                                  f"{type(exc).__name__}: {exc}")
            raise RestartBudgetExceeded(
                f"{self.restarts} engine failures exceed the max_restarts="
                f"{self.max_restarts} budget; last: "
                f"{type(exc).__name__}: {exc}") from exc
        if (self.degrade_after is not None and not self.degraded
                and self.restarts >= self.degrade_after):
            self.degraded = True
        if self.metrics is not None:
            self.metrics.on_restart()
        self.journal.log_restart(self.restarts, self.degraded,
                                 type(exc).__name__, tick=self.tick)
        if self.trace is not None:
            self.trace.on_crash(
                prev_now,
                [rid for rid in self._open
                 if self.requests[rid].state in (QUEUED, ACTIVE)],
                type(exc).__name__)
        self._dump_postmortem("restart", f"{type(exc).__name__}: {exc}")
        # journal-ONLY reconstruction: nothing of the dead engine's memory
        # is trusted; its pool frees once the failing tick's traceback goes
        snapshots = self.journal.recovered_state()
        self.engine = self.factory(self.degraded)
        self._attach_engine(prev_now=prev_now)
        if self.trace is not None:
            self.trace.on_restart(prev_now, self.restarts, self.degraded,
                                  type(exc).__name__)
        self._reseat(snapshots, note_recovered=True)
        self.state = RUNNING
        self._note_degraded()    # RUNNING -> DEGRADED when a mode is on

    def _reseat(self, snapshots: dict[int, Request],
                note_recovered: bool) -> None:
        """Apply journal snapshots to the live handles (or adopt them as
        handles on a cold start) and re-admit the in-flight ones in rid
        order, so FCFS arrival order survives the restart."""
        if snapshots:
            # the rebuilt engine's rid space clears EVERY journaled rid
            self.engine._next_rid = max(self.engine._next_rid,
                                        max(snapshots) + 1)
        inflight = []
        for rid in sorted(snapshots):
            snap = snapshots[rid]
            r = self.requests.get(rid)
            if r is None:
                r = snap                     # cold start / mid-submit crash
                self.requests[rid] = r
            else:
                self._apply_snapshot(r, snap)
            if r.state == QUEUED:
                inflight.append(r)
            elif rid in self._open:
                # finished or shed exactly at the crash boundary: the
                # stream is already complete — ack it now
                if r.state == DONE:
                    self.journal.log_done(rid=rid, reason=r.finish_reason,
                                          t=r.done_time, tick=self.tick)
                self._open.discard(rid)
                self._user_cb.pop(rid, None)
        for r in inflight:
            r.on_token = self._on_token
            self.engine.restore(r)
            self._open.add(r.rid)
        if note_recovered and inflight and self.metrics is not None:
            self.metrics.on_recovered(len(inflight))

    @staticmethod
    def _apply_snapshot(r: Request, snap: Request) -> None:
        """Overwrite a live handle's decode state with the journal's (the
        caller's handle object stays live): tokens truncate to the
        journaled prefix and key streams rewind to the last durable
        token's."""
        r.tokens[:] = snap.tokens
        r.key_data = snap.key_data
        r.draft_key_data = snap.draft_key_data
        r.submit_time = snap.submit_time
        r.first_token_time = snap.first_token_time
        r.slot = None
        r.prefill_pos = None
        r.state = snap.state
        r.finish_reason = snap.finish_reason
        if snap.done_time is not None:
            r.done_time = snap.done_time
