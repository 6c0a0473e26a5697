"""Continuous-batching schedulers (port of ``serve/scheduler.py``).

The policy layer between the request queue and the KV pool:

- a request is admitted the first tick the POOL accepts it
  (``pool.can_admit``: a free slot for the dense layout; a free slot AND
  the block budget after prefix sharing for the paged one), never before
  a request that arrived earlier — the head of the line is probed, so a
  big request is never starved;
- admission BINDS the sequence inside the loop (``pool.bind_seq``
  reserves its worst-case budget), so a burst cannot over-admit;
- retirement unbinds and releases in the same tick, so a waiting request
  boards on the very next one.

:class:`PriorityScheduler` (the scenario suite's policy) admits by request
``priority``, FCFS within a class, and when the pool cannot fit the pick
it *preempts* strictly lower-priority active requests (lowest priority
first, newest-boarded first within it). A victim returns to the queue
with its tokens and key stream intact and later re-prefills
``resume_seq``, so its final tokens equal an unpreempted run's.
"""

from __future__ import annotations

import collections
import weakref

from simple_distributed_machine_learning_tpu_torch.serve.request import (
    ACTIVE,
    DONE,
    QUEUED,
    Request,
)


class FCFSScheduler:
    """First-come-first-served admission over a slot pool."""

    def __init__(self, pool) -> None:
        self.pool = pool
        self.queue: collections.deque[Request] = collections.deque()
        self._engine_ref = None
        self._board_count = 0

    def attach(self, engine) -> None:
        """Called by the engine at construction. The reference is weak:
        the engine owns its scheduler, so an engine dropped by its owner
        (a crashed one the serve supervisor replaced) frees its device
        pool at once instead of waiting for the cycle collector."""
        self._engine_ref = weakref.ref(engine)

    @property
    def _engine(self):
        """The engine this scheduler serves: policies that evict active
        requests need it; FCFS never does."""
        return None if self._engine_ref is None else self._engine_ref()

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    def enqueue(self, request: Request) -> None:
        if request.state != QUEUED:
            raise ValueError(
                f"request {request.rid} is {request.state}, not queued")
        self.queue.append(request)

    def pick(self) -> Request:
        """The next request to admit (FCFS: the oldest). Callers guarantee
        the queue is non-empty."""
        return self.queue.popleft()

    def admit(self) -> list[Request]:
        """Board waiting requests into free slots, as many as the pool
        accepts. The gate runs on the request :meth:`pick` returns; a pick
        that does not fit (and for which :meth:`_make_room` frees nothing)
        goes back to the front and admission stops (head-of-line
        blocking)."""
        admitted = []
        while self.queue:
            r = self.pick()
            if not self.pool.can_admit(r) and not self._make_room(r):
                self.queue.appendleft(r)
                break
            # the adapter gate runs after the pool accepts (a free slot
            # makes a free bank row certain) and before the slot binds:
            # it pins (uploading if needed) the request's bank row at this
            # tick boundary and sets its prefix namespace
            gate = getattr(self._engine, "_adapter_board", None)
            if gate is not None and not gate(r):
                self.queue.appendleft(r)
                break
            r.slot = self.pool.acquire(r.rid)
            r.prefill_pos = self.pool.bind_seq(r)
            r.state = ACTIVE
            r._board_seq = self._board_count
            self._board_count += 1
            admitted.append(r)
        return admitted

    def _make_room(self, request: Request) -> bool:
        """Policy hook: may the scheduler free capacity for ``request``?
        FCFS never evicts — a blocked head blocks."""
        return False

    def retire(self, request: Request, reason: str) -> None:
        """Free the request's slot in the same tick."""
        if request.state != ACTIVE or request.slot is None:
            raise ValueError(
                f"request {request.rid} is not active (state "
                f"{request.state!r}, slot {request.slot!r})")
        self.pool.unbind_seq(request.slot)
        self.pool.release(request.slot)
        request.slot = None
        request.state = DONE
        request.finish_reason = reason


class PriorityScheduler(FCFSScheduler):
    """Priority-class admission with prefill preemption of best-effort
    traffic; see the module docstring. The base class's budget gate still
    runs on whatever :meth:`pick` returns, so admission never outspends
    the pool."""

    def pick(self) -> Request:
        # the scan's first maximum is the oldest of its class
        best_i = 0
        for i, r in enumerate(self.queue):
            if r.priority > self.queue[best_i].priority:
                best_i = i
        r = self.queue[best_i]
        del self.queue[best_i]
        return r

    def _victims_below(self, priority: int) -> list[Request]:
        victims = [self._engine.requests[self.pool.occupant(s)]
                   for s in self.pool.active_slots()]
        return [v for v in victims if v.priority < priority]

    def _make_room(self, request: Request) -> bool:
        if self._engine is None:
            return False
        if self.pool.prefetch_blocked(request):
            # an in-flight host->device upload covers this request's
            # prefix: it boards when the upload lands, and preempting
            # would destroy work for nothing
            return False
        victims = self._victims_below(request.priority)
        if not victims:
            return False
        # feasibility precheck: eviction discards the victims' K/V, so
        # never start unless freeing EVERY eligible victim covers the
        # requester's block shortfall (any one eviction frees a slot)
        if self.pool.admit_shortfall(request) > sum(
                self.pool.freeable_blocks(v.slot) for v in victims):
            return False
        while not self.pool.can_admit(request):
            victims = self._victims_below(request.priority)
            if not victims:         # pragma: no cover - precheck bound
                return False
            # lowest priority first; newest boarding within it
            victim = max(victims,
                         key=lambda v: (-v.priority, v._board_seq))
            self._engine.preempt(victim.rid)
        return True
