"""FCFS continuous-batching scheduler (port of ``serve/scheduler.py``).

The policy layer between the request queue and the KV pool:

- a request is admitted the first tick the POOL accepts it
  (``pool.can_admit``: a free slot AND the block budget after prefix
  sharing), never before a request that arrived earlier — the head of
  the line is probed, so a big request is never starved;
- admission BINDS the sequence inside the loop (``pool.bind_seq``
  reserves its worst-case budget), so a burst cannot over-admit;
- retirement unbinds and releases in the same tick, so a waiting request
  boards on the very next one.

The ``PriorityScheduler`` (priority classes with preemption) waits for
the serving-robustness slice; :meth:`FCFSScheduler.pick` is its hook.
"""

from __future__ import annotations

import collections

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

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    def enqueue(self, request: Request) -> None:
        if request.state != QUEUED:
            raise ValueError(
                f"request {request.rid} is {request.state}, not queued")
        self.queue.append(request)

    def pick(self) -> Request:
        """The next request to admit (FCFS: the oldest)."""
        return self.queue.popleft()

    def admit(self) -> list[Request]:
        """Board waiting requests into free slots, FCFS, as many as the
        pool accepts; a picked request that does not fit goes back to the
        front and admission stops (head-of-line blocking)."""
        admitted = []
        while self.queue:
            r = self.pick()
            if not self.pool.can_admit(r):
                self.queue.appendleft(r)
                break
            r.slot = self.pool.acquire(r.rid)
            r.prefill_pos = self.pool.bind_seq(r)
            r.state = ACTIVE
            admitted.append(r)
        return admitted

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
