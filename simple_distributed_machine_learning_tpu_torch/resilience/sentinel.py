"""Self-healing training: anomaly sentinel, micro-rollback, quarantine
(port of ``resilience/sentinel.py``).

PR-7 gave the trainer COARSE fault tolerance: any failure costs everything
back to the last disk checkpoint (a whole epoch of work at the default
cadence). But the most common production training faults are not host
losses — they are *numeric*: a NaN gradient from one bad batch, a corrupted
input record, a loss excursion that poisons the optimizer state. Production
training treats those as routine events to absorb in-memory, not
crashes to replay from disk. This module is that layer:

- **detection** (:meth:`Sentinel.observe`): every step's loss (and global
  gradient norm — one extra scalar the sentinel-enabled compiled step
  returns) is checked host-side for NaN/Inf, and against an EWMA spike
  threshold (``loss > spike_factor * (ewma + spike_margin)`` after a
  warmup of healthy steps). The gradient norm comes from
  ``train/step.py::make_train_step(..., with_grad_norm=True)``. Anomalous observations never enter the EWMA,
  so one excursion cannot drag the threshold up after itself.
- **micro-rollback** (:class:`SnapshotRing`): a bounded in-memory ring of
  host-side ``(step, params, opt_state, data-cursor, EWMA state)``
  snapshots (copies, never views: the optimizer updates the live tensors
  in place, and on the card a NaN step has overwritten them by the time
  the host reads its loss), refreshed every ``snapshot_every`` steps (plus one forced at
  each epoch entry, so a pre-anomaly point always exists). On detection
  the trainer restores the newest snapshot at-or-before the anomaly step
  and *replays* forward — orders of magnitude cheaper than a
  ``CheckpointStore`` disk generation, and exact: replayed steps re-run
  with the same per-step keys and batches, so the recovered trajectory is
  bit-identical to one that never took the fault.
- **quarantine** (:class:`QuarantineJournal`): the offending batch —
  identified as ``(epoch, batch_idx)`` — is recorded in an append-only
  JSONL journal and deterministically skipped on replay AND on any later
  run that loads the journal (a restarted attempt skips the same batches).
  The acceptance pin: with ``nan-grad@train.grad=K`` injected, the
  sentinel run's post-rollback per-step losses equal a clean run that
  pre-loaded the same quarantine journal and never saw the fault — exact
  (``tests/test_torch_sentinel.py``; ``chip_smoke.py`` phase 10 on the
  card).
- **escalation** (:class:`SentinelExhausted`): repeated anomalies within
  one ``window`` of steps (more than ``max_rollbacks`` of them, by
  default ``ring_size``) mean the fault is systematic, not transient —
  micro-rollback cannot converge, so the sentinel raises and the elastic
  supervisor (``resilience/supervisor.py``, which lists the exception as
  RECOVERABLE) takes over with a full disk restore.

Detection→rollback→quarantine→escalate is driven by the Trainer's step
loop (``train/trainer.py``); this module holds the state machine's memory
and verdicts. The cost when enabled: one device→host sync per step (the
loss and the grad norm in one copy) and one device→host copy of the
training state per ``snapshot_every`` steps; when disabled the trainer
pays nothing.

Metric series (through ``registry``, a ``telemetry/registry.py``
``MetricsRegistry``, when one is attached):

- ``train_anomalies_total{kind=}`` (counter) — anomalies detected, by
  verdict kind (``nan`` / ``inf`` / ``spike``)
- ``train_rollbacks_total`` (counter) — in-memory micro-rollbacks taken
- ``train_quarantined_batches_total`` (counter) — batches journaled as
  quarantined and deterministically skipped from then on
- ``train_snapshot_ring_bytes`` (gauge) — resident host bytes of the
  snapshot ring (bounded by ``ring_size`` x one state's bytes)
- ``train_preempt_graceful`` (gauge) — 1 when the run ended on a graceful
  preemption (SIGTERM / injected ``preempt``): in-flight step finished,
  synchronous checkpoint + quarantine-journal flush, clean exit
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
from typing import Any, NamedTuple

import torch

from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (
    param_leaves,
)


def _is_zero1(state) -> bool:
    from simple_distributed_machine_learning_tpu_torch.train.optimizer import (  # noqa: E501
        Zero1State,
    )
    return isinstance(state, Zero1State)


def state_leaves(state) -> list:
    """An optimizer state's leaves in order: its tensors (a list holds one
    per parameter) and its int step counters; tuples are structure, and a
    ZeRO-1 state (``train/optimizer.py::Zero1State``) holds its shards'
    state in ``inner``."""
    if _is_zero1(state):
        return state_leaves(state.inner)
    if isinstance(state, (tuple, list)):
        return [leaf for s in state for leaf in state_leaves(s)]
    return [state]


def restore_state(live, leaves) -> Any:
    """Put ``leaves`` (a snapshot's, in :func:`state_leaves` order) back
    into the optimizer state ``live``: tensors are copied INTO the live
    ones, which the optimizer and the parameters keep referencing; int
    counters, which cannot change in place, come back in a state of the
    same structure, which is returned."""
    it = iter(leaves)

    def put(s):
        if _is_zero1(s):
            s.inner = put(s.inner)
            return s
        if isinstance(s, tuple):
            return tuple(put(x) for x in s)
        if isinstance(s, list):
            return [put(x) for x in s]
        v = next(it)
        if isinstance(s, torch.Tensor):
            s.copy_(v)
            return s
        return v

    with torch.no_grad():
        return put(live)


def _host_copy(v):
    return (v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor)
            else v)


def _nbytes(v) -> int:
    # an int step counter is the JAX state's int32 scalar leaf
    return (v.numel() * v.element_size() if isinstance(v, torch.Tensor)
            else 4)


class SentinelExhausted(RuntimeError):
    """Micro-rollback cannot absorb the fault: more than ``max_rollbacks``
    (by default ``ring_size``) anomalies within one ``window`` of steps.
    The elastic supervisor treats this as RECOVERABLE (restore the last
    valid disk checkpoint, same topology); anything above it treats it as
    the training run failing."""


@dataclasses.dataclass(frozen=True)
class SentinelConfig:
    """Knobs for detection and rollback; see the module docstring."""

    window: int = 16            # EWMA horizon AND the escalation window
    snapshot_every: int = 4     # steps between ring snapshots
    ring_size: int = 4          # retained snapshots (memory bound)
    spike_factor: float = 3.0   # loss > factor * (ewma + margin) = spike
    spike_margin: float = 0.25  # absolute slack so a near-zero EWMA does
    #                             not turn converged-loss jitter into spikes
    warmup_steps: int = 8       # healthy observations before spike checks
    max_rollbacks: int | None = None   # escalation budget (None: ring_size)

    def __post_init__(self):
        if self.window < 2:
            raise ValueError(f"sentinel window must be >= 2, got "
                             f"{self.window}")
        if self.snapshot_every < 1:
            raise ValueError(f"sentinel snapshot_every must be >= 1, got "
                             f"{self.snapshot_every}")
        if self.ring_size < 1:
            raise ValueError(f"sentinel ring_size must be >= 1, got "
                             f"{self.ring_size}")
        if self.spike_factor <= 1.0:
            raise ValueError(f"sentinel spike_factor must be > 1, got "
                             f"{self.spike_factor}")
        if self.spike_margin < 0 or self.warmup_steps < 0:
            raise ValueError("sentinel spike_margin/warmup_steps must be "
                             ">= 0")
        if self.max_rollbacks is not None and self.max_rollbacks < 1:
            raise ValueError(f"sentinel max_rollbacks must be >= 1, got "
                             f"{self.max_rollbacks}")

    @property
    def rollback_budget(self) -> int:
        return (self.ring_size if self.max_rollbacks is None
                else self.max_rollbacks)


class Snapshot(NamedTuple):
    """One host-side restore point (pre-step state at ``step``)."""

    step: int
    epoch: int
    batch_idx: int          # the data cursor: next batch to execute
    params: object          # host copies of the parameter tensors
    opt_leaves: tuple       # host copies of the optimizer state's tensors
    #                         and its int step counters, in order
    ewma: float | None      # EWMA state rides along so a rollback also
    healthy: int            # rewinds the detector, and replay re-updates
    #                         it with the identical losses
    nbytes: int


class Anomaly(NamedTuple):
    """One detection verdict (``observe``'s non-None return)."""

    step: int
    epoch: int
    batch_idx: int
    kind: str               # "nan" | "inf" | "spike"
    value: float            # the offending loss (or grad-norm) value


class SnapshotRing:
    """Bounded FIFO of :class:`Snapshot` entries (newest last)."""

    def __init__(self, ring_size: int) -> None:
        self._ring: collections.deque[Snapshot] = collections.deque(
            maxlen=ring_size)

    def __len__(self) -> int:
        return len(self._ring)

    def push(self, snap: Snapshot) -> None:
        # one snapshot per step: a replay re-gathering the same step
        # replaces the identical entry instead of aging a sibling out
        if self._ring and self._ring[-1].step == snap.step:
            self._ring[-1] = snap
            return
        self._ring.append(snap)

    def newest_at_or_before(self, step: int) -> Snapshot | None:
        """The rollback target: snapshots are PRE-step state, so the entry
        taken at the anomaly step itself is still clean."""
        for snap in reversed(self._ring):
            if snap.step <= step:
                return snap
        return None

    def bytes(self) -> int:
        return sum(s.nbytes for s in self._ring)

    def clear(self) -> None:
        self._ring.clear()


class QuarantineJournal:
    """Append-only JSONL journal of quarantined batches.

    Each record is ``{"epoch": E, "batch": B, "step": S, "kind": K,
    "value": V}``; the ``(epoch, batch)`` pair is the skip key — batch
    order is deterministic per epoch (fixed order, or the seeded shuffle),
    so the same journal skips the same data on every run that loads it.
    With ``path=None`` the journal is in-memory only (tests, dryruns);
    with a path it loads existing records on construction (a restarted or
    clean reference run skips identically) and flushes every append.
    ``write_ok=False`` (every process but the first of a multi-process
    run) loads and skips the same records but never appends to the shared
    file.
    """

    def __init__(self, path: str | None = None,
                 write_ok: bool = True) -> None:
        self.path = path
        self.write_ok = write_ok
        self.records: list[dict] = []
        self._skips: set[tuple[int, int]] = set()
        if path and os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue           # torn tail: keep what parsed
                    self._note(rec)

    def _note(self, rec: dict) -> None:
        self.records.append(rec)
        self._skips.add((int(rec["epoch"]), int(rec["batch"])))

    def skip(self, epoch: int, batch_idx: int) -> bool:
        return (epoch, batch_idx) in self._skips

    def add(self, rec: dict) -> None:
        self._note(rec)
        if self.path and self.write_ok:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                        exist_ok=True)
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
                f.flush()

    def __len__(self) -> int:
        return len(self.records)


class Sentinel:
    """The per-run anomaly sentinel; the Trainer drives it per step.

    Protocol (``train/trainer.py``)::

        sentinel.begin_epoch(epoch)                  # clear ring, force snap
        sentinel.quarantined(epoch, batch_idx)       # skip check per batch
        sentinel.maybe_snapshot(step, ..., buf, opt) # pre-step, every K
        anomaly = sentinel.observe(step, ..., loss, gnorm)
        if anomaly:                                  # post-step
            snap = sentinel.rollback(anomaly)        # may raise Exhausted
            <restore snap, rewind the batch stream to snap.batch_idx>
    """

    def __init__(self, config: SentinelConfig | None = None, registry=None,
                 journal_path: str | None = None,
                 journal_write_ok: bool = True) -> None:
        self.config = config or SentinelConfig()
        self.registry = registry
        self.ring = SnapshotRing(self.config.ring_size)
        self.journal = QuarantineJournal(journal_path,
                                         write_ok=journal_write_ok)
        # step -> last HEALTHY loss: the bit-exactness record the recovery
        # pin compares (tests/test_sentinel.py). Bounded: only the recent
        # tail is ever revisited by a rollback, so old entries age out —
        # a million-step run must not grow an unbounded host-side dict.
        self.observed: dict[int, float] = {}
        self._observed_cap = max(4096, 4 * self.config.window)
        # a per-instance id stamped into every metric record: counters are
        # cumulative per sentinel LIFETIME, and the report CLI needs a
        # reliable generation boundary to sum across restarts (a pure
        # counter-drop heuristic misses a resumed run that re-accumulates
        # past the previous generation's count before its first record)
        self.run_id = "%08x" % int.from_bytes(os.urandom(4), "big")
        self.by_kind: dict[str, int] = {}
        self.n_anomalies = 0
        self.n_rollbacks = 0
        self._events: list[dict] = []          # drained per epoch record
        self._ewma: float | None = None
        self._healthy = 0
        self._alpha = 2.0 / (self.config.window + 1)
        self._last_anomaly_step: int | None = None
        self._streak = 0
        self._force_snapshot = False

    # -- counters ----------------------------------------------------------

    @property
    def n_quarantined(self) -> int:
        return len(self.journal)

    def _gauge_ring(self) -> None:
        if self.registry is not None:
            self.registry.gauge("train_snapshot_ring_bytes").set(
                self.ring.bytes())

    # -- epoch / snapshot lifecycle ---------------------------------------

    def begin_epoch(self, epoch: int) -> None:
        """Rollback is epoch-scoped (the epoch boundary ran eval/save, so
        rewinding across it would replay non-step work): clear the ring and
        force a snapshot at the first executed batch of the epoch, so a
        pre-anomaly restore point always exists."""
        self.ring.clear()
        self._force_snapshot = True
        self._gauge_ring()

    def maybe_snapshot(self, step: int, epoch: int, batch_idx: int,
                       buf, opt_state) -> bool:
        """Copy a restore point to the host when one is due (every
        ``snapshot_every`` steps, or forced at epoch entry): ``buf`` is the
        stage modules (anything ``param_leaves`` flattens), ``opt_state``
        the optimizer's state. Called BEFORE the step executes, so the
        captured state is pre-anomaly even when this very step is the
        poisoned one."""
        if not (self._force_snapshot
                or step % self.config.snapshot_every == 0):
            return False
        self._force_snapshot = False
        params = tuple(_host_copy(t) for t in param_leaves(buf))
        leaves = tuple(_host_copy(leaf) for leaf in state_leaves(opt_state))
        nbytes = sum(_nbytes(v) for v in params + leaves)
        self.ring.push(Snapshot(step=int(step), epoch=int(epoch),
                                batch_idx=int(batch_idx), params=params,
                                opt_leaves=leaves, ewma=self._ewma,
                                healthy=self._healthy, nbytes=nbytes))
        self._gauge_ring()
        return True

    # -- detection ---------------------------------------------------------

    def observe(self, step: int, epoch: int, batch_idx: int, loss: float,
                gnorm: float | None = None) -> Anomaly | None:
        """Judge one executed step. A healthy loss updates the EWMA and the
        per-step loss record; an anomalous one touches neither (so the
        detector's threshold and the bit-exactness record both match a run
        that never saw the fault)."""
        loss = float(loss)
        verdict = None
        for name, value in (("loss", loss),
                            ("grad-norm",
                             None if gnorm is None else float(gnorm))):
            if value is None:
                continue
            if math.isnan(value):
                verdict = ("nan", value)
                break
            if math.isinf(value):
                verdict = ("inf", value)
                break
        if (verdict is None and self._healthy >= self.config.warmup_steps
                and self._ewma is not None
                and loss > self.config.spike_factor
                * (self._ewma + self.config.spike_margin)):
            verdict = ("spike", loss)
        if verdict is None:
            self._ewma = (loss if self._ewma is None
                          else self._alpha * loss
                          + (1.0 - self._alpha) * self._ewma)
            self._healthy += 1
            self.observed[int(step)] = loss
            if len(self.observed) > self._observed_cap:
                # dicts iterate in insertion order: drop the oldest entry
                del self.observed[next(iter(self.observed))]
            return None
        kind, value = verdict
        self.n_anomalies += 1
        self.by_kind[kind] = self.by_kind.get(kind, 0) + 1
        event = {"step": int(step), "epoch": int(epoch),
                 "batch": int(batch_idx), "kind": kind,
                 "value": (None if math.isnan(value) or math.isinf(value)
                           else value)}
        self._events.append(event)
        if self.registry is not None:
            self.registry.counter("train_anomalies_total",
                                  labels={"kind": kind}).inc()
        return Anomaly(step=int(step), epoch=int(epoch),
                       batch_idx=int(batch_idx), kind=kind, value=value)

    # -- recovery ----------------------------------------------------------

    def quarantined(self, epoch: int, batch_idx: int) -> bool:
        return self.journal.skip(epoch, batch_idx)

    def rollback(self, anomaly: Anomaly) -> Snapshot:
        """Quarantine the offending batch, pick the restore point, rewind
        the detector state — or escalate with :class:`SentinelExhausted`
        when anomalies repeat faster than micro-rollback can absorb."""
        # quarantine FIRST: even an escalating anomaly's batch is recorded,
        # so the supervisor's next attempt (which loads the journal from
        # disk) skips it
        self.journal.add({"epoch": anomaly.epoch, "batch": anomaly.batch_idx,
                          "step": anomaly.step, "kind": anomaly.kind,
                          "value": (None if math.isnan(anomaly.value)
                                    or math.isinf(anomaly.value)
                                    else anomaly.value)})
        if self.registry is not None:
            self.registry.counter("train_quarantined_batches_total").inc()
        if (self._last_anomaly_step is not None
                and anomaly.step - self._last_anomaly_step
                <= self.config.window):
            self._streak += 1
        else:
            self._streak = 1
        self._last_anomaly_step = anomaly.step
        snap = self.ring.newest_at_or_before(anomaly.step)
        if snap is None or self._streak > self.config.rollback_budget:
            raise SentinelExhausted(
                f"sentinel exhausted at step {anomaly.step} "
                f"({anomaly.kind}): {self._streak} anomalies within a "
                f"{self.config.window}-step window exceed the "
                f"{self.config.rollback_budget}-rollback budget"
                if snap is not None else
                f"sentinel exhausted at step {anomaly.step} "
                f"({anomaly.kind}): no snapshot at or before the anomaly "
                f"remains in the ring")
        self.n_rollbacks += 1
        if self.registry is not None:
            self.registry.counter("train_rollbacks_total").inc()
        # rewind the detector with the state: replay re-updates it with
        # the identical losses, so post-recovery thresholds match a run
        # that never saw the fault
        self._ewma = snap.ewma
        self._healthy = snap.healthy
        return snap

    # -- persistence (rides the trainer checkpoint's ``extra``) -----------

    def detector_state(self) -> dict:
        """The EWMA detector's state, JSON-serializable. Checkpoints carry
        it so a resumed run's spike threshold matches the uninterrupted
        run's instead of re-warming from scratch (a spike right after
        resume must not slip through a cold detector)."""
        return {"ewma": self._ewma, "healthy": self._healthy}

    def restore_detector(self, state: dict) -> None:
        self._ewma = (None if state.get("ewma") is None
                      else float(state["ewma"]))
        self._healthy = int(state.get("healthy", 0))

    # -- reporting ---------------------------------------------------------

    def drain_events(self) -> list[dict]:
        events, self._events = self._events, []
        return events

    def stats(self) -> dict:
        return {"anomalies": self.n_anomalies,
                "by_kind": dict(self.by_kind),
                "rollbacks": self.n_rollbacks,
                "quarantined_batches": self.n_quarantined,
                # tells the report CLI whether this generation's quarantine
                # count carries the previous one's forward (reloaded from
                # disk — dedup on aggregation) or restarted from zero
                "quarantine_persistent": bool(self.journal.path),
                "snapshot_ring_bytes": self.ring.bytes(),
                "sentinel_run": self.run_id}
