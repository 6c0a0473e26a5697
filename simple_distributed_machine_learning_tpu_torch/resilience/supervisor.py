"""The elastic checkpoint-restart supervisor: restore → repack → resume
(port of ``resilience/supervisor.py``).

Composes the validated checkpoint history (``resilience/store.py``), the
cross-topology repack (``train/checkpoint.py::repack_packed_buffer``), and
the failure signals (``resilience/faults.py`` injected faults; a peer loss
surfaced as :class:`PeerLost`).

State machine::

            +---------------------------------------------+
            v                                             |
    RUNNING --fault--> RESTORING --backoff--> RUNNING ... |
       |                   |                              |
       |                   +--budget exhausted--> FAILED  |
       +--fit() returns--> DONE <-------------------------+

- RUNNING: one *attempt* — a freshly built trainer (``build_trainer(n)``)
  driving ``fit()`` to completion. A recoverable failure (injected
  host-kill, peer loss from the watchdog, a checkpoint-write crash, a
  wedged device) aborts the attempt; every other exception propagates —
  a real bug must not be retried into oblivion.
- RESTORING: the next attempt's trainer restores the latest *valid*
  checkpoint from the store (corrupt generations are skipped by checksum)
  and — when it was written at another stage count — repacks the packed
  param/optimizer buffers onto the attempt's before resuming: the ladder
  (``--chaos-stages 2,1``) steps down across stage counts, and a store that
  either package wrote at any stage count restores. The restore happens inside
  ``build_trainer`` via :func:`make_elastic_trainer`; nothing in-memory
  survives an attempt, exactly as if the process had died: the dead
  attempt's tensors on the card become unreachable once the next one is
  built.
- Backoff between attempts is exponential and bounded; the restart budget
  (``max_restarts``) caps the loop — a persistently failing run FAILS
  loudly with :class:`RestartBudgetExceeded` instead of flapping forever.
"""

from __future__ import annotations

import dataclasses
import sys
import time

from simple_distributed_machine_learning_tpu_torch.resilience.faults import (
    CheckpointWriteCrash,
    DeviceWedged,
    HostLost,
)
from simple_distributed_machine_learning_tpu_torch.resilience.sentinel import (
    SentinelExhausted,
)
from simple_distributed_machine_learning_tpu_torch.resilience.store import (
    CheckpointStore,
)
from simple_distributed_machine_learning_tpu_torch.train.trainer import Trainer


class PeerLost(RuntimeError):
    """A peer vanished or froze (the watchdog's verdict), surfaced as an
    exception for in-process supervision. (The port's multi-process
    watchdog waits for ROADMAP Queue A item 6.)"""


#: failures the supervisor restarts through; anything else is a bug and
#: propagates. Host/peer loss additionally shrinks the topology (the dead
#: host's devices are gone); write crashes, device wedges and an exhausted
#: anomaly sentinel (micro-rollback could not absorb a systematic numeric
#: fault — escalate to a full disk restore) retry in place.
RECOVERABLE = (HostLost, PeerLost, CheckpointWriteCrash, DeviceWedged,
               SentinelExhausted)
_SHRINKING = (HostLost, PeerLost)


class RestartBudgetExceeded(RuntimeError):
    """More recoverable failures than ``max_restarts`` allows — the one
    class for training and serving: ``serve/supervisor.py`` imports it, so
    one ``except`` catches either budget running out."""


@dataclasses.dataclass(frozen=True)
class RestartPolicy:
    max_restarts: int = 3
    base_backoff_s: float = 0.05
    backoff_factor: float = 2.0
    max_backoff_s: float = 2.0

    def __post_init__(self):
        if self.max_restarts < 0 or self.base_backoff_s < 0:
            raise ValueError("max_restarts/base_backoff_s must be >= 0")
        if self.backoff_factor < 1.0:
            raise ValueError("backoff_factor must be >= 1")


class ElasticTrainer(Trainer):
    """A :class:`Trainer` whose persistence is a :class:`CheckpointStore`.

    The base trainer's single-file ``state.npz`` path stays untouched
    (``config.checkpoint_dir`` must be None — the store owns persistence);
    every epoch saves one retained, checksummed generation whose manifest
    records the stage count it was written at. Per-epoch metric records
    are kept on ``self.history`` so the supervisor's report can prove loss
    continuity across a restart.
    """

    def __init__(self, pipe, train_ds, test_ds, config, store: CheckpointStore,
                 opt=None, telemetry=None) -> None:
        if config.checkpoint_dir:
            raise ValueError(
                "ElasticTrainer persists through its CheckpointStore; "
                "config.checkpoint_dir must be None (the two would race "
                "over who owns resume)")
        # before super().__init__: the base constructor resolves the
        # sentinel's quarantine-journal directory via _sentinel_dir()
        self.store = store
        super().__init__(pipe, train_ds, test_ds, config, opt=opt,
                         telemetry=telemetry)
        self.history: list[dict] = []

    def _sentinel_dir(self) -> str | None:
        # the quarantine journal lives next to the checkpoint generations,
        # so a restarted attempt skips the same batches
        return self.store.dir

    def _persists(self) -> bool:
        return True

    def _save(self, epoch: int, cursor: int | None = None,
              sync: bool = False) -> None:
        extra = self._save_extra(epoch, cursor)
        extra["n_stages"] = len(self.pipe.metas)
        self.store.save(self.params, self.opt_state, self._step_count,
                        extra=extra)

    def _log_metrics(self, record: dict) -> None:
        self.history.append(dict(record))
        super()._log_metrics(record)


def make_elastic_trainer(build_pipe, n_stages: int, store: CheckpointStore,
                         train_ds, test_ds, config,
                         opt_factory=None, telemetry=None) -> ElasticTrainer:
    """Build one attempt's trainer at ``n_stages``, resumed from the store.

    ``build_pipe(n_stages) -> Pipeline`` is the topology factory. When the
    latest valid checkpoint was written at a different stage count, the
    packed param + optimizer buffers are repacked onto the attempt's
    layout (:meth:`CheckpointStore.restore_latest`). The source's packing
    metadata is the attempt's own model split contiguously into that many
    stages (``train/checkpoint.py::split_layout``: the MLP and GPT
    families split that way in both packages), so no second ``Pipeline``
    is built for it. Loss then continues from the restored step.

    ``opt_factory(pipe) -> Optimizer`` builds the optimizer against the
    attempt's OWN pipeline (pipe-dependent optimizers — e.g. replication-
    weighted gradient clipping — must see the topology they run on); None
    is the Trainer's default optimizer. ``telemetry`` (a
    ``telemetry/session.py`` ``Telemetry``) is the attempt's session; one
    session passed to every attempt keeps appending its records across a
    restart.
    """
    pipe = build_pipe(n_stages)
    opt = None if opt_factory is None else opt_factory(pipe)
    trainer = ElasticTrainer(pipe, train_ds, test_ds, config, store, opt=opt,
                             telemetry=telemetry)
    st = store.restore_latest(pipe=pipe, opt_treedef_like=trainer.opt_state)
    if st is None:
        return trainer
    entry = st["entry"]
    src_n = int(entry["extra"].get("n_stages", n_stages))
    trainer.params = st["params"]
    trainer.opt_state = st["opt_state"]
    trainer._step_count = st["step"]
    trainer.start_epoch = int(st["extra"].get("epoch", 0)) + 1
    # a graceful-preemption checkpoint carries the mid-epoch data cursor:
    # resume re-enters the epoch at the exact next batch. The sentinel's
    # EWMA detector state rides along too (a spike right after resume
    # must not slip through a cold detector).
    trainer._resume_batch_idx = int(st["extra"].get("next_batch", 0))
    if trainer._sentinel is not None and "sentinel" in st["extra"]:
        trainer._sentinel.restore_detector(st["extra"]["sentinel"])
    trainer._print(
        f"| elastic: restored {entry['file']} (step {st['step']}, written "
        f"at {src_n} stage{'s' if src_n != 1 else ''}"
        + (f", repacked onto {n_stages}" if src_n != n_stages else "")
        + f"); resuming at epoch {trainer.start_epoch}"
        + (f" (batch {trainer._resume_batch_idx})"
           if trainer._resume_batch_idx else ""))
    return trainer


def supervise(build_trainer, topologies, *, policy: RestartPolicy | None = None,
              sleep=time.sleep) -> dict:
    """Run ``build_trainer(n_stages).fit()`` to completion through failures.

    ``topologies`` is the stage-count ladder, largest first — each host/peer
    loss steps down one rung (staying on the last once exhausted); other
    recoverable failures retry at the same rung. Returns the report dict:
    per-attempt outcomes with the resumed step and per-epoch loss history,
    the state-machine transition log, and the restart count. Raises
    :class:`RestartBudgetExceeded` (chained to the last failure) when the
    budget runs out, and re-raises non-recoverable exceptions untouched.
    """
    policy = policy or RestartPolicy()
    topologies = list(topologies)
    if not topologies:
        raise ValueError("topologies must name at least one stage count")
    report: dict = {"attempts": [], "transitions": [], "restarts": 0,
                    "completed": False}

    def note(state: str, n_stages: int) -> None:
        report["transitions"].append((state, n_stages))

    rung = 0
    restarts = 0
    backoff = policy.base_backoff_s
    while True:
        n_stages = topologies[rung]
        note("RUNNING", n_stages)
        trainer = build_trainer(n_stages)
        attempt = {"n_stages": n_stages,
                   "resumed_step": trainer._step_count,
                   "start_epoch": trainer.start_epoch}
        try:
            trainer.fit()
        except RECOVERABLE as e:
            attempt.update(outcome="fault", fault=type(e).__name__,
                           detail=str(e)[:200],
                           history=list(trainer.history))
            stats = getattr(trainer, "sentinel_stats", lambda: None)()
            if stats is not None:
                attempt["sentinel"] = stats
            report["attempts"].append(attempt)
            restarts += 1
            report["restarts"] = restarts
            if restarts > policy.max_restarts:
                note("FAILED", n_stages)
                raise RestartBudgetExceeded(
                    f"{restarts} recoverable failures exceed the "
                    f"max_restarts={policy.max_restarts} budget; last: "
                    f"{type(e).__name__}: {e}") from e
            if isinstance(e, _SHRINKING) and rung < len(topologies) - 1:
                rung += 1  # the lost host's devices are gone: shrink
            sys.stderr.write(
                f"[resilience] attempt at {n_stages} stage(s) lost to "
                f"{type(e).__name__}; restoring onto {topologies[rung]} "
                f"stage(s) after {backoff:.3g}s backoff "
                f"(restart {restarts}/{policy.max_restarts})\n")
            note("RESTORING", topologies[rung])
            sleep(min(backoff, policy.max_backoff_s))
            backoff = min(backoff * policy.backoff_factor,
                          policy.max_backoff_s)
            continue
        attempt.update(outcome="completed", history=list(trainer.history))
        stats = getattr(trainer, "sentinel_stats", lambda: None)()
        if stats is not None:
            attempt["sentinel"] = stats
        report["attempts"].append(attempt)
        report["completed"] = True
        note("DONE", n_stages)
        return report
