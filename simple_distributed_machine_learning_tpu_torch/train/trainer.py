"""Epoch driver with the reference's console surface (port of
``train/trainer.py``).

The console lines are the JAX Trainer's, byte for byte (``Train Epoch:
...``, ``Test set: ...``, ``| epoch N: ... samples/sec``, ``| resumed
from ...``, ``| preempt: ...``), and ``metrics_json`` appends the same
schema-2 records. Checkpoints are the JAX package's files
(``train/checkpoint.py``), so a run resumes from either package's.

Randomness: each step's dropout generator is seeded by
``ops.random.fold_in(config.seed, step)``, never drawn from a running
generator, so a resumed or replayed step draws the masks the
uninterrupted run drew (JAX: ``fold_in(key, step)``); eval is
deterministic.

Timing: one pageable host -> device copy per batch, as the JAX feed does.
The throughput meter restarts after the first step has finished on the
device and is read after the device has drained, so samples/sec is the
card's rate, not the host's enqueue rate.

Not ported (each raises ``NotImplementedError`` at construction, naming
its ROADMAP item): the sentinel (``sentinel=True``) and a telemetry
session (``telemetry=``), both Queue A item 6. ``shard_inputs`` acts only
across processes, and the port runs one; the fault-injection sites are
left out with the rest of Queue A item 4.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from simple_distributed_machine_learning_tpu_torch import _roadmap
from simple_distributed_machine_learning_tpu_torch.data.mnist import (
    Dataset,
    batches,
    prefetch_batches,
)
from simple_distributed_machine_learning_tpu_torch.ops.random import fold_in
from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (
    Pipeline,
)
from simple_distributed_machine_learning_tpu_torch.telemetry.registry import (
    append_jsonl,
)
from simple_distributed_machine_learning_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
    save_checkpoint_async,
)
from simple_distributed_machine_learning_tpu_torch.train.optimizer import (
    Optimizer,
    sgd,
    shard_opt_state_zero1,
)
from simple_distributed_machine_learning_tpu_torch.train.step import (
    make_eval_step,
    make_train_step,
)
from simple_distributed_machine_learning_tpu_torch.utils.metrics import (
    Throughput,
)

# Reference hyperparameters
BATCH_SIZE = 60
EPOCHS = 10
LEARNING_RATE = 0.1
MOMENTUM = 0.5
LOG_INTERVAL = 10


@dataclasses.dataclass
class TrainConfig:
    """The JAX package's ``TrainConfig``, field for field and default for
    default."""
    epochs: int = EPOCHS
    batch_size: int = BATCH_SIZE
    learning_rate: float = LEARNING_RATE
    momentum: float = MOMENTUM
    log_interval: int = LOG_INTERVAL
    seed: int = 0
    print_throughput: bool = True
    # a checkpoint after every epoch, auto-resumed on construction
    checkpoint_dir: str | None = None
    resume: bool = True
    # the checkpoint FILE WRITE overlaps the next epoch
    async_checkpoint: bool = False
    # ZeRO-1: the identity on one card (one data shard)
    zero1: bool = False
    # seeded per-epoch shuffle (the reference trains in fixed order)
    shuffle: bool = False
    # per-host input slices: acts only across processes
    shard_inputs: bool = True
    # one schema-2 JSON line per epoch appended here
    metrics_json: str | None = None
    # train at most this many batches per epoch (None = all)
    max_steps_per_epoch: int | None = None
    # self-healing training: not ported (ROADMAP Queue A item 6)
    sentinel: bool = False
    sentinel_window: int = 16
    sentinel_snapshot_every: int = 4
    sentinel_ring: int = 4
    sentinel_spike_factor: float = 3.0


class Trainer:
    """Drives a :class:`Pipeline` over a dataset, reference-style.
    ``self.params`` (the stage modules) and ``self.opt_state`` are the
    training state; a step updates both in place."""

    def __init__(self, pipe: Pipeline, train_ds: Dataset, test_ds: Dataset,
                 config: TrainConfig | None = None,
                 opt: Optimizer | None = None, telemetry=None) -> None:
        self.config = config or TrainConfig()
        if self.config.sentinel:
            raise _roadmap.not_ported("the training sentinel (sentinel=True)",
                                      _roadmap.PARALLEL_AXES)
        if telemetry is not None:
            raise _roadmap.not_ported("a training telemetry session "
                                      "(Trainer(telemetry=...))",
                                      _roadmap.PARALLEL_AXES)
        self.pipe = pipe
        self.train_ds = train_ds
        self.test_ds = test_ds
        self.opt = opt or sgd(self.config.learning_rate, self.config.momentum)
        self.params = pipe.init_params()
        self.opt_state = self.opt.init(self.params)
        if self.config.zero1:
            self.opt_state = shard_opt_state_zero1(self.opt_state)
        self._train_step = make_train_step(pipe, self.opt)
        self._eval_step = make_eval_step(pipe)
        self._step_count = 0
        self._last_samples_per_sec = 0.0
        self._pending_save = None
        self.start_epoch = 1
        # graceful preemption (SIGTERM/SIGINT through request_stop): the
        # in-flight step finishes, then a synchronous checkpoint with the
        # mid-epoch data cursor, then a clean return
        self._stop_requested = False
        self._stop_signal: int | None = None
        self._preempt_cursor: int | None = None
        self._resume_batch_idx = 0
        self.preempted = False
        self.preempt_persisted = False
        if self.config.checkpoint_dir and self.config.resume:
            self._maybe_resume()

    # -- persistence -------------------------------------------------------

    def _ckpt_path(self) -> str:
        return os.path.join(self.config.checkpoint_dir, "state.npz")

    def _maybe_resume(self) -> None:
        path = self._ckpt_path()
        if not os.path.exists(path):
            return
        st = restore_checkpoint(path, pipe=self.pipe,
                                opt_treedef_like=self.opt_state)
        self.params, self.opt_state = st["params"], st["opt_state"]
        self._step_count = st["step"]
        self.start_epoch = int(st["extra"].get("epoch", 0)) + 1
        # a graceful-preemption checkpoint carries the mid-epoch cursor:
        # the saved epoch is the last COMPLETED one
        self._resume_batch_idx = int(st["extra"].get("next_batch", 0))
        self._print(f"| resumed from {path} at epoch {self.start_epoch} "
                    f"(step {self._step_count})"
                    + (f" (batch {self._resume_batch_idx})"
                       if self._resume_batch_idx else ""))

    def _save_extra(self, epoch: int, cursor: int | None) -> dict:
        """A completed epoch records itself; a mid-epoch preemption save
        records the last completed epoch and the ``next_batch`` cursor."""
        return ({"epoch": epoch} if cursor is None
                else {"epoch": epoch - 1, "next_batch": int(cursor)})

    def _save(self, epoch: int, cursor: int | None = None,
              sync: bool = False) -> None:
        if not self.config.checkpoint_dir:
            return
        extra = self._save_extra(epoch, cursor)
        if self.config.async_checkpoint and not sync:
            if self._pending_save is not None:
                self._wait_pending()         # one write in flight at a time
            self._pending_save = save_checkpoint_async(
                self._ckpt_path(), self.params, self.opt_state,
                self._step_count, extra=extra)
        else:
            save_checkpoint(self._ckpt_path(), self.params, self.opt_state,
                            self._step_count, extra=extra)

    def _wait_pending(self) -> None:
        """Drain the in-flight async write, re-raising its error (original
        type) after a diagnostic on stderr."""
        pending, self._pending_save = self._pending_save, None
        try:
            pending.wait()
        except BaseException as e:
            sys.stderr.write(
                f"[checkpoint] async write to {self._ckpt_path()} FAILED "
                f"({type(e).__name__}: {e}) — surfacing the writer "
                f"thread's error; the previously committed checkpoint is "
                f"intact\n")
            sys.stderr.flush()
            raise

    def request_stop(self, signum: int | None = None) -> None:
        """Graceful preemption (the CLI's SIGTERM/SIGINT handler calls
        this): the in-flight step finishes, then ``fit`` writes a
        synchronous checkpoint carrying the data cursor and returns."""
        self._stop_requested = True
        self._stop_signal = signum

    # -- the loops ---------------------------------------------------------

    def _print(self, msg: str) -> None:
        print(msg)

    def _sync(self) -> None:
        if self.pipe.device.type == "cuda":
            torch.cuda.synchronize(self.pipe.device)

    def _epoch_stream(self, shuffle_seed: int | None, start_idx: int):
        """The epoch's ``(batch_idx, Batch)`` stream from ``start_idx``:
        batch order is fixed per (epoch, seed), so skipping forward gives
        the batches the first pass saw."""
        for i, b in enumerate(prefetch_batches(
                self.train_ds, self.config.batch_size,
                shuffle_seed=shuffle_seed)):
            if i >= start_idx:
                yield i, b

    def train_epoch(self, epoch: int) -> float:
        cfg = self.config
        meter = Throughput()
        n_total = len(self.train_ds.x)
        n_batches = max(1, (n_total + cfg.batch_size - 1) // cfg.batch_size)
        loss = 0.0
        shuffle_seed = (cfg.seed * 100003 + epoch) if cfg.shuffle else None
        start_idx = (self._resume_batch_idx if epoch == self.start_epoch
                     else 0)
        self._resume_batch_idx = 0
        first = True
        for batch_idx, b in self._epoch_stream(shuffle_seed, start_idx):
            if (cfg.max_steps_per_epoch is not None
                    and batch_idx >= cfg.max_steps_per_epoch):
                break
            if self._stop_requested:
                self._preempt_cursor = batch_idx
                break
            # ragged final batch: zero-padded, masked out of the loss mean
            w = None
            if b.n_valid < len(b.x):
                w = torch.from_numpy(
                    (np.arange(len(b.x)) < b.n_valid).astype(np.float32))
            self.params, self.opt_state, loss = self._train_step(
                self.params, self.opt_state, torch.from_numpy(b.x),
                torch.from_numpy(b.y), fold_in(cfg.seed, self._step_count),
                w)
            self._step_count += 1
            meter.update(b.n_valid)
            if first:
                # the first step carries one-time costs (kernel builds,
                # allocator growth): keep it out of the throughput window
                self._sync()
                meter.reset()
                first = False
            if batch_idx % cfg.log_interval == 0:
                self._print(
                    'Train Epoch: {} [{}/{} ({:.0f}%)]\tLoss: {:.6f}'.format(
                        epoch, batch_idx * len(b.x), n_total,
                        100.0 * batch_idx / n_batches, float(loss)))
        self._sync()                         # drain before reading the meter
        self._last_samples_per_sec = meter.samples_per_sec
        if cfg.print_throughput:
            self._print('| epoch {}: {:.1f} samples/sec'.format(
                epoch, self._last_samples_per_sec))
        return float(loss)

    def evaluate(self) -> tuple[float, int]:
        total_loss = 0.0
        correct = 0
        # prediction units: samples for classifiers, tokens for LMs
        n = int(self.test_ds.y.size)
        for b in batches(self.test_ds, self.config.batch_size,
                         pad_last=True):
            sl, c = self._eval_step(self.params, torch.from_numpy(b.x),
                                    torch.from_numpy(b.y), None, b.n_valid)
            total_loss += float(sl)
            correct += int(c)
        avg = total_loss / n
        self._print(
            '\nTest set: Average loss: {:.4f}, Accuracy: {}/{} ({:.0f}%)\n'
            .format(avg, correct, n, 100.0 * correct / n))
        return avg, correct

    def _log_metrics(self, record: dict) -> None:
        if self.config.metrics_json:
            append_jsonl(self.config.metrics_json, record, schema=2)

    def fit(self) -> None:
        """The reference's epoch driver, plus a checkpoint per epoch when
        ``checkpoint_dir`` is set and a metrics record per epoch when
        ``metrics_json`` is. After :meth:`request_stop` the in-flight step
        finishes, a synchronous checkpoint with the data cursor is
        written, and ``fit`` returns with ``self.preempted`` set."""
        for epoch in range(self.start_epoch, self.config.epochs + 1):
            train_loss = self.train_epoch(epoch)
            if self._stop_requested:
                self._finish_preempt(epoch)
                return
            eval_loss, correct = self.evaluate()
            n_eval = int(self.test_ds.y.size)
            self._log_metrics({
                "epoch": epoch,
                "step": self._step_count,
                "train_loss": round(train_loss, 6),
                "samples_per_sec": round(self._last_samples_per_sec, 1),
                "eval_loss": round(eval_loss, 6),
                "accuracy": round(correct / n_eval, 6) if n_eval else None,
                "correct": correct,
                "n_eval": n_eval,
            })
            self._save(epoch)
        if self._pending_save is not None:
            self._wait_pending()

    def _finish_preempt(self, epoch: int) -> None:
        """Synchronous checkpoint (with the data cursor when the stop hit
        mid-epoch), the interrupted epoch's metrics record, clean
        return."""
        if self._pending_save is not None:
            self._wait_pending()
        self._save(epoch, cursor=self._preempt_cursor, sync=True)
        self._log_metrics({"epoch": epoch, "step": self._step_count,
                           "preempted": True, "correct": None})
        self.preempted = True
        sig = (f"signal {self._stop_signal}"
               if self._stop_signal is not None else "preempt notice")
        where = (f"batch {self._preempt_cursor} of epoch {epoch}"
                 if self._preempt_cursor is not None
                 else f"end of epoch {epoch}")
        self.preempt_persisted = bool(self.config.checkpoint_dir)
        self._print(
            f"| preempt: graceful stop on {sig} at step "
            f"{self._step_count} ({where}) — "
            + ("synchronous checkpoint + quarantine-journal flush"
               if self.preempt_persisted
               else "no checkpoint_dir configured, state NOT persisted "
               "(quarantine journal flushed)"))
