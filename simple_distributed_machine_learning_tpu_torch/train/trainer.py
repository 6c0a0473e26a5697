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

Timing: one pageable host -> device copy per batch (``_feed``), as the
JAX feed does. The throughput meter restarts after the first step has
finished on the device and is read after the device has drained, so
samples/sec is the card's rate, not the host's enqueue rate.

Telemetry (``telemetry=Telemetry(dir)``, ``telemetry/session.py``): a
``feed`` span around each batch's copy to the device, a ``step`` span
around each step, ``eval`` spans in :meth:`Trainer.evaluate`, the fenced
step-timing windows (each epoch's first step forced; the run's first is
the compile window), and one epoch record per epoch (and on a graceful
preemption) with the training record's fields riding along, and the
static collective bytes of the step (``ici_bytes_per_step``: the run's
first batch registers the step with ``Telemetry.set_step_probe``); the
registry carries the training series and the sentinel's. None = the reference's
console and ``metrics_json`` only.

Fault sites (``resilience/faults.py``), where the JAX Trainer has them:
``train.sigterm`` (checked before each step: a graceful preemption),
``train.step`` (a host-kill raises ``HostLost`` between steps),
``train.grad`` and ``data.batch`` (the sentinel's numeric kinds, applied
to the raw numpy batch before it is copied to the device; without the
sentinel they raise ``NumericFault``); ``ckpt.write`` sits in
``train/checkpoint.py``. With ``sentinel=True`` every step's loss and
gradient norm are checked on the host (``resilience/sentinel.py``): an
anomaly rolls the state back to a host snapshot, quarantines the batch and
replays, bit for bit what a run that never saw the batch computes.

Across processes (``parallel/mesh.py``): ``is_main`` is process 0, the
only one that prints the console and appends ``metrics_json``; each batch
is cut to this process's rows (``data/sharding.py::host_rows``) before
its copy to the device — under ``SDML_DEBUG_SHARDING`` each process names
them once on stderr; checkpoints are collective saves, and a resume
checks that every process sees the checkpoint; the quarantine journal is
appended by process 0 alone.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys

import numpy as np
import torch

from simple_distributed_machine_learning_tpu_torch.data.mnist import (
    Dataset,
    batches,
    prefetch_batches,
)
from simple_distributed_machine_learning_tpu_torch.data.sharding import (
    host_rows,
)
from simple_distributed_machine_learning_tpu_torch.ops.random import fold_in
from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (
    Pipeline,
    param_leaves,
)
from simple_distributed_machine_learning_tpu_torch.resilience import faults
from simple_distributed_machine_learning_tpu_torch.resilience.sentinel import (
    Sentinel,
    SentinelConfig,
    restore_state,
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
    # ZeRO-1: the optimizer state sharded over the data axis (the identity
    # on a one-wide one)
    zero1: bool = False
    # seeded per-epoch shuffle (the reference trains in fixed order)
    shuffle: bool = False
    # per-host input slices; the port always feeds each process its own
    # rows (its Pipeline takes them), so this field is the JAX one's only
    shard_inputs: bool = True
    # one schema-2 JSON line per epoch appended here
    metrics_json: str | None = None
    # train at most this many batches per epoch (None = all)
    max_steps_per_epoch: int | None = None
    # self-healing training (resilience/sentinel.py): every step's loss
    # and grad norm checked on the host, a ring of host snapshots, and on
    # an anomaly a rollback, the batch quarantined (<checkpoint_dir>/
    # quarantine.jsonl) and a replay
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
        self.pipe = pipe
        self.train_ds = train_ds
        self.test_ds = test_ds
        # the observability hook (telemetry/session.py); None = the
        # reference's console and metrics_json only
        self.telemetry = telemetry
        # LM datasets have [N, T] targets: telemetry reports tokens/sec
        # beside examples/sec (0 = classifier, no token throughput)
        self._tokens_per_sample = (int(np.prod(train_ds.y.shape[1:]))
                                   if np.ndim(train_ds.y) > 1 else 0)
        self._registry = telemetry.registry if telemetry is not None else None
        mesh = pipe.mesh
        # the reference's master-only console, across processes
        self.is_main = mesh is None or mesh.rank == 0
        self._rows_announced = False
        self.opt = opt or sgd(self.config.learning_rate, self.config.momentum)
        self.params = pipe.init_params()
        self.opt_state = self.opt.init(self.params)
        if self.config.zero1:
            self.opt_state = shard_opt_state_zero1(
                self.opt_state, mesh, pipe, params=self.params)
        self._train_step = make_train_step(
            pipe, self.opt, with_grad_norm=self.config.sentinel)
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
        self._sentinel = None
        if self.config.sentinel:
            jdir = self._sentinel_dir()
            self._sentinel = Sentinel(
                SentinelConfig(
                    window=self.config.sentinel_window,
                    snapshot_every=self.config.sentinel_snapshot_every,
                    ring_size=self.config.sentinel_ring,
                    spike_factor=self.config.sentinel_spike_factor),
                registry=self._registry,
                journal_path=(os.path.join(jdir, "quarantine.jsonl")
                              if jdir else None),
                # process 0 writes the shared journal; every process still
                # loads it and skips identically
                journal_write_ok=self.is_main)
        if self.config.checkpoint_dir and self.config.resume:
            self._maybe_resume()

    # -- persistence -------------------------------------------------------

    def _ckpt_path(self) -> str:
        return os.path.join(self.config.checkpoint_dir, "state.npz")

    def _maybe_resume(self) -> None:
        path = self._ckpt_path()
        found = os.path.exists(path)
        mesh = self.pipe.mesh
        if mesh is not None and mesh.distributed:
            # every process must agree on whether to resume, or they would
            # issue different numbers of collectives and hang (a
            # checkpoint_dir that is not a shared filesystem)
            founds = [None] * mesh.world_size
            torch.distributed.all_gather_object(founds, found)
            if min(founds) != max(founds):
                raise RuntimeError(
                    f"checkpoint {path} visible on only some processes — "
                    "checkpoint_dir must be a shared filesystem for "
                    "multi-process resume")
        if not found:
            return
        st = restore_checkpoint(path, pipe=self.pipe,
                                opt_treedef_like=self.opt_state)
        self.params, self.opt_state = st["params"], st["opt_state"]
        self._step_count = st["step"]
        self.start_epoch = int(st["extra"].get("epoch", 0)) + 1
        # a graceful-preemption checkpoint carries the mid-epoch cursor:
        # the saved epoch is the last COMPLETED one
        self._resume_batch_idx = int(st["extra"].get("next_batch", 0))
        if self._sentinel is not None and "sentinel" in st["extra"]:
            self._sentinel.restore_detector(st["extra"]["sentinel"])
        self._print(f"| resumed from {path} at epoch {self.start_epoch} "
                    f"(step {self._step_count})"
                    + (f" (batch {self._resume_batch_idx})"
                       if self._resume_batch_idx else ""))

    def _save_extra(self, epoch: int, cursor: int | None) -> dict:
        """A completed epoch records itself; a mid-epoch preemption save
        records the last completed epoch and the ``next_batch`` cursor.
        With the sentinel on, its EWMA detector state rides along, so a
        resumed run's spike threshold is the uninterrupted run's."""
        extra = ({"epoch": epoch} if cursor is None
                 else {"epoch": epoch - 1, "next_batch": int(cursor)})
        if self._sentinel is not None:
            extra["sentinel"] = self._sentinel.detector_state()
        return extra

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

    def _persists(self) -> bool:
        """Whether a save reaches disk; ``ElasticTrainer`` (which saves
        through its store) overrides it."""
        return bool(self.config.checkpoint_dir)

    # -- self-healing training (resilience/sentinel.py) --------------------

    def _sentinel_dir(self) -> str | None:
        """Directory of the quarantine journal (``quarantine.jsonl``);
        None = in memory. ``ElasticTrainer`` overrides it with its store's
        directory."""
        return self.config.checkpoint_dir

    @property
    def sentinel(self):
        return self._sentinel

    def sentinel_stats(self) -> dict | None:
        """The sentinel's cumulative counters (None when it is off): the
        epoch record and the supervisor's attempt report embed them."""
        return None if self._sentinel is None else self._sentinel.stats()

    def _restore_snapshot(self, snap) -> None:
        """Micro-rollback: copy a ring snapshot INTO the live parameter and
        optimizer tensors (the optimizer keeps referencing them), with the
        snapshot's step counters and step count."""
        with torch.no_grad():
            for t, v in zip(param_leaves(self.params), snap.params):
                t.copy_(v)
        self.opt_state = restore_state(self.opt_state, snap.opt_leaves)
        self._step_count = snap.step

    def _apply_numeric_faults(self, x, step: int):
        """The sentinel's numeric fault kinds on the RAW numpy batch,
        before it is copied to the device: nan-grad scales it by NaN,
        corrupt-batch by 1e30, loss-spike by 100 (the JAX Trainer's
        effects). Without the sentinel the sites fire their standard
        effect, a raised ``NumericFault``, so a drill never passes against
        an undefended trainer."""
        if faults.active() is None:
            return x
        if self._sentinel is None:
            faults.maybe_fire("train.grad", step=step)
            faults.maybe_fire("data.batch", step=step)
            return x
        fired = (faults.check("train.grad", step=step)
                 + faults.check("data.batch", step=step)
                 + faults.check("train.step", step=step,
                                only=("loss-spike",)))
        for spec in fired:
            if spec.kind == "nan-grad":
                x = np.asarray(x) * np.float32("nan")
            elif spec.kind == "corrupt-batch":
                x = np.asarray(x) * np.float32(1e30)
            elif spec.kind == "loss-spike":
                x = np.asarray(x) * np.float32(100.0)
        return x

    def request_stop(self, signum: int | None = None) -> None:
        """Graceful preemption (the CLI's SIGTERM/SIGINT handler calls
        this): the in-flight step finishes, then ``fit`` writes a
        synchronous checkpoint carrying the data cursor and returns."""
        self._stop_requested = True
        self._stop_signal = signum

    # -- the loops ---------------------------------------------------------

    def _print(self, msg: str) -> None:
        if self.is_main:
            print(msg)

    def _sync(self) -> None:
        for dev in dict.fromkeys(self.pipe.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _span(self, name: str):
        return (self.telemetry.span(name) if self.telemetry is not None
                else contextlib.nullcontext())

    def _feed(self, x, y, w):
        """The batch's one host -> device copy of this process's rows
        (``host_rows``, cut on the host first, so each process moves
        ``B / D`` rows per replica it holds, not the global batch): inputs
        onto the first stage's device, targets and weights onto the last's
        (the step then finds each where it is read)."""
        B = len(x)
        lo, hi = host_rows(self.pipe.mesh, B)
        if (lo, hi) != (0, B):
            x, y = x[lo:hi], y[lo:hi]
            w = None if w is None else w[lo:hi]
        if not self._rows_announced:
            self._rows_announced = True
            if os.environ.get("SDML_DEBUG_SHARDING"):
                # stderr on every process: the reference-format stdout
                # stays process 0's
                rank = 0 if self.pipe.mesh is None else self.pipe.mesh.rank
                print(f"| host {rank}: input rows [{lo},{hi}) of {B}",
                      file=sys.stderr, flush=True)
        dev, out = self.pipe.device, self.pipe.out_device
        return (torch.from_numpy(np.ascontiguousarray(x)).to(dev),
                torch.from_numpy(np.ascontiguousarray(y)).to(out),
                None if w is None else torch.from_numpy(w).to(out))

    def _epoch_stream(self, shuffle_seed: int | None, start_idx: int):
        """The epoch's ``(batch_idx, Batch)`` stream from ``start_idx``:
        batch order is fixed per (epoch, seed), so skipping forward gives
        the batches the first pass saw (a mid-epoch resume and a rollback
        both re-enter here)."""
        for i, b in enumerate(prefetch_batches(
                self.train_ds, self.config.batch_size,
                shuffle_seed=shuffle_seed)):
            if i >= start_idx:
                yield i, b

    def train_epoch(self, epoch: int) -> float:
        cfg = self.config
        tele = self.telemetry
        sent = self._sentinel
        meter = Throughput()
        n_total = len(self.train_ds.x)
        n_batches = max(1, (n_total + cfg.batch_size - 1) // cfg.batch_size)
        loss = 0.0
        shuffle_seed = (cfg.seed * 100003 + epoch) if cfg.shuffle else None
        start_idx = (self._resume_batch_idx if epoch == self.start_epoch
                     else 0)
        self._resume_batch_idx = 0
        if tele is not None:
            tele.mark()                  # window start = loop entry, not init
        if sent is not None:
            sent.begin_epoch(epoch)      # fresh ring + forced entry snapshot
        stream = self._epoch_stream(shuffle_seed, start_idx)
        first = True                     # first EXECUTED batch of the epoch
        try:
            # explicit next(): a rollback REPLACES the stream mid-loop
            while True:
                nxt = next(stream, None)
                if nxt is None:
                    break
                batch_idx, b = nxt
                if (cfg.max_steps_per_epoch is not None
                        and batch_idx >= cfg.max_steps_per_epoch):
                    break
                if sent is not None and sent.quarantined(epoch, batch_idx):
                    continue             # deterministic corrupt-batch skip
                step = self._step_count
                # graceful preemption (the injected preempt@train.sigterm,
                # or SIGTERM through request_stop), checked BEFORE the
                # step, so the in-flight one always finishes
                if faults.check("train.sigterm", step=step):
                    self._stop_requested = True
                if self._stop_requested:
                    self._preempt_cursor = batch_idx
                    break
                if sent is not None:
                    # pre-step snapshot: this very step's state is a valid
                    # rollback target even when the step is poisoned
                    sent.maybe_snapshot(step, epoch, batch_idx, self.params,
                                        self.opt_state)
                # a host-kill raises HostLost here, between steps;
                # loss-spike is the sentinel's (_apply_numeric_faults)
                faults.maybe_fire("train.step", step=step,
                           exclude=(("loss-spike",) if sent is not None
                                    else ()))
                # ragged final batch: zero-padded, masked out of the loss
                w = None
                if b.n_valid < len(b.x):
                    w = (np.arange(len(b.x)) < b.n_valid).astype(np.float32)
                bx = self._apply_numeric_faults(b.x, step)
                with self._span("feed"):
                    x, y, w = self._feed(bx, b.y, w)
                if tele is not None and first and epoch == self.start_epoch:
                    # register the exact step + shapes for the static
                    # collective-bytes gauge (trace-only: fake stand-ins,
                    # nothing copied or launched). Keyed on the run's first
                    # batch — not _step_count, which a resume starts
                    # nonzero
                    from simple_distributed_machine_learning_tpu_torch.analysis import (  # noqa: E501
                        abstractify,
                    )
                    tele.set_step_probe(
                        self._train_step, abstractify(self.params),
                        abstractify(self.opt_state), abstractify(x),
                        abstractify(y), fold_in(cfg.seed, step),
                        abstractify(w), mesh=self.pipe.mesh)
                with self._span("step"):
                    out = self._train_step(self.params, self.opt_state, x, y,
                                           fold_in(cfg.seed, step), w)
                self.params, self.opt_state, loss = out[:3]
                self._step_count += 1
                if sent is not None:
                    # ONE host sync for both scalars: the sentinel's cost
                    loss_f, gnorm_f = torch.stack(
                        (loss.float(), out[3])).tolist()
                    anomaly = sent.observe(step, epoch, batch_idx, loss_f,
                                           gnorm_f)
                    if anomaly is not None:
                        # restore the newest pre-anomaly snapshot, rewind
                        # the batch stream to its cursor and replay; the
                        # quarantined batch is skipped on the way through.
                        # SentinelExhausted (the supervisor recovers from
                        # it) when anomalies repeat too fast
                        snap = sent.rollback(anomaly)
                        self._restore_snapshot(snap)
                        self._print(
                            f"| sentinel: {anomaly.kind} at step "
                            f"{anomaly.step} (epoch {epoch} batch "
                            f"{anomaly.batch_idx}) — rolled back to step "
                            f"{snap.step}, batch quarantined, replaying")
                        stream.close()
                        stream = self._epoch_stream(shuffle_seed,
                                                    snap.batch_idx)
                        if tele is not None:
                            tele.mark()  # the poisoned window is not a step
                        continue
                meter.update(b.n_valid)
                if tele is not None:
                    # each epoch's first batch is fenced; the run's first
                    # window is the compile window the StepTimer splits out
                    tele.on_step(
                        loss, examples=b.n_valid,
                        tokens=b.n_valid * self._tokens_per_sample,
                        force_fence=first)
                if first:
                    # the first step carries one-time costs (kernel
                    # builds, allocator growth): keep it out of the
                    # throughput window
                    self._sync()
                    meter.reset()
                    first = False
                if batch_idx % cfg.log_interval == 0:
                    self._print(
                        'Train Epoch: {} [{}/{} ({:.0f}%)]\tLoss: '
                        '{:.6f}'.format(
                            epoch, batch_idx * len(b.x), n_total,
                            100.0 * batch_idx / n_batches, float(loss)))
        finally:
            stream.close()
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
            with self._span("eval"):
                x, y, _ = self._feed(b.x, b.y, None)
                sl, c = self._eval_step(self.params, x, y, None, b.n_valid)
                total_loss += float(sl)      # the host read closes the span
                correct += int(c)            # at the batch's true end
        avg = total_loss / n
        self._print(
            '\nTest set: Average loss: {:.4f}, Accuracy: {}/{} ({:.0f}%)\n'
            .format(avg, correct, n, 100.0 * correct / n))
        return avg, correct

    def _log_metrics(self, record: dict) -> None:
        """The per-epoch record to ``metrics_json`` (schema 2), mirrored
        into the telemetry registry when a session is attached (monotonic
        counters for step/correct counts, gauges for the rest), so the
        same numbers ride the Prometheus exposition."""
        reg = self._registry
        if reg is not None:
            steps = reg.counter("train_steps_total")
            steps.inc(record["step"] - steps.value)
            if record["correct"] is not None:
                reg.counter("eval_correct_total").inc(record["correct"])
            for key in ("train_loss", "eval_loss", "accuracy",
                        "samples_per_sec"):
                if record.get(key) is not None:
                    reg.gauge(key).set(record[key])
        if self.config.metrics_json and self.is_main:
            append_jsonl(self.config.metrics_json, record, schema=2)

    def fit(self) -> None:
        """The reference's epoch driver, plus a checkpoint per epoch when
        ``checkpoint_dir`` is set, a metrics record per epoch when
        ``metrics_json`` is, and a telemetry record per epoch when a
        session is attached. After :meth:`request_stop` the in-flight step
        finishes, a synchronous checkpoint with the data cursor is
        written, and ``fit`` returns with ``self.preempted`` set."""
        for epoch in range(self.start_epoch, self.config.epochs + 1):
            train_loss = self.train_epoch(epoch)
            if self._stop_requested:
                self._finish_preempt(epoch)
                return
            eval_loss, correct = self.evaluate()
            n_eval = int(self.test_ds.y.size)
            record = {
                "epoch": epoch,
                "step": self._step_count,
                "train_loss": round(train_loss, 6),
                "samples_per_sec": round(self._last_samples_per_sec, 1),
                "eval_loss": round(eval_loss, 6),
                "accuracy": round(correct / n_eval, 6) if n_eval else None,
                "correct": correct,
                "n_eval": n_eval,
            }
            if self._sentinel is not None:
                # the self-healing block rides every epoch record, so a
                # drill re-asserts rollbacks from the metrics file
                record.update(self.sentinel_stats())
                record["anomaly_events"] = self._sentinel.drain_events()
            self._log_metrics(record)
            if self.telemetry is not None:
                # the full telemetry record: step-latency quantiles,
                # throughput, memory, the bubble estimate, with the
                # training record's fields riding along
                self.telemetry.on_epoch(epoch, pipe=self.pipe, extra=record)
            self._save(epoch)
        if self._pending_save is not None:
            self._wait_pending()
        if self.telemetry is not None:
            self.telemetry.close()

    def _finish_preempt(self, epoch: int) -> None:
        """Synchronous checkpoint (with the data cursor when the stop hit
        mid-epoch), the interrupted epoch's metrics record, clean
        return."""
        if self._pending_save is not None:
            self._wait_pending()
        self._save(epoch, cursor=self._preempt_cursor, sync=True)
        record: dict = {"epoch": epoch, "step": self._step_count,
                        "preempted": True, "correct": None}
        if self._sentinel is not None:
            record.update(self.sentinel_stats())
            record["anomaly_events"] = self._sentinel.drain_events()
        self._log_metrics(record)
        if self.telemetry is not None:
            self.telemetry.on_epoch(epoch, pipe=self.pipe, extra=record)
        if self._registry is not None:
            self._registry.gauge("train_preempt_graceful").set(1)
        self.preempted = True
        sig = (f"signal {self._stop_signal}"
               if self._stop_signal is not None else "preempt notice")
        where = (f"batch {self._preempt_cursor} of epoch {epoch}"
                 if self._preempt_cursor is not None
                 else f"end of epoch {epoch}")
        self.preempt_persisted = self._persists()
        self._print(
            f"| preempt: graceful stop on {sig} at step "
            f"{self._step_count} ({where}) — "
            + ("synchronous checkpoint + quarantine-journal flush"
               if self.preempt_persisted
               else "no checkpoint_dir configured, state NOT persisted "
               "(quarantine journal flushed)"))
        if self.telemetry is not None:
            self.telemetry.close()
