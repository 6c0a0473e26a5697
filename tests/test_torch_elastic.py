"""The port's elastic supervisor (``resilience/supervisor.py``) against
the JAX package's, on the CPU.

The acceptance pin: a host-kill at step 6 (mid-epoch 2 of a 4-step-per-
epoch run) makes the port's ``supervise`` restore the epoch-1 generation
(step 4) and complete — with the JAX package's ``supervise`` at ``(1,)``
on the same weights giving the same transitions, the same resumed step
and start epoch, the same backoff and epoch losses within rtol = atol =
3e-5. Plus the state machine on stubs, the checkpoint-write crash (sync
and async), the one ``RestartBudgetExceeded`` class, and that nothing
keeps a dead attempt's trainer alive.
"""

import dataclasses
import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu.data.mnist import (
    Dataset as JDataset,
)
from simple_distributed_machine_learning_tpu.models import mlp as jmlp
from simple_distributed_machine_learning_tpu.parallel.mesh import (
    make_mesh as jmake_mesh,
)
from simple_distributed_machine_learning_tpu.parallel.pipeline import (
    Pipeline as JPipeline,
)
from simple_distributed_machine_learning_tpu.resilience import (
    CheckpointStore as JStore,
    RestartPolicy as JPolicy,
    faults as jfaults,
    make_elastic_trainer as jmake_elastic_trainer,
    supervise as jsupervise,
)
from simple_distributed_machine_learning_tpu.train import trainer as jtrainer
from simple_distributed_machine_learning_tpu_torch import serve as tserve
from simple_distributed_machine_learning_tpu_torch.data.mnist import Dataset
from simple_distributed_machine_learning_tpu_torch.interop import (
    params_from_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.models import mlp as tmlp
from simple_distributed_machine_learning_tpu_torch.parallel import Pipeline
from simple_distributed_machine_learning_tpu_torch.resilience import (
    CheckpointStore,
    RestartBudgetExceeded,
    RestartPolicy,
    faults,
    make_elastic_trainer,
    supervise,
)
from simple_distributed_machine_learning_tpu_torch.resilience.supervisor import (  # noqa: E501
    PeerLost,
)
from simple_distributed_machine_learning_tpu_torch.train import (
    TrainConfig,
    Trainer,
)

DIMS = [12, 16, 14, 16, 10]
TOL = dict(rtol=3e-5, atol=3e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread while this module runs (tiny models)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    faults.uninstall()
    jfaults.uninstall()
    yield
    faults.uninstall()
    jfaults.uninstall()


def _ds(cls):
    rng = np.random.RandomState(0)
    return cls(rng.randn(120, 12).astype(np.float32),
               rng.randint(0, 10, 120))


def _port_pipe(n=1):
    jst = jmlp.make_mlp_stages(jax.random.key(0), DIMS, 1)[0]
    nparams = jax.tree.map(np.asarray, [s.params for s in jst])
    st, wd, od = tmlp.make_mlp_stages(0, DIMS, 1, device="cpu")
    st = [dataclasses.replace(st[0],
                              params=params_from_numpy(nparams, "cpu")[0])]
    return Pipeline(st, None, wd, od, device="cpu")


def _jax_pipe(n):
    st, wd, od = jmlp.make_mlp_stages(jax.random.key(0), DIMS, n)
    return JPipeline(st, jmake_mesh(n_stages=n, n_data=1,
                                    devices=jax.devices()[:n]), wd, od)


def _cfg(epochs, **kw):
    return dict(epochs=epochs, batch_size=30, print_throughput=False, **kw)


# ---------------------------------------------------------------------------
# the state machine on stubs (tests/test_resilience.py's cases)


class _StubTrainer:
    def __init__(self, outcomes, n_stages):
        self._outcomes = outcomes
        self.n_stages = n_stages
        self._step_count = 0
        self.start_epoch = 1
        self.history = []

    def fit(self):
        out = self._outcomes.pop(0)
        if out is not None:
            raise out


def _host_lost():
    return faults.HostLost(
        faults.FaultSpec(kind="host-kill", site="train.step"), "train.step")


def test_supervise_shrinks_on_peer_loss_with_exponential_backoff():
    outcomes = [PeerLost("peer 1 vanished"), _host_lost(), None]
    built, sleeps = [], []

    def build(n):
        built.append(n)
        return _StubTrainer(outcomes, n)

    report = supervise(build, (4, 2, 1),
                       policy=RestartPolicy(max_restarts=3,
                                            base_backoff_s=0.1,
                                            backoff_factor=2.0,
                                            max_backoff_s=10.0),
                       sleep=sleeps.append)
    assert built == [4, 2, 1]
    assert report["completed"] and report["restarts"] == 2
    assert sleeps == [0.1, 0.2]
    assert [t[0] for t in report["transitions"]] == [
        "RUNNING", "RESTORING", "RUNNING", "RESTORING", "RUNNING", "DONE"]


def test_supervise_budget_exhaustion_fails_loudly():
    outcomes = [_host_lost(), _host_lost(), _host_lost()]
    with pytest.raises(RestartBudgetExceeded, match="max_restarts=2"):
        supervise(lambda n: _StubTrainer(outcomes, n), (2, 1),
                  policy=RestartPolicy(max_restarts=2, base_backoff_s=0.0),
                  sleep=lambda s: None)


def test_supervise_propagates_real_bugs_and_validates_its_policy():
    with pytest.raises(ValueError, match="a real bug"):
        supervise(lambda n: _StubTrainer([ValueError("a real bug")], n),
                  (1,), sleep=lambda s: None)
    with pytest.raises(ValueError, match="at least one"):
        supervise(lambda n: None, ())
    with pytest.raises(ValueError, match="backoff_factor"):
        RestartPolicy(backoff_factor=0.5)


def test_one_except_catches_the_serving_and_the_training_budget(tmp_path):
    """``RestartBudgetExceeded`` is one class: the serve supervisor's and
    the elastic supervisor's budgets both land in one ``except``."""
    assert tserve.RestartBudgetExceeded is RestartBudgetExceeded
    cfg = tgpt.GPTConfig(vocab=32, seq_len=48, d_model=32, n_heads=2,
                         n_layers=2)
    stages = tgpt.make_gpt_stages(0, cfg, 1, device="cpu")[0]

    def serving():
        faults.install(faults.FaultPlan.parse(
            "engine-crash@serve.tick,times=0"))
        sup = tserve.ServeSupervisor(
            tserve.engine_factory(stages, cfg, n_slots=2, block_size=4,
                                  device="cpu"),
            str(tmp_path / "j.jsonl"), max_restarts=1)
        sup.submit(np.arange(4, dtype=np.int32), max_new_tokens=4, seed=1)
        try:
            sup.drain()
        finally:
            sup.close()

    def training():
        supervise(lambda n: _StubTrainer([_host_lost()] * 2, n), (1,),
                  policy=RestartPolicy(max_restarts=1),
                  sleep=lambda s: None)

    caught = []
    for run in (serving, training):
        try:
            run()
        except RestartBudgetExceeded as e:
            caught.append(type(e).__name__)
        finally:
            faults.uninstall()
    assert caught == ["RestartBudgetExceeded"] * 2


# ---------------------------------------------------------------------------
# real training, against the JAX package's supervise


def test_elastic_host_kill_restores_and_equals_the_jax_supervise(tmp_path):
    ds, jds = _ds(Dataset), _ds(JDataset)
    cfg = TrainConfig(**_cfg(4))
    ref = Trainer(_port_pipe(), ds, ds, cfg)
    ref_losses = []
    ref._log_metrics = lambda rec: ref_losses.append(rec["train_loss"])
    ref.fit()

    store = CheckpointStore(str(tmp_path / "port"), keep=8)
    faults.install(faults.FaultPlan.parse("host-kill@train.step=6"))
    sleeps = []
    report = supervise(
        lambda n: make_elastic_trainer(_port_pipe, n, store, ds, ds, cfg),
        (1,), policy=RestartPolicy(max_restarts=3), sleep=sleeps.append)
    faults.uninstall()

    jstore = JStore(str(tmp_path / "jax"), keep=8)
    jfaults.install(jfaults.FaultPlan.parse("host-kill@train.step=6"))
    jsleeps = []
    jcfg = jtrainer.TrainConfig(**_cfg(4))
    jreport = jsupervise(
        lambda n: jmake_elastic_trainer(_jax_pipe, n, jstore, jds, jds,
                                        jcfg),
        (1,), policy=JPolicy(max_restarts=3), sleep=jsleeps.append)

    assert report["completed"] and report["restarts"] == 1
    assert report["transitions"] == jreport["transitions"] == [
        ("RUNNING", 1), ("RESTORING", 1), ("RUNNING", 1), ("DONE", 1)]
    a1, a2 = report["attempts"]
    assert (a1["n_stages"], a1["outcome"], a1["fault"]) == (1, "fault",
                                                            "HostLost")
    assert [h["epoch"] for h in a1["history"]] == [1]
    assert a1["history"][0]["train_loss"] == ref_losses[0]
    assert (a2["resumed_step"], a2["start_epoch"], a2["outcome"]) == (
        4, 2, "completed")
    assert sleeps == jsleeps == [0.05]
    for ours, theirs in zip(report["attempts"], jreport["attempts"]):
        assert ({k: v for k, v in ours.items() if k != "history"}
                == {k: v for k, v in theirs.items() if k != "history"})
        np.testing.assert_allclose(
            [h["train_loss"] for h in ours["history"]],
            [h["train_loss"] for h in theirs["history"]], **TOL)
    # loss continues from the restored step: epochs 2-4 equal the
    # uninterrupted port run's exactly (the same state and batches)
    assert [h["train_loss"] for h in a2["history"]] == ref_losses[1:]
    assert store.latest_valid()["extra"]["n_stages"] == 1


@pytest.mark.parametrize("async_checkpoint", [False, True])
def test_checkpoint_write_crash_leaves_the_committed_file(tmp_path,
                                                          async_checkpoint):
    """The ``ckpt.write`` site fires in the sync and the async save: the
    crash halves the temp file and raises before the rename, so the
    previous checkpoint stays whole and no temp file is left."""
    ds = _ds(Dataset)
    cfg = TrainConfig(**_cfg(2, checkpoint_dir=str(tmp_path),
                             async_checkpoint=async_checkpoint))
    Trainer(_port_pipe(), ds, ds, dataclasses.replace(cfg, epochs=1)).fit()
    before = (tmp_path / "state.npz").read_bytes()
    faults.install(faults.FaultPlan.parse("ckpt-write-crash@ckpt.write"))
    tr = Trainer(_port_pipe(), ds, ds, cfg)
    assert tr.start_epoch == 2
    with pytest.raises(faults.CheckpointWriteCrash):
        tr.fit()
    assert (tmp_path / "state.npz").read_bytes() == before
    assert [p.name for p in tmp_path.iterdir() if ".tmp." in p.name] == []


def test_async_write_crash_surfaces_from_fit(tmp_path, capfd):
    ds = _ds(Dataset)
    cfg = TrainConfig(**_cfg(2, checkpoint_dir=str(tmp_path),
                             async_checkpoint=True))
    tr = Trainer(_port_pipe(), ds, ds, cfg)
    faults.install(faults.FaultPlan.parse("ckpt-write-crash@ckpt.write"))
    with pytest.raises(faults.CheckpointWriteCrash):
        tr.fit()
    assert "async write" in capfd.readouterr().err


def test_elastic_write_crash_retries_in_place(tmp_path):
    ds = _ds(Dataset)
    store = CheckpointStore(str(tmp_path), keep=4)
    faults.install(faults.FaultPlan.parse("ckpt-write-crash@ckpt.write"))
    report = supervise(
        lambda n: make_elastic_trainer(_port_pipe, n, store, ds, ds,
                                       TrainConfig(**_cfg(2))),
        (1,), policy=RestartPolicy(max_restarts=2), sleep=lambda s: None)
    assert report["completed"] and report["restarts"] == 1
    a1, a2 = report["attempts"]
    assert a1["fault"] == "CheckpointWriteCrash" and a2["n_stages"] == 1
    assert (a2["resumed_step"], a2["start_epoch"]) == (0, 1)
    assert store.latest_valid()["step"] == 8


def test_elastic_trainer_rejects_checkpoint_dir_config(tmp_path):
    ds = _ds(Dataset)
    with pytest.raises(ValueError, match="CheckpointStore"):
        make_elastic_trainer(_port_pipe, 1, CheckpointStore(str(tmp_path)),
                             ds, ds, TrainConfig(**_cfg(
                                 1, checkpoint_dir=str(tmp_path / "x"))))


def test_elastic_preemption_is_persisted_through_the_store(tmp_path,
                                                          capsys):
    """A graceful stop in an elastic attempt saves a store generation with
    the mid-epoch cursor, says so, and the next attempt resumes there."""
    ds = _ds(Dataset)
    store = CheckpointStore(str(tmp_path), keep=4)
    faults.install(faults.FaultPlan.parse("preempt@train.sigterm=2"))
    tr = make_elastic_trainer(_port_pipe, 1, store, ds, ds,
                              TrainConfig(**_cfg(2)))
    tr.fit()
    assert tr.preempted and tr.preempt_persisted
    assert "synchronous checkpoint" in capsys.readouterr().out
    entry = store.latest_valid()
    assert entry["step"] == 2 and entry["extra"]["next_batch"] == 2
    resumed = make_elastic_trainer(_port_pipe, 1, store, ds, ds,
                                   TrainConfig(**_cfg(2)))
    assert (resumed._step_count, resumed.start_epoch,
            resumed._resume_batch_idx) == (2, 1, 2)


def test_a_dead_attempt_is_freed(tmp_path):
    """Nothing keeps a failed attempt's trainer, parameters or optimizer
    state alive once the next attempt runs: no reference cycle, no
    closure, no thread, with the collector off (on the card this is the
    memory a restart gives back)."""
    ds = _ds(Dataset)
    store = CheckpointStore(str(tmp_path), keep=4)
    refs, dead = [], []

    def build(n):
        tr = make_elastic_trainer(_port_pipe, n, store, ds, ds,
                                  TrainConfig(**_cfg(2, sentinel=True)))
        if refs:
            fit = tr.fit

            def checked_fit():
                dead.append(all(r() is None for r in refs))
                fit()
            tr.fit = checked_fit
        else:
            refs.extend(weakref.ref(t) for t in
                        [tr] + list(tr.params[0].parameters())
                        + list(tr.opt_state))
        return tr

    gc.collect()
    gc.disable()
    try:
        faults.install(faults.FaultPlan.parse("host-kill@train.step=5"))
        report = supervise(build, (1,), sleep=lambda s: None)
    finally:
        gc.enable()
    assert report["restarts"] == 1 and report["completed"]
    assert dead == [True]
