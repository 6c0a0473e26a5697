"""The port's Trainer: the reference's console surface, losses equal to the
JAX Trainer's, per-epoch checkpoints that resume bit for bit, graceful
preemption with the mid-epoch cursor, and the metrics records.

The JAX Trainer runs on ``make_mesh(n_stages=1, n_data=1)`` (its fused
single-device path) with the weights the port's Trainer starts from.
Console losses agree within 1e-5 relative: the same f32 steps, summed in
another order. A resumed port run equals the uninterrupted one exactly:
each step's dropout generator is seeded from ``(seed, step)`` alone.
"""

import dataclasses
import json
import re

import jax
import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu import make_mesh
from simple_distributed_machine_learning_tpu.models import mlp as jmlp
from simple_distributed_machine_learning_tpu.parallel.pipeline import (
    Pipeline as JaxPipeline,
)
from simple_distributed_machine_learning_tpu.train import trainer as jtrainer
from simple_distributed_machine_learning_tpu_torch.data.mnist import (
    Dataset,
    synthetic_mnist,
)
from simple_distributed_machine_learning_tpu_torch.interop import (
    params_from_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import lenet as tlenet
from simple_distributed_machine_learning_tpu_torch.models import mlp as tmlp
from simple_distributed_machine_learning_tpu_torch.parallel import Pipeline
from simple_distributed_machine_learning_tpu_torch.train import (
    TrainConfig,
    Trainer,
)

# the reference's exact print formats (tests/test_trainer.py)
TRAIN_RE = re.compile(
    r"^Train Epoch: (\d+) \[(\d+)/(\d+) \((\d+)%\)\]\tLoss: (\d+\.\d{6})$")
TEST_RE = re.compile(
    r"^Test set: Average loss: (\d+\.\d{4}), Accuracy: (\d+)/(\d+) "
    r"\((\d+)%\)$")
EPOCH_RE = re.compile(r"^\| epoch (\d+): (\d+\.\d) samples/sec$")
DIMS = [784, 32, 10]


def _flat(ds):
    return Dataset(ds.x.reshape(len(ds.x), -1), ds.y)


def _mlp_data(n_train=240, n_test=60, seed=3):
    tr, te = synthetic_mnist(n_train=n_train, n_test=n_test, seed=seed)
    return _flat(tr), _flat(te)


def _port_mlp_pipe(jax_weights=False):
    stages, wd, od = tmlp.make_mlp_stages(0, DIMS, 1, device="cpu")
    if jax_weights:
        jst = jmlp.make_mlp_stages(jax.random.key(0), DIMS, 1)[0]
        nparams = jax.tree.map(np.asarray, [s.params for s in jst])
        stages = [dataclasses.replace(
            stages[0], params=params_from_numpy(nparams, "cpu")[0])]
    return Pipeline(stages, None, wd, od, device="cpu")


def _lenet_pipe():
    stages, wd, od = tlenet.make_lenet_stages(0, 1, device="cpu")
    return Pipeline(stages, None, wd, od, device="cpu")


def _lines(out, regex):
    return [m for m in (regex.match(l) for l in out.split("\n")) if m]


def test_console_format_matches_reference(capsys):
    train, test = synthetic_mnist(n_train=240, n_test=100, seed=3)
    cfg = TrainConfig(epochs=2, batch_size=60, log_interval=2)
    Trainer(_lenet_pipe(), train, test, cfg).fit()
    out = capsys.readouterr().out
    lines = [l for l in out.split("\n") if l]
    for l in lines:
        assert TRAIN_RE.match(l) or TEST_RE.match(l) or EPOCH_RE.match(l), l
    train_lines = _lines(out, TRAIN_RE)
    # 2 epochs * ceil(4 batches / log_interval 2) = 4 train logs, 2 tests
    assert len(train_lines) == 4 and len(_lines(out, TEST_RE)) == 2
    assert [m.group(1) for m in _lines(out, EPOCH_RE)] == ["1", "2"]
    assert train_lines[0].group(2) == "0" and train_lines[0].group(3) == "240"
    assert train_lines[1].group(2) == "120" and \
        train_lines[1].group(4) == "50"
    # the test line sits between blank lines, as the reference prints it
    assert "\n\nTest set: " in out and re.search(r"\(\d+%\)\n\n", out)


@pytest.mark.parametrize("shuffle,n_train", [(False, 240), (True, 250)])
def test_mlp_console_losses_match_the_jax_trainer(capsys, shuffle, n_train):
    train, test = _mlp_data(n_train=n_train, n_test=70)
    cfg = dict(epochs=2, batch_size=60, log_interval=1,
               print_throughput=False, shuffle=shuffle, seed=4)
    jst, wd, od = jmlp.make_mlp_stages(jax.random.key(0), DIMS, 1)
    jpipe = JaxPipeline(jst, make_mesh(n_stages=1, n_data=1), wd, od)
    jtrainer.Trainer(jpipe, train, test, jtrainer.TrainConfig(**cfg)).fit()
    ref = capsys.readouterr().out
    Trainer(_port_mlp_pipe(jax_weights=True), train, test,
            TrainConfig(**cfg)).fit()
    out = capsys.readouterr().out
    ours, theirs = _lines(out, TRAIN_RE), _lines(ref, TRAIN_RE)
    assert len(ours) == len(theirs) == 2 * -(-n_train // 60)
    for a, b in zip(ours, theirs):
        assert a.groups()[:4] == b.groups()[:4]
        assert float(a.group(5)) == pytest.approx(float(b.group(5)),
                                                  rel=1e-5, abs=1e-6)
    ours, theirs = _lines(out, TEST_RE), _lines(ref, TEST_RE)
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        assert a.groups()[1:] == b.groups()[1:]
        assert float(a.group(1)) == pytest.approx(float(b.group(1)),
                                                  abs=1.5e-4)


def _build(model, tmp_path, epochs, **kw):
    if model == "mlp":
        train, test = _mlp_data(n_train=150, n_test=40)
        pipe = _port_mlp_pipe()
    else:
        train, test = synthetic_mnist(n_train=150, n_test=40, seed=3)
        pipe = _lenet_pipe()
    cfg = TrainConfig(epochs=epochs, batch_size=60, print_throughput=False,
                      checkpoint_dir=str(tmp_path), **kw)
    return Trainer(pipe, train, test, cfg)


def _same_params(a, b):
    for x, y in zip(a[0].parameters(), b[0].parameters()):
        assert torch.equal(x, y)


def _same_state(a, b):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert torch.equal(x, y) if torch.is_tensor(x) else x == y


@pytest.mark.parametrize("model", ["mlp", "lenet"])
@pytest.mark.parametrize("async_checkpoint", [False, True])
def test_two_epochs_equal_one_plus_resume(tmp_path, capsys, model,
                                          async_checkpoint):
    straight = _build(model, tmp_path / "a", 2)
    straight.fit()
    first = _build(model, tmp_path / "b", 1,
                   async_checkpoint=async_checkpoint)
    first.fit()
    resumed = _build(model, tmp_path / "b", 2,
                     async_checkpoint=async_checkpoint)
    out = capsys.readouterr().out
    assert f"| resumed from {tmp_path / 'b' / 'state.npz'} at epoch 2 " \
           f"(step 3)" in out
    assert resumed.start_epoch == 2 and resumed._step_count == 3
    resumed.fit()
    assert resumed._step_count == straight._step_count == 6
    _same_params(resumed.params, straight.params)
    _same_state(resumed.opt_state, straight.opt_state)
    # nothing left to do
    assert _build(model, tmp_path / "b", 2).start_epoch == 3


@pytest.mark.parametrize("model", ["mlp", "lenet"])
def test_preemption_cursor_resumes_bit_exact(tmp_path, capsys, model):
    straight = _build(model, tmp_path / "a", 2)
    straight.fit()
    t = _build(model, tmp_path / "b", 2)
    step = t._train_step

    def stop_after_four(*a, **k):          # batch 1 of epoch 2
        out = step(*a, **k)
        if t._step_count == 3:
            t.request_stop(15)
        return out

    t._train_step = stop_after_four
    t.fit()
    out = capsys.readouterr().out
    assert t.preempted and t.preempt_persisted
    assert ("| preempt: graceful stop on signal 15 at step 4 (batch 1 of "
            "epoch 2)") in out
    meta = json.load(open(tmp_path / "b" / "state.npz.meta.json"))
    assert meta["extra"] == {"epoch": 1, "next_batch": 1}
    resumed = _build(model, tmp_path / "b", 2)
    assert "at epoch 2 (step 4) (batch 1)" in capsys.readouterr().out
    resumed.fit()
    assert resumed._step_count == 6
    _same_params(resumed.params, straight.params)
    _same_state(resumed.opt_state, straight.opt_state)


def test_preemption_without_checkpoint_dir_says_nothing_was_kept(capsys):
    train, test = _mlp_data(n_train=120, n_test=20)
    t = Trainer(_port_mlp_pipe(), train, test,
                TrainConfig(epochs=1, print_throughput=False))
    t.request_stop()
    t.fit()
    assert t.preempted and not t.preempt_persisted
    assert "state NOT persisted" in capsys.readouterr().out


def test_metrics_json_records_per_epoch(tmp_path):
    train, test = _mlp_data(n_train=120, n_test=60, seed=5)
    path = tmp_path / "metrics.jsonl"
    cfg = TrainConfig(epochs=3, batch_size=60, print_throughput=False,
                      metrics_json=str(path))
    Trainer(_port_mlp_pipe(), train, test, cfg).fit()
    records = [json.loads(l) for l in path.read_text().splitlines()]
    assert [r["epoch"] for r in records] == [1, 2, 3]
    for r in records:
        assert set(r) == {"schema", "time", "epoch", "step", "train_loss",
                          "samples_per_sec", "eval_loss", "accuracy",
                          "correct", "n_eval"}
        assert r["schema"] == 2 and r["n_eval"] == 60
        assert abs(r["accuracy"] - r["correct"] / r["n_eval"]) < 1e-6
        assert r["samples_per_sec"] > 0.0
    assert records[-1]["step"] == 6


def test_max_steps_per_epoch_caps_every_epoch(capsys):
    train, test = _mlp_data(n_train=300, n_test=20)
    t = Trainer(_port_mlp_pipe(), train, test,
                TrainConfig(epochs=2, max_steps_per_epoch=2, log_interval=1,
                            print_throughput=False))
    t.fit()
    assert t._step_count == 4
    assert len(_lines(capsys.readouterr().out, TRAIN_RE)) == 4


def test_mlp_learns_the_synthetic_digits():
    train, test = _mlp_data(n_train=240, n_test=100)
    t = Trainer(_port_mlp_pipe(), train, test,
                TrainConfig(epochs=5, print_throughput=False, zero1=True))
    t.fit()
    avg, correct = t.evaluate()
    assert correct / 100 > 0.5 and avg < 2.0        # chance is 10%


def test_one_card_mesh_bootstrap_and_zero1(capsys):
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        bootstrap_distributed,
        make_mesh,
    )
    from simple_distributed_machine_learning_tpu_torch.train import (
        Zero1State,
        sgd,
        shard_opt_state_zero1,
    )
    assert make_mesh() is None and make_mesh(n_stages=1, n_data=1) is None
    # the model, seq and expert axes are ported (items 6d.1-6d.3): over
    # listed devices; without a card to default to there is none
    for axis, name in (("n_seq", "seq"), ("n_expert", "expert")):
        assert make_mesh(**{axis: 2}, devices=["cpu"] * 2).shape[name] == 2
        if not torch.cuda.is_available():
            with pytest.raises(ValueError, match="needs 2 devices, have 0"):
                make_mesh(**{axis: 2})
    assert make_mesh(n_model=2, devices=["cpu"] * 2).shape["model"] == 2
    # the stage and data axes are ported: over listed devices, or the
    # visible cards
    assert make_mesh(n_stages=2, devices=["cpu", "cpu"]).n_stages == 2
    assert make_mesh(n_data=2, devices=["cpu", "cpu"]).shape["data"] == 2
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs 2 devices, have 0"):
            make_mesh(n_stages=2)
        with pytest.raises(ValueError, match="needs 2 devices, have 0"):
            make_mesh(n_data=2)
    with pytest.raises(ValueError, match=">= 1"):
        make_mesh(n_data=0)
    assert bootstrap_distributed(0, 1, "localhost", "29500") is None
    state = [torch.zeros(3)]
    assert shard_opt_state_zero1(state) is state
    assert shard_opt_state_zero1(
        state, mesh=make_mesh(n_stages=2, devices=["cpu"] * 2)) is state
    # over a real data axis the state is sharded; one process holding both
    # replicas keeps both chunks of every stage's packed vector
    pipe = Pipeline(tmlp.make_mlp_stages(0, [8, 6, 4], 1, device="cpu")[0],
                    make_mesh(n_data=2, devices=["cpu"] * 2))
    params = pipe.init_params()
    z = shard_opt_state_zero1(sgd(0.1, 0.5).init(params), pipe.mesh, pipe,
                              params=params)
    assert isinstance(z, Zero1State) and z.ranges == {0: (0, 82)}
    # a packed width the data axis does not divide stays replicated, with
    # the JAX package's line
    pipe = Pipeline(tmlp.make_mlp_stages(0, [8, 6, 3], 1, device="cpu")[0],
                    make_mesh(n_data=2, devices=["cpu"] * 2))
    params = pipe.init_params()
    st = sgd(0.1, 0.5).init(params)
    assert shard_opt_state_zero1(st, pipe.mesh, pipe, params=params) is st
    assert ("zero1: packed param axis 75 not divisible by data axis 2"
            in capsys.readouterr().err)


def test_step_seeds_are_a_pure_function_of_seed_and_step():
    """Each step's dropout generator is seeded by ``fold_in(seed, step)``:
    the murmur mix's two 32-bit words (the same bits on int64 tensors as
    on Python ints), distinct across steps and seeds."""
    from simple_distributed_machine_learning_tpu_torch.ops import random
    seeds = [random.fold_in(s, d) for s in (0, 1, 2 ** 40 + 7)
             for d in range(50)]
    assert len(set(seeds)) == len(seeds)
    assert all(0 <= v < 2 ** 63 for v in seeds)
    assert random.fold_in(3, 17) == random.fold_in(3, 17)
    kd = torch.from_numpy(random.key_data(3).astype(np.int64))
    words = random._bits(kd[0], kd[1], 34 + torch.arange(2)).tolist()
    assert random.fold_in(3, 17) == (words[0] << 31) | (words[1] >> 1)
