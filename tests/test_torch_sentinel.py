"""The port's self-healing training (``resilience/sentinel.py`` and the
Trainer's sentinel loop) against the JAX package's, on the CPU.

The acceptance pin: with ``nan-grad@train.grad=6`` injected, the port's
sentinel detects the NaN at step 6, rolls back, quarantines the batch and
replays — and its per-step losses equal, exactly, a clean port run that
pre-loaded the same quarantine journal. Across the packages, from the same
weights (carried with ``interop.params_from_numpy``): the same quarantine
records (step, kind, epoch, batch), the same observed steps, and the
observed losses within rtol = atol = 3e-5 (the same f32 steps summed in
another order). The sizes are ``tests/test_sentinel.py``'s: the MLP
``[12, 16, 14, 16, 10]``, 120 samples, batch 30, 3 epochs, a snapshot
every 2 steps. The GPT pins run the tiny GPT on float token ids, where the
numeric faults reach the gather: NaN ids become id 0 (nan-grad trains on
it, undetected), ids scaled past the vocab give NaN rows (corrupt-batch
and loss-spike are both caught as ``nan``) — in both packages.
"""

import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu.data.mnist import (
    Dataset as JDataset,
)
from simple_distributed_machine_learning_tpu.models import gpt as jgpt
from simple_distributed_machine_learning_tpu.models import mlp as jmlp
from simple_distributed_machine_learning_tpu.parallel.mesh import (
    make_mesh as jmake_mesh,
)
from simple_distributed_machine_learning_tpu.parallel.pipeline import (
    Pipeline as JPipeline,
)
from simple_distributed_machine_learning_tpu.resilience import (
    faults as jfaults,
)
from simple_distributed_machine_learning_tpu.train import trainer as jtrainer
from simple_distributed_machine_learning_tpu_torch.data.mnist import Dataset
from simple_distributed_machine_learning_tpu_torch.interop import (
    params_from_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.models import mlp as tmlp
from simple_distributed_machine_learning_tpu_torch.parallel import Pipeline
from simple_distributed_machine_learning_tpu_torch.resilience import (
    CheckpointStore,
    RestartPolicy,
    faults,
    make_elastic_trainer,
    supervise,
)
from simple_distributed_machine_learning_tpu_torch.resilience.sentinel import (  # noqa: E501
    QuarantineJournal,
    Sentinel,
    SentinelConfig,
    SentinelExhausted,
    Snapshot,
    SnapshotRing,
    restore_state,
    state_leaves,
)
from simple_distributed_machine_learning_tpu_torch.telemetry import report
from simple_distributed_machine_learning_tpu_torch.telemetry.registry import (
    MetricsRegistry,
)
from simple_distributed_machine_learning_tpu_torch.train import (
    TrainConfig,
    Trainer,
    adamw,
    schedules,
    sgd,
)

DIMS = [12, 16, 14, 16, 10]
GPT = dict(vocab=32, seq_len=8, d_model=16, n_heads=2, n_layers=2)
TOL = dict(rtol=3e-5, atol=3e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread while this module runs (tiny models;
    more threads only contend under a multi-process test run)."""
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


def _mlp_ds():
    rng = np.random.RandomState(0)
    return (rng.randn(120, 12).astype(np.float32), rng.randint(0, 10, 120))


def _gpt_ds():
    rng = np.random.RandomState(0)
    x = rng.randint(0, GPT["vocab"], (120, GPT["seq_len"]))
    return x.astype(np.float32), np.roll(x, -1, 1)


def _jax_stages(model):
    if model == "mlp":
        return jmlp.make_mlp_stages(jax.random.key(0), DIMS, 1)
    return jgpt.make_gpt_stages(jax.random.key(0), jgpt.GPTConfig(**GPT), 1)


def _port_pipe(model="mlp"):
    """The port's one-card pipeline holding the JAX package's seed-0
    weights."""
    jst = _jax_stages(model)[0]
    nparams = jax.tree.map(np.asarray, [s.params for s in jst])
    if model == "mlp":
        st, wd, od = tmlp.make_mlp_stages(0, DIMS, 1, device="cpu")
    else:
        st, wd, od = tgpt.make_gpt_stages(0, tgpt.GPTConfig(**GPT), 1,
                                          device="cpu")
    st = [dataclasses.replace(st[0],
                              params=params_from_numpy(nparams, "cpu")[0])]
    return Pipeline(st, None, wd, od, device="cpu")


def _jax_pipe(model="mlp"):
    st, wd, od = _jax_stages(model)
    return JPipeline(st, jmake_mesh(n_stages=1, n_data=1,
                                    devices=jax.devices()[:1]), wd, od)


def _kw(**kw):
    base = dict(epochs=3, batch_size=30, print_throughput=False,
                sentinel=True, sentinel_snapshot_every=2, log_interval=100)
    base.update(kw)
    return base


def _port_run(spec=None, model="mlp", opt=None, **kw):
    ds = Dataset(*(_mlp_ds() if model == "mlp" else _gpt_ds()))
    if spec:
        faults.install(faults.FaultPlan.parse(spec))
    tr = Trainer(_port_pipe(model), ds, ds, TrainConfig(**_kw(**kw)),
                 opt=opt)
    try:
        tr.fit()
    finally:
        faults.uninstall()
    return tr


def _jax_run(spec=None, model="mlp", **kw):
    ds = JDataset(*(_mlp_ds() if model == "mlp" else _gpt_ds()))
    if spec:
        jfaults.install(jfaults.FaultPlan.parse(spec))
    tr = jtrainer.Trainer(_jax_pipe(model), ds, ds,
                          jtrainer.TrainConfig(**_kw(**kw)))
    try:
        tr.fit()
    finally:
        jfaults.uninstall()
    return tr


def _same_as_jax(ours, theirs):
    """Quarantine records, counters and observed steps equal; observed
    losses within the cross-framework tolerance."""
    a, b = ours.sentinel, theirs.sentinel
    assert a.journal.records == b.journal.records
    assert a.by_kind == b.by_kind
    assert (a.n_anomalies, a.n_rollbacks) == (b.n_anomalies, b.n_rollbacks)
    assert sorted(a.observed) == sorted(b.observed)
    np.testing.assert_allclose([a.observed[k] for k in sorted(a.observed)],
                               [b.observed[k] for k in sorted(b.observed)],
                               **TOL)


# ---------------------------------------------------------------------------
# the ring, the journal, the detector


def _snap(step, nbytes=100):
    return Snapshot(step=step, epoch=1, batch_idx=step, params=None,
                    opt_leaves=(), ewma=None, healthy=0, nbytes=nbytes)


def test_snapshot_ring_bound_and_lookup():
    ring = SnapshotRing(3)
    for s in (0, 2, 4, 6):
        ring.push(_snap(s))
    assert len(ring) == 3 and ring.bytes() == 300
    assert ring.newest_at_or_before(5).step == 4
    assert ring.newest_at_or_before(6).step == 6
    assert ring.newest_at_or_before(1) is None
    ring.push(_snap(6, nbytes=50))              # re-snapshot of one step
    assert len(ring) == 3 and ring.bytes() == 250


def test_quarantine_journal_roundtrip_and_torn_tail(tmp_path):
    path = str(tmp_path / "quarantine.jsonl")
    j = QuarantineJournal(path)
    j.add({"epoch": 2, "batch": 3, "step": 11, "kind": "nan", "value": None})
    j.add({"epoch": 1, "batch": 0, "step": 0, "kind": "spike", "value": 9.0})
    with open(path, "a") as f:
        f.write('{"epoch": 5, "ba')        # torn tail from a crash
    j2 = QuarantineJournal(path)
    assert len(j2) == 2
    assert j2.skip(2, 3) and j2.skip(1, 0) and not j2.skip(2, 4)


@pytest.mark.parametrize("kw,match", [
    (dict(window=1), "window"), (dict(snapshot_every=0), "snapshot_every"),
    (dict(ring_size=0), "ring_size"), (dict(spike_factor=1.0),
                                       "spike_factor")])
def test_sentinel_config_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        SentinelConfig(**kw)


@pytest.mark.parametrize("ring", [1, 3])
def test_rollback_budget_is_the_ring_size_as_in_the_jax_package(ring):
    """NaN steps one after another, within one window: ``ring_size``
    rollbacks are taken and the next anomaly escalates, after the same
    count in the JAX package's sentinel at its default budget."""
    from simple_distributed_machine_learning_tpu.resilience import (
        sentinel as jsentinel,
    )

    def drive(mod):
        sent = mod.Sentinel(mod.SentinelConfig(ring_size=ring, window=8))
        sent.ring.push(mod.Snapshot(step=0, epoch=1, batch_idx=0,
                                    params=None, opt_leaves=(), ewma=None,
                                    healthy=0, nbytes=0))
        for step in range(1, ring + 3):
            anomaly = sent.observe(step, 1, step, float("nan"))
            try:
                sent.rollback(anomaly)
            except mod.SentinelExhausted:
                return step, sent.n_rollbacks, len(sent.journal)
        return None

    ours = drive(sys.modules[Sentinel.__module__])
    assert ours == (ring + 1, ring, ring + 1)
    assert ours == drive(jsentinel)


def test_observe_ewma_excludes_anomalies():
    s = Sentinel(SentinelConfig(warmup_steps=2, spike_factor=2.0,
                                spike_margin=0.0))
    for i, loss in enumerate((1.0, 1.0, 1.0)):
        assert s.observe(i, 1, i, loss) is None
    assert s.observe(3, 1, 3, 5.0).kind == "spike"
    assert s.observe(4, 1, 4, 5.0).kind == "spike"   # not in the EWMA
    assert s.observe(5, 1, 5, float("nan")).kind == "nan"
    assert s.observe(6, 1, 6, 1.0, gnorm=float("inf")).kind == "inf"
    assert s.n_anomalies == 4 and sorted(s.observed) == [0, 1, 2]


def test_snapshot_is_a_copy_and_rollback_writes_the_live_tensors():
    """A snapshot survives in-place updates of the live state (a copy, not
    a view), and a rollback copies INTO the live tensors: the optimizer's
    state keeps pointing at the tensors the parameters are updated with,
    and its int step counter comes back from the snapshot."""
    pipe = _port_pipe()
    opt = adamw(1e-2)
    params = pipe.init_params()
    state = opt.init(params)
    sent = Sentinel(SentinelConfig(snapshot_every=1))
    sent.begin_epoch(1)
    assert sent.maybe_snapshot(0, 1, 0, params, state)
    x, y = (torch.from_numpy(a[:30]) for a in _mlp_ds())
    before = [t.clone() for t in state_leaves(state)[1:]]
    loss, grads = pipe.loss_and_grads(params, x, y)
    params, state = opt.update(grads, state, params)
    assert state[0] == 1
    snap = sent.ring.newest_at_or_before(0)
    live = state_leaves(state)
    state = restore_state(state, snap.opt_leaves)
    assert state[0] == 0
    assert all(a is b for a, b in zip(state_leaves(state)[1:], live[1:]))
    for a, b in zip(state_leaves(state)[1:], before):
        assert torch.equal(a, b)
    # the JAX gauge's bytes: params, m, v (f32) and the int32 counter
    n = sum(p.numel() for p in params[0].parameters())
    assert snap.nbytes == 3 * 4 * n + 4


# ---------------------------------------------------------------------------
# THE acceptance pin and its cross-package twin


def test_nan_grad_rollback_bit_exact_vs_clean_run_and_equal_to_jax(tmp_path):
    dirty, clean = str(tmp_path / "dirty"), str(tmp_path / "clean")
    tr = _port_run("nan-grad@train.grad=6", checkpoint_dir=dirty)
    assert tr.sentinel.n_anomalies == 1 and tr.sentinel.n_rollbacks == 1
    [q] = tr.sentinel.journal.records
    assert (q["step"], q["kind"], q["epoch"], q["batch"]) == (6, "nan", 2, 2)
    os.makedirs(clean)
    with open(os.path.join(dirty, "quarantine.jsonl")) as f, \
            open(os.path.join(clean, "quarantine.jsonl"), "w") as g:
        g.write(f.read())
    ref = _port_run(checkpoint_dir=clean)
    assert ref.sentinel.n_anomalies == 0 and ref.sentinel.n_rollbacks == 0
    assert tr.sentinel.observed == ref.sentinel.observed      # exact
    assert len(tr.sentinel.observed) == 11
    for a, b in zip(tr.params[0].parameters(), ref.params[0].parameters()):
        assert torch.equal(a, b)
    _same_as_jax(tr, _jax_run("nan-grad@train.grad=6"))


def test_corrupt_batch_quarantine_deterministic_and_equal_to_jax():
    runs = [_port_run("corrupt-batch@data.batch=5") for _ in range(2)]
    a, b = (dict(r.sentinel.observed) for r in runs)
    assert a == b
    assert (runs[0].sentinel.journal.records
            == runs[1].sentinel.journal.records)
    [q] = runs[0].sentinel.journal.records
    assert q["step"] == 5 and q["kind"] in ("nan", "inf")
    assert (q["epoch"], q["batch"]) == (2, 1)
    _same_as_jax(runs[0], _jax_run("corrupt-batch@data.batch=5"))


@pytest.mark.parametrize("factor,caught", [(3.0, False), (1.5, True)])
def test_loss_spike_detected_rolled_back_and_equal_to_jax(factor, caught):
    """``loss-spike@train.step=10`` scales the batch by 100: step 10's loss
    is about 5.18 against an EWMA near 2.29. At the default spike factor
    3 the threshold, 3 x (EWMA + 0.25), lies above it and neither package
    trips (the JAX suite's own pin of a spike here fails on this tree);
    at factor 1.5 both catch it as a spike, roll back and quarantine."""
    tr = _port_run("loss-spike@train.step=10", sentinel_spike_factor=factor)
    ref = _jax_run("loss-spike@train.step=10", sentinel_spike_factor=factor)
    if not caught:
        assert tr.sentinel.by_kind == {} and tr.sentinel.observed[10] > 5
        _same_as_jax(tr, ref)
        return
    assert tr.sentinel.by_kind == {"spike": 1}
    assert tr.sentinel.n_rollbacks == 1
    [q] = tr.sentinel.journal.records
    assert q["step"] == 10 and q["kind"] == "spike"
    [r] = ref.sentinel.journal.records
    assert q["value"] == pytest.approx(r["value"], rel=3e-5)
    q["value"] = r["value"]
    _same_as_jax(tr, ref)


def test_loss_spike_no_false_positive_on_warmup_run():
    tr = _port_run(opt=sgd(schedules.warmup_cosine(0.1, 6, 12), 0.5))
    assert tr.sentinel.n_anomalies == 0 and tr.sentinel.n_rollbacks == 0
    assert len(tr.sentinel.observed) == 12


def test_numeric_fault_without_sentinel_fails_loudly():
    with pytest.raises(faults.NumericFault):
        _port_run("nan-grad@train.grad=0", sentinel=False, epochs=1)


# ---------------------------------------------------------------------------
# the GPT: numeric faults through the float token wire and the gather


@pytest.mark.parametrize("spec,by_kind,record", [
    # NaN ids become id 0: the step trains on it and nothing trips
    ("nan-grad@train.grad=6", {}, None),
    # ids scaled past the vocab give NaN rows: a NaN loss
    ("corrupt-batch@data.batch=5", {"nan": 1}, (5, "nan", 2, 1)),
    ("loss-spike@train.step=10", {"nan": 1}, (10, "nan", 3, 2))])
def test_gpt_numeric_faults_equal_the_jax_package(spec, by_kind, record):
    tr = _port_run(spec, model="gpt")
    assert tr.sentinel.by_kind == by_kind
    recs = [(q["step"], q["kind"], q["epoch"], q["batch"])
            for q in tr.sentinel.journal.records]
    assert recs == ([] if record is None else [record])
    ref = _jax_run(spec, model="gpt")
    _same_as_jax(tr, ref)
    if record is None:
        # the undetected step trained on id 0, not on the batch a clean
        # run sees: its loss differs from the clean run's
        clean = _port_run(model="gpt")
        assert clean.sentinel.observed[6] != tr.sentinel.observed[6]
        assert clean.sentinel.observed[5] == tr.sentinel.observed[5]


# ---------------------------------------------------------------------------
# the ring's memory bound, escalation, preemption, the records


def test_snapshot_ring_memory_bound_and_gauge():
    reg = MetricsRegistry()
    ds = Dataset(*_mlp_ds())
    tr = Trainer(_port_pipe(), ds, ds,
                 TrainConfig(**_kw(sentinel_snapshot_every=1,
                                   sentinel_ring=3)))
    tr.sentinel.registry = reg
    tr.fit()
    sent = tr.sentinel
    per = sum(4 * p.numel() for p in tr.params[0].parameters()) * 2
    assert len(sent.ring) == 3 and sent.ring.bytes() == 3 * per
    assert reg.gauge("train_snapshot_ring_bytes").value == sent.ring.bytes()
    # the same bytes as the JAX package's ring (packed buffer + momentum)
    jds = JDataset(*_mlp_ds())
    jtr = jtrainer.Trainer(_jax_pipe(), jds, jds, jtrainer.TrainConfig(
        **_kw(sentinel_snapshot_every=1, sentinel_ring=3)))
    jtr.fit()
    assert jtr.sentinel.ring.bytes() == sent.ring.bytes()


def test_ring_exhaustion_raises_sentinel_exhausted():
    with pytest.raises(SentinelExhausted, match="exceed"):
        _port_run("nan-grad@train.grad,times=0")


def test_escalation_recovers_through_elastic_supervisor(tmp_path):
    ds = Dataset(*_mlp_ds())
    store = CheckpointStore(str(tmp_path), keep=4)
    faults.install(faults.FaultPlan.parse("nan-grad@train.grad,times=6"))
    cfg = TrainConfig(**_kw())
    report_ = supervise(
        lambda n: make_elastic_trainer(lambda n: _port_pipe(), n, store, ds,
                                       ds, cfg),
        (1,), policy=RestartPolicy(max_restarts=2), sleep=lambda s: None)
    assert report_["completed"] and report_["restarts"] == 1
    a1, a2 = report_["attempts"]
    assert a1["outcome"] == "fault" and a1["fault"] == "SentinelExhausted"
    assert a1["sentinel"]["rollbacks"] >= 1
    assert a1["sentinel"]["anomalies"] > a1["sentinel"]["rollbacks"]
    assert a2["outcome"] == "completed"
    assert os.path.exists(os.path.join(str(tmp_path), "quarantine.jsonl"))


def test_preempt_fault_graceful_stop_and_bit_exact_resume(tmp_path):
    ref = _port_run()
    ck, mpath = str(tmp_path / "ck"), str(tmp_path / "m.jsonl")
    p1 = _port_run("preempt@train.sigterm=5", checkpoint_dir=ck,
                   metrics_json=mpath)
    recs = [json.loads(line) for line in open(mpath)]
    assert recs[-1]["preempted"] is True and recs[-1]["step"] == 5
    assert recs[-1]["rollbacks"] == 0 and "anomaly_events" in recs[-1]
    assert p1.preempted and p1._step_count == 5
    meta = json.load(open(os.path.join(ck, "state.npz.meta.json")))
    assert meta["extra"]["epoch"] == 1 and meta["extra"]["next_batch"] == 1
    assert meta["extra"]["sentinel"]["healthy"] == 5
    ds = Dataset(*_mlp_ds())
    p2 = Trainer(_port_pipe(), ds, ds, TrainConfig(**_kw(checkpoint_dir=ck)))
    assert p2.start_epoch == 2 and p2._resume_batch_idx == 1
    assert p2.sentinel.detector_state() == meta["extra"]["sentinel"]
    p2.fit()
    merged = dict(p1.sentinel.observed)
    merged.update(p2.sentinel.observed)
    assert merged == ref.sentinel.observed
    for a, b in zip(p2.params[0].parameters(), ref.params[0].parameters()):
        assert torch.equal(a, b)


def test_epoch_records_carry_the_block_and_the_report_renders_it(tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    tr = _port_run("nan-grad@train.grad=6", metrics_json=path)
    records = [json.loads(line) for line in open(path)]
    assert records[-1]["rollbacks"] == 1 and records[-1]["anomalies"] == 1
    assert records[-1]["quarantined_batches"] == 1
    assert records[-1]["snapshot_ring_bytes"] > 0
    assert records[-1]["sentinel_run"] == tr.sentinel.run_id
    ev = [e for r in records for e in r.get("anomaly_events", [])]
    assert [(e["step"], e["kind"]) for e in ev] == [(6, "nan")]
    assert tr.sentinel.drain_events() == []
    # the report CLI reads the training block from epoch records
    with open(path) as f, open(str(tmp_path / "m2.jsonl"), "w") as g:
        for line in f:
            g.write(json.dumps({**json.loads(line), "kind": "epoch"}) + "\n")
    os.replace(str(tmp_path / "m2.jsonl"), path)
    collected = report.collect(str(tmp_path))
    assert collected["sentinel"]["rollbacks"] == 1
    assert [e["step"] for e in collected["sentinel"]["events"]] == [6]
    text = report.render(collected)
    assert "self-healing: 1 anomaly" in text and "anomaly @step 6" in text
