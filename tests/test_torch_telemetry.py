"""The port's training telemetry (``telemetry/{bubble,timer,memory,
session}.py``, ``utils/profiler.py``) against the JAX package's, on the
CPU.

The bubble model and the ``StepTimer`` are pure arithmetic: equal to the
JAX functions exactly on the same inputs. The session is held through the
Trainer: a port Trainer and a JAX Trainer (one-stage mesh, the same
weights through ``interop``) write ``metrics.jsonl`` records with the same
key set, the same step accounting and bubble fields, and losses within
the tolerances of ``tests/test_torch_trainer.py``; timings only have to be
positive and ordered. The JAX Trainer with a session attached dies at its
first batch on this tree (``train/trainer.py`` imports ``abstractify``
from ``analysis``, which raises ``ImportError``), so the JAX side runs with
two in-process patches: ``analysis.abstractify`` as the identity and
``Telemetry.set_step_probe`` as a no-op (the JAX record has no ``ici_*``
keys without one). No file changes. The port's probe runs: its record adds
the two keys of the static collective-bytes gauge, ``ici_bytes_per_step``
(0: the one-card mesh has no collective) and ``ici_top_collectives``
(empty).
"""

import dataclasses
import gc
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu import analysis as janalysis
from simple_distributed_machine_learning_tpu import make_mesh
from simple_distributed_machine_learning_tpu import telemetry as jtm
from simple_distributed_machine_learning_tpu.models import mlp as jmlp
from simple_distributed_machine_learning_tpu.parallel.pipeline import (
    Pipeline as JaxPipeline,
)
from simple_distributed_machine_learning_tpu.resilience import (
    CheckpointStore as JStore,
    faults as jfaults,
    make_elastic_trainer as jmake_elastic_trainer,
    supervise as jsupervise,
)
from simple_distributed_machine_learning_tpu.telemetry import (
    bubble as jbubble,
)
from simple_distributed_machine_learning_tpu.telemetry import (
    registry as jregistry,
)
from simple_distributed_machine_learning_tpu.train import trainer as jtrainer
from simple_distributed_machine_learning_tpu_torch import telemetry as tm
from simple_distributed_machine_learning_tpu_torch.data.mnist import (
    Dataset,
    synthetic_mnist,
)
from simple_distributed_machine_learning_tpu_torch.interop import (
    params_from_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import mlp as tmlp
from simple_distributed_machine_learning_tpu_torch.parallel import Pipeline
from simple_distributed_machine_learning_tpu_torch.resilience import (
    CheckpointStore,
    faults,
    make_elastic_trainer,
    supervise,
)
from simple_distributed_machine_learning_tpu_torch.telemetry import (
    bubble as tbubble,
)
from simple_distributed_machine_learning_tpu_torch.telemetry import (
    memory as tmemory,
)
from simple_distributed_machine_learning_tpu_torch.train import (
    TrainConfig,
    Trainer,
)
from simple_distributed_machine_learning_tpu_torch.utils.profiler import (
    trace,
)

DIMS = [784, 32, 10]
TRAIN_RE = re.compile(r"^Train Epoch: .*Loss: (\d+\.\d{6})$")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread while this module runs: its models are
    tiny, and under a multi-process test run more threads only contend
    for the same cores. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_telemetry_runs(monkeypatch):
    """The two in-process patches that let the JAX Trainer run a session
    on this tree (module docstring)."""
    monkeypatch.setattr(janalysis, "abstractify", lambda a: a, raising=False)
    monkeypatch.setattr(jtm.Telemetry, "set_step_probe",
                        lambda self, *a, **k: None)


@pytest.fixture
def _no_leftover_plan():
    faults.uninstall()
    jfaults.uninstall()
    yield
    faults.uninstall()
    jfaults.uninstall()


# -- the bubble model and the StepTimer ----------------------------------------

@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_bubble_functions_equal_the_jax_ones_over_a_grid(schedule):
    for s in range(1, 9):
        for m in (1, 2, 3, 4, 8, 16):
            frac = tbubble.schedule_bubble_fraction(s, m, schedule)
            assert frac == jbubble.schedule_bubble_fraction(s, m, schedule)
            assert tbubble.ideal_step_time(0.37, s, m, schedule) \
                == jbubble.ideal_step_time(0.37, s, m, schedule)
            for measured, ideal in ((0.5, 0.4), (0.2, 0.3), (1.0, 1.0)):
                assert tbubble.measured_bubble_fraction(measured, ideal) \
                    == jbubble.measured_bubble_fraction(measured, ideal)
                assert tbubble.bubble_drift(s, m, schedule, measured, ideal) \
                    == jbubble.bubble_drift(s, m, schedule, measured, ideal)
    assert tbubble.schedule_bubble_fraction(4, 8, schedule) \
        == pytest.approx(3 / 11)
    with pytest.raises(ValueError, match="unknown schedule"):
        tbubble.schedule_bubble_fraction(2, 2, "interleaved")
    with pytest.raises(ValueError, match="step times"):
        tbubble.measured_bubble_fraction(0.0, 1.0)


WINDOWS = {
    # (seconds, steps, examples, tokens) per window; the first is compile
    "weighted": [(10.0, 1, 0, 0), (1.0, 10, 100, 0), (0.2, 1, 10, 0)],
    "tokens": [(0.31, 1, 8, 512), (0.0123, 1, 8, 512), (0.0456, 3, 24, 1536),
               (0.0101, 1, 8, 512), (0.0, 0, 0, 0), (0.099, 5, 40, 2560)],
    "compile_only": [(0.5, 1, 60, 0)],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(WINDOWS))
def test_step_timer_summary_equals_the_jax_timer(case):
    ours, theirs = tm.StepTimer(), jtm.StepTimer()
    for sec, steps, ex, tok in WINDOWS[case]:
        ours.record_window(sec, steps=steps, examples=ex, tokens=tok)
        theirs.record_window(sec, steps=steps, examples=ex, tokens=tok)
    assert ours.summary() == theirs.summary()
    assert ours.steps == theirs.steps
    assert ours.compile_time_s == theirs.compile_time_s
    for q in (0.5, 0.95):
        assert ours.quantile_ms(q) == theirs.quantile_ms(q)
    assert (ours.examples_per_sec, ours.tokens_per_sec) \
        == (theirs.examples_per_sec, theirs.tokens_per_sec)


def test_telemetry_every_validates(tmp_path):
    with pytest.raises(ValueError, match="every"):
        tm.Telemetry(str(tmp_path / "t"), every=0)
    assert not (tmp_path / "t").exists()


def test_compiled_cost_stats_best_effort():
    a = torch.ones(32, 32)
    assert tm.compiled_cost_stats(lambda x: (x @ x).sum(), a) \
        == {"flops": 2.0 * 32 ** 3}

    def broken(x):
        raise RuntimeError("no cost model")
    assert tm.compiled_cost_stats(broken, a) is None      # never raises


def test_memory_sample_counts_each_storage_once():
    gc.collect()                # no cyclic garbage to vanish mid-measure
    base = tm.live_array_bytes()
    held = torch.zeros(25_000)                      # 100,000 bytes
    views = [held[10:], held.view(250, 100), torch.nn.Parameter(held)]
    gc.collect()
    assert tm.live_array_bytes() - base == 100_000
    assert tmemory.device_memory_stats() == {}      # no card here
    reg = tm.MetricsRegistry()
    rec = tmemory.sample(reg)
    assert set(rec) == {"live_array_bytes"} and rec["live_array_bytes"] > 0
    assert reg.gauge("live_array_bytes").value == rec["live_array_bytes"]
    del held, views


# -- the session through the Trainer, against the JAX Trainer ------------------

def _data(n_train=360, n_test=60):
    tr, te = synthetic_mnist(n_train=n_train, n_test=n_test, seed=7)
    return (Dataset(tr.x.reshape(len(tr.x), -1), tr.y),
            Dataset(te.x.reshape(len(te.x), -1), te.y))


def _port_pipe():
    jst = jmlp.make_mlp_stages(jax.random.key(0), DIMS, 1)[0]
    nparams = jax.tree.map(np.asarray, [s.params for s in jst])
    stages, wd, od = tmlp.make_mlp_stages(0, DIMS, 1, device="cpu")
    stages = [dataclasses.replace(stages[0],
                                  params=params_from_numpy(nparams,
                                                           "cpu")[0])]
    return Pipeline(stages, None, wd, od, device="cpu")


def _jax_pipe():
    jst, wd, od = jmlp.make_mlp_stages(jax.random.key(0), DIMS, 1)
    return JaxPipeline(jst, make_mesh(n_stages=1, n_data=1), wd, od)


def _records(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f]


def _cfg(tmp_path, name, **kw):
    return dict(epochs=2, batch_size=60, print_throughput=False,
                metrics_json=str(tmp_path / f"{name}_v2.jsonl"), **kw)


#: the keys the port's step probe adds to each epoch record (the JAX
#: side's probe is patched out: module docstring)
ICI_KEYS = {"ici_bytes_per_step", "ici_top_collectives"}


def _same_records(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert set(a) == set(b) | ICI_KEYS, set(a) ^ (set(b) | ICI_KEYS)
        assert a["ici_bytes_per_step"] == 0
        assert a["ici_top_collectives"] == []
        for key in ("kind", "epoch", "step", "steps", "n_stages",
                    "n_microbatches", "schedule", "bubble_fraction",
                    "correct", "n_eval", "schema"):
            assert a[key] == b[key], key
        assert a["bubble_fraction"] == 0.0
        assert a["train_loss"] == pytest.approx(b["train_loss"], rel=1e-5,
                                                abs=1e-6)
        assert a["eval_loss"] == pytest.approx(b["eval_loss"], abs=1.5e-4)
        assert a["accuracy"] == pytest.approx(b["accuracy"], abs=2e-2)
        assert a["compile_time_s"] > 0
        assert 0 < a["step_time_ms_p50"] <= a["step_time_ms_p95"] \
            <= a["step_time_ms_max"]
        assert a["examples_per_sec"] > 0 and a["live_array_bytes"] > 0


@pytest.mark.parametrize("every,steps", [(1, [5, 11]), (3, [5, 11])])
def test_trainer_records_match_the_jax_trainer(tmp_path, jax_telemetry_runs,
                                               every, steps):
    """6 batches per epoch: the first is the compile window, so epoch 1
    counts 5 steady steps at any ``every`` (at 3: the (2, 3) and (4, 5, 6)
    windows), and epoch 2 adds its 6 (its first batch force-fenced)."""
    train, test = _data()
    jt = jtm.Telemetry(str(tmp_path / "jax"), every=every)
    jtrainer.Trainer(_jax_pipe(), train, test,
                     jtrainer.TrainConfig(**_cfg(tmp_path, "jax")),
                     telemetry=jt).fit()
    pt = tm.Telemetry(str(tmp_path / "port"), every=every)
    Trainer(_port_pipe(), train, test, TrainConfig(**_cfg(tmp_path, "port")),
            telemetry=pt).fit()
    ours = _records(tmp_path / "port" / tm.METRICS_FILE)
    theirs = _records(tmp_path / "jax" / jtm.METRICS_FILE)
    _same_records(ours, theirs)
    assert [r["steps"] for r in ours] == steps
    # the --metrics-json stream rides along, schema-versioned
    v2 = _records(tmp_path / "port_v2.jsonl")
    assert [r["epoch"] for r in v2] == [1, 2]
    assert all(r["schema"] == 2 and "accuracy" in r for r in v2)


def test_artifacts_and_help_lines_equal_the_jax_exposition(tmp_path):
    pt = tm.Telemetry(str(tmp_path / "tele"))
    Trainer(_port_pipe(), *_data(240), TrainConfig(**_cfg(tmp_path, "p")),
            telemetry=pt).fit()
    with open(tmp_path / "tele" / tm.TRACE_FILE) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"feed", "step", "eval", "epoch_end"} <= names
    with open(tmp_path / "tele" / tm.PROM_FILE) as f:
        prom = f.read()
    assert "# TYPE step_time_ms summary" in prom
    assert "epochs_total 2" in prom and "train_steps_total 8" in prom
    # the # HELP text of the training series equals the JAX exposition's
    names = ("step_time_ms", "epochs_total", "bubble_fraction",
             "examples_per_sec", "tokens_per_sec", "train_rollbacks_total",
             "train_quarantined_batches_total", "train_snapshot_ring_bytes",
             "train_preempt_graceful")
    ours, theirs = tm.MetricsRegistry(), jregistry.MetricsRegistry()
    for reg in (ours, theirs):
        for name in names:
            reg.gauge(name).set(1)
        reg.counter("train_anomalies_total", labels={"kind": "nan"}).inc()

    def helps(text):
        return sorted(ln for ln in text.splitlines()
                      if ln.startswith("# HELP"))
    assert helps(ours.prometheus_text()) == helps(theirs.prometheus_text())
    assert len(helps(ours.prometheus_text())) == len(names) + 1
    assert [ln for ln in helps(prom) if "step_time_ms" in ln] \
        == [ln for ln in helps(theirs.prometheus_text())
            if "step_time_ms" in ln]


def test_telemetry_none_leaves_console_and_trajectory_unchanged(tmp_path,
                                                                capsys):
    cfg = dict(epochs=1, batch_size=60, log_interval=1,
               print_throughput=False)
    Trainer(_port_pipe(), *_data(240), TrainConfig(**cfg)).fit()
    plain = capsys.readouterr().out
    Trainer(_port_pipe(), *_data(240), TrainConfig(**cfg),
            telemetry=tm.Telemetry(str(tmp_path / "tele"))).fit()
    traced = capsys.readouterr().out
    assert plain == traced
    assert len([ln for ln in plain.split("\n") if TRAIN_RE.match(ln)]) == 4
    assert [p.name for p in tmp_path.iterdir()] == ["tele"]


@pytest.mark.usefixtures("_no_leftover_plan")
def test_elastic_trainer_keeps_one_session_across_a_restart(
        tmp_path, jax_telemetry_runs):
    """A host-kill at step 6 (mid-epoch 2 of 4-step epochs): one session
    passed to every attempt holds epochs 1, 2 and 3, the same records the
    JAX supervisor writes from the same weights."""
    train, test = _data(240, 60)
    cfg = dict(epochs=3, batch_size=60, print_throughput=False)
    pt = tm.Telemetry(str(tmp_path / "port"))
    jt = jtm.Telemetry(str(tmp_path / "jax"))
    faults.install(faults.FaultPlan.parse("host-kill@train.step=6"))
    report = supervise(lambda n: make_elastic_trainer(
        lambda _: _port_pipe(), n, CheckpointStore(str(tmp_path / "ps")),
        train, test, TrainConfig(**cfg), telemetry=pt), (1,),
        sleep=lambda s: None)
    jfaults.install(jfaults.FaultPlan.parse("host-kill@train.step=6"))
    jreport = jsupervise(lambda n: jmake_elastic_trainer(
        lambda _: _jax_pipe(), n, JStore(str(tmp_path / "js")),
        train, test, jtrainer.TrainConfig(**cfg), telemetry=jt), (1,),
        sleep=lambda s: None)
    assert report["restarts"] == jreport["restarts"] == 1
    ours = _records(tmp_path / "port" / tm.METRICS_FILE)
    assert [r["epoch"] for r in ours] == [1, 2, 3]
    _same_records(ours, _records(tmp_path / "jax" / jtm.METRICS_FILE))


# -- the profiler on torch.profiler --------------------------------------------

def test_profiler_trace_disabled_and_bad_logdir(tmp_path, capsys):
    with trace(str(tmp_path / "off"), enabled=False) as d:
        assert d is None                    # nothing created, nothing started
    assert not (tmp_path / "off").exists()
    blocker = tmp_path / "a_file"
    blocker.write_text("not a dir")
    with trace(str(blocker / "sub")) as d:  # makedirs must fail
        assert d is None                    # degraded to disabled, no raise
    assert "cannot create trace dir" in capsys.readouterr().err


def _files(d):
    return [f for _, _, fs in os.walk(d) for f in fs]


def test_profiler_trace_no_leak_on_body_exception(tmp_path):
    with pytest.raises(RuntimeError, match="boom"):
        with trace(str(tmp_path / "t1")):
            torch.ones(8, 8) @ torch.ones(8, 8)
            raise RuntimeError("boom")
    # the first capture was stopped despite the exception: a fresh one starts
    with trace(str(tmp_path / "t2")) as d:
        assert d == str(tmp_path / "t2")
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert _files(tmp_path / "t1") and _files(tmp_path / "t2")


def test_profiler_nested_trace_keeps_the_outer_capture(tmp_path):
    with trace(str(tmp_path / "outer")) as outer:
        assert outer == str(tmp_path / "outer")
        with trace(str(tmp_path / "inner")) as inner:
            assert inner is None
            torch.ones(8, 8) @ torch.ones(8, 8)
        torch.ones(4, 4) @ torch.ones(4, 4)
    [name] = _files(tmp_path / "outer")
    with open(tmp_path / "outer" / name) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert not _files(tmp_path / "inner")
