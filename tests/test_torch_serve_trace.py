"""Request tracing, the flight recorder, post-mortem bundles and the report
CLI of the PyTorch port, pinned as the JAX package pins them
(``tests/test_serve_trace.py``), and crash-serve's timeline held row for
row against the JAX package's.

The port runs on the CPU (``device="cpu"``) with the scenario model of
``tests/test_scenarios.py`` (2 stages, weights from ``jax.random.key(0)``
carried over by ``interop.params_from_numpy``). The JAX engine's metered
tick calls its analyzer's byte model (``kv_drift``), whose module does not
import on this tree; the JAX side runs with that one method patched to
``(0, 0)`` (it only feeds a gauge).
"""

import dataclasses
import hashlib
import json
import os

import jax
import numpy as np
import pytest

from simple_distributed_machine_learning_tpu.models import gpt as jgpt
from simple_distributed_machine_learning_tpu.resilience import (
    faults as jfaults,
)
from simple_distributed_machine_learning_tpu.resilience import (
    scenarios as jscen,
)
from simple_distributed_machine_learning_tpu.serve.engine import (
    InferenceEngine as JaxEngine,
)
from simple_distributed_machine_learning_tpu_torch.interop import (
    params_from_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.resilience import faults
from simple_distributed_machine_learning_tpu_torch.resilience.scenarios import (  # noqa: E501
    VirtualClock,
    run_scenario,
)
from simple_distributed_machine_learning_tpu_torch.serve import (
    DrainTimeout,
    FlightRecorder,
    InferenceEngine,
    PriorityScheduler,
    ServeMetrics,
    ServeSupervisor,
    ServeTrace,
    engine_factory,
)
from simple_distributed_machine_learning_tpu_torch.serve.flight import (
    write_bundle,
)
from simple_distributed_machine_learning_tpu_torch.serve.journal import (
    read_journal,
)
from simple_distributed_machine_learning_tpu_torch.telemetry import report

KW = dict(vocab=32, seq_len=48, d_model=32, n_heads=2, n_layers=2)
CFG = tgpt.GPTConfig(**KW)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread while this module runs: its models are
    tiny, and under a multi-process test run more threads only contend
    for the same cores. Restored afterwards."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """``(jax_cfg, jax_stages, port_stages)`` over one set of weights."""
    jcfg = jgpt.GPTConfig(**KW)
    jst = jgpt.make_gpt_stages(jax.random.key(0), jcfg, 2)[0]
    nparams = jax.tree.map(np.asarray, [s.params for s in jst])
    tst = tgpt.make_gpt_stages(0, CFG, 2, device="cpu")[0]
    tst = [dataclasses.replace(s, params=p)
           for s, p in zip(tst, params_from_numpy(nparams, "cpu"))]
    return jcfg, jst, tst


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.setattr(JaxEngine, "kv_drift", lambda self: (0, 0))
    faults.uninstall()
    jfaults.uninstall()
    yield
    faults.uninstall()
    jfaults.uninstall()


def _prompt(n, seed, first=None):
    p = np.random.default_rng(seed).integers(0, CFG.vocab, n).astype(
        np.int32)
    if first is not None:
        p[0] = first            # distinct first tokens: no prefix sharing
    return p


def _factory(tst, **kw):
    return engine_factory(tst, CFG, device="cpu", **kw)


def _span_balance(events):
    """(orphan ends, unclosed begins) over a Chrome trace's async b/e
    events."""
    open_count: dict = {}
    orphans = []
    for e in events:
        key = (e.get("cat"), e.get("id"), e["name"])
        if e["ph"] == "b":
            open_count[key] = open_count.get(key, 0) + 1
        elif e["ph"] == "e":
            if open_count.get(key, 0) < 1:
                orphans.append(e)
            else:
                open_count[key] -= 1
    return orphans, {k: v for k, v in open_count.items() if v}


# -- the engine's trace sites -------------------------------------------------


def test_engine_trace_covers_request_lifecycle(model, tmp_path):
    trace = ServeTrace(outdir=str(tmp_path))
    eng = InferenceEngine(model[2], CFG, n_slots=2, block_size=4,
                          prefill_chunk=3, trace=trace, device="cpu")
    h = eng.submit(_prompt(7, 1, first=0), max_new_tokens=4, seed=1)
    eng.submit(_prompt(5, 2, first=1), max_new_tokens=3, seed=2)
    eng.drain()
    trace.close()
    rows = [json.loads(line)
            for line in open(tmp_path / "request_timeline.jsonl")]
    evs_h = [r["ev"] for r in rows if r.get("rid") == h.rid]
    assert evs_h[0] == "submit" and evs_h[-1] == "done"
    assert "admit" in evs_h and "first_token" in evs_h
    assert evs_h.count("prefill_chunk") == 3          # ceil(7/3)
    assert evs_h.count("tick") == 3                   # tokens 2..4
    ts = [r["t"] for r in rows if r.get("rid") == h.rid]
    assert ts == sorted(ts)
    doc = json.load(open(tmp_path / "serve_trace.json"))
    orphans, unclosed = _span_balance(doc["traceEvents"])
    assert not orphans and not unclosed
    assert all(e["pid"] == 0 for e in doc["traceEvents"])


def test_trace_preempt_resume_and_shed_events(model):
    trace = ServeTrace()
    eng = InferenceEngine(model[2], CFG, n_slots=1, block_size=4,
                          scheduler=PriorityScheduler, trace=trace,
                          device="cpu")
    low = eng.submit(_prompt(4, 1, first=0), max_new_tokens=10, seed=1,
                     cls="batch", priority=0)
    for _ in range(3):
        eng.step()
    eng.submit(_prompt(4, 2, first=1), max_new_tokens=3, seed=2,
               cls="interactive", priority=2)
    for _ in range(6):
        eng.step()
    eng.cancel(low.rid, "deadline")
    eng.drain()
    evs = [(r["ev"], r.get("rid")) for r in trace.rows]
    assert ("preempt", low.rid) in evs
    assert ("resume", low.rid) in evs
    assert ("shed", low.rid) in evs
    orphans, unclosed = _span_balance(
        trace.to_chrome_trace()["traceEvents"])
    assert not orphans and not unclosed


@pytest.mark.parametrize("kv_layout", ["paged", "dense"])
def test_tracing_does_not_perturb_virtual_clock_metrics(model, kv_layout):
    """The recorder reads no clock: one virtual-clock workload gives the
    same summary with tracing on and off, on both layouts."""
    paged = (dict(block_size=4, prefill_chunk=3) if kv_layout == "paged"
             else dict(kv_layout="dense"))

    def run(trace):
        clock = VirtualClock()
        metrics = ServeMetrics(clock=clock)
        eng = InferenceEngine(model[2], CFG, n_slots=2, metrics=metrics,
                              clock=clock, trace=trace, device="cpu",
                              **paged)
        for i in range(4):
            eng.submit(_prompt(5 + i, i, first=i), max_new_tokens=5,
                       seed=i)
        eng.drain()
        return metrics.summary()

    trace = ServeTrace()
    assert run(None) == run(trace)
    assert trace.n_events > 0


# -- crash-serve: spans join across the restart --------------------------------


def test_crash_serve_trace_spans_the_restart(model, tmp_path):
    trace = ServeTrace(outdir=str(tmp_path), suffix="-crash-serve")
    rep = run_scenario("crash-serve", model[2], CFG, trace=trace,
                       device="cpu")
    assert rep["slo_ok"] and rep["all_completed"] and rep["restarts"] == 1
    assert rep["slo"]["interactive"]["ttft_ms_p95"] == 23.16
    assert rep["trace_events"] == trace.n_events == 208
    rows = trace.rows
    crashed = {r["rid"] for r in rows if r["ev"] == "crash"}
    assert crashed
    rid = sorted(crashed)[0]
    evs = [r["ev"] for r in rows if r.get("rid") == rid]
    assert evs.index("submit") < evs.index("crash") \
        < evs.index("readmit") < evs.index("done")
    assert {r["inc"] for r in rows if r.get("rid") == rid} == {0, 1}
    orphans, unclosed = _span_balance(
        trace.to_chrome_trace()["traceEvents"])
    assert not orphans and not unclosed
    trace.close()


def test_crash_serve_timeline_equals_the_jax_packages(model):
    """Row for row, the port's crash-serve timeline equals the JAX
    package's on ``ev``, ``rid``, ``inc`` and ``t`` (virtual seconds)."""
    jcfg, jst, tst = model
    from simple_distributed_machine_learning_tpu.serve import (
        ServeTrace as JaxServeTrace,
    )
    jtrace, ttrace = JaxServeTrace(), ServeTrace()
    jscen.run_scenario("crash-serve", jst, jcfg, trace=jtrace)
    run_scenario("crash-serve", tst, CFG, trace=ttrace, device="cpu")
    pick = (lambda rows: [(r["ev"], r["rid"], r["inc"], r["t"])
                          for r in rows])
    assert pick(ttrace.rows) == pick(jtrace.rows)
    assert len(ttrace.rows) == 208


def test_virtual_clock_trace_byte_identical_across_runs(model, tmp_path):
    digests = []
    for run_dir in ("a", "b"):
        d = tmp_path / run_dir
        run_scenario("crash-serve", model[2], CFG, outdir=str(d),
                     trace=True, device="cpu")
        digests.append(tuple(
            hashlib.sha256(open(d / name, "rb").read()).hexdigest()
            for name in ("serve_trace-crash-serve.json",
                         "request_timeline-crash-serve.jsonl")))
    assert digests[0] == digests[1]


def test_cold_restart_timeline_appends_under_same_rid(model, tmp_path):
    jpath = str(tmp_path / "journal.jsonl")
    trace1 = ServeTrace(outdir=str(tmp_path))
    kw = dict(n_slots=2, block_size=4, prefill_chunk=3)
    sup = ServeSupervisor(_factory(model[2], **kw), jpath, trace=trace1)
    h = sup.submit(_prompt(5, 1, first=0), max_new_tokens=6, seed=1)
    for _ in range(4):
        sup.step()
    mid = list(h.tokens)
    assert 0 < len(mid) < 6
    sup.close()                 # the process "dies" mid-request
    trace1.close()
    trace2 = ServeTrace(outdir=str(tmp_path), fresh=False)
    sup2 = ServeSupervisor(_factory(model[2], **kw), jpath, trace=trace2)
    sup2.drain()
    sup2.close()
    trace2.close()
    rows = [json.loads(line)
            for line in open(tmp_path / "request_timeline.jsonl")]
    evs = [r["ev"] for r in rows if r.get("rid") == h.rid]
    assert evs[0] == "submit" and "readmit" in evs and evs[-1] == "done"
    assert sup2.requests[h.rid].tokens[:len(mid)] == mid


# -- the flight recorder and post-mortem bundles --------------------------------


def test_flight_recorder_ring_bounds():
    fr = FlightRecorder(capacity=3)
    for i in range(7):
        fr.record({"tick": i})
    assert fr.ticks_recorded == 7
    assert [r["tick"] for r in fr.rows()] == [4, 5, 6]
    with pytest.raises(ValueError, match="capacity"):
        FlightRecorder(capacity=0)


def test_engine_flight_snaps_every_busy_tick(model):
    fr = FlightRecorder()
    eng = InferenceEngine(model[2], CFG, n_slots=2, block_size=4,
                          prefill_chunk=3, flight=fr, device="cpu")
    eng.submit(_prompt(5, 1), max_new_tokens=3, seed=1)
    eng.drain()
    rows = fr.rows()
    assert fr.ticks_recorded == eng._tick_count == len(rows)
    assert [r["engine_tick"] for r in rows] == list(range(1, len(rows) + 1))
    assert set(rows[0]["blocks"]) >= {"blocks_total", "blocks_in_use"}


def test_restart_writes_postmortem_bundle_that_joins_journal(model,
                                                             tmp_path):
    faults.install(faults.FaultPlan.parse("engine-crash@serve.tick=3"))
    sup = ServeSupervisor(
        _factory(model[2], n_slots=2, block_size=4, prefill_chunk=3),
        str(tmp_path / "journal.jsonl"), postmortem_dir=str(tmp_path))
    for i in range(3):
        sup.submit(_prompt(5, i, first=i), max_new_tokens=6, seed=i)
    sup.drain()
    sup.close()
    assert sup.restarts == 1 and len(sup.postmortems) == 1
    bundle = json.load(open(sup.postmortems[0]))
    assert bundle["kind"] == "postmortem" and bundle["trigger"] == "restart"
    assert "EngineCrash" in bundle["cause"]
    assert bundle["flight"], "the dead incarnation's flight rows"
    assert bundle["flight_ticks_recorded"] == len(bundle["flight"])
    assert bundle["requests"] and bundle["journal_tail"]
    flight_ticks = {row["tick"] for row in bundle["flight"]}
    journal_ticks = {ev["tick"] for ev in bundle["journal_tail"]
                     if "tick" in ev}
    assert flight_ticks & journal_ticks
    assert bundle["tick"] >= max(flight_ticks)
    events, _ = read_journal(str(tmp_path / "journal.jsonl"))
    ticks = [ev["tick"] for ev in events]
    assert ticks == sorted(ticks)


def test_drain_timeout_dumps_bundle_before_raising(model, tmp_path):
    sup = ServeSupervisor(_factory(model[2], n_slots=1, block_size=4),
                          str(tmp_path / "journal.jsonl"),
                          postmortem_dir=str(tmp_path))
    sup.submit(_prompt(4, 1), max_new_tokens=12, seed=1)
    sup.submit(_prompt(4, 2), max_new_tokens=12, seed=2)
    with pytest.raises(DrainTimeout):
        sup.drain(max_ticks=2)
    assert len(sup.postmortems) == 1
    bundle = json.load(open(sup.postmortems[0]))
    assert bundle["trigger"] == "drain_timeout"
    assert len(bundle["flight"]) == 2
    assert [r for r in bundle["requests"]
            if r["state"] in ("queued", "active")]
    sup.close()


def test_shed_burst_dumps_bundle(model, tmp_path):
    clock = VirtualClock()
    sup = ServeSupervisor(
        _factory(model[2], n_slots=1, block_size=4, clock=clock),
        str(tmp_path / "journal.jsonl"), clock=clock,
        postmortem_dir=str(tmp_path), shed_burst=3,
        default_ttft_deadline_s=0.004)
    for i in range(5):
        sup.submit(_prompt(4, i, first=i), max_new_tokens=4, seed=i)
    clock.sleep(1.0)            # every TTFT deadline expires
    sup.step()
    assert any("shed_burst" in p for p in sup.postmortems)
    bundle = json.load(open(sup.postmortems[0]))
    assert bundle["trigger"] == "shed_burst"
    # the journal joins the bundle: every shed rid is in its tail
    shed = {ev["rid"] for ev in bundle["journal_tail"] if ev["ev"] == "shed"}
    assert shed and shed <= {r["rid"] for r in bundle["requests"]}
    sup.close()


def test_write_bundle_atomic_and_complete(tmp_path):
    fr = FlightRecorder()
    fr.record({"tick": 1})
    path = write_bundle(str(tmp_path / "b.json"), trigger="restart",
                        cause="x", tick=1, flight=fr, requests={})
    b = json.load(open(path))
    assert b["flight"] == [{"tick": 1}] and b["requests"] == []
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]


# -- the report CLI -------------------------------------------------------------


def test_report_cli_renders_and_exits_zero(model, tmp_path, capsys):
    d = str(tmp_path / "run")
    rep = run_scenario("crash-serve", model[2], CFG, outdir=d, trace=True,
                       device="cpu")
    assert rep["postmortem_bundles"] == 1
    assert report.main(["--dir", d]) == 0
    out = capsys.readouterr().out
    assert "scenario crash-serve [PASS]" in out
    assert "restart #1" in out and "postmortem" in out
    assert "timeline" in out and "2 incarnation(s)" in out
    assert "attribution [crash-serve]: 16 request(s) folded" in out
    assert report.main(["--dir", d, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["serve"]["requests_completed"] == 16
    assert doc["postmortems"][0]["trigger"] == "restart"
    assert doc["postmortems"][0]["flight_rows"] > 0


def test_report_cli_exit_codes(tmp_path, capsys):
    assert report.main(["--dir", str(tmp_path / "missing")]) == 2
    empty = tmp_path / "empty"
    empty.mkdir()
    assert report.main(["--dir", str(empty)]) == 2
    capsys.readouterr()


def test_report_json_schema_pinned(model, tmp_path, capsys):
    d = str(tmp_path / "run")
    run_scenario("overload-shed", model[2], CFG, outdir=d, trace=True,
                 device="cpu")
    assert report.main(["--dir", d, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert set(doc) == {
        "dir", "serve", "scenarios", "slo_alerts", "attribution",
        "epochs", "last_epoch", "sentinel", "journals", "timelines",
        "traces", "postmortems"}
    assert [(r["tick"], r["to"]) for r in doc["slo_alerts"]] == [
        (37, "pending"), (38, "firing"), (49, "resolved"),
        (50, "inactive")]
    att = doc["attribution"]["overload-shed"]
    assert att["requests"] == 11 and att["top_slow"][0]["rid"] == 2
    assert report.main(["--dir", d]) == 0
    out = capsys.readouterr().out
    assert "alert slo_burn{class=interactive}: pending -> firing" in out
    assert "top slow requests (TTFT autopsy):" in out


def test_tracer_events_equal_the_jax_tracers(tmp_path):
    """Async events stamped by the caller, and the pinned pid, give the
    JAX ``Tracer``'s Chrome trace byte for byte; ``span`` records one
    complete event, also when its body raises."""
    from simple_distributed_machine_learning_tpu.telemetry.tracing import (
        Tracer as JaxTracer,
    )
    from simple_distributed_machine_learning_tpu_torch.telemetry.tracing import (  # noqa: E501
        Tracer,
    )
    ours, ref = Tracer("p", pid=0), JaxTracer("p", pid=0)
    for t in (ours, ref):
        t.async_begin("request", 3, ts_us=1.5, cat="req", cls="x")
        t.async_instant("tick", 3, ts_us=2.0, cat="req", obj=object)
        t.async_end("request", 3, ts_us=4.25, cat="req")
    assert json.dumps(ours.to_chrome_trace()) == json.dumps(
        ref.to_chrome_trace())
    with pytest.raises(KeyError):
        with ours.span("step", epoch=3):
            raise KeyError("x")
    ev = ours.to_chrome_trace()["traceEvents"][-1]
    assert (ev["name"], ev["ph"], ev["args"]) == ("step", "X", {"epoch": 3})
    assert ev["dur"] >= 0
    path = ours.write(str(tmp_path / "t.json"))
    assert json.load(open(path)) == ours.to_chrome_trace()
