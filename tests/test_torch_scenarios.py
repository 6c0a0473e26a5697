"""The SLO scenarios: the port against the JAX package — the six
one-engine scenarios and the seven fleet scenarios, offload-churn and
hot-adapter-churn included (with hot-prefix-skew under round-robin and
disagg-prefill-heavy's symmetric fleet as variants).

Both packages run each scenario on the virtual clock with one set of
weights (``tests/test_scenarios.py``'s model, 2 stages from
``jax.random.key(0)``, carried into the port by
``interop.params_from_numpy``). The virtual clock charges every clock
read, so the scenarios pin the *structure* of admission, scheduling,
shedding and recovery: every count, every per-class TTFT/TPOT quantile in
virtual ms, ``slo_ok``, the overload-shed alert trajectory and every
request's finish reason must be EXACTLY the JAX package's. Greedy token
streams are equal token for token; a sampled request draws from each
package's own generator, so its tokens (and its journaled ``tok`` and
``kd``) differ by design — its length and timing do not.

The JAX engine's metered tick calls its analyzer's byte model
(``kv_drift``), whose module does not import on this tree; the JAX side
runs with that one method patched to ``(0, 0)`` (it only feeds a gauge).
"""

import dataclasses
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
from simple_distributed_machine_learning_tpu.serve import (
    OverloadPolicy as JaxOverloadPolicy,
)
from simple_distributed_machine_learning_tpu.serve import (
    PriorityScheduler as JaxPriorityScheduler,
)
from simple_distributed_machine_learning_tpu.serve import (
    ServeMetrics as JaxServeMetrics,
)
from simple_distributed_machine_learning_tpu.serve import (
    ServeSupervisor as JaxServeSupervisor,
)
from simple_distributed_machine_learning_tpu.serve import (
    engine_factory as jax_engine_factory,
)
from simple_distributed_machine_learning_tpu.serve.engine import (
    InferenceEngine as JaxEngine,
)
from simple_distributed_machine_learning_tpu_torch.interop import (
    params_from_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.resilience import faults
from simple_distributed_machine_learning_tpu_torch.resilience import (
    scenarios as tscen,
)
from simple_distributed_machine_learning_tpu_torch.serve import (
    OverloadPolicy,
    PriorityScheduler,
    ServeMetrics,
    ServeSupervisor,
    engine_factory,
)

KW = dict(vocab=32, seq_len=48, d_model=32, n_heads=2, n_layers=2)

# the pins: (completed, shed, restarts, preemptions, {class: TTFT p95 vms})
PINS = {
    "steady": (16, 0, None, 0, {"interactive": 14.16}),
    "burst-interactive": (28, 0, None, 3, {"interactive": 22.249,
                                           "batch": 451.418}),
    "multi-tenant": (30, 0, None, 0, {"interactive": 14.312,
                                      "standard": 14.469, "batch": 92.16}),
    "burst-slow-tick": (24, 0, None, 5, {"interactive": 25.484,
                                         "batch": 443.309}),
    "crash-serve": (16, 0, 1, 0, {"interactive": 23.16}),
    "overload-shed": (11, 25, 0, 2, {"interactive": 75.651,
                                     "batch": 351.149}),
}
OVERLOAD_ALERTS = [(37, "inactive", "pending"), (38, "pending", "firing"),
                   (49, "firing", "resolved"), (50, "resolved", "inactive")]

# the fleet pins: (name, run_scenario overrides) -> (completed, interactive
# TTFT p95 vms or None, fleet block fields, prefix-hit blocks or None)
FLEET_PINS = {
    ("fleet-replica-loss", ()): (16, 22.16, dict(
        replicas=3, alive=2, replica_losses=1, migrations=1,
        replica_log=[("loss", 0, 5, 2)]), None),
    ("hot-prefix-skew", ()): (18, 42.62, dict(
        replicas=3, affinity_hits=17, replica_log=[]), 17),
    ("hot-prefix-skew", (("route", "round-robin"),)): (18, None, dict(
        replicas=3, affinity_hits=0, route="round-robin"), 5),
    ("fleet-autoscale-diurnal", ()): (50, None, dict(
        replicas=1, scale_outs=4, retired=2, replica_log=[
            ("scale-out", 1, 30, 2), ("scale-out", 2, 36, 3),
            ("retire", 2, 61, 2), ("retire", 1, 61, 1),
            ("scale-out", 3, 76, 2), ("scale-out", 4, 78, 3)]), None),
    ("disagg-prefill-heavy", ()): (16, 74.719, dict(
        replicas=4, prefill_replicas=2, handoffs=16), None),
    ("disagg-prefill-heavy", (("prefill_replicas", 0),)): (16, 206.719,
                                                           dict(replicas=4),
                                                           None),
    ("handoff-replica-loss", ()): (16, 25.16, dict(
        replicas=3, prefill_replicas=1, handoffs=16, replica_losses=1,
        migrations=1, replica_log=[("loss", 1, 6, 2)]), None),
    # the host tier and the adapters (their own blocks are held equal to
    # the JAX run's in the test; the pins are in tests/test_torch_host_
    # tier.py and tests/test_torch_adapters.py)
    ("offload-churn", ()): (24, None, dict(replicas=1, replica_log=[]), 16),
    ("hot-adapter-churn", ()): (18, None, dict(replicas=3, replica_log=[]),
                                None),
}


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
    """``(jax_cfg, jax_stages, port_cfg, port_stages)`` over one set of
    weights."""
    jcfg = jgpt.GPTConfig(**KW)
    jst = jgpt.make_gpt_stages(jax.random.key(0), jcfg, 2)[0]
    nparams = jax.tree.map(np.asarray, [s.params for s in jst])
    tcfg = tgpt.GPTConfig(**KW)
    tst = tgpt.make_gpt_stages(0, tcfg, 2, device="cpu")[0]
    tst = [dataclasses.replace(s, params=p)
           for s, p in zip(tst, params_from_numpy(nparams, "cpu"))]
    return jcfg, jst, tcfg, tst


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """No fault plan leaks in or out; the JAX engine's drift gauge is
    patched (module docstring)."""
    monkeypatch.setattr(JaxEngine, "kv_drift", lambda self: (0, 0))
    faults.uninstall()
    jfaults.uninstall()
    yield
    faults.uninstall()
    jfaults.uninstall()


def _capture(monkeypatch, module):
    """Wrap ``module.simulate`` so the run's live handles are kept."""
    seen = {}
    inner = module.simulate

    def simulate(target, sim, **kw):
        report = inner(target, sim, **kw)
        seen["requests"] = dict(target.requests)
        return report

    monkeypatch.setattr(module, "simulate", simulate)
    return seen


def _run_both(monkeypatch, model, name, **kw):
    jcfg, jst, tcfg, tst = model
    jseen, tseen = _capture(monkeypatch, jscen), _capture(monkeypatch, tscen)
    jr = jscen.run_scenario(name, jst, jcfg, **kw)
    tr = tscen.run_scenario(name, tst, tcfg, device="cpu", **kw)
    return jr, tr, jseen["requests"], tseen["requests"]


def _check_streams(jreqs, treqs) -> int:
    """Every request: same state, finish reason, length, preemptions and
    timestamps; greedy ones the same tokens. Returns the greedy count."""
    assert sorted(jreqs) == sorted(treqs)
    greedy = 0
    for rid in sorted(jreqs):
        j, t = jreqs[rid], treqs[rid]
        assert (t.state, t.finish_reason, len(t.tokens), t.n_preempted,
                t.submit_time, t.first_token_time, t.done_time) == (
            j.state, j.finish_reason, len(j.tokens), j.n_preempted,
            j.submit_time, j.first_token_time, j.done_time), rid
        if j.temperature == 0.0:
            greedy += 1
            assert list(t.tokens) == [int(x) for x in j.tokens], rid
    return greedy


@pytest.mark.parametrize("name", list(PINS))
def test_scenario_equals_the_jax_run(monkeypatch, model, name):
    jr, tr, jreqs, treqs = _run_both(monkeypatch, model, name)
    completed, shed, restarts, preemptions, p95 = PINS[name]
    for rep in (jr, tr):
        assert rep["completed"] == completed and rep["shed"] == shed
        assert rep.get("restarts") == restarts
        assert rep.get("preemptions", 0) == preemptions
        assert {c: b["ttft_ms_p95"] for c, b in rep["per_class"].items()
                } == p95
        assert rep["slo_ok"]
    assert _check_streams(jreqs, treqs) >= 4
    assert [r["n_tokens"] for r in tr["requests"]] == [
        r["n_tokens"] for r in jr["requests"]]
    for key in ("n_requests", "submitted", "completed", "shed",
                "all_completed", "stopped", "wall_s", "requests",
                "requests_submitted", "requests_completed",
                "tokens_generated", "tokens_per_sec", "ttft_ms_p50",
                "ttft_ms_p95", "tpot_ms_p50", "tpot_ms_p95",
                "slot_occupancy_mean", "tp", "spec_k", "preemptions",
                "per_class", "restarts", "recovered_requests", "shed_total",
                "shed_by_reason", "degraded", "blocks_total",
                "blocks_in_use", "blocks_cached", "kv_bytes_resident",
                "prefix_hit_blocks", "cow_copies", "block_evictions",
                "prefill_chunk_ms_p50", "prefill_chunk_ms_p95", "scenario",
                "scheduler", "supervised", "slo", "slo_ok", "slo_alerts",
                "faults", "supervisor_state", "postmortem_bundles"):
        assert tr.get(key) == jr.get(key), key
    if name == "crash-serve":
        assert tr["recovered_requests"] > 0
        assert tr["faults"]["total_fired"] == 1
        assert tr["slo_alerts"]["transitions"] == []
    if name == "overload-shed":
        assert tr["shed_by_reason"] == {"backpressure": 5, "class": 18,
                                        "deadline": 2}
        assert [(t["tick"], t["from"], t["to"])
                for t in tr["slo_alerts"]["transitions"]] == OVERLOAD_ALERTS
    if name == "burst-slow-tick":
        assert tr["faults"]["total_fired"] == 10
    assert faults.active() is None


def test_overload_fcfs_baseline_fails_the_same_gate(monkeypatch, model):
    """The no-deadline FCFS baseline completes everything but misses the
    interactive TTFT target by an order of magnitude, exactly as the JAX
    package's does."""
    jr, tr, jreqs, treqs = _run_both(monkeypatch, model, "overload-shed",
                                     scheduler="fcfs", supervised=False)
    for rep in (jr, tr):
        assert not rep["slo_ok"] and rep["all_completed"]
        assert rep["slo"]["interactive"]["ttft_ms_p95"] == 995.326
    assert tr["slo"] == jr["slo"]
    _check_streams(jreqs, treqs)


# journal fields allowed to differ, with the reason: a SAMPLED request's
# tokens come from each package's own generator (the port's murmur-based
# ops/random.py, JAX's threefry), so its token records' token value and
# post-token key data differ; a greedy request consumes no key and every
# field of its records is equal
SAMPLED_TOKEN_FIELDS = {"tok", "kd"}


@pytest.mark.parametrize("name", ["crash-serve", "overload-shed"])
def test_journals_and_records_match_line_for_line(model, tmp_path, name):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jscen.run_scenario(name, model[1], model[0], outdir=str(jdir))
    tscen.run_scenario(name, model[3], model[2], outdir=str(tdir),
                       device="cpu")
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    assert any(f.startswith("postmortem-000-") for f in os.listdir(tdir))
    jlines = open(jdir / f"journal-{name}.jsonl").read().splitlines()
    tlines = open(tdir / f"journal-{name}.jsonl").read().splitlines()
    assert len(tlines) == len(jlines) > 100
    temp = {}
    n_equal = 0
    for jl, tl in zip(jlines, tlines):
        je, te = json.loads(jl), json.loads(tl)
        if je["ev"] == "submit":
            temp[je["rid"]] = je["temp"]
        if jl == tl:
            n_equal += 1
            continue
        differ = {k for k in set(je) | set(te) if je.get(k) != te.get(k)}
        assert je["ev"] == "tok" and temp[je["rid"]] > 0, (jl, tl)
        assert differ <= SAMPLED_TOKEN_FIELDS, (jl, tl)
    assert n_equal > len(jlines) // 2

    def records(d):
        out = []
        for line in open(d / "metrics.jsonl"):
            rec = json.loads(line)
            rec.pop("time")
            if rec["kind"] == "serve":
                rec.pop("journal_bytes")       # sums the sampled tokens
                for k in ("kv_bytes_predicted", "kv_drift_bytes"):
                    rec.pop(k, None)           # JAX's kv_drift is patched
            out.append(rec)
        return out

    assert records(tdir) == records(jdir)


class CountingClock:
    """A virtual clock that logs how many reads each tick made."""

    def __init__(self):
        self.t = 0.0
        self.reads = 0

    def __call__(self):
        self.reads += 1
        self.t += 0.001
        return self.t

    def sleep(self, dt):
        self.t += dt


def _clock_reads(pkg, model, layout):
    """Clock reads per supervised tick, from submission to drain, of one
    request mix under a crash, deadlines and preemption."""
    jcfg, jst, tcfg, tst = model
    clock = CountingClock()
    if pkg == "jax":
        fmod, sup_cls, fac, prio, met, pol = (
            jfaults, JaxServeSupervisor, jax_engine_factory,
            JaxPriorityScheduler, JaxServeMetrics, JaxOverloadPolicy)
        stages, cfg, extra = jst, jcfg, {}
    else:
        fmod, sup_cls, fac, prio, met, pol = (
            faults, ServeSupervisor, engine_factory, PriorityScheduler,
            ServeMetrics, OverloadPolicy)
        stages, cfg, extra = tst, tcfg, {"device": "cpu"}
    kw = ({"block_size": 4, "prefill_chunk": 3} if layout == "paged"
          else {"kv_layout": "dense"})
    metrics = met(clock=clock)
    fmod.install(fmod.FaultPlan.parse("engine-crash@serve.tick=5",
                                      sleep=clock.sleep))
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        sup = sup_cls(fac(stages, cfg, n_slots=2, scheduler=prio,
                          metrics=metrics, clock=clock, **kw, **extra),
                      os.path.join(d, "j.jsonl"), metrics=metrics,
                      clock=clock, overload=pol(max_queue_depth=3))
        rng = np.random.default_rng(5)
        per_tick = []
        for i in range(7):
            sup.submit(rng.integers(0, 32, 3 + i).astype(np.int32),
                       max_new_tokens=6, seed=i, priority=i % 3,
                       deadline_s=0.12 if i == 4 else None,
                       temperature=0.7 if i % 2 else 0.0,
                       top_k=5 if i % 2 else None)
            per_tick.append(("submit", clock.reads))
            clock.reads = 0
            sup.step()
            per_tick.append(("tick", clock.reads))
            clock.reads = 0
        while sup.busy:
            sup.step()
            per_tick.append(("tick", clock.reads))
            clock.reads = 0
        sup.close()
    fmod.uninstall()
    return per_tick, sup.restarts, sorted(
        (r.rid, r.state, len(r.tokens)) for r in sup.requests.values())


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_clock_reads_per_tick_equal_the_jax_engine(model, layout):
    ours = _clock_reads("port", model, layout)
    ref = _clock_reads("jax", model, layout)
    assert ours == ref
    per_tick, restarts, states = ours
    assert restarts == 1 and len(per_tick) > 20
    assert sum(n for _, n in per_tick) > 50


def test_unported_scenarios_and_knobs_name_their_items(model):
    """Every JAX scenario is ported (the name stays from when the
    host-tier and adapter ones raised naming item 5): the catalog equals
    the JAX package's, ``host_cache_blocks`` runs (a steady run with the
    tier reports its block and the same counts), and so do ``trace``/
    ``route``/``prefill_replicas``."""
    _, _, tcfg, tst = model
    rep = tscen.run_scenario("steady", tst, tcfg, device="cpu",
                             host_cache_blocks=4)
    assert rep["slo_ok"] and rep["completed"] == 16
    assert rep["host_tier"]["host_cache_blocks"] == 4
    rep = tscen.run_scenario("steady", tst, tcfg, device="cpu", trace=True)
    assert rep["slo_ok"] and rep["attribution"]["requests"] == 16
    with pytest.raises(ValueError, match="unknown scenario"):
        tscen.run_scenario("nope", tst, tcfg, device="cpu")
    assert set(tscen.SCENARIOS) == set(PINS) | {n for n, _ in FLEET_PINS}
    assert list(tscen.SCENARIOS) == list(jscen.SCENARIOS)
    for kw, match in ((dict(min_host_demotes=1), "host_cache_blocks > 0"),
                      (dict(adapters=("t",)), "adapter_rank > 0"),
                      (dict(adapter_rank=2), "supervised=True or a fleet")):
        with pytest.raises(ValueError, match=match):
            dataclasses.replace(tscen.SCENARIOS["steady"], **kw)
    with pytest.raises(ValueError, match="min_restarts"):
        tscen.Scenario(name="x", description="",
                       sim=tscen.SCENARIOS["steady"].sim, min_restarts=1)


def test_crash_serve_gate_requires_a_restart(model):
    _, _, tcfg, tst = model
    quiet = dataclasses.replace(tscen.SCENARIOS["crash-serve"], chaos=None)
    rep = tscen.run_scenario(quiet, tst, tcfg, device="cpu")
    assert rep["restarts"] == 0 and rep["all_completed"]
    assert not rep["slo_ok"]


def test_virtual_clock_semantics():
    clock = tscen.VirtualClock(per_call_s=0.5)
    assert clock() == 0.5 and clock() == 1.0
    clock.sleep(2.0)
    assert clock() == 3.5
    clock.sleep(-1.0)
    assert clock() == 4.0
    with pytest.raises(ValueError):
        tscen.VirtualClock(per_call_s=0.0)


# -- the fleet scenarios --------------------------------------------------------


@pytest.mark.parametrize("name,over", list(FLEET_PINS),
                         ids=[n + ("" if not o else f"[{o[0][0]}={o[0][1]}]")
                              for n, o in FLEET_PINS])
def test_fleet_scenario_equals_the_jax_run(monkeypatch, model, name, over):
    """Every number of the fleet pins holds exactly in both packages: the
    count, the interactive TTFT p95, the fleet block with its replica log,
    ``slo_ok``; every greedy stream is equal."""
    kw = dict(over)
    jr, tr, jreqs, treqs = _run_both(monkeypatch, model, name, **kw)
    completed, p95, fleet, hits = FLEET_PINS[(name, over)]
    for rep in (jr, tr):
        assert rep["completed"] == completed and rep["shed"] == 0
        if p95 is not None:
            assert rep["slo"]["interactive"]["ttft_ms_p95"] == p95
        for key, want in fleet.items():
            got = rep["fleet"][key]
            if key == "replica_log":
                got = [(e["event"], e["replica"], e["tick"], e["alive"])
                       for e in got]
            assert got == want, (key, got)
        if hits is not None:
            assert rep["prefix_hit_blocks"] == hits
    assert tr["fleet"] == jr["fleet"]
    assert tr["slo_ok"] == jr["slo_ok"]
    assert tr["slo_ok"] is True
    assert tr["slo"] == jr["slo"]
    assert tr.get("slo_alerts") == jr.get("slo_alerts")
    assert tr.get("faults") == jr.get("faults")
    assert tr.get("host_tier") == jr.get("host_tier")
    assert tr.get("adapters") == jr.get("adapters")
    assert _check_streams(jreqs, treqs) >= 4
    assert faults.active() is None


def _fleet_clock_reads(pkg, model, n_replicas, chaos=None):
    """Clock reads per call (each submit, each tick) of one request mix
    through a fleet (``n_replicas`` > 0) or a lone supervisor (0)."""
    jcfg, jst, tcfg, tst = model
    clock = CountingClock()
    if pkg == "jax":
        from simple_distributed_machine_learning_tpu.serve import (
            ServeFleet as fleet_cls,
        )
        fmod, sup_cls, fac = jfaults, JaxServeSupervisor, jax_engine_factory
        stages, cfg, extra = jst, jcfg, {}
    else:
        from simple_distributed_machine_learning_tpu_torch.serve import (
            ServeFleet as fleet_cls,
        )
        fmod, sup_cls, fac = faults, ServeSupervisor, engine_factory
        stages, cfg, extra = tst, tcfg, {"device": "cpu"}
    if chaos:
        fmod.install(fmod.FaultPlan.parse(chaos, sleep=clock.sleep))
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        factory = fac(stages, cfg, n_slots=2, block_size=4, prefill_chunk=3,
                      clock=clock, **extra)
        if n_replicas:
            target = fleet_cls(factory, d, n_replicas=n_replicas,
                               clock=clock, journal_sync=False)
        else:
            target = sup_cls(factory, os.path.join(d, "j.jsonl"),
                             clock=clock)
        rng = np.random.default_rng(7)
        reads = []
        for i in range(6):
            target.submit(rng.integers(0, 32, 3 + i).astype(np.int32),
                          max_new_tokens=5, seed=i)
            reads.append(("submit", clock.reads))
            clock.reads = 0
            target.step()
            reads.append(("tick", clock.reads))
            clock.reads = 0
        while target.busy:
            target.step()
            reads.append(("tick", clock.reads))
            clock.reads = 0
        target.close()
    fmod.uninstall()
    return reads, sorted((r.rid, list(r.tokens))
                         for r in target.requests.values())


def test_a_fleet_tick_adds_no_clock_read(model):
    """A one-replica fleet reads the clock exactly as often, call for
    call, as the lone supervisor it wraps; a three-replica fleet through a
    replica loss reads it exactly as the JAX package's fleet does."""
    alone = _fleet_clock_reads("port", model, 0)
    assert _fleet_clock_reads("port", model, 1) == alone
    assert sum(n for _, n in alone[0]) > 30
    chaos = "replica-kill@fleet.tick=3"
    assert (_fleet_clock_reads("port", model, 3, chaos)
            == _fleet_clock_reads("jax", model, 3, chaos))
