"""The port's serve supervisor: crash recovery, the degraded rebuild,
deadlines and overload control, held bit for bit against the port's own
uninterrupted runs and its solo decoder.

These are the JAX package's pins (``tests/test_serve_supervisor.py``)
with the port's engine: an injected ``engine-crash`` mid-flight (mixed
prompt lengths, greedy and sampled, paged and dense layouts, a second
crash during recovery, a crash inside admission, a process death) leaves
every request's full stream equal to the uninterrupted run's, which
equals its solo ``make_cached_decoder`` decode. One greedy case runs the
same crash plan through both packages. The process-global fault plan is
uninstalled around every test.
"""

import dataclasses
import gc
import json
import os
import weakref

import jax
import numpy as np
import pytest

from simple_distributed_machine_learning_tpu.models import gpt as jgpt
from simple_distributed_machine_learning_tpu.resilience import (
    faults as jfaults,
)
from simple_distributed_machine_learning_tpu.serve import (
    ServeSupervisor as JaxServeSupervisor,
)
from simple_distributed_machine_learning_tpu.serve import (
    engine_factory as jax_engine_factory,
)
from simple_distributed_machine_learning_tpu_torch.interop import (
    params_from_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.ops.random import key_data
from simple_distributed_machine_learning_tpu_torch.resilience import faults
from simple_distributed_machine_learning_tpu_torch.resilience.scenarios import (  # noqa: E501
    VirtualClock,
)
from simple_distributed_machine_learning_tpu_torch.serve import (
    InferenceEngine,
    OverloadPolicy,
    PriorityScheduler,
    RequestJournal,
    RestartBudgetExceeded,
    ServeMetrics,
    ServeSupervisor,
    engine_factory,
)
from simple_distributed_machine_learning_tpu_torch.serve.request import (
    ACTIVE,
    DONE,
    QUEUED,
    SHED,
)

CFG = tgpt.GPTConfig(vocab=32, seq_len=48, d_model=32, n_heads=2, n_layers=2)


@pytest.fixture(scope="module")
def model():
    stages = tgpt.make_gpt_stages(0, CFG, 2, device="cpu")[0]
    return stages, [s.params for s in stages]


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    faults.uninstall()
    jfaults.uninstall()
    yield
    faults.uninstall()
    jfaults.uninstall()


def _solo(model, prompt, n_new, seed, temperature=0.0, top_k=None):
    stages, params = model
    dec = tgpt.make_cached_decoder(stages, CFG, len(prompt), n_new,
                                   temperature=temperature, top_k=top_k,
                                   device="cpu")
    out = dec(params, np.asarray(prompt, np.int32)[None], key_data(seed))
    return out[0, len(prompt):].tolist()


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab, n).astype(
        np.int32)


def _supervisor(model, tmp_path, name="journal.jsonl", clock=None,
                metrics=None, engine_kw=None, **sup_kw):
    kw = dict(engine_kw or {})
    kw.setdefault("n_slots", 2)
    if kw.get("kv_layout", "paged") == "paged":
        kw.setdefault("block_size", 4)
        kw.setdefault("prefill_chunk", 3)
    if clock is not None:
        kw["clock"] = sup_kw["clock"] = clock
    if metrics is not None:
        kw["metrics"] = sup_kw["metrics"] = metrics
    return ServeSupervisor(engine_factory(model[0], CFG, device="cpu", **kw),
                           str(tmp_path / name), **sup_kw)


SPECS = [
    dict(prompt=_prompt(5, 1), max_new_tokens=8, seed=11),
    dict(prompt=_prompt(9, 2), max_new_tokens=6, seed=12,
         temperature=0.8, top_k=5),
    dict(prompt=_prompt(3, 3), max_new_tokens=7, seed=13),
    dict(prompt=_prompt(7, 4), max_new_tokens=5, seed=14,
         temperature=1.1, top_k=4),
]


def _fixed_run(model, tmp_path, name, chaos, layout="paged"):
    """Mixed prompt lengths, greedy AND sampled, with queueing (2 slots,
    4 requests), optionally under a chaos schedule."""
    kw = ({"kv_layout": "paged", "block_size": 4, "prefill_chunk": 3}
          if layout == "paged" else {"kv_layout": "dense"})
    if chaos:
        faults.install(faults.FaultPlan.parse(chaos))
    sup = _supervisor(model, tmp_path, name, engine_kw=kw)
    handles = [sup.submit(**s) for s in SPECS]
    sup.drain()
    sup.close()
    faults.uninstall()
    return sup, [list(h.tokens) for h in handles]


def _solos(model):
    return [_solo(model, s["prompt"], s["max_new_tokens"], s["seed"],
                  s.get("temperature", 0.0), s.get("top_k"))
            for s in SPECS]


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_crash_recovery_bitexact(model, tmp_path, layout):
    """An engine crash mid-flight recovers every in-flight request from
    the journal with its FULL stream equal to the uninterrupted run's and
    to its solo decode, on both layouts."""
    _, base = _fixed_run(model, tmp_path, "base.jsonl", None, layout)
    sup, crashed = _fixed_run(model, tmp_path, "crash.jsonl",
                              "engine-crash@serve.tick=3", layout)
    assert sup.restarts == 1 and sup.state == "running"
    assert crashed == base == _solos(model)
    assert all(r.state == DONE for r in sup.requests.values())
    assert sup.engine.kv_layout == layout


@pytest.mark.parametrize("kind", ["engine-crash", "wedged-device",
                                  "host-kill"])
def test_every_recoverable_kind_recovers(model, tmp_path, kind):
    sup, crashed = _fixed_run(model, tmp_path, "k.jsonl",
                              f"{kind}@serve.tick=4")
    assert sup.restarts == 1 and crashed == _solos(model)
    events = [json.loads(line) for line in open(tmp_path / "k.jsonl")]
    restart = [e for e in events if e["ev"] == "restart"]
    assert len(restart) == 1 and restart[0]["degraded"] is False


def test_slow_tick_stalls_without_a_restart(model, tmp_path):
    clock = VirtualClock(0.001)
    faults.install(faults.FaultPlan.parse(
        "slow-tick@serve.tick,after=1,times=2,dur=0.5", sleep=clock.sleep))
    sup = _supervisor(model, tmp_path, clock=clock)
    h = sup.submit(_prompt(4, 1), max_new_tokens=4, seed=1)
    sup.drain()
    sup.close()
    assert sup.restarts == 0 and faults.active().stats()["total_fired"] == 2
    assert clock() > 1.0                        # two 0.5 s stalls
    assert h.tokens == _solo(model, h.prompt, 4, 1)


def test_double_crash_recovery_bitexact(model, tmp_path):
    """A crash DURING recovery: the second firing lands on the rebuilt
    engine's first busy tick, and the streams still equal the
    uninterrupted run's."""
    _, base = _fixed_run(model, tmp_path, "base2.jsonl", None)
    sup, crashed = _fixed_run(model, tmp_path, "crash2.jsonl",
                              "engine-crash@serve.tick,after=3,times=2")
    assert sup.restarts == 2 and crashed == base


def test_admit_crash_recovers_journaled_submission(model, tmp_path):
    """A crash inside engine.submit (the serve.admit site): the
    submission was journaled first, so recovery re-admits it and the
    handle returned from the same submit() call completes."""
    faults.install(faults.FaultPlan.parse("engine-crash@serve.admit=1"))
    sup = _supervisor(model, tmp_path, "admit.jsonl")
    h0 = sup.submit(_prompt(5, 1), max_new_tokens=4, seed=21)
    h1 = sup.submit(_prompt(4, 2), max_new_tokens=4, seed=22)   # crashes
    faults.uninstall()
    assert sup.restarts == 1
    assert h1.rid == 1 and h1.state == QUEUED
    sup.drain()
    sup.close()
    for h in (h0, h1):
        assert h.state == DONE
        assert h.tokens == _solo(model, h.prompt, 4, h.seed)


def test_cold_restart_resumes_from_journal_bitexact(model, tmp_path):
    """The process-death path: a NEW supervisor over the dead one's
    journal replays finished prefixes onto fresh handles and continues
    the in-flight requests bit for bit."""
    sup = _supervisor(model, tmp_path, "cold.jsonl",
                      clock=VirtualClock(0.001))
    h1 = sup.submit(_prompt(5, 1), max_new_tokens=8, seed=31)
    h2 = sup.submit(_prompt(7, 2), max_new_tokens=6, seed=32,
                    temperature=0.9, top_k=4)
    for _ in range(4):
        sup.step()
    mid = [list(h1.tokens), list(h2.tokens)]
    assert 0 < len(h1.tokens) < 8
    sup.close()                            # the process "dies" here
    sup2 = _supervisor(model, tmp_path, "cold.jsonl",
                       clock=VirtualClock(0.001))
    g1, g2 = sup2.requests[0], sup2.requests[1]
    assert list(g1.tokens) == mid[0] and list(g2.tokens) == mid[1]
    sup2.drain()
    sup2.close()
    sup3 = _supervisor(model, tmp_path, "ref.jsonl",
                       clock=VirtualClock(0.001))
    r1 = sup3.submit(_prompt(5, 1), max_new_tokens=8, seed=31)
    r2 = sup3.submit(_prompt(7, 2), max_new_tokens=6, seed=32,
                     temperature=0.9, top_k=4)
    sup3.drain()
    sup3.close()
    assert g1.tokens == r1.tokens and g2.tokens == r2.tokens


def test_finished_but_unacked_request_not_redecoded(model, tmp_path):
    sup = _supervisor(model, tmp_path, "ack.jsonl")
    h = sup.submit(_prompt(5, 1), max_new_tokens=4, seed=41)
    sup.drain()
    sup.close()
    path = tmp_path / "ack.jsonl"
    lines = open(path, "rb").read().splitlines(keepends=True)
    assert json.loads(lines[-1])["ev"] == "done"
    open(path, "wb").write(b"".join(lines[:-1]))    # ack never landed
    sup2 = _supervisor(model, tmp_path, "ack.jsonl")
    g = sup2.requests[h.rid]
    assert g.state == DONE and g.finish_reason == "length"
    assert g.tokens == h.tokens and not sup2.busy
    sup2.close()


def test_empty_journal_recovers_fresh_engine(model, tmp_path):
    (tmp_path / "j.jsonl").write_bytes(b"")
    sup = _supervisor(model, tmp_path, "j.jsonl")
    assert sup.requests == {} and not sup.busy and sup.restarts == 0
    h = sup.submit(_prompt(4, 1), max_new_tokens=3, seed=5)
    sup.drain()
    sup.close()
    assert h.tokens == _solo(model, h.prompt, 3, 5)


def test_degraded_rebuild_dense_and_bitexact(model, tmp_path):
    """Past ``degrade_after`` restarts the rebuild drops the draft and
    serves on dense slot rows; greedy streams still equal the full
    (speculative, paged) run's."""
    draft_cfg = dataclasses.replace(CFG, n_layers=1)
    draft_stages = tgpt.make_gpt_stages(9, draft_cfg, 1, device="cpu")[0]
    metrics = ServeMetrics()

    def run(name, chaos, degrade_after=None):
        if chaos:
            faults.install(faults.FaultPlan.parse(chaos))
        sup = ServeSupervisor(
            engine_factory(model[0], CFG, n_slots=2, block_size=4,
                           attn_kernel="fused", draft_stages=draft_stages,
                           draft_cfg=draft_cfg, spec_k=3, device="cpu",
                           metrics=metrics if chaos else None),
            str(tmp_path / name), degrade_after=degrade_after,
            max_restarts=3, metrics=metrics if chaos else None)
        assert sup.engine.speculative
        h1 = sup.submit(_prompt(5, 1), max_new_tokens=8, seed=51)
        h2 = sup.submit(_prompt(7, 2), max_new_tokens=6, seed=52)
        sup.drain()
        sup.close()
        faults.uninstall()
        return sup, [h1.tokens, h2.tokens]

    _, base = run("dbase.jsonl", None)
    sup, deg = run("dcrash.jsonl", "engine-crash@serve.tick=2",
                   degrade_after=1)
    assert sup.degraded and sup.state == "degraded"
    assert sup.engine.kv_layout == "dense" and not sup.engine.speculative
    assert deg == base
    s = metrics.summary()
    assert s["degraded"] == 1 and s["restarts"] == 1
    assert s["recovered_requests"] == 2


def test_degraded_rebuild_widens_a_quantised_cache(model):
    fac = engine_factory(model[0], CFG, n_slots=2, block_size=4,
                         cache_dtype="int8", prefill_chunk=3,
                         device="cpu")
    assert fac(False).pool.quantized
    eng = fac(True)
    assert eng.kv_layout == "dense" and eng.pool.kc.dtype.is_floating_point
    assert eng.pool.kc.dtype == tgpt._cache_dtype(None)


def test_restart_budget_exceeded_raises(model, tmp_path):
    faults.install(faults.FaultPlan.parse(
        "engine-crash@serve.tick,times=0"))      # every tick crashes
    sup = _supervisor(model, tmp_path, "budget.jsonl", max_restarts=2,
                      postmortem_dir=str(tmp_path / "pm"))
    sup.submit(_prompt(4, 1), max_new_tokens=4, seed=61)
    with pytest.raises(RestartBudgetExceeded, match="max_restarts=2"):
        sup.drain()
    assert sup.state == "failed" and sup.restarts == 3
    assert [os.path.basename(p)[:-5] for p in sup.postmortems] == [
        "postmortem-000-restart", "postmortem-001-restart",
        "postmortem-002-restart_budget"]
    bundle = json.load(open(sup.postmortems[0]))
    assert bundle["trigger"] == "restart" and bundle["flight"] == []
    assert bundle["journal_tail"][-1]["ev"] == "restart"
    assert bundle["requests"][0]["rid"] == 0
    sup.close()


def test_dead_engine_and_its_pool_are_freed(model, tmp_path):
    """Nothing keeps a crashed engine alive: once the failing tick
    returns, its pool is garbage (no collector pass needed)."""
    faults.install(faults.FaultPlan.parse("engine-crash@serve.tick=2"))
    sup = _supervisor(model, tmp_path)
    for s in SPECS:
        sup.submit(**s)
    gc.disable()
    try:
        old = weakref.ref(sup.engine)
        old_kc = weakref.ref(sup.engine.pool.kc)
        for _ in range(3):
            sup.step()
        assert sup.restarts == 1
        assert old() is None and old_kc() is None
    finally:
        gc.enable()
    sup.drain()
    sup.close()
    # the same for an engine its owner drops: the scheduler holds it weakly
    gc.disable()
    try:
        eng = InferenceEngine(model[0], CFG, n_slots=2,
                              scheduler=PriorityScheduler, device="cpu")
        ref = weakref.ref(eng)
        del eng
        assert ref() is None
    finally:
        gc.enable()


# -- deadlines + overload control (virtual clock: deterministic) -----------


def test_deadline_shed_refunds_budget_and_counts(model, tmp_path):
    clock = VirtualClock(0.001)
    metrics = ServeMetrics(clock=clock)
    sup = _supervisor(model, tmp_path, "dl.jsonl", clock=clock,
                      metrics=metrics, engine_kw={"n_slots": 1})
    h1 = sup.submit(_prompt(5, 1), max_new_tokens=20, seed=1)  # slot hog
    h2 = sup.submit(_prompt(5, 2), max_new_tokens=6, seed=2,
                    deadline_s=0.02)       # 20 vms: expires while queued
    sup.drain()
    assert h1.state == DONE and len(h1.tokens) == 20
    assert h2.state == SHED and h2.finish_reason == "deadline"
    assert sup.pool.n_active == 0 and sup.pool.stats()["blocks_in_use"] == 0
    s = metrics.summary()
    assert s["shed_total"] == 1 and s["shed_by_reason"] == {"deadline": 1}
    assert s["restarts"] == 0 and s["journal_bytes"] > 0
    prom = metrics.registry.prometheus_text()
    assert 'serve_shed_total{reason="deadline"} 1' in prom
    assert "serve_journal_bytes" in prom
    sup.close()


def test_deadline_sheds_active_request_midflight(model, tmp_path):
    clock = VirtualClock(0.001)
    sup = _supervisor(model, tmp_path, "dla.jsonl", clock=clock,
                      engine_kw={"n_slots": 1})
    h = sup.submit(_prompt(4, 1), max_new_tokens=40, seed=3,
                   deadline_s=0.08)
    while h.state in (QUEUED, ACTIVE):
        sup.step()
    assert h.state == SHED and h.finish_reason == "deadline"
    assert 0 < len(h.tokens) < 40
    assert sup.pool.n_active == 0
    sup.close()


def test_ttft_deadline_binds_only_before_first_token(model, tmp_path):
    clock = VirtualClock(0.001)
    sup = _supervisor(model, tmp_path, "ttft.jsonl", clock=clock,
                      engine_kw={"n_slots": 1})
    h1 = sup.submit(_prompt(4, 1), max_new_tokens=25, seed=4,
                    ttft_deadline_s=5.0)
    h2 = sup.submit(_prompt(4, 2), max_new_tokens=4, seed=5,
                    ttft_deadline_s=0.03)
    sup.drain()
    assert h1.state == DONE
    assert h2.state == SHED and h2.finish_reason == "deadline"
    sup.close()


def test_backpressure_sheds_lowest_priority_newest_first(model, tmp_path):
    clock = VirtualClock(0.001)
    sup = _supervisor(model, tmp_path, "bp.jsonl", clock=clock,
                      engine_kw={"n_slots": 1},
                      overload=OverloadPolicy(max_queue_depth=2))
    a = sup.submit(_prompt(4, 1), max_new_tokens=10, seed=1)
    sup.step()
    b = sup.submit(_prompt(4, 2), max_new_tokens=4, seed=2, priority=0)
    c = sup.submit(_prompt(4, 3), max_new_tokens=4, seed=3, priority=0)
    d = sup.submit(_prompt(4, 4), max_new_tokens=4, seed=4, priority=0)
    assert d.state == SHED and d.finish_reason == "backpressure"
    e = sup.submit(_prompt(4, 5), max_new_tokens=4, seed=5, priority=2)
    assert c.state == SHED and c.finish_reason == "backpressure"
    assert e.state == QUEUED and b.state == QUEUED
    sup.drain()
    assert a.state == DONE and b.state == DONE and e.state == DONE
    sup.close()


def test_class_token_bucket_polices_rate(model, tmp_path):
    clock = VirtualClock(0.001)
    sup = _supervisor(model, tmp_path, "tb.jsonl", clock=clock,
                      overload=OverloadPolicy(
                          class_rates={"batch": (1.0, 2)}))
    hs = [sup.submit(_prompt(4, i), max_new_tokens=2, seed=i, cls="batch",
                     arrival_time=0.001 * i) for i in range(4)]
    assert [h.state for h in hs] == [QUEUED, QUEUED, SHED, SHED]
    assert hs[2].finish_reason == "class"
    late = sup.submit(_prompt(4, 9), max_new_tokens=2, seed=9, cls="batch",
                      arrival_time=5.0)
    assert late.state == QUEUED
    sup.drain()
    sup.close()


def test_backpressure_shed_does_not_debit_class_bucket(model, tmp_path):
    clock = VirtualClock(0.001)
    sup = _supervisor(model, tmp_path, "bpb.jsonl", clock=clock,
                      engine_kw={"n_slots": 1},
                      overload=OverloadPolicy(
                          max_queue_depth=1,
                          class_rates={"batch": (1.0, 1)}))
    sup.submit(_prompt(4, 1), max_new_tokens=12, seed=1)
    sup.step()
    b = sup.submit(_prompt(4, 2), max_new_tokens=2, seed=2, cls="batch")
    assert b.state == QUEUED
    c = sup.submit(_prompt(4, 3), max_new_tokens=2, seed=3, cls="batch",
                   arrival_time=2.0)
    assert c.state == SHED and c.finish_reason == "backpressure"
    sup.drain()
    d = sup.submit(_prompt(4, 4), max_new_tokens=2, seed=4, cls="batch",
                   arrival_time=2.1)
    assert d.state == QUEUED, (d.state, d.finish_reason)
    sup.drain()
    sup.close()


def test_load_degraded_lockout_hysteresis(model, tmp_path):
    clock = VirtualClock(0.001)
    metrics = ServeMetrics(clock=clock)
    sup = _supervisor(model, tmp_path, "deg.jsonl", clock=clock,
                      metrics=metrics, engine_kw={"n_slots": 1},
                      overload=OverloadPolicy(degrade_queue_depth=2,
                                              recover_queue_depth=0,
                                              degraded_priority_floor=0))
    sup.submit(_prompt(4, 1), max_new_tokens=6, seed=1)
    sup.step()
    sup.submit(_prompt(4, 2), max_new_tokens=2, seed=2)
    sup.submit(_prompt(4, 3), max_new_tokens=2, seed=3)
    d = sup.submit(_prompt(4, 4), max_new_tokens=2, seed=4, priority=0)
    assert d.state == SHED and d.finish_reason == "class"
    assert sup.load_degraded and sup.state == "degraded"
    assert metrics.summary()["degraded"] == 1
    e = sup.submit(_prompt(4, 5), max_new_tokens=2, seed=5, priority=2)
    assert e.state == QUEUED
    sup.drain()
    f = sup.submit(_prompt(4, 6), max_new_tokens=2, seed=6, priority=0)
    assert f.state == QUEUED and not sup.load_degraded
    assert sup.state == "running"
    sup.drain()
    sup.close()


def test_overload_policy_and_constructor_validation(tmp_path):
    with pytest.raises(ValueError, match="max_queue_depth"):
        OverloadPolicy(max_queue_depth=0)
    with pytest.raises(ValueError, match="hysteresis"):
        OverloadPolicy(degrade_queue_depth=2, recover_queue_depth=2)
    with pytest.raises(ValueError, match="token bucket"):
        OverloadPolicy(class_rates={"x": (0.0, 2)})
    with pytest.raises(ValueError, match="max_restarts"):
        ServeSupervisor(lambda d: None, str(tmp_path / "x.jsonl"),
                        max_restarts=-1)
    with pytest.raises(ValueError, match="degrade_after"):
        ServeSupervisor(lambda d: None, str(tmp_path / "y.jsonl"),
                        degrade_after=0)


def test_fleet_tracing_and_adapter_surfaces_name_their_items(model,
                                                             tmp_path):
    """The fleet's half (adopt/release/seal_handoff), tracing and the
    adapters are ported: they check their arguments. A supervisor built
    without ``adapter_rank`` refuses a named adapter before journaling;
    ``engine_factory(adapter_rank=)`` gives every build, the degraded
    one included, a store over one shared host dict."""
    sup = _supervisor(model, tmp_path)
    with pytest.raises(ValueError, match="does not live"):
        sup.release(0)
    with pytest.raises(ValueError, match="migration adopts journal"):
        sup.adopt(dataclasses.replace(
            sup.engine.submit(_prompt(4, 1), max_new_tokens=2), rid=7,
            state=ACTIVE))
    sup.engine.requests.clear()
    sup.engine.scheduler.queue.clear()
    sup.seal_handoff(0)                        # a released rid: journaled
    assert sup.journal.tail(1)[-1]["ev"] == "handoff"
    with pytest.raises(ValueError, match="without an AdapterStore"):
        sup.submit(_prompt(4, 1), max_new_tokens=2, adapter="tenant")
    with pytest.raises(ValueError, match="adapter_rank"):
        sup.register_adapter("tenant", {})
    assert sup.requests == {}                  # nothing was journaled
    sup.close()
    traced = _supervisor(model, tmp_path, "t.jsonl",
                         postmortem_dir=str(tmp_path))
    assert traced.flight is not None           # implicit with bundles
    factory = engine_factory(model[0], CFG, adapter_rank=4, n_slots=2,
                             device="cpu")
    paged, dense = factory(False), factory(True)
    assert (paged.kv_layout, dense.kv_layout) == ("paged", "dense")
    assert paged._adapters is not dense._adapters
    assert paged._adapters._host is dense._adapters._host
    assert (paged._adapters.rank, paged._adapters.n_rows) == (4, 3)


# -- priority scheduling with preemption ------------------------------------


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_preempted_requests_keep_their_solo_streams(model, layout):
    """An interactive arrival preempts a decoding best-effort request; the
    victim re-admits, recomputes its K/V and finishes equal to its solo
    decode (greedy and sampled victims alike)."""
    stages, params = model
    kw = ({"block_size": 4, "prefill_chunk": 3} if layout == "paged"
          else {"kv_layout": "dense"})
    eng = InferenceEngine(stages, CFG, n_slots=2,
                          scheduler=PriorityScheduler, device="cpu", **kw)
    b1 = eng.submit(_prompt(6, 1), max_new_tokens=14, seed=11, cls="batch")
    b2 = eng.submit(_prompt(8, 2), max_new_tokens=14, seed=12, cls="batch",
                    temperature=0.8, top_k=5)
    for _ in range(6):
        eng.step()
    it = eng.submit(_prompt(4, 3), max_new_tokens=5, seed=13,
                    cls="interactive", priority=2)
    eng.drain()
    assert b1.n_preempted + b2.n_preempted >= 1 and it.n_preempted == 0
    assert b1.tokens == _solo(model, b1.prompt, 14, 11)
    assert b2.tokens == _solo(model, b2.prompt, 14, 12, 0.8, 5)
    assert it.tokens == _solo(model, it.prompt, 5, 13)


def test_priority_never_preempts_equal_or_higher(model):
    eng = InferenceEngine(model[0], CFG, n_slots=1,
                          scheduler=PriorityScheduler, block_size=4,
                          device="cpu")
    a = eng.submit(_prompt(4, 1), max_new_tokens=10, seed=1,
                   cls="interactive", priority=2)
    eng.step()
    b = eng.submit(_prompt(4, 2), max_new_tokens=4, seed=2,
                   cls="interactive", priority=2)
    eng.drain()
    assert a.n_preempted == 0 and b.n_preempted == 0
    assert a.done_time <= b.first_token_time


def test_dense_layout_checks_follow_the_jax_engine(model):
    for kw, match in ((dict(attn_kernel="fused"), "fused"),
                      (dict(prefill_chunk=3), "paged-pool knobs"),
                      (dict(n_blocks=8), "paged-pool knobs"),
                      (dict(host_cache_blocks=4), "host_cache_blocks")):
        with pytest.raises(ValueError, match=match):
            InferenceEngine(model[0], CFG, kv_layout="dense", device="cpu",
                            **kw)


# -- across packages ----------------------------------------------------------


def test_greedy_crash_plan_gives_the_jax_streams(tmp_path, monkeypatch):
    """The same greedy traffic under the same crash plan through both
    packages' supervisors (paged, one restart mid-decode) emits the same
    streams token for token, and the journals agree line for line."""
    from simple_distributed_machine_learning_tpu.serve.engine import (
        InferenceEngine as JaxEngine,
    )
    monkeypatch.setattr(JaxEngine, "kv_drift", lambda self: (0, 0))
    jcfg = jgpt.GPTConfig(**{k: getattr(CFG, k) for k in (
        "vocab", "seq_len", "d_model", "n_heads", "n_layers")})
    jst = jgpt.make_gpt_stages(jax.random.key(0), jcfg, 2)[0]
    tst = [dataclasses.replace(s, params=p) for s, p in zip(
        tgpt.make_gpt_stages(0, CFG, 2, device="cpu")[0],
        params_from_numpy(jax.tree.map(np.asarray,
                                       [s.params for s in jst]), "cpu"))]
    greedy = [dict(s, temperature=0.0, top_k=None) for s in SPECS]
    out = {}
    for pkg, fmod, sup_cls, fac, stages, cfg, extra in (
            ("jax", jfaults, JaxServeSupervisor, jax_engine_factory, jst,
             jcfg, {}),
            ("port", faults, ServeSupervisor, engine_factory, tst, CFG,
             {"device": "cpu"})):
        fmod.install(fmod.FaultPlan.parse("engine-crash@serve.tick=5"))
        path = str(tmp_path / f"{pkg}.jsonl")
        sup = sup_cls(fac(stages, cfg, n_slots=2, block_size=4,
                          prefill_chunk=3, **extra),
                      RequestJournal(path, sync=False)
                      if pkg == "port" else path)
        hs = [sup.submit(**s, arrival_time=0.0) for s in greedy]
        sup.drain()
        sup.close()
        fmod.uninstall()
        assert sup.restarts == 1
        out[pkg] = ([[int(t) for t in h.tokens] for h in hs],
                    [json.loads(line) for line in open(path)])
    assert out["port"][0] == out["jax"][0]
    assert len({t for s in out["port"][0] for t in s}) > 3

    def strip(events):      # wall-clock token stamps differ per process
        return [{k: v for k, v in e.items() if k != "t"} for e in events]

    assert strip(out["port"][1]) == strip(out["jax"][1])
