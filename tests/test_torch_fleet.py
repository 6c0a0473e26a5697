"""The port's multi-replica fleet: routing, journal-backed migration,
health-aware rotation and autoscaling (``tests/test_fleet.py``'s pins).

Every migration case holds each request's full token stream (greedy and
sampled) bit for bit against the port's own uninterrupted fleet run and
against its solo ``make_cached_decoder`` decode: a whole replica killed
mid-decode, two at once, one while another recovers from an engine
crash, and the adopter crashing after it adopted. One greedy case runs
the ``fleet-replica-loss`` scenario through both packages and compares
the streams rid by rid. The process-global fault plans are uninstalled
around every test.
"""

import dataclasses
import gc
import json
import weakref

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
from simple_distributed_machine_learning_tpu.serve import (
    ServeMetrics as JaxMetrics,
)
from simple_distributed_machine_learning_tpu.serve import (
    engine_factory as jax_factory,
)
from simple_distributed_machine_learning_tpu.serve.fleet import (
    AutoscalePolicy as JaxPolicy,
)
from simple_distributed_machine_learning_tpu.serve.fleet import (
    ServeFleet as JaxFleet,
)
from simple_distributed_machine_learning_tpu.telemetry import slo as jslo
from simple_distributed_machine_learning_tpu_torch.interop import (
    params_from_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.ops.random import key_data
from simple_distributed_machine_learning_tpu_torch.resilience import faults
from simple_distributed_machine_learning_tpu_torch.resilience import (
    scenarios as tscen,
)
from simple_distributed_machine_learning_tpu_torch.resilience.scenarios import (  # noqa: E501
    SCENARIOS,
    VirtualClock,
    run_scenario,
)
from simple_distributed_machine_learning_tpu_torch.serve import (
    AutoscalePolicy,
    FleetRouter,
    OverloadPolicy,
    RequestJournal,
    ServeFleet,
    ServeMetrics,
    ServeSupervisor,
    engine_factory,
)
from simple_distributed_machine_learning_tpu_torch.serve.request import (
    DONE,
    QUEUED,
    SHED,
)
from simple_distributed_machine_learning_tpu_torch.telemetry import (
    slo as tslo,
)

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
    """Port stages (weights from ``jax.random.key(0)``) and their params,
    plus the JAX build they were carried from."""
    jcfg = jgpt.GPTConfig(**KW)
    jst = jgpt.make_gpt_stages(jax.random.key(0), jcfg, 2)[0]
    nparams = jax.tree.map(np.asarray, [s.params for s in jst])
    tst = tgpt.make_gpt_stages(0, CFG, 2, device="cpu")[0]
    tst = [dataclasses.replace(s, params=p)
           for s, p in zip(tst, params_from_numpy(nparams, "cpu"))]
    return tst, [s.params for s in tst], jcfg, jst


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.setattr(JaxEngine, "kv_drift", lambda self: (0, 0))
    faults.uninstall()
    jfaults.uninstall()
    yield
    faults.uninstall()
    jfaults.uninstall()


def _solo(model, prompt, n_new, seed, temperature=0.0, top_k=None):
    stages, params = model[0], model[1]
    dec = tgpt.make_cached_decoder(stages, CFG, len(prompt), n_new,
                                   temperature=temperature, top_k=top_k,
                                   device="cpu")
    out = dec(params, np.asarray(prompt, np.int32)[None], key_data(seed))
    return out[0, len(prompt):].tolist()


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab, n).astype(
        np.int32)


def _fleet(model, tmp_path, name, clock=None, metrics=None, n_replicas=3,
           engine_kw=None, **fleet_kw):
    kw = dict(engine_kw or {})
    kw.setdefault("n_slots", 2)
    kw.setdefault("block_size", 4)
    kw.setdefault("prefill_chunk", 3)
    if clock is not None:
        kw["clock"] = fleet_kw["clock"] = clock
    if metrics is not None:
        kw["metrics"] = fleet_kw["metrics"] = metrics
    return ServeFleet(engine_factory(model[0], CFG, device="cpu", **kw),
                      str(tmp_path / name), n_replicas=n_replicas,
                      journal_sync=False, **fleet_kw)


SPECS = [
    dict(prompt=_prompt(5, 1), max_new_tokens=8, seed=11),
    dict(prompt=_prompt(9, 2), max_new_tokens=6, seed=12,
         temperature=0.8, top_k=5),
    dict(prompt=_prompt(3, 3), max_new_tokens=7, seed=13),
    dict(prompt=_prompt(7, 4), max_new_tokens=5, seed=14,
         temperature=1.1, top_k=4),
]


def _fixed_run(model, tmp_path, name, chaos, **fleet_kw):
    """The mixed workload (greedy and sampled, varied prompt lengths) over
    a 3-replica fleet, optionally under a chaos schedule."""
    if chaos:
        faults.install(faults.FaultPlan.parse(chaos))
    fleet = _fleet(model, tmp_path, name, **fleet_kw)
    handles = [fleet.submit(**s) for s in SPECS]
    fleet.drain()
    fleet.close()
    faults.uninstall()
    return fleet, [list(h.tokens) for h in handles]


@pytest.fixture(scope="module")
def baseline(model, tmp_path_factory):
    """The uninterrupted fleet run's streams, which equal every request's
    solo decode."""
    _, base = _fixed_run(model, tmp_path_factory.mktemp("base"), "b", None)
    solos = [_solo(model, s["prompt"], s["max_new_tokens"], s["seed"],
                   s.get("temperature", 0.0), s.get("top_k"))
             for s in SPECS]
    assert base == solos
    return base


# -- bit-exact cross-replica migration -------------------------------------------


@pytest.mark.parametrize("chaos,losses,restarts", [
    ("replica-kill@fleet.tick=3", 1, 0),
    # two replicas at one tick: the first loss migrates onto a replica the
    # second then kills; the adoptee recovers again from the adopter's snap
    ("replica-kill@fleet.tick=3,times=2", 2, 0),
    # an engine crash puts one replica into recovery; a kill lands on
    # another one tick later
    ("engine-crash@serve.tick=3;replica-kill@fleet.tick=4,rank=1", 1, 1),
    # the adopter's engine crashes after it adopted: its journal alone
    # (the snap plus later tokens) recovers the adoptee
    ("replica-kill@fleet.tick=3;engine-crash@serve.tick,after=8", 1, None),
], ids=["single-loss", "double-loss", "loss-during-recovery",
        "adopter-crash"])
def test_replica_loss_migrates_bitexact(model, baseline, tmp_path, chaos,
                                        losses, restarts):
    fleet, killed = _fixed_run(model, tmp_path, "k", chaos)
    assert fleet.replica_losses == losses
    assert fleet.migrations >= losses
    n_restarts = sum(r.supervisor.restarts for r in fleet.replicas)
    assert n_restarts >= 1 if restarts is None else n_restarts == restarts
    assert killed == baseline
    assert all(r.state == DONE for r in fleet.requests.values())


def test_lost_replica_pool_is_freed(model, tmp_path):
    """A lost replica's engine, and with it its device K/V pool, goes the
    moment the fleet absorbs the loss (no collector pass needed)."""
    faults.install(faults.FaultPlan.parse("replica-kill@fleet.tick=2"))
    fleet = _fleet(model, tmp_path, "free", n_replicas=2)
    for s in SPECS:
        fleet.submit(**s)
    gc.disable()
    try:
        eng = weakref.ref(fleet.replicas[0].supervisor.engine)
        kc = weakref.ref(fleet.replicas[0].supervisor.engine.pool.kc)
        fleet.step()
        fleet.step()
        assert fleet.replica_losses == 1 and not fleet.replicas[0].alive
        assert eng() is None and kc() is None
    finally:
        gc.enable()
    fleet.drain()
    fleet.close()
    assert all(r.state == DONE for r in fleet.requests.values())


def test_fleet_replica_loss_streams_equal_the_jax_packages(model):
    """The ``fleet-replica-loss`` scenario through both packages: every
    greedy request's stream is equal, rid for rid."""
    tst, _, jcfg, jst = model
    seen = {}

    def capture(module, key):
        inner = module.simulate

        def simulate(target, sim, **kw):
            rep = inner(target, sim, **kw)
            seen[key] = dict(target.requests)
            return rep
        return simulate

    mp = pytest.MonkeyPatch()
    mp.setattr(jscen, "simulate", capture(jscen, "jax"))
    mp.setattr(tscen, "simulate", capture(tscen, "port"))
    try:
        jrep = jscen.run_scenario("fleet-replica-loss", jst, jcfg)
        trep = run_scenario("fleet-replica-loss", tst, CFG, device="cpu")
    finally:
        mp.undo()
    assert trep["fleet"] == jrep["fleet"]
    jreqs, treqs = seen["jax"], seen["port"]
    assert sorted(jreqs) == sorted(treqs) == list(range(16))
    greedy = [rid for rid in jreqs if jreqs[rid].temperature == 0.0]
    assert greedy
    for rid in greedy:
        assert treqs[rid].tokens == list(jreqs[rid].tokens), rid
    for rid in jreqs:
        assert len(treqs[rid].tokens) == len(jreqs[rid].tokens)


def test_fleet_rids_are_globally_unique(model, tmp_path):
    fleet = _fleet(model, tmp_path, "rids", route="round-robin")
    hs = [fleet.submit(_prompt(4, i), max_new_tokens=2, seed=i)
          for i in range(6)]
    assert [h.rid for h in hs] == list(range(6))
    assert len({fleet._home[h.rid] for h in hs}) == 3
    fleet.drain()
    fleet.close()
    assert all(h.state == DONE for h in hs)


# -- health-aware rotation and losses by budget ---------------------------------


def test_crash_recovered_replica_reenters_with_hysteresis(model, tmp_path):
    faults.install(faults.FaultPlan.parse("engine-crash@serve.tick=2"))
    fleet = _fleet(model, tmp_path, "hyst", n_replicas=2,
                   health_recover_ticks=3)
    for s in SPECS:
        fleet.submit(**s)
    fleet.drain()
    fleet.close()
    events = [(e["event"], e["replica"]) for e in fleet.replica_log]
    assert ("drain", 0) in events and ("re-enter", 0) in events
    drain_t = next(e["tick"] for e in fleet.replica_log
                   if e["event"] == "drain")
    reenter_t = next(e["tick"] for e in fleet.replica_log
                     if e["event"] == "re-enter")
    assert reenter_t - drain_t >= 3
    assert all(r.state == DONE for r in fleet.requests.values())


def test_restart_budget_exhaustion_is_a_replica_loss(model, tmp_path):
    faults.install(faults.FaultPlan.parse(
        "engine-crash@serve.tick,times=2"))
    fleet = _fleet(model, tmp_path, "budget", n_replicas=2, max_restarts=1)
    h = fleet.submit(_prompt(5, 1), max_new_tokens=4, seed=21)
    fleet.drain()
    fleet.close()
    assert fleet.replica_losses == 1 and fleet.n_alive == 1
    assert h.state == DONE and h.tokens == _solo(model, h.prompt, 4, 21)


def test_budget_exhaustion_during_admission_is_a_replica_loss(model,
                                                              tmp_path):
    faults.install(faults.FaultPlan.parse("engine-crash@serve.admit=1"))
    fleet = _fleet(model, tmp_path, "admitloss", n_replicas=2,
                   max_restarts=0)
    h0 = fleet.submit(_prompt(5, 1), max_new_tokens=4, seed=21)
    h1 = fleet.submit(_prompt(4, 2), max_new_tokens=4, seed=22)  # crashes
    faults.uninstall()
    assert fleet.replica_losses == 1 and fleet.n_alive == 1
    assert h1.rid == 1 and h1.state == QUEUED
    fleet.drain()
    fleet.close()
    for h in (h0, h1):
        assert h.state == DONE
        assert h.tokens == _solo(model, h.prompt, 4, h.seed)


# -- routing ------------------------------------------------------------------------


def test_affinity_routes_to_prefix_holder(model, tmp_path):
    fleet = _fleet(model, tmp_path, "aff", clock=VirtualClock(0.001),
                   n_replicas=2,
                   engine_kw={"n_slots": 2, "block_size": 4,
                              "prefill_chunk": None})
    p = _prompt(8, 7)
    h0 = fleet.submit(p, max_new_tokens=2, seed=1)
    fleet.drain()                     # registers p's blocks on h0's home
    longer = np.concatenate([p, _prompt(3, 8)])
    for rep in fleet.replicas:
        held = rep.supervisor.pool.shared_prefix_len(longer)
        assert held == (8 if rep.idx == fleet._home[h0.rid] else 0)
    h1 = fleet.submit(longer, max_new_tokens=2, seed=2)
    assert fleet._home[h1.rid] == fleet._home[h0.rid]
    fleet.drain()
    fleet.close()


def test_router_demotion_and_policies():
    """The router unit: affinity prefers the longest prefix, a demoted
    holder is skipped (and counted), least-loaded breaks ties by index,
    round-robin cycles."""

    class Pool:
        def __init__(self, n, active=0):
            self.n, self.n_active, self.n_slots = n, active, 2

        def shared_prefix_len(self, prompt, ns=b""):
            return self.n

        def host_prefix_len(self, prompt, ns=b""):
            return 0

    class Rep:
        def __init__(self, idx, n, qd=0, active=0):
            self.idx = idx
            self.supervisor = type("S", (), {
                "pool": Pool(n, active),
                "scheduler": type("Q", (), {"queue_depth": qd})()})()

    a, b, c = Rep(0, 4, qd=3), Rep(1, 8, qd=5), Rep(2, 0)
    r = FleetRouter("affinity")
    assert r.route([1, 2], [a, b, c]) == (b, True)
    assert r.route([1, 2], [a, b, c], demoted=frozenset({1})) == (a, True)
    assert r.last_suppressed
    r = FleetRouter("least-loaded")
    assert r.route([1], [a, b, c]) == (c, False)
    assert r.route([1], [a, b, c], demoted=frozenset({2})) == (a, False)
    r = FleetRouter("round-robin")
    assert [r.route([1], [a, b, c])[0].idx for _ in range(4)] == [0, 1, 2, 0]
    with pytest.raises(ValueError, match="empty candidate"):
        r.route([1], [])


# -- autoscaling -----------------------------------------------------------------


def test_wall_clock_idle_retire_anchored_at_observation(model, tmp_path):
    class OffsetClock(VirtualClock):
        def __init__(self):
            super().__init__(0.001)
            self._t = 50_000.0               # monotonic-style absolute base

    fleet = _fleet(model, tmp_path, "wall", clock=OffsetClock(),
                   n_replicas=2,
                   autoscale=AutoscalePolicy(min_replicas=1,
                                             max_replicas=2,
                                             retire_idle_s=0.5))
    h = fleet.submit(_prompt(4, 1), max_new_tokens=2, seed=1,
                     arrival_time=50_000.5)
    assert fleet.n_alive == 2
    fleet.drain()
    assert h.state == DONE
    h2 = fleet.submit(_prompt(4, 2), max_new_tokens=2, seed=2,
                      arrival_time=50_010.0)
    assert fleet.n_alive == 1
    assert fleet.replicas[1].supervisor.engine is None   # pool freed
    fleet.drain()
    fleet.close()
    assert h2.state == DONE


def test_autoscale_floor_replaces_lost_replica(model, tmp_path):
    faults.install(faults.FaultPlan.parse("replica-kill@fleet.tick=2"))
    fleet = _fleet(model, tmp_path, "floor", n_replicas=2,
                   autoscale=AutoscalePolicy(min_replicas=2,
                                             max_replicas=3))
    h = fleet.submit(_prompt(5, 1), max_new_tokens=4, seed=1)
    fleet.drain()
    fleet.close()
    assert fleet.replica_losses == 1 and fleet.n_alive == 2
    assert [(e["event"], e["replica"]) for e in fleet.replica_log] == \
        [("loss", 0), ("replace", 2)]
    assert h.state == DONE


@pytest.mark.parametrize("ttft_ms,scales_out", [(999.0, True),
                                                 (5.0, False)])
def test_burn_rate_feeds_autoscaler_scale_out(model, tmp_path, ttft_ms,
                                              scales_out):
    """The optional scale-out trigger (``tests/test_slo.py``'s case, held
    against the JAX fleet): sustained burn counts toward the same backlog
    streak as queue depth, so capacity arrives on latency pressure with
    the queue-depth watermark out of reach; TTFTs inside the SLO burn
    nothing and spawn nothing."""
    pol = dict(min_replicas=1, max_replicas=2, scale_out_queue_depth=999,
               scale_out_ticks=2, retire_idle_s=60.0, scale_out_burn_rate=1.0)
    jclock, jmet = jscen.VirtualClock(per_call_s=0.001), JaxMetrics()
    jslo_eng = jslo.SLOEngine([jslo.SLOObjective("synthetic",
                                                 ttft_slo_ms=10.0)],
                              fast_window=2, slow_window=4)
    jfleet = JaxFleet(
        jax_factory(model[3], model[2], n_slots=2, block_size=4,
                    prefill_chunk=3, clock=jclock, metrics=jmet),
        str(tmp_path / "jax"), n_replicas=1, journal_sync=False,
        clock=jclock, metrics=jmet, slo=jslo_eng,
        autoscale=JaxPolicy(**pol))
    tslo_eng = tslo.SLOEngine([tslo.SLOObjective("synthetic",
                                                 ttft_slo_ms=10.0)],
                              fast_window=2, slow_window=4)
    tfleet = _fleet(model, tmp_path, "port", clock=VirtualClock(0.001),
                    metrics=ServeMetrics(), n_replicas=1, slo=tslo_eng,
                    autoscale=AutoscalePolicy(**pol))
    try:
        alive = []
        for fleet, eng in ((jfleet, jslo_eng), (tfleet, tslo_eng)):
            seen = [fleet.n_alive]
            for _ in range(2):
                eng.observe_ttft("synthetic", ttft_ms)
                fleet.step()
                seen.append(fleet.n_alive)
            alive.append((seen, eng.burn_rates(), fleet.replica_log))
        assert alive[1] == alive[0]
        assert alive[1][0] == ([1, 1, 2] if scales_out else [1, 1, 1])
        assert any(e["event"] == "scale-out"
                   for e in tfleet.replica_log) == scales_out
    finally:
        jfleet.close()
        tfleet.close()


@pytest.mark.parametrize("kv_frac_high,scales_out", [(0.3, True),
                                                      (1.0, False)])
def test_kv_fraction_feeds_autoscaler_scale_out(model, tmp_path,
                                                kv_frac_high, scales_out):
    """The paged-pool scale-out signal (``AutoscalePolicy.kv_frac_high``,
    held against the JAX fleet): with the queue-depth watermark out of
    reach, blocks in use over blocks total at or above the threshold
    count toward the backlog streak, so long prompts filling the pool
    spawn a replica; a threshold the pool never reaches spawns none. The
    replica log and the live count on every tick equal the JAX fleet's."""
    pol = dict(min_replicas=1, max_replicas=2, scale_out_queue_depth=999,
               scale_out_ticks=2, retire_idle_s=60.0,
               kv_frac_high=kv_frac_high)
    eng_kw = dict(n_slots=2, block_size=4, prefill_chunk=8, n_blocks=12,
                  max_len=24)
    jclock = jscen.VirtualClock(per_call_s=0.001)
    jfleet = JaxFleet(
        jax_factory(model[3], model[2], clock=jclock, **eng_kw),
        str(tmp_path / "jax"), n_replicas=1, journal_sync=False,
        clock=jclock, autoscale=JaxPolicy(**pol))
    tfleet = _fleet(model, tmp_path, "port", clock=VirtualClock(0.001),
                    n_replicas=1, engine_kw=eng_kw,
                    autoscale=AutoscalePolicy(**pol))
    try:
        runs = []
        for fleet in (jfleet, tfleet):
            for seed in (1, 2):
                fleet.submit(_prompt(12, seed), max_new_tokens=4,
                             seed=seed)
            seen = [fleet.n_alive]
            for _ in range(4):
                fleet.step()
                seen.append(fleet.n_alive)
            runs.append((seen, fleet.replica_log))
        assert runs[1] == runs[0]
        assert any(e["event"] == "scale-out"
                   for e in tfleet.replica_log) == scales_out
    finally:
        jfleet.close()
        tfleet.close()
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError, match=r"kv_frac_high must be in "
                                             r"\(0, 1\], got"):
            AutoscalePolicy(kv_frac_high=bad)


def test_fleet_replica_restart_writes_tagged_postmortem(model, tmp_path):
    faults.install(faults.FaultPlan.parse("engine-crash@serve.tick=2"))
    fleet = _fleet(model, tmp_path, "pm", n_replicas=2,
                   postmortem_dir=str(tmp_path))
    h = fleet.submit(_prompt(5, 1), max_new_tokens=4, seed=1)
    fleet.drain()
    fleet.close()
    assert h.state == DONE
    bundles = sorted(p.name for p in tmp_path.glob("postmortem-*.json"))
    assert bundles and all(b.startswith("postmortem-r") for b in bundles)
    assert json.load(open(tmp_path / bundles[0]))["flight"]


def test_drain_timeout_dumps_one_tagged_bundle_per_replica(model,
                                                           tmp_path):
    from simple_distributed_machine_learning_tpu_torch.serve import (
        DrainTimeout,
    )
    fleet = _fleet(model, tmp_path, "dt", n_replicas=2,
                   postmortem_dir=str(tmp_path))
    for s in SPECS:
        fleet.submit(**s)
    with pytest.raises(DrainTimeout):
        fleet.drain(max_ticks=2)
    names = sorted(p.name for p in tmp_path.glob("postmortem-*.json"))
    assert names == ["postmortem-r0-000-drain_timeout.json",
                     "postmortem-r1-000-drain_timeout.json"]
    fleet.close()


# -- the fleet-replica-loss gate and record --------------------------------------


def test_fleet_scenario_gate_requires_migrations(model):
    quiet = dataclasses.replace(SCENARIOS["fleet-replica-loss"],
                                name="fleet-no-kill", chaos=None)
    report = run_scenario(quiet, model[0], CFG, device="cpu")
    assert report["completed"] == 16
    assert report["fleet"]["migrations"] == 0
    assert report["slo_ok"] is False


def test_fleet_scenario_emits_gateable_record(model, tmp_path):
    report = run_scenario("fleet-replica-loss", model[0], CFG,
                          outdir=str(tmp_path), device="cpu")
    assert report["slo_ok"] is True
    recs = [json.loads(ln) for ln in open(tmp_path / "metrics.jsonl")]
    scen = [r for r in recs if r.get("kind") == "scenario"][-1]
    assert scen["fleet"]["migrations"] >= 1
    assert scen["fleet"]["replica_losses"] == 1
    serve = [r for r in recs if r.get("kind") == "serve"][-1]
    assert serve["fleet_migrations"] == scen["fleet"]["migrations"]
    assert len(list(tmp_path.glob(
        "journal-fleet-replica-loss-r*.jsonl"))) == 3
    prom = open(tmp_path / "metrics.prom").read()
    for name in ("serve_fleet_replicas", "serve_fleet_migrations_total",
                 "serve_route_affinity_hits_total"):
        assert f"# HELP {name}" in prom, name


# -- journal rotation and per-replica buckets -----------------------------------


def test_journal_rotation_recovery_byte_identical(model, tmp_path):
    path = str(tmp_path / "rot.jsonl")
    factory = engine_factory(model[0], CFG, n_slots=2, block_size=4,
                             prefill_chunk=3, device="cpu")
    sup = ServeSupervisor(factory, RequestJournal(path, sync=False))
    h1 = sup.submit(_prompt(5, 1), max_new_tokens=8, seed=31)
    h2 = sup.submit(_prompt(7, 2), max_new_tokens=6, seed=32,
                    temperature=0.9, top_k=4)
    for _ in range(6):
        sup.step()
    assert 0 < len(h1.tokens) < 8

    def key(snaps):
        return {rid: (r.state, list(r.tokens),
                      None if r.key_data is None
                      else [int(x) for x in r.key_data],
                      r.submit_time, r.first_token_time, r.done_time)
                for rid, r in snaps.items()}

    before = key(sup.journal.recovered_state())
    pre_bytes = sup.journal.bytes
    assert sup.journal.rotate() > 0 and sup.journal.bytes < pre_bytes
    assert key(sup.journal.recovered_state()) == before
    sup.drain()
    sup.close()
    sup2 = ServeSupervisor(factory, RequestJournal(path, sync=False))
    assert not sup2.busy
    assert [sup2.requests[h1.rid].tokens, sup2.requests[h2.rid].tokens] \
        == [h1.tokens, h2.tokens]
    sup2.close()


def test_token_bucket_not_shared_across_replicas(model, tmp_path):
    policy = OverloadPolicy(class_rates={"batch": (0.1, 1)})
    fleet = _fleet(model, tmp_path, "buckets", clock=VirtualClock(0.001),
                   n_replicas=2, route="round-robin", overload=policy)
    a = fleet.submit(_prompt(4, 1), max_new_tokens=2, seed=1, cls="batch",
                     arrival_time=0.001)
    b = fleet.submit(_prompt(4, 2), max_new_tokens=2, seed=2, cls="batch",
                     arrival_time=0.002)
    assert fleet._home[a.rid] != fleet._home[b.rid]
    assert a.state == QUEUED and b.state == QUEUED
    c = fleet.submit(_prompt(4, 3), max_new_tokens=2, seed=3, cls="batch",
                     arrival_time=0.003)
    assert c.state == SHED and c.finish_reason == "class"
    fleet.drain()
    fleet.close()


# -- validation -------------------------------------------------------------------


def test_router_and_autoscale_validation():
    with pytest.raises(ValueError, match="route policy"):
        FleetRouter("fastest")
    for kw, match in ((dict(min_replicas=0), "min_replicas"),
                      (dict(min_replicas=3, max_replicas=2),
                       "max_replicas"),
                      (dict(retire_idle_s=0), "retire_idle_s"),
                      (dict(scale_out_burn_rate=0), "scale_out_burn_rate")):
        with pytest.raises(ValueError, match=match):
            AutoscalePolicy(**kw)


def test_fleet_constructor_validation(model, tmp_path):
    with pytest.raises(ValueError, match="n_replicas"):
        _fleet(model, tmp_path, "v1", n_replicas=0)
    with pytest.raises(ValueError, match="autoscale bounds"):
        _fleet(model, tmp_path, "v2", n_replicas=5,
               autoscale=AutoscalePolicy(min_replicas=1, max_replicas=3))
    with pytest.raises(ValueError, match="at least one decode"):
        _fleet(model, tmp_path, "v3", n_replicas=2, prefill_replicas=2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        _fleet(model, tmp_path, "v4", n_replicas=2, prefill_replicas=1,
               autoscale=AutoscalePolicy(min_replicas=1, max_replicas=3))


def test_scenario_fleet_field_validation():
    base = SCENARIOS["fleet-replica-loss"]
    with pytest.raises(ValueError, match="drop supervised"):
        dataclasses.replace(base, supervised=True)
    with pytest.raises(ValueError, match="fleet knobs"):
        dataclasses.replace(SCENARIOS["steady"], min_migrations=1)
    with pytest.raises(ValueError, match="route"):
        dataclasses.replace(base, route="fastest")
    with pytest.raises(ValueError, match="min_handoffs needs"):
        dataclasses.replace(base, min_handoffs=1)


def test_adapters_and_host_tier_on_the_fleet_name_item_5(model, tmp_path):
    """Item 5's two fleet surfaces are ported (the name stays from when
    they raised naming it): on a fleet built without adapters a named
    adapter fails before anything is journaled, registration names the
    missing ``adapter_rank``, and the routing-time prefetch is a no-op on
    pools without a host tier."""
    fleet = _fleet(model, tmp_path, "ext", n_replicas=2)
    with pytest.raises(ValueError, match="without an AdapterStore"):
        fleet.submit(_prompt(4, 1), max_new_tokens=2, adapter="tenant")
    with pytest.raises(ValueError, match="adapter_rank"):
        fleet.register_adapter("tenant", {})
    assert fleet._prefetch_host(_prompt(4, 1), fleet.replicas) is None
    assert fleet.requests == {} and fleet._next_rid == 0
    fleet.close()


def test_router_host_tier_and_adapter_signals():
    """The router unit with the two signals the tier and the adapters add:
    a host-resident prefix is an affinity hit; a prefix probe is scoped
    to the request's adapter namespace (a replica without a store cannot
    serve the tenant's cache); with no prefix anywhere a replica holding
    the adapter wins over the least-loaded one and is counted; the
    baseline policies stay adapter-blind."""

    class Store:
        def __init__(self, resident):
            self.resident = resident

        def namespace_of(self, name):
            return name.encode() + b"@"

        def is_resident(self, name):
            return name in self.resident

    class Pool:
        def __init__(self, dev=None, host=None):
            self.dev, self.host = dev or {}, host or {}
            self.n_active, self.n_slots = 0, 2

        def shared_prefix_len(self, prompt, ns=b""):
            return self.dev.get(ns, 0)

        def host_prefix_len(self, prompt, ns=b""):
            return self.host.get(ns, 0)

    class Rep:
        def __init__(self, idx, pool, store=None, qd=0):
            self.idx = idx
            eng = type("E", (), {"_adapters": store})()
            self.supervisor = type("S", (), {
                "pool": pool, "engine": eng,
                "scheduler": type("Q", (), {"queue_depth": qd})()})()

    a = Rep(0, Pool(dev={b"": 4}), Store(()), qd=1)
    b = Rep(1, Pool(host={b"": 8}), Store({"t"}), qd=2)
    c = Rep(2, Pool(dev={b"t@": 2}), Store(()))
    r = FleetRouter("affinity")
    assert r.route([1, 2], [a, b, c]) == (b, True)      # host prefix wins
    assert not r.last_adapter_hit
    assert r.route([1, 2], [a, b, c], adapter="t") == (c, True)
    assert not r.last_adapter_hit                      # c lacks the row
    assert r.route([1, 2], [a, b], adapter="t") == (b, False)
    assert r.last_adapter_hit                          # resident, no prefix
    bare = Rep(3, Pool(dev={b"": 9}))                  # no adapter store
    assert r.route([1, 2], [bare, a], adapter="u") == (bare, False)
    assert not r.last_adapter_hit
    rr = FleetRouter("round-robin")
    assert rr.route([1], [a, b], adapter="t") == (a, False)
    assert not rr.last_adapter_hit
