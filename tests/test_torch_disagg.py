"""Disaggregated prefill/decode serving in the PyTorch port
(``tests/test_disagg.py``'s pins without the host offload tier, which is
ROADMAP.md, Queue A, item 5.2).

- Every request crosses the prefill->decode handoff and its stream (greedy
  and sampled, paged f32 and int8) equals the symmetric fleet's, which
  equals its solo decode — also with a decode replica killed while
  handoffs land on it, and with the prefill source killed inside the
  adopt->seal window (``fleet.handoff``), where the live-elsewhere guard
  keeps every request served exactly once.
- The journal grammar: the source's terminal ``handoff`` records, the
  adopters' ``why`` causes, and journals written before the field.
- The disagg-prefill-heavy and handoff-replica-loss pins on the virtual
  clock, and the handoff gate.
"""

import dataclasses
import json

import numpy as np
import pytest

from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.ops.random import key_data
from simple_distributed_machine_learning_tpu_torch.resilience import faults
from simple_distributed_machine_learning_tpu_torch.resilience.scenarios import (  # noqa: E501
    SCENARIOS,
    Scenario,
    run_scenario,
)
from simple_distributed_machine_learning_tpu_torch.serve import (
    ServeFleet,
    engine_factory,
)
from simple_distributed_machine_learning_tpu_torch.serve.journal import (
    read_journal,
    recover_state,
)
from simple_distributed_machine_learning_tpu_torch.serve.request import DONE

CFG = tgpt.GPTConfig(vocab=32, seq_len=48, d_model=32, n_heads=2, n_layers=2)


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
    stages = tgpt.make_gpt_stages(0, CFG, 2, device="cpu")[0]
    return stages, [s.params for s in stages]


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    faults.uninstall()
    yield
    faults.uninstall()


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab, n).astype(
        np.int32)


def _solo(model, prompt, n_new, seed, temperature=0.0, top_k=None):
    stages, params = model
    dec = tgpt.make_cached_decoder(stages, CFG, len(prompt), n_new,
                                   temperature=temperature, top_k=top_k,
                                   device="cpu")
    out = dec(params, np.asarray(prompt, np.int32)[None], key_data(seed))
    return out[0, len(prompt):].tolist()


SPECS = [
    dict(prompt=_prompt(5, 1), max_new_tokens=8, seed=11),
    dict(prompt=_prompt(9, 2), max_new_tokens=6, seed=12,
         temperature=0.8, top_k=5),
    dict(prompt=_prompt(3, 3), max_new_tokens=7, seed=13),
    dict(prompt=_prompt(7, 4), max_new_tokens=5, seed=14,
         temperature=1.1, top_k=4),
]


def _fixed_run(model, tmp_path, name, chaos, engine_kw=None, **fleet_kw):
    kw = dict(n_slots=2, block_size=4, prefill_chunk=3, **(engine_kw or {}))
    if chaos:
        faults.install(faults.FaultPlan.parse(chaos))
    fleet = ServeFleet(engine_factory(model[0], CFG, device="cpu", **kw),
                       str(tmp_path / name), n_replicas=3,
                       journal_sync=False, **fleet_kw)
    handles = [fleet.submit(**s) for s in SPECS]
    fleet.drain()
    fleet.close()
    faults.uninstall()
    return fleet, [list(h.tokens) for h in handles]


@pytest.mark.parametrize("cache_dtype", [None, "int8"], ids=["f32", "int8"])
def test_handoff_bitexact_vs_symmetric(model, tmp_path, cache_dtype):
    kw = dict(cache_dtype=cache_dtype)
    _, base = _fixed_run(model, tmp_path, "sym", None, engine_kw=kw)
    fleet, moved = _fixed_run(model, tmp_path, "dis", None, engine_kw=kw,
                              prefill_replicas=1)
    assert fleet.disaggregated and fleet.handoffs == len(SPECS)
    assert [r.role for r in fleet.replicas] == ["prefill", "decode",
                                                "decode"]
    assert moved == base
    if cache_dtype is None:
        assert moved == [_solo(model, s["prompt"], s["max_new_tokens"],
                               s["seed"], s.get("temperature", 0.0),
                               s.get("top_k")) for s in SPECS]
    assert all(r.state == DONE for r in fleet.requests.values())


def test_handoff_racing_replica_loss_bitexact(model, tmp_path):
    _, base = _fixed_run(model, tmp_path, "sym", None)
    fleet, moved = _fixed_run(model, tmp_path, "dis",
                              "replica-kill@fleet.tick=3,rank=1",
                              prefill_replicas=1)
    assert fleet.handoffs >= len(SPECS)
    assert fleet.replica_losses == 1 and fleet.migrations >= 1
    assert moved == base


def test_kill_inside_the_adopt_seal_window_serves_once(model, tmp_path):
    """``replica-kill@fleet.handoff`` kills the prefill source after the
    destination journaled its adopt and before the source's tombstone:
    the dead journal still holds the rid, and the live-elsewhere guard
    must not re-adopt it (a double-serve) nor rewind the live stream."""
    _, base = _fixed_run(model, tmp_path, "sym", None)
    fleet, moved = _fixed_run(model, tmp_path, "race",
                              "replica-kill@fleet.handoff,rank=0",
                              prefill_replicas=1)
    assert fleet.replica_losses == 1 and not fleet.replicas[0].alive
    assert moved == base
    served = [rid for rep in fleet.replicas if rep.alive
              for rid in rep.supervisor.requests]
    assert sorted(served) == sorted(set(served)) == [0, 1, 2, 3]
    assert all(r.state == DONE for r in fleet.requests.values())


def test_handoff_journal_grammar_and_old_journal_tolerance(model, tmp_path):
    fleet, _ = _fixed_run(model, tmp_path, "g", None, prefill_replicas=1)
    events, _ = read_journal(fleet.replicas[0].journal_path)
    assert len([e for e in events if e["ev"] == "handoff"]) == len(SPECS)
    assert recover_state(events) == {}      # terminal: nothing re-admits
    snaps = []
    for rep in fleet.replicas[1:]:
        snaps += [e for e in read_journal(rep.journal_path)[0]
                  if e["ev"] == "snap"]
    assert snaps and all(e["why"] == "handoff" for e in snaps)
    rec = recover_state(snaps)
    assert all(r.snap_reason == "handoff" for r in rec.values())
    old = recover_state([{k: v for k, v in e.items() if k != "why"}
                         for e in snaps])
    assert set(old) == set(rec)
    for rid in rec:
        assert old[rid].tokens == rec[rid].tokens
        assert old[rid].snap_reason is None


def test_failure_migration_snap_says_failure(model, tmp_path):
    fleet, _ = _fixed_run(model, tmp_path, "f", "replica-kill@fleet.tick=3")
    assert fleet.replica_losses == 1 and fleet.migrations >= 1
    whys = [e["why"] for rep in fleet.replicas
            for e in read_journal(rep.journal_path)[0] if e["ev"] == "snap"]
    assert whys and set(whys) == {"failure"}


def test_release_and_seal_validation(model, tmp_path):
    fleet, _ = _fixed_run(model, tmp_path, "v", None, prefill_replicas=1)
    sup = fleet.replicas[1].supervisor
    done_rid = next(iter(sup.requests))
    with pytest.raises(ValueError, match="only live"):
        sup.release(done_rid)
    with pytest.raises(ValueError, match="does not live"):
        sup.release(99)
    with pytest.raises(ValueError, match="still lives"):
        sup.seal_handoff(done_rid)
    with pytest.raises(ValueError, match="already lives"):
        sup.adopt(sup.requests[done_rid])


# -- the scenario pins ----------------------------------------------------------


def test_disagg_prefill_heavy_scenario_pinned(model):
    rep = run_scenario("disagg-prefill-heavy", model[0], CFG, device="cpu")
    assert rep["slo_ok"] and rep["completed"] == 16
    assert rep["fleet"]["prefill_replicas"] == 2
    assert rep["fleet"]["handoffs"] == 16
    assert rep["slo"]["interactive"]["ttft_ms_p95"] == 74.719
    base = run_scenario("disagg-prefill-heavy", model[0], CFG,
                        device="cpu", prefill_replicas=0)
    assert base["completed"] == 16
    assert base["slo"]["interactive"]["ttft_ms_p95"] == 206.719
    assert rep["slo"]["interactive"]["ttft_ms_p95"] * 2 \
        < base["slo"]["interactive"]["ttft_ms_p95"]


def test_handoff_replica_loss_scenario_pinned(model, tmp_path):
    rep = run_scenario("handoff-replica-loss", model[0], CFG,
                       outdir=str(tmp_path), device="cpu")
    assert rep["slo_ok"] and rep["completed"] == 16
    assert rep["fleet"]["prefill_replicas"] == 1
    assert rep["fleet"]["handoffs"] == 16
    assert rep["fleet"]["replica_losses"] == 1
    assert rep["fleet"]["migrations"] >= 1
    assert [(e["event"], e["replica"], e["tick"])
            for e in rep["fleet"]["replica_log"]] == [("loss", 1, 6)]
    recs = [json.loads(ln) for ln in open(tmp_path / "metrics.jsonl")]
    serve = [r for r in recs if r.get("kind") == "serve"][-1]
    assert serve["fleet_handoffs"] == 16
    assert serve["pools"]["prefill"]["replicas"] == 1
    prom = open(tmp_path / "metrics.prom").read()
    assert "serve_fleet_handoffs_total 16" in prom
    for name in ("serve_fleet_handoffs_total", "serve_pool_replicas",
                 "serve_pool_queue_depth", "serve_pool_slots_active"):
        assert f"# HELP {name}" in prom, name
    whys = set()
    for p in tmp_path.glob("journal-handoff-replica-loss-r*.jsonl"):
        whys |= {e["why"] for e in read_journal(str(p))[0]
                 if e["ev"] == "snap"}
    assert whys == {"handoff", "failure"}


def test_handoff_gate_requires_handoffs(model):
    with pytest.raises(ValueError, match="min_handoffs"):
        dataclasses.replace(SCENARIOS["handoff-replica-loss"],
                            name="no-pools", prefill_replicas=0,
                            chaos=None, min_migrations=0)
    starved = dataclasses.replace(SCENARIOS["handoff-replica-loss"],
                                  name="starved", chaos=None,
                                  min_migrations=0, min_handoffs=17)
    rep = run_scenario(starved, model[0], CFG, device="cpu")
    assert rep["completed"] == 16
    assert rep["fleet"]["handoffs"] == 16
    assert not rep["slo_ok"]
    with pytest.raises(ValueError, match="min_handoffs"):
        Scenario(name="x", description="", sim=SCENARIOS["steady"].sim,
                 replicas=2, min_handoffs=1)
