"""The host offload tier of the port's paged pool (``tests/test_disagg.py``'s
host-tier cases, ported against the JAX package).

- A demoted-then-promoted block equals its bytes before demotion, bit for
  bit, for f32, bf16, int8, float8_e4m3fn and float8_e5m2 pools (the
  narrow data and its f32 scale planes travel together).
- Routing-time prefetch: an affinity hit on a host-resident prefix starts
  the upload at submit, the request does not board while it flies
  (``prefetch_ticks=3``), and its stream equals the solo decode; the pool
  counters equal the JAX fleet's at every checkpoint. Misses are counted.
- A key registered on the device while its upload flew wins, and the
  upload's block goes back to the free list.
- The host gauges on every tick of a disaggregated run with the tier
  (mid-handoff, post-demote, prefetch in flight): resident bytes are host
  blocks x ``kv_block_bytes``, transfer bytes are (demotes + promotes) x
  ``kv_block_bytes``; a replica loss migrates with the tier on and every
  stream still equals the solo decode; flight rows carry the pool role
  and the host stats.
- The offload-churn pin, equal to the JAX run's (``kv_drift`` patched on
  the JAX engine: its analyzer does not import on this tree), with
  the HBM-only contrast: 16 prefix-hit blocks against 10, and greedy
  streams unchanged by the tier.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu.models import gpt as jgpt
from simple_distributed_machine_learning_tpu.resilience import (
    scenarios as jscen,
)
from simple_distributed_machine_learning_tpu.serve import (
    ServeFleet as JaxServeFleet,
)
from simple_distributed_machine_learning_tpu.serve import (
    engine_factory as jax_engine_factory,
)
from simple_distributed_machine_learning_tpu.serve.engine import (
    InferenceEngine as JaxEngine,
)
from simple_distributed_machine_learning_tpu.serve.tracing import (
    ServeTrace as JaxServeTrace,
)
from simple_distributed_machine_learning_tpu.telemetry import (
    attribution as jatt,
)
from simple_distributed_machine_learning_tpu_torch.interop import (
    params_from_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.ops.random import key_data
from simple_distributed_machine_learning_tpu_torch.resilience import faults
from simple_distributed_machine_learning_tpu_torch.resilience import (
    scenarios as tscen,
)
from simple_distributed_machine_learning_tpu_torch.serve import (
    InferenceEngine,
    PagedKVPool,
    ServeFleet,
    ServeTrace,
    engine_factory,
)
from simple_distributed_machine_learning_tpu_torch.serve.flight import (
    FlightRecorder,
)
from simple_distributed_machine_learning_tpu_torch.serve.request import (
    DONE,
    Request,
)
from simple_distributed_machine_learning_tpu_torch.serve.slots import (
    kv_block_bytes,
)
from simple_distributed_machine_learning_tpu_torch.telemetry import (
    attribution as tatt,
)

KW = dict(vocab=32, seq_len=48, d_model=32, n_heads=2, n_layers=2)
CFG = tgpt.GPTConfig(**KW)
OFFLOAD_KW = dict(n_slots=2, block_size=4, n_blocks=6, max_len=24,
                  prefill_chunk=4, host_cache_blocks=8)
HOST_TIER_PIN = {"host_cache_blocks": 12, "demotes": 66, "promotes": 5,
                 "prefetch_hits": 3, "prefetch_misses": 0,
                 "host_evictions": 53, "transfer_bytes": 145408}
HOST_METRICS = ("serve_host_blocks", "serve_host_bytes_resident",
                "serve_host_inflight_blocks", "serve_host_demotes_total",
                "serve_host_promotes_total", "serve_host_evictions_total",
                "serve_host_prefetch_hits_total",
                "serve_host_prefetch_misses_total",
                "serve_host_transfer_bytes_total")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread while this module runs: its models are
    tiny, and under a multi-process test run more threads only contend
    for the same cores. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """``(jax_cfg, jax_stages, port_stages, port_params)`` over one set of
    weights."""
    jcfg = jgpt.GPTConfig(**KW)
    jst = jgpt.make_gpt_stages(jax.random.key(0), jcfg, 2)[0]
    nparams = jax.tree.map(np.asarray, [s.params for s in jst])
    tst = tgpt.make_gpt_stages(0, CFG, 2, device="cpu")[0]
    tst = [dataclasses.replace(s, params=p)
           for s, p in zip(tst, params_from_numpy(nparams, "cpu"))]
    return jcfg, jst, tst, [s.params for s in tst]


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.setattr(JaxEngine, "kv_drift", lambda self: (0, 0))
    faults.uninstall()
    yield
    faults.uninstall()


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab, n).astype(
        np.int32)


def _solo(model, prompt, n_new, seed):
    stages, params = model[2], model[3]
    dec = tgpt.make_cached_decoder(stages, CFG, len(prompt), n_new,
                                   device="cpu")
    out = dec(params, np.asarray(prompt, np.int32)[None], key_data(seed))
    return out[0, len(prompt):].tolist()


def _offload_fleet(model, tmp_path, name, n_replicas=1, prefill_replicas=0,
                   prefetch_ticks=3):
    return ServeFleet(
        engine_factory(model[2], CFG, device="cpu",
                       prefetch_ticks=prefetch_ticks, **OFFLOAD_KW),
        os.path.join(str(tmp_path), name), n_replicas=n_replicas,
        prefill_replicas=prefill_replicas, journal_sync=False)


# -- the block round trip ----------------------------------------------------


def _leaves(cache, block):
    """Every stored byte of one physical block, data and scale planes."""
    leaves = cache if isinstance(cache, tgpt.QuantKV) else (cache,)
    return [leaf[:, block].clone() for leaf in leaves]


def _fill(pool, blocks, seed):
    """Random BYTES into ``blocks`` of every stored leaf (scales too), as
    the programs' writes would leave them."""
    g = torch.Generator().manual_seed(seed)
    for cache in (pool.kc, pool.vc):
        for leaf in (cache if isinstance(cache, tgpt.QuantKV) else (cache,)):
            raw = leaf.view(torch.uint8)
            for b in blocks:
                raw[:, b] = torch.randint(0, 256, raw[:, b].shape,
                                          generator=g, dtype=torch.uint8)


def _board(pool, rid, prompt, max_new):
    r = Request(rid=rid, prompt=prompt, max_new_tokens=max_new)
    r.slot = pool.acquire(rid)
    pool.bind_seq(r)
    for p in range(len(prompt)):
        assert pool.ensure_writable(r.slot, p) is None
    return r


@pytest.mark.parametrize("cache_dtype", [None, "bfloat16", "int8",
                                         "float8_e4m3fn", "float8_e5m2"],
                         ids=["f32", "bf16", "int8", "e4m3", "e5m2"])
def test_demoted_then_promoted_block_is_bit_exact(cache_dtype):
    """Prefill a prefix, evict it into the host tier with another
    sequence's allocation (which then overwrites the device block), upload
    it back: the promoted block's bytes equal the bytes before demotion,
    every layer, K and V, data and scales."""
    pool = PagedKVPool(2, 1, 2, 8, 16, cache_dtype, block_size=4,
                       n_blocks=2, host_cache_blocks=4, device="cpu")
    p1 = _prompt(5, 1)
    r1 = _board(pool, 0, p1, 1)
    _fill(pool, pool.tables[0], seed=1)
    want = [_leaves(c, pool.tables[0][0]) for c in (pool.kc, pool.vc)]
    pool.register_prefix(0, p1)
    pool.unbind_seq(0)
    pool.release(r1.slot)
    r2 = _board(pool, 1, _prompt(5, 2), 1)     # evicts and demotes both
    assert pool.host_demotes_total == 2 and pool.host_prefix_len(p1) == 4
    _fill(pool, pool.tables[0], seed=2)        # the device copy is gone
    pool.unbind_seq(0)
    pool.release(r2.slot)
    assert pool.shared_prefix_len(p1) == 0
    assert pool.prefetch(p1) is True
    pool.advance_transfers()
    assert pool.host_promotes_total == 1 and pool.shared_prefix_len(p1) == 4
    block = pool._prefix[p1[:4].tobytes()][0]
    got = [_leaves(c, block) for c in (pool.kc, pool.vc)]
    for ws, gs in zip(want, got):
        for w, g in zip(ws, gs):
            assert w.dtype == g.dtype
            assert torch.equal(w.view(torch.uint8), g.view(torch.uint8))
    st = pool.stats()
    assert st["host_transfer_bytes_total"] == 3 * pool.bytes_per_block
    assert st["host_bytes_resident"] == 2 * pool.bytes_per_block


def test_pool_and_engine_check_the_host_tier_knobs(model):
    with pytest.raises(ValueError, match="host_cache_blocks must be >= 0"):
        PagedKVPool(2, 1, 2, 8, 16, host_cache_blocks=-1, device="cpu")
    with pytest.raises(ValueError, match="prefetch_ticks must be >= 1"):
        PagedKVPool(2, 1, 2, 8, 16, prefetch_ticks=0, device="cpu")
    pool = PagedKVPool(2, 1, 2, 8, 16, device="cpu")
    assert pool.prefetch(_prompt(5, 1)) is False       # no tier: no-op
    assert "host_blocks" not in pool.stats()
    eng = InferenceEngine(model[2], CFG, n_slots=2, host_cache_blocks=4,
                          prefetch_ticks=2, device="cpu")
    assert (eng.pool.host_cache_blocks, eng.pool.prefetch_ticks) == (4, 2)


def test_first_writer_wins_over_an_upload_in_flight(model):
    """A request whose prompt IS the in-flight key boards (only a longer
    sequence waits for an upload), registers the key first, and the
    upload then hands its block back instead of promoting."""
    eng = InferenceEngine(model[2], CFG, device="cpu", prefetch_ticks=3,
                          **OFFLOAD_KW)
    pool = eng.pool
    p = _prompt(9, 1)
    eng.submit(p, max_new_tokens=4, seed=1)
    eng.drain()
    eng.submit(_prompt(16, 7), max_new_tokens=8, seed=2)
    eng.drain()
    assert pool.host_prefix_len(p) == 8 and pool.shared_prefix_len(p) == 0
    assert pool.prefetch(p) is True
    h = eng.submit(p[:4], max_new_tokens=6, seed=3)
    assert not pool.prefetch_blocked(h)
    eng.drain()
    assert pool.host_promotes_total == 1            # p[:8] landed, p[:4] not
    assert pool.stats()["host_inflight_blocks"] == 0
    assert p[:4].tobytes() in pool._prefix
    # no block leaked: the losing upload's block went back to the free list
    assert pool.blocks_in_use == 0
    assert len(pool._free_blocks) + pool.blocks_cached == pool.n_blocks
    assert h.tokens == _solo(model, p[:4], 6, 3)


def _gate_drive(eng):
    """Demote a prefix to the host tier, start its upload, then queue a
    request that carries it: the request waits on its own upload (the
    prefetch gate) until the blocks land, then boards. Returns its
    tokens."""
    pool = eng.pool
    p = _prompt(9, 1)
    eng.submit(p, max_new_tokens=4, seed=1)
    eng.drain()
    eng.submit(_prompt(16, 7), max_new_tokens=8, seed=2)
    eng.drain()
    assert pool.prefetch(p) is True
    # a request in decode makes the ticks of the wait read the clock
    busy = eng.submit(_prompt(5, 3), max_new_tokens=6, seed=4)
    h = eng.submit(p, max_new_tokens=4, seed=3)
    assert pool.prefetch_blocked(h)
    eng.drain()
    return [[int(t) for t in r.tokens] for r in (busy, h)]


def test_traced_prefetch_gate_rows_and_attribution_equal_jax(model):
    """A traced engine whose queued request waits on its own in-flight
    upload writes one ``gate`` row (``ServeTrace.on_gate``: the queue wait
    ends, the prefetch wait begins), and the attribution fold carries a
    nonzero ``prefetch`` component; the rows and the attribution block
    equal the JAX engine's on the same weights and virtual clock."""
    runs = []
    for make_eng, make_trace, clock, att in (
            (JaxEngine, JaxServeTrace, jscen.VirtualClock(0.001), jatt),
            (InferenceEngine, ServeTrace, tscen.VirtualClock(0.001), tatt)):
        stages, cfg = ((model[1], model[0]) if make_eng is JaxEngine
                       else (model[2], CFG))
        kw = {} if make_eng is JaxEngine else {"device": "cpu"}
        trace = make_trace()
        eng = make_eng(stages, cfg, prefetch_ticks=3, clock=clock,
                       trace=trace, **OFFLOAD_KW, **kw)
        toks = _gate_drive(eng)
        rows = trace.rows
        runs.append((toks, rows, att.attribute(rows)))
    (jtoks, jrows, jblock), (toks, rows, block) = runs
    gates = [r for r in rows if r["ev"] == "gate"]
    assert len(gates) == 1 and gates[0]["rid"] == 3
    slow = {a["rid"]: a["components_ms"] for a in block["top_slow"]}
    assert slow[3].get("prefetch", 0) > 0
    assert toks == jtoks == [_solo(model, _prompt(5, 3), 6, 4),
                             _solo(model, _prompt(9, 1), 4, 3)]
    assert rows == jrows
    assert block == jblock


# -- routing-time prefetch ---------------------------------------------------------


def _prefetch_drive(fleet, pool, solo=None):
    """``tests/test_disagg.py``'s prefetch drive; returns the pool stats at
    each checkpoint and the prefetched request's tokens."""
    p = _prompt(9, 1)
    marks = []
    fleet.submit(p, max_new_tokens=4, seed=21)
    fleet.drain()
    fleet.submit(_prompt(16, 7), max_new_tokens=8, seed=22)
    fleet.drain()
    marks.append(dict(pool.stats()))
    assert pool.host_prefix_len(p) == 8 and pool.shared_prefix_len(p) == 0
    h = fleet.submit(p, max_new_tokens=4, seed=23)
    marks.append(dict(pool.stats()))
    fleet.step()
    assert h.slot is None and not h.tokens
    assert pool.prefetch_blocked(h)
    marks.append(dict(pool.stats()))
    fleet.drain()
    fleet.close()
    marks.append(dict(pool.stats()))
    return marks, [int(t) for t in h.tokens], p


def test_prefetch_starts_at_submit_and_blocks_boarding_as_in_jax(model,
                                                                  tmp_path):
    """Demote a hot prefix to host, submit a request carrying it: the
    upload is in flight before any tick, the request does not board while
    it flies, and once landed its stream equals the solo decode; the pool
    counters equal the JAX fleet's at every checkpoint."""
    fleet = _offload_fleet(model, tmp_path, "p")
    marks, toks, p = _prefetch_drive(fleet,
                                     fleet.replicas[0].supervisor.pool)
    assert marks[0]["host_demotes_total"] >= 2
    assert (marks[1]["host_prefetch_hits_total"],
            marks[1]["host_inflight_blocks"]) == (1, 2)
    assert marks[2]["host_inflight_blocks"] == 2
    assert (marks[3]["host_promotes_total"],
            marks[3]["host_inflight_blocks"]) == (2, 0)
    assert toks == _solo(model, p, 4, 23)
    jcfg, jst = model[0], model[1]
    jfleet = JaxServeFleet(
        jax_engine_factory(jst, jcfg, prefetch_ticks=3, **OFFLOAD_KW),
        os.path.join(str(tmp_path), "jp"), n_replicas=1, journal_sync=False)
    jmarks, jtoks, _ = _prefetch_drive(jfleet,
                                       jfleet.replicas[0].supervisor.pool)
    assert marks == jmarks
    assert toks == jtoks


def test_prefetch_misses_are_counted_not_fatal(model, tmp_path):
    fleet = _offload_fleet(model, tmp_path, "m")
    pool = fleet.replicas[0].supervisor.pool
    assert pool.prefetch(_prompt(8, 9)) is False
    assert pool.stats()["host_prefetch_misses_total"] == 1
    h = fleet.submit(_prompt(8, 9), max_new_tokens=2, seed=31)
    fleet.drain()
    fleet.close()
    assert h.state == DONE and len(h.tokens) == 2


# -- the gauges on every tick, migration, flight rows ------------------------------


def test_host_gauges_hold_on_every_tick_across_shapes(model, tmp_path):
    """Host resident bytes and transfer bytes follow the block formula on
    every tick of a disaggregated run with the tier, which passes through
    a handoff, a demotion and an upload in flight."""
    fleet = _offload_fleet(model, tmp_path, "a", n_replicas=2,
                           prefill_replicas=1, prefetch_ticks=2)
    per = kv_block_bytes(CFG.n_layers, CFG.n_heads, 4,
                         CFG.d_model // CFG.n_heads)
    seen = {"mid_handoff": False, "post_demote": False,
            "prefetch_inflight": False}

    def check():
        for rep in fleet.replicas:
            if not rep.alive:
                continue
            st = rep.supervisor.pool.stats()
            assert st["host_bytes_resident"] == st["host_blocks"] * per
            assert st["host_transfer_bytes_total"] == per * (
                st["host_demotes_total"] + st["host_promotes_total"])
            seen["post_demote"] |= st["host_demotes_total"] > 0
            seen["prefetch_inflight"] |= st["host_inflight_blocks"] > 0

    def run(submits):
        last = fleet.handoffs
        for prompt, max_new, seed in submits:
            fleet.submit(prompt, max_new_tokens=max_new, seed=seed)
            check()
        while fleet.busy:
            fleet.step()
            if fleet.handoffs > last:
                seen["mid_handoff"] = True
                last = fleet.handoffs
            check()

    p = _prompt(8, 1)
    run([(p, 4, 41)])                           # registers the prefix
    run([(_prompt(16, 7), 8, 42)])              # churns it out -> demote
    run([(p, 4, 43)])                           # upload in flight
    fleet.close()
    assert fleet.handoffs >= 3
    assert all(seen.values()), seen


def test_replica_loss_with_the_tier_keeps_every_stream(model, tmp_path):
    """Two replicas with the tier, one killed mid-run: its requests
    migrate off its journal, and every stream equals the solo decode."""
    faults.install(faults.FaultPlan.parse("replica-kill@fleet.tick=3"))
    fleet = _offload_fleet(model, tmp_path, "k", n_replicas=2,
                           prefetch_ticks=1)
    specs = [(_prompt(9, 1), 4, 51), (_prompt(16, 7), 6, 52),
             (_prompt(9, 1), 5, 53), (_prompt(6, 3), 5, 54)]
    hs = [fleet.submit(p, max_new_tokens=n, seed=s) for p, n, s in specs]
    fleet.drain()
    fleet.close()
    assert fleet.replica_losses == 1 and fleet.migrations >= 1
    for h, (p, n, s) in zip(hs, specs):
        assert fleet.requests[h.rid].tokens == _solo(model, p, n, s)


def test_flight_rows_carry_pool_role_and_host_stats(model, tmp_path):
    fleet = _offload_fleet(model, tmp_path, "fl", n_replicas=2,
                           prefill_replicas=1)
    for rep in fleet.replicas:
        rep.supervisor.flight = FlightRecorder()
    fleet.submit(_prompt(8, 1), max_new_tokens=4, seed=51)
    fleet.submit(_prompt(16, 7), max_new_tokens=6, seed=52)
    fleet.drain()
    fleet.close()
    roles = set()
    for rep in fleet.replicas:
        rows = rep.supervisor.flight.rows()
        assert rows
        for row in rows:
            assert row["pool_role"] == rep.role
            assert "host_blocks" in row["blocks"]
            assert "host_inflight_blocks" in row["blocks"]
        roles.add(rep.role)
    assert roles == {"prefill", "decode"}


# -- the offload-churn pin, both packages -------------------------------------------


def _serve_record(outdir):
    recs = [json.loads(ln) for ln in open(os.path.join(outdir,
                                                       "metrics.jsonl"))]
    return [r for r in recs if r.get("kind") == "serve"][-1]


def test_offload_churn_equals_the_jax_run_and_beats_hbm_only(model,
                                                            tmp_path,
                                                            monkeypatch):
    """Under hot-prefix churn the host tier's demote/promote/prefetch
    cycle is pinned exactly in both packages, and its device prefix-hit
    blocks (16) strictly exceed the HBM-only run's (10); the serve record
    and the metric catalog's HELP lines carry the tier; greedy streams do
    not change with the tier on."""
    jcfg, jst, stages, _ = model
    seen = {}
    inner = tscen.simulate

    def simulate(target, sim, **kw):
        report = inner(target, sim, **kw)
        seen.setdefault("runs", []).append(
            [list(r.tokens) for _, r in sorted(target.requests.items())])
        return report

    monkeypatch.setattr(tscen, "simulate", simulate)
    hbm = dataclasses.replace(tscen.SCENARIOS["offload-churn"],
                              name="offload-hbm-only", host_cache_blocks=0,
                              min_host_demotes=0, min_host_prefetch_hits=0)
    jhbm = dataclasses.replace(jscen.SCENARIOS["offload-churn"],
                               name="offload-hbm-only", host_cache_blocks=0,
                               min_host_demotes=0, min_host_prefetch_hits=0)
    rows = {}
    for tag, run, scen, hbm_scen in (
            ("port", lambda s, d: tscen.run_scenario(
                s, stages, CFG, outdir=d, device="cpu"),
             "offload-churn", hbm),
            ("jax", lambda s, d: jscen.run_scenario(s, jst, jcfg, outdir=d),
             "offload-churn", jhbm)):
        d = str(tmp_path / tag)
        rep = run(scen, d)
        assert rep["slo_ok"] and rep["completed"] == 24
        assert rep["host_tier"] == HOST_TIER_PIN
        serve = _serve_record(d)
        assert serve["prefix_hit_blocks"] == 16
        assert (serve["host_demotes"], serve["host_promotes"],
                serve["host_transfer_bytes"]) == (66, 5, 145408)
        prom = open(os.path.join(d, "metrics.prom")).read()
        for name in HOST_METRICS:
            assert f"# HELP {name}" in prom, name
        base = run(hbm_scen, d + "-hbm")
        assert base["completed"] == 24 and "host_tier" not in base
        assert _serve_record(d + "-hbm")["prefix_hit_blocks"] == 10
        rows[tag] = {k: serve[k] for k in serve
                     if k.startswith(("host_", "prefix_hit", "block"))}
    assert rows["port"] == rows["jax"]
    with_tier, without = seen["runs"]
    assert with_tier == without
