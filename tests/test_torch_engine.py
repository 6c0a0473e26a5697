"""The port's serving engine against the JAX package's, and against itself.

Across packages (same weights, carried by ``interop.params_from_numpy``):
the same request mix — chunked prefill, a shared prefix, a request whose
prompt is another's prefix (copy-on-write) — through both engines gives
equal greedy token streams, token for token, with ``attn_kernel="fused"``
(the JAX Pallas kernel in interpret mode; the port's plain version on
CPU tensors) and ``"dense"``, and equal prefix-share and CoW counts.

Within the port: every stream, greedy and sampled, equals the solo
``make_cached_decoder`` decode with the same seed; fused equals dense for
greedy decoding with every cache dtype.
"""

import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu.models import gpt as jgpt
from simple_distributed_machine_learning_tpu.serve import (
    InferenceEngine as JaxEngine,
)
from simple_distributed_machine_learning_tpu_torch.interop import (
    params_from_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.ops.random import key_data
from simple_distributed_machine_learning_tpu_torch.serve import (
    AdapterStore,
    DrainTimeout,
    InferenceEngine,
    ServeMetrics,
    SimConfig,
    simulate,
)

SMALL = dict(vocab=64, seq_len=32, d_model=32, n_heads=2, n_layers=2)
REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = "simple_distributed_machine_learning_tpu_torch"


@pytest.fixture(scope="module")
def weights():
    """One set of numpy weights (a JAX build plus seeded noise, std 0.5)
    in both packages: ``(jcfg, jstages, jparams, tcfg, tstages, tparams)``."""
    jcfg = jgpt.GPTConfig(**SMALL)
    jst = jgpt.make_gpt_stages(jax.random.key(0), jcfg, 1)[0]
    rng = np.random.default_rng(0)
    nparams = jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0.0, 0.5, a.shape)
                   ).astype(np.float32), [s.params for s in jst])
    tcfg = tgpt.GPTConfig(**SMALL)
    tst = tgpt.make_gpt_stages(0, tcfg, 1, device="cpu")[0]
    return (jcfg, jst, jax.tree.map(jnp.asarray, nparams), tcfg, tst,
            params_from_numpy(nparams, "cpu"))


def _mix(sampled: bool = False) -> list[dict]:
    """Five requests over a 6-token shared prefix: r0's prompt IS the
    prefix and decodes long, so r3 (boarding once r1/r2 retire) shares
    r0's partial tail block while r0 still holds it — a copy-on-write."""
    rng = np.random.default_rng(7)
    pre = rng.integers(0, 64, 6).astype(np.int32)

    def body(n):
        return np.concatenate([pre, rng.integers(0, 64, n).astype(np.int32)])

    reqs = [dict(prompt=pre, max_new_tokens=12),
            dict(prompt=body(2), max_new_tokens=2),
            dict(prompt=body(5), max_new_tokens=3),
            dict(prompt=body(3), max_new_tokens=6),
            dict(prompt=pre[:5], max_new_tokens=4)]
    for i, r in enumerate(reqs):
        r["seed"] = 100 + i
        if sampled and i % 2:
            r.update(temperature=0.9, top_k=12)
    return reqs


ENGINE_KW = dict(n_slots=3, block_size=4, prefill_chunk=3)


def _run(engine, reqs):
    handles = [engine.submit(**r) for r in reqs]
    engine.drain()
    return [h.tokens for h in handles]


def _port_engine(weights, **kw):
    _, _, _, tcfg, tst, tparams = weights
    return InferenceEngine(tst, tcfg, params=tparams, device="cpu",
                           metrics=ServeMetrics(), **{**ENGINE_KW, **kw})


@pytest.mark.parametrize("kernel", ["fused", "dense"])
def test_greedy_streams_and_pool_counters_match_jax(weights, kernel):
    """The JAX engine runs without ServeMetrics: with metrics on, its tick
    calls the analyzer's byte model (``kv_drift``), whose module does not
    import on this tree. Its ServeMetrics counters are the deltas of the
    pool's lifetime totals, so the port's summary is held against those
    totals directly."""
    jcfg, jst, jparams, *_ = weights
    jeng = JaxEngine(jst, jcfg, params=jparams, attn_kernel=kernel,
                     **ENGINE_KW)
    teng = _port_engine(weights, attn_kernel=kernel)
    reqs = _mix()
    ref, out = _run(jeng, reqs), _run(teng, reqs)
    assert out == ref
    assert len({t for s in out for t in s}) > 4          # not collapsed
    js, ts = jeng.pool.stats(), teng.metrics.summary()
    assert ts["cow_copies"] >= 1 and ts["prefix_hit_blocks"] >= 2
    for key, jkey in (("prefix_hit_blocks", "prefix_hit_blocks_total"),
                      ("cow_copies", "cow_copies_total"),
                      ("block_evictions", "evictions_total"),
                      ("blocks_total", "blocks_total"),
                      ("blocks_cached", "blocks_cached")):
        assert ts[key] == js[jkey], key
    assert ts["tokens_generated"] == sum(len(s) for s in ref)


@pytest.mark.parametrize("kernel", ["fused", "dense"])
def test_every_stream_equals_solo_decode(weights, kernel):
    _, _, _, tcfg, tst, tparams = weights
    reqs = _mix(sampled=True)
    out = _run(_port_engine(weights, attn_kernel=kernel), reqs)
    for r, toks in zip(reqs, out):
        t0 = len(r["prompt"])
        dec = tgpt.make_cached_decoder(
            tst, tcfg, t0, r["max_new_tokens"],
            temperature=r.get("temperature", 0.0), top_k=r.get("top_k"),
            device="cpu")
        solo = dec(tparams, r["prompt"][None], key_data(r["seed"]))
        assert toks == solo[0, t0:].tolist()


@pytest.mark.parametrize("cache_dtype", [None, "bfloat16", "int8",
                                         "float8_e4m3fn", "float8_e5m2"])
def test_fused_equals_dense_greedy(weights, cache_dtype):
    reqs = _mix()
    fused = _run(_port_engine(weights, attn_kernel="fused",
                              cache_dtype=cache_dtype), reqs)
    dense = _run(_port_engine(weights, attn_kernel="dense",
                              cache_dtype=cache_dtype), reqs)
    assert fused == dense
    assert [len(s) for s in fused] == [r["max_new_tokens"] for r in reqs]


def test_flash_configured_model_serves_the_dense_streams(weights):
    """``attn_impl="flash"`` names the training attention: serving attends
    with the dense einsums whatever the config, in the JAX engine and in
    the port, so a flash-configured model's greedy streams equal the dense
    config's, and the JAX engine's for the same flash config."""
    jcfg, jst, jparams, tcfg, tst, tparams = weights
    reqs = _mix()
    dense = _run(_port_engine(weights), reqs)
    flash = _run(InferenceEngine(
        tst, dataclasses.replace(tcfg, attn_impl="flash"), params=tparams,
        device="cpu", metrics=ServeMetrics(), **ENGINE_KW), reqs)
    jflash = _run(JaxEngine(jst, dataclasses.replace(jcfg, attn_impl="flash"),
                            params=jparams, **ENGINE_KW), reqs)
    assert flash == dense == jflash
    assert [len(s) for s in flash] == [r["max_new_tokens"] for r in reqs]


def test_engine_defaults_to_cuda_and_raises_without_it(weights):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: device=None is valid here")
    _, _, _, tcfg, tst, _ = weights
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(tst, tcfg)


@pytest.mark.parametrize("kw,item", [
    # speculative decoding over the dense slot layout (the dense verify
    # programs) is ported: it builds and serves
    (dict(kv_layout="dense", draft=True, spec_k=2), None),
    (dict(mesh=object()), "item 6"),
    # the adapters and the host tier are ported: they build and serve
    (dict(adapters=True), None),
    (dict(host_cache_blocks=4), None),
    (dict(host_cache_blocks=4, prefetch_ticks=2), None),
    (dict(lint=True), "item 7"),
], ids=["speculative", "tp", "adapters", "host-tier", "prefetch", "lint"])
def test_unported_engine_knobs_raise_with_roadmap_item(weights, kw, item):
    _, _, _, tcfg, tst, tparams = weights
    if item is not None:
        with pytest.raises(NotImplementedError,
                           match=rf"ROADMAP\.md, Queue A: {item}"):
            InferenceEngine(tst, tcfg, params=tparams, device="cpu", **kw)
        return
    if kw.get("adapters"):
        kw = dict(adapters=AdapterStore(tcfg, 2, 4, device="cpu"))
    if kw.pop("draft", False):
        kw.update(draft_stages=tst, draft_cfg=tcfg)
    eng = InferenceEngine(tst, tcfg, params=tparams, device="cpu", **kw)
    h = eng.submit(np.arange(5) % 64, max_new_tokens=4, seed=3)
    eng.drain()
    solo = tgpt.make_cached_decoder(tst, tcfg, 5, 4, device="cpu")(
        tparams, (np.arange(5) % 64)[None].astype(np.int32), key_data(3))
    assert h.tokens == solo[0, 5:].tolist()
    if eng.kv_layout == "dense":
        assert eng.speculative and eng.spec_k == 2
        return
    assert eng.pool.host_cache_blocks == kw.get("host_cache_blocks", 0)
    assert eng.pool.prefetch_ticks == kw.get("prefetch_ticks", 1)


@pytest.mark.parametrize("cfg_kw", [dict(n_experts=4),
                                    dict(attn_impl="ring", n_seq=2)])
def test_unported_model_configs_raise_in_the_engine(weights, cfg_kw):
    _, _, _, _, tst, tparams = weights
    cfg = tgpt.GPTConfig(**{**SMALL, **cfg_kw})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        InferenceEngine(tst, cfg, params=tparams, device="cpu")


def test_submit_with_adapter_raises(weights):
    """Without an AdapterStore a named adapter is refused with the JAX
    engine's message; with one, an unregistered name is a KeyError."""
    eng = _port_engine(weights)
    with pytest.raises(ValueError, match="built without an AdapterStore"):
        eng.submit(np.arange(4), max_new_tokens=2, adapter="tenant")
    assert eng.requests == {}
    eng = _port_engine(weights, n_slots=2,
                       adapters=AdapterStore(weights[3], 2, 2, device="cpu"))
    with pytest.raises(KeyError, match="not registered"):
        eng.submit(np.arange(4), max_new_tokens=2, adapter="tenant")


def _imports(path: pathlib.Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    return mods


def test_port_and_chip_smoke_import_no_jax():
    files = sorted((REPO / PORT).rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    assert {"faults.py", "scenarios.py"} <= {
        p.name for p in files if p.parent.name == "resilience"}
    assert {"fleet.py", "router.py", "tracing.py", "flight.py"} <= {
        p.name for p in files if p.parent.name == "serve"}
    assert {"tracing.py", "attribution.py", "catalog.py", "report.py"} <= {
        p.name for p in files if p.parent.name == "telemetry"}
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib",
                               "simple_distributed_machine_learning_tpu"), (
                f"{path.relative_to(REPO)} imports {mod}")


def test_simulate_serves_every_request_and_reports(weights, tmp_path):
    _, _, _, tcfg, tst, tparams = weights
    metrics = ServeMetrics(outdir=str(tmp_path))
    eng = InferenceEngine(tst, tcfg, params=tparams, device="cpu",
                          metrics=metrics, n_slots=3, block_size=4,
                          attn_kernel="fused")
    rep = simulate(eng, SimConfig(n_requests=6, rate=500.0, seed=0,
                                  prompt_lens=(3, 5), max_new_tokens=4,
                                  shared_prefix_len=4))
    assert rep["completed"] == 6 and rep["all_completed"]
    s = metrics.summary()
    for key in ("tokens_generated", "tokens_per_sec", "ttft_ms_p50",
                "ttft_ms_p95", "tpot_ms_p50", "tpot_ms_p95",
                "slot_occupancy_mean", "blocks_in_use", "blocks_total",
                "blocks_cached", "kv_bytes_resident", "prefix_hit_blocks",
                "cow_copies", "prefill_chunk_ms_p50",
                "prefill_chunk_ms_p95"):
        assert key in s, key
    # the per-tick KV-drift check: sharing only shrinks the truth
    assert "kv_bytes_predicted" in s and s["kv_drift_bytes"] <= 0
    assert s["tokens_generated"] == 24 and s["prefix_hit_blocks"] > 0
    rec = metrics.emit()
    assert rec["kind"] == "serve"
    assert (tmp_path / "metrics.jsonl").exists()
    assert "serve_ttft_ms_count" in (tmp_path / "metrics.prom").read_text()


def test_preempted_request_resumes_to_its_solo_stream(weights):
    _, _, _, tcfg, tst, tparams = weights
    eng = _port_engine(weights)
    reqs = _mix(sampled=True)
    handles = [eng.submit(**r) for r in reqs]
    while len(handles[0].tokens) < 3:
        eng.step()
    eng.preempt(handles[0].rid)
    assert handles[0].state == "queued" and handles[0].n_preempted == 1
    eng.drain()
    r = reqs[0]
    solo = tgpt.make_cached_decoder(tst, tcfg, 6, 12, device="cpu")(
        tparams, r["prompt"][None], key_data(r["seed"]))
    assert handles[0].tokens == solo[0, 6:].tolist()
    assert eng.metrics.summary()["preemptions"] == 1


def test_cancel_refunds_slot_and_blocks(weights):
    eng = _port_engine(weights, n_slots=2)
    reqs = _mix()
    handles = [eng.submit(**r) for r in reqs]
    eng.step()
    eng.cancel(handles[0].rid, reason="deadline")      # active
    eng.cancel(handles[4].rid)                         # queued
    assert handles[0].state == handles[4].state == "shed"
    assert handles[0].finish_reason == "deadline"
    eng.drain()
    assert all(h.state == "done" for h in handles[1:4])
    assert eng.pool.blocks_in_use == 0 and eng.pool._reserved == 0
    with pytest.raises(ValueError):
        eng.cancel(handles[0].rid)


def test_drain_cap_raises_with_unfinished_handles(weights):
    eng = _port_engine(weights)
    for r in _mix():
        eng.submit(**r)
    with pytest.raises(DrainTimeout) as exc:
        eng.drain(max_ticks=2)
    assert len(exc.value.unfinished) == 5
