"""The byte model (item 7.3) of the PyTorch port against the JAX
package's, and the per-tick KV-drift gauge of both engines.

The JAX ``analysis/programs.py`` imports ``abstractify`` and ``spec``
from its package, which do not import on this tree; the module fixture
here imports it with those two names patched in-process (the identity and
a stub: no function held here calls either) and removes it again after
the module. Then the JAX functions run, and the port's are held EQUAL to
them (tolerance 0: these are byte counts):

- ``hbm_tick_costs`` row for row (op, program, bytes, note) and every
  ``predict_*`` over the JAX registry's deployments
  (``default_registry_reports``), the three of
  ``test_predicted_resident_bytes_match_gauge`` and a few more (bf16,
  fp8, the host tier);
- the port's pool gauge equals the prediction on every tick of those
  three runs (the JAX test's pin, on the port);
- a metered port engine and a metered JAX engine (the same weights
  through ``interop``, the same requests) give the same
  ``serve_kv_bytes_predicted`` and ``serve_kv_drift_bytes`` on every tick:
  0 without prefix sharing, equal and <= 0 with it;
- the pins of ``tests/test_adapters.py::
  test_analyzer_predicts_live_adapter_bytes_exactly`` and
  ``tests/test_disagg.py::test_host_tier_analyzer_drift_zero_across_shapes``
  on the port.
"""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

import simple_distributed_machine_learning_tpu.analysis as janalysis
from simple_distributed_machine_learning_tpu.models import gpt as jgpt
from simple_distributed_machine_learning_tpu.serve import (
    ServeMetrics as JaxMetrics,
)
from simple_distributed_machine_learning_tpu.serve.engine import (
    InferenceEngine as JaxEngine,
)
from simple_distributed_machine_learning_tpu_torch.analysis import programs
from simple_distributed_machine_learning_tpu_torch.interop import (
    adapter_from_numpy,
    params_from_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.models import lora
from simple_distributed_machine_learning_tpu_torch.resilience import faults
from simple_distributed_machine_learning_tpu_torch.serve import (
    AdapterStore,
    InferenceEngine,
    ServeFleet,
    ServeMetrics,
    engine_factory,
)

JPROGRAMS = "simple_distributed_machine_learning_tpu.analysis.programs"
CFG_KEYS = ("vocab", "seq_len", "d_model", "n_heads", "n_layers")
# tests/test_analysis_serve.py's model and three resident-bytes runs
CFG = tgpt.GPTConfig(vocab=32, seq_len=24, d_model=16, n_heads=2,
                     n_layers=2)
RESIDENT_RUNS = [(4, 2, (5, 9)), (8, 3, (4, 6, 9)), (4, 3, (3, 3, 11))]
# the engine-pair model (tests/test_torch_engine.py's width)
PAIR_KW = dict(vocab=32, seq_len=48, d_model=32, n_heads=2, n_layers=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread while this module runs (tiny models)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jprog():
    """The JAX ``analysis.programs`` module, imported under the two
    patches, and removed again after this module's tests."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(janalysis, "abstractify", lambda a: a, raising=False)
        mp.setattr(janalysis, "spec", lambda *a, **k: None, raising=False)
        assert JPROGRAMS not in sys.modules
        import simple_distributed_machine_learning_tpu.analysis.programs as m
        try:
            yield m
        finally:
            sys.modules.pop(JPROGRAMS, None)
            if getattr(janalysis, "programs", None) is m:
                delattr(janalysis, "programs")


@pytest.fixture(autouse=True)
def _no_plan():
    faults.uninstall()
    yield
    faults.uninstall()


def _jcfg(cfg):
    return jgpt.GPTConfig(**{k: getattr(cfg, k) for k in CFG_KEYS})


def _jspec(jprog, s):
    """The JAX ServeSpec of a port ServeSpec (the same fields)."""
    kw = {f.name: getattr(s, f.name) for f in dataclasses.fields(s)}
    kw["cfg"] = _jcfg(s.cfg)
    if s.draft_cfg is not None:
        kw["draft_cfg"] = _jcfg(s.draft_cfg)
    return jprog.ServeSpec(**kw)


def _specs():
    cfg, draft_cfg = programs.registry_config()
    S = programs.ServeSpec
    return programs.registry_specs(cfg, draft_cfg) + [
        S(CFG, n_slots=n, max_len=20, kv_layout="paged", block_size=bs)
        for bs, n, _ in RESIDENT_RUNS] + [
        S(cfg, n_slots=3, kv_layout="paged", block_size=4, prefill_chunk=3,
          cache_dtype="bfloat16", attn_kernel="fused"),
        S(cfg, n_slots=3, kv_layout="paged", block_size=8,
          cache_dtype="float8_e4m3fn", attn_kernel="fused", spec_k=3,
          draft_cfg=draft_cfg),
        S(cfg, n_slots=2, kv_layout="paged", block_size=4, n_blocks=6,
          max_len=20, prefill_chunk=4, host_cache_blocks=8,
          prefetch_ticks=2),
        S(cfg, n_slots=2, kv_layout="dense", cache_dtype="bfloat16",
          spec_k=2, draft_cfg=draft_cfg)]


def _rows(costs):
    return [(h.op, h.program, h.bytes_per_tick, h.note) for h in costs]


@pytest.mark.parametrize("i", range(len(_specs())))
def test_byte_model_equals_the_jax_functions(jprog, i):
    s = _specs()[i]
    j = _jspec(jprog, s)
    assert _rows(programs.hbm_tick_costs(s)) == _rows(jprog.hbm_tick_costs(j))
    assert _rows(programs.hbm_tick_costs(s, n_layers=1)) == _rows(
        jprog.hbm_tick_costs(j, n_layers=1))
    for rows in ([], [1], [5, 9], [3, 3, 11], [s.ml, 1, 17]):
        assert programs.predict_kv_bytes_resident(s, rows) == (
            jprog.predict_kv_bytes_resident(j, rows))
    assert programs.predict_adapter_bytes(s) == jprog.predict_adapter_bytes(j)
    for n in (0, 1, 7):
        assert programs.predict_host_kv_bytes(s, n) == (
            jprog.predict_host_kv_bytes(j, n))
        assert programs.predict_transfer_bytes(s, n) == (
            jprog.predict_transfer_bytes(j, n))
    d, jd = programs.degraded_spec(s), jprog.degraded_spec(j)
    assert _jspec(jprog, d) == jd
    assert _rows(programs.hbm_tick_costs(d)) == _rows(
        jprog.hbm_tick_costs(jd))


@pytest.mark.parametrize("block_size,n_reqs,prompts", RESIDENT_RUNS)
def test_predicted_resident_bytes_match_gauge(block_size, n_reqs, prompts):
    stages = tgpt.make_gpt_stages(0, CFG, 1, device="cpu")[0]
    rng = np.random.default_rng(3)
    ml = 20
    engine = InferenceEngine(stages, CFG, n_slots=n_reqs, max_len=ml,
                             block_size=block_size, device="cpu")
    handles = []
    for i, plen in enumerate(prompts):
        # distinct first tokens: no prefix sharing, so the model is exact
        prompt = rng.integers(0, CFG.vocab, plen).astype(np.int32)
        prompt[0] = i
        handles.append(engine.submit(prompt, max_new_tokens=6, seed=i))
    sspec = programs.ServeSpec(CFG, n_slots=n_reqs, max_len=ml,
                               kv_layout="paged", block_size=block_size)
    for _ in range(n_reqs + 2):      # prefills (one per tick) + decodes
        engine.step()
        rows = []
        for h in handles:
            if h.state != "active":
                continue
            if h.prefill_pos is not None:        # mid-prefill
                rows.append(h.prefill_pos)
            else:
                rows.append(int(h.prompt.shape[0]) + len(h.tokens) - 1)
        predicted = programs.predict_kv_bytes_resident(
            sspec, [r for r in rows if r > 0])
        assert predicted == engine.pool.stats()["kv_bytes_resident"], (
            block_size, rows, engine.pool.stats())
        assert engine.kv_drift() == (predicted, predicted)
    assert engine.pool.stats()["kv_bytes_resident"] > 0
    gather = next(h for h in programs.hbm_tick_costs(sspec)
                  if h.op == "decode.kv_gather")
    span = -(-ml // block_size) * block_size
    assert gather.bytes_per_tick == (
        n_reqs * engine.pool.bytes_per_block * span // block_size)


@pytest.fixture(scope="module")
def pair_model():
    jcfg = jgpt.GPTConfig(**PAIR_KW)
    jst = jgpt.make_gpt_stages(jax.random.key(0), jcfg, 2)[0]
    nparams = jax.tree.map(np.asarray, [s.params for s in jst])
    tcfg = tgpt.GPTConfig(**PAIR_KW)
    tst = tgpt.make_gpt_stages(0, tcfg, 2, device="cpu")[0]
    tst = [dataclasses.replace(s, params=p)
           for s, p in zip(tst, params_from_numpy(nparams, "cpu"))]
    return jcfg, jst, tcfg, tst


@pytest.mark.parametrize("layout,shared", [
    ("paged", False), ("paged", True), ("dense", False),
], ids=["paged", "paged-shared-prefix", "dense"])
def test_metered_engines_give_the_jax_drift_every_tick(jprog, pair_model,
                                                       layout, shared):
    jcfg, jst, tcfg, tst = pair_model
    kw = dict(n_slots=3, kv_layout=layout)
    if layout == "paged":
        kw.update(block_size=4, prefill_chunk=3, attn_kernel="fused")
    jeng = JaxEngine(jst, jcfg, metrics=JaxMetrics(), **kw)
    teng = InferenceEngine(tst, tcfg, metrics=ServeMetrics(), device="cpu",
                           **kw)
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, 32, 8).astype(np.int32)
    prompts = []
    for i, n in enumerate((5, 9, 7, 11)):
        p = rng.integers(0, 32, n).astype(np.int32)
        p = np.concatenate([prefix, p]) if shared else p
        p[0] = p[0] if shared else i
        prompts.append(p)
    ticks = drifts = 0
    # the first request alone for 6 ticks: its prefix blocks register
    # before the others board and share them
    while ticks < 6 + len(prompts) or jeng.busy or teng.busy:
        if ticks == 0 or 6 <= ticks < 6 + len(prompts) - 1:
            i = 0 if ticks == 0 else ticks - 5
            for eng in (jeng, teng):
                eng.submit(prompts[i], max_new_tokens=5, seed=i)
        jeng.step()
        teng.step()
        js, ts = jeng.metrics, teng.metrics
        assert (int(ts.kv_bytes_predicted.value), int(ts.kv_drift_bytes.value)
                ) == (int(js.kv_bytes_predicted.value),
                      int(js.kv_drift_bytes.value))
        assert int(ts.kv_drift_bytes.value) <= 0
        drifts += int(ts.kv_drift_bytes.value) != 0
        ticks += 1
    assert ticks > 8 and (drifts > 0) == shared
    s = teng.metrics.summary()
    assert s["kv_drift_bytes"] == 0
    assert s["kv_bytes_predicted"] == jeng.metrics.summary()[
        "kv_bytes_predicted"]
    assert teng.metrics.attn_kernel_gauge.value == (layout == "paged")
    assert "serve_kv_drift_bytes 0" in teng.metrics.registry.prometheus_text()


def _np_adapter(seed, rank=2):
    rng = np.random.default_rng(seed)
    L, d = CFG.n_layers, CFG.d_model
    return {k: rng.normal(0.0, 0.2, s).astype(np.float32)
            for k, s in (("aq", (L, d, rank)), ("bq", (L, rank, d)),
                         ("av", (L, d, rank)), ("bv", (L, rank, d)))}


def test_analyzer_predicts_live_adapter_bytes_exactly():
    """``predict_adapter_bytes`` over the live engine's spec equals the
    store's own accounting equals the exported gauge — one formula
    (lora.bank_bytes), zero drift."""
    stages = tgpt.make_gpt_stages(0, CFG, 1, device="cpu")[0]
    metrics = ServeMetrics()
    store = AdapterStore(CFG, 2, 2, device="cpu")
    eng = InferenceEngine(stages, CFG, n_slots=2, adapters=store,
                          metrics=metrics, device="cpu")
    eng.register_adapter("t1", adapter_from_numpy(_np_adapter(1), "cpu"))
    eng.submit(np.arange(5, dtype=np.int32), max_new_tokens=3, seed=1,
               adapter="t1")
    eng.drain()
    predicted = programs.predict_adapter_bytes(programs.engine_spec(eng))
    assert predicted == store.resident_bytes > 0
    assert predicted == int(metrics.adapter_resident_bytes.value)
    assert predicted == lora.bank_bytes(3, CFG.n_layers, CFG.d_model, 2)
    assert metrics.summary()["kv_drift_bytes"] == 0


def test_host_tier_analyzer_drift_zero_across_shapes(tmp_path):
    """``predict_host_kv_bytes`` / ``predict_transfer_bytes`` equal the
    live gauges on EVERY tick of a disaggregated run with the tier, which
    passes through all three shapes: mid-handoff, post-demote, and
    prefetch-in-flight; the engines' KV drift stays 0."""
    cfg = tgpt.GPTConfig(**PAIR_KW)
    stages = tgpt.make_gpt_stages(0, cfg, 2, device="cpu")[0]
    fleet = ServeFleet(
        engine_factory(stages, cfg, device="cpu", prefetch_ticks=2,
                       n_slots=2, block_size=4, n_blocks=6, max_len=24,
                       prefill_chunk=4, host_cache_blocks=8),
        os.path.join(str(tmp_path), "a"), n_replicas=2, prefill_replicas=1,
        journal_sync=False)
    seen = {"mid_handoff": False, "post_demote": False,
            "prefetch_inflight": False}

    def check():
        for rep in fleet.replicas:
            if not rep.alive:
                continue
            engine = rep.supervisor.engine
            spec = programs.engine_spec(engine)
            st = engine.pool.stats()
            assert programs.predict_host_kv_bytes(spec, st["host_blocks"]) \
                == st["host_bytes_resident"]
            moves = st["host_demotes_total"] + st["host_promotes_total"]
            assert programs.predict_transfer_bytes(spec, moves) \
                == st["host_transfer_bytes_total"]
            live, predicted = engine.kv_drift()
            assert live == predicted
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

    def prompt(n, seed):
        return np.random.default_rng(seed).integers(0, cfg.vocab, n).astype(
            np.int32)

    p = prompt(8, 1)
    run([(p, 4, 41)])                           # registers the prefix
    run([(prompt(16, 7), 8, 42)])               # churns it out -> demote
    run([(p, 4, 43)])                           # prefetch-in-flight
    fleet.close()
    assert fleet.handoffs >= 3
    assert all(seen.values()), seen
