"""Multi-tenant LoRA serving in the PyTorch port (``tests/test_adapters.py``
ported; its ``predict_adapter_bytes`` pin is in
``tests/test_torch_kv_drift.py``).

Both packages get one set of weights (``tests/test_adapters.py``'s model,
2 stages from ``jax.random.key(0)``, carried over by
``interop.params_from_numpy``) and the same numpy-made adapter factors
(``interop.adapter_from_numpy``), large enough that a tenant's greedy
stream leaves the base model's. The anchors:

- a tenant's stream through the batched bank-row path equals a solo
  decode through weights merged offline (``lora.merge_adapter``), greedy
  and sampled, across mixed tenants in one tick, the int8 cache,
  preemption, hot-swap and a crash restart — and greedy streams equal the
  JAX engine's token for token;
- a base request (bank row 0) is bit-identical to an engine built without
  adapters, on the paged, dense and speculative paths;
- the decode programs' log-probs with adapters equal the JAX programs'
  within rtol = atol = 1e-5 (``tests/test_torch_gpt_serve.py``'s f32
  tolerance);
- the store's invariants, the journal's ``adp`` grammar, prefix-cache
  isolation, adapter-affinity routing, the per-store swap accounting,
  and the hot-adapter-churn pins (equal to the JAX run's).

The JAX engines run without ``metrics=`` or with their ``kv_drift``
gauge patched (its analyzer module does not import on this tree).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu.models import gpt as jgpt
from simple_distributed_machine_learning_tpu.models import lora as jlora
from simple_distributed_machine_learning_tpu.resilience import (
    scenarios as jscen,
)
from simple_distributed_machine_learning_tpu.serve.adapters import (
    AdapterStore as JaxAdapterStore,
)
from simple_distributed_machine_learning_tpu.serve.engine import (
    InferenceEngine as JaxEngine,
)
from simple_distributed_machine_learning_tpu_torch.interop import (
    adapter_from_numpy,
    params_from_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.models import lora
from simple_distributed_machine_learning_tpu_torch.ops.random import key_data
from simple_distributed_machine_learning_tpu_torch.resilience import faults
from simple_distributed_machine_learning_tpu_torch.resilience.scenarios import (  # noqa: E501
    VirtualClock,
    run_scenario,
)
from simple_distributed_machine_learning_tpu_torch.serve import (
    AdapterStore,
    InferenceEngine,
    RequestJournal,
    ServeFleet,
    ServeMetrics,
    ServeSupervisor,
    engine_factory,
)
from simple_distributed_machine_learning_tpu_torch.serve.adapters import (
    adapter_namespace,
)
from simple_distributed_machine_learning_tpu_torch.serve.journal import (
    read_journal,
    recover_state,
)

KW = dict(vocab=32, seq_len=48, d_model=32, n_heads=2, n_layers=2)
CFG = tgpt.GPTConfig(**KW)
TOL = dict(rtol=1e-5, atol=1e-5)


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


def _np_adapter(seed, rank=2, std=0.2):
    """Numpy factors, both A and B drawn: a delta large enough to move a
    tenant's greedy stream off the base model's."""
    rng = np.random.default_rng(seed)
    L, d = CFG.n_layers, CFG.d_model
    return {k: rng.normal(0.0, std, s).astype(np.float32)
            for k, s in (("aq", (L, d, rank)), ("bq", (L, rank, d)),
                         ("av", (L, d, rank)), ("bv", (L, rank, d)))}


def _adapter(seed, rank=2):
    return adapter_from_numpy(_np_adapter(seed, rank), "cpu")


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab, n).astype(
        np.int32)


def _solo(stages, params, prompt, n_new, seed, temperature=0.0, top_k=None,
          top_p=None):
    dec = tgpt.make_cached_decoder(stages, CFG, len(prompt), n_new,
                                   temperature=temperature, top_k=top_k,
                                   top_p=top_p, device="cpu")
    out = dec(params, np.asarray(prompt, np.int32)[None], key_data(seed))
    return out[0, len(prompt):].tolist()


def _store(n_slots=2, rank=2, host=None):
    return AdapterStore(CFG, rank, n_slots, host=host, device="cpu")


def _factory(stages, **kw):
    return engine_factory(stages, CFG, n_slots=2, block_size=4,
                          prefill_chunk=3, adapter_rank=2, device="cpu", **kw)


# -- lora math against the JAX package ---------------------------------------


def test_lora_math_and_merge_equal_the_jax_package(model):
    """``lora_delta`` in both serving shapes, ``merge_adapter`` and
    ``bank_bytes`` equal the JAX functions on the same numpy factors; the
    merge leaves the originals untouched."""
    _, jst, _, params = model
    w = _np_adapter(3)
    rng = np.random.default_rng(0)
    hn = rng.normal(size=(3, 5, CFG.d_model)).astype(np.float32)
    a = rng.normal(size=(3, CFG.d_model, 2)).astype(np.float32)
    b = rng.normal(size=(3, 2, CFG.d_model)).astype(np.float32)
    for x, y, z in ((hn, a, b), (hn[:1], a[0], b[0])):
        np.testing.assert_allclose(
            lora.lora_delta(*map(torch.from_numpy, (x, y, z))).numpy(),
            np.asarray(jlora.lora_delta(x, y, z)), **TOL)
    before = params[0]["blocks"][0]["attn"]["wq"].detach().clone()
    merged = lora.merge_adapter(params, adapter_from_numpy(w, "cpu"))
    jmerged = jlora.merge_adapter([s.params for s in jst], w)
    for t, j in zip(merged, jmerged):
        for tb, jb in zip(t["blocks"], j["blocks"]):
            for k in ("wq", "wv", "wk", "wo"):
                np.testing.assert_allclose(
                    tb["attn"][k].detach().numpy(), np.asarray(jb["attn"][k]),
                    **TOL)
    assert torch.equal(params[0]["blocks"][0]["attn"]["wq"], before)
    assert not torch.equal(merged[0]["blocks"][0]["attn"]["wq"], before)
    assert lora.bank_bytes(3, 2, 32, 2) == jlora.bank_bytes(3, 2, 32, 2)


@pytest.mark.parametrize("kernel", ["dense", "fused"])
def test_adapter_decode_logits_equal_the_jax_programs(model, kernel):
    """One paged decode tick with mixed bank rows (two tenants and the
    base row): the port's log-probs equal the JAX program's within the
    f32 tolerance, the base slot's equal the adapter-free build's
    exactly, and a tenant's move."""
    _, jst, _, params = model
    bank_np = {k: np.stack([np.zeros_like(_np_adapter(1)[k]),
                            _np_adapter(1)[k], _np_adapter(2)[k]])
               for k in lora.BANK_KEYS}
    tbank = {k: torch.from_numpy(v) for k, v in bank_np.items()}
    aids = np.array([2, 0, 1], np.int64)
    H, bs, nb = CFG.n_heads, 4, 6
    dh = CFG.d_model // H
    rng = np.random.default_rng(7)
    pool = rng.normal(size=(2, nb + 1, H, bs, dh)).astype(np.float32)
    tables = np.array([[1, 2, 0], [3, 4, 0], [5, 6, 0]], np.int64)
    pos = np.array([5, 2, 7], np.int64)
    toks = np.array([3, 9, 14], np.int64)
    je, jb, jh = jgpt._merged_stage_trees([s.params for s in jst])
    te, tb, th = tgpt._merged_stage_trees(params)
    jat = jgpt._adapter_layers({k: jnp.asarray(v)
                                for k, v in bank_np.items()},
                               jnp.asarray(aids, jnp.int32))
    tat = tgpt._adapter_layers(tbank, torch.from_numpy(aids))

    @torch.no_grad()
    def port_rows(at):
        return tgpt._paged_decode_fwd(
            tb, te, th, torch.from_numpy(pool.copy()),
            torch.from_numpy(pool.copy()), torch.from_numpy(toks),
            torch.from_numpy(pos), torch.from_numpy(tables), H, bs, kernel,
            at=at)[2]

    _, _, jrows = jgpt._paged_decode_fwd(
        jb, je, jh, jnp.asarray(pool), jnp.asarray(pool),
        jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32),
        jnp.asarray(tables, jnp.int32), H, bs, dh, jgpt._dense_attn_tail,
        kernel="dense", ab_at=jat)
    trows = port_rows(tat)
    np.testing.assert_allclose(trows.numpy(), np.asarray(jrows), **TOL)
    base = port_rows(None)
    assert torch.equal(base[1], trows[1])
    assert not torch.allclose(base[0], trows[0], **TOL)


def test_builders_check_their_adapter_arguments(model):
    stages = model[2]
    with_ad = tgpt.make_paged_decode_step(stages, CFG, 16, 4, adapters=True,
                                          device="cpu")
    plain = tgpt.make_paged_decode_step(stages, CFG, 16, 4, device="cpu")
    pool = torch.zeros((2, 5, 2, 4, 16))
    args = (model[3], pool, pool.clone(), np.zeros(2, np.int32),
            np.zeros(2, np.int32), np.zeros((2, 4), np.int32),
            np.zeros((2, 2), np.uint32), np.zeros(2, np.float32),
            np.zeros(2, np.int32), np.full(2, 2.0, np.float32))
    with pytest.raises(ValueError, match="built with adapters=True"):
        with_ad(*args)
    with pytest.raises(ValueError, match="built without adapters"):
        plain(*args, _store().bank, np.zeros(2, np.int64))


# -- AdapterStore: registration, versioning, residency -----------------------


def test_store_rejects_bad_names_and_shapes():
    store = _store()
    with pytest.raises(ValueError):
        store.register("", _adapter(1))
    with pytest.raises(ValueError):
        store.register("a\x00b", _adapter(1))
    with pytest.raises(ValueError):
        store.register("t1", lora.init_lora_adapter(
            torch.Generator().manual_seed(0), CFG, 4, device="cpu"))
    bad = dict(_adapter(1))
    del bad["bv"]
    with pytest.raises(ValueError):
        store.register("t1", bad)
    assert store.names() == ()
    with pytest.raises(ValueError, match="rank 33"):
        _store(rank=33)


def test_namespaces_version_qualified_and_base_empty():
    store = _store()
    assert store.namespace_of(None) == b""
    store.register("t1", _adapter(1))
    ns0 = store.namespace_of("t1")
    assert ns0 == adapter_namespace("t1@0") != b""
    store.register("t1", _adapter(2))          # hot-swap: version bump
    assert store.namespace_of("t1") == adapter_namespace("t1@1") != ns0
    jstore = JaxAdapterStore(jgpt.GPTConfig(**KW), 2, 2)
    jstore.register("t1", _np_adapter(1))
    jstore.register("t1", _np_adapter(2))
    assert jstore.namespace_of("t1") == store.namespace_of("t1")


def test_residency_refcount_eviction_and_release_guards():
    store = _store()                            # rows 1..2 usable
    for k in (1, 2, 3):
        store.register(f"t{k}", _adapter(k))
    r1 = store.retain("t1")
    r2 = store.retain("t2")
    assert {r1, r2} == {1, 2} and store.swaps_total == 2
    assert store.is_resident("t1") and store.row_of("t1") == r1
    assert torch.equal(store.bank["aq"][r1], _adapter(1)["aq"])
    assert not store.bank["aq"][0].any()        # row 0 stays the base
    store.release(r1)                           # t1 stays resident (warm)
    assert store.is_resident("t1")
    r3 = store.retain("t3")                     # until t3 needs the row
    assert r3 == r1 and not store.is_resident("t1")
    assert store.swaps_total == 3
    assert store.retain("t3") == r3 and store.swaps_total == 3
    store.release(0)                            # base rows carry no refs
    store.release(r3)
    store.release(r3)
    with pytest.raises(RuntimeError):
        store.release(r3)
    store.release(r2)
    st = store.stats()
    assert st["resident_bytes"] == lora.bank_bytes(3, 2, 32, 2) == 6144
    assert (st["n_rows"], st["rank"], st["swaps_total"]) == (3, 2, 3)


def test_hot_swap_keeps_referenced_row_until_released():
    store = _store()
    store.register("t1", _adapter(1))
    old_row = store.retain("t1")
    store.register("t1", _adapter(2))           # swap while referenced
    assert not store.is_resident("t1")
    new_row = store.retain("t1")
    assert new_row != old_row
    assert torch.equal(store.bank["bq"][old_row], _adapter(1)["bq"])
    assert torch.equal(store.bank["bq"][new_row], _adapter(2)["bq"])
    store.release(old_row)
    store.release(new_row)


def test_shared_host_survives_store_rebuild():
    host = {}
    s1 = _store(host=host)
    s1.register("t1", _adapter(1))
    s1.register("t1", _adapter(2))
    s2 = _store(host=host)                      # the post-crash rebuild
    assert s2.is_registered("t1") and not s2.is_resident("t1")
    assert s2.retain("t1") > 0
    assert s2.stats()["store"] != s1.stats()["store"]


def test_engine_checks_its_store():
    stages = tgpt.make_gpt_stages(0, CFG, 2, device="cpu")[0]
    with pytest.raises(ValueError, match="n_slots \\+ 1"):
        InferenceEngine(stages, CFG, n_slots=3, adapters=_store(),
                        device="cpu")
    eng = InferenceEngine(stages, CFG, n_slots=2, device="cpu")
    with pytest.raises(ValueError, match="without an AdapterStore"):
        eng.submit(_prompt(4, 1), max_new_tokens=2, adapter="t1")
    with pytest.raises(ValueError, match="without an AdapterStore"):
        eng.register_adapter("t1", _adapter(1))
    eng = InferenceEngine(stages, CFG, n_slots=2, adapters=_store(),
                          device="cpu")
    with pytest.raises(KeyError, match="not registered"):
        eng.submit(_prompt(4, 1), max_new_tokens=2, adapter="nope")


# -- THE anchor: streams equal the offline-merged weights' ---------------------

MIXED = [
    dict(prompt=_prompt(5, 1), max_new_tokens=7, seed=11),
    dict(prompt=_prompt(9, 2), max_new_tokens=5, seed=12, adapter="t1",
         temperature=0.8, top_k=5),
    dict(prompt=_prompt(3, 3), max_new_tokens=8, seed=13, adapter="t2"),
    dict(prompt=_prompt(7, 4), max_new_tokens=6, seed=14, adapter="t1"),
    dict(prompt=_prompt(4, 5), max_new_tokens=6, seed=15, adapter="t2",
         temperature=1.1, top_p=0.9),
]


def _mixed_run(eng, register, specs=MIXED):
    register("t1", 1)
    register("t2", 2)
    handles = [eng.submit(**specs[i]) for i in range(3)]
    for _ in range(3):
        eng.step()                              # mid-flight admissions
    handles += [eng.submit(**s) for s in specs[3:]]
    eng.drain()
    return handles


@pytest.mark.parametrize("layout", ["paged-fused", "paged-dense", "dense"])
def test_mixed_tenant_streams_match_merged_solo_and_jax(model, layout):
    """Base + two tenants interleaved through 2 slots (ticks mix bank rows,
    admissions land mid-flight), greedy and sampled: every stream equals
    a solo decode through merged weights, a tenant's greedy stream leaves
    the base model's, and greedy streams equal the JAX engine's."""
    jcfg, jst, stages, params = model
    kw = ({"kv_layout": "dense"} if layout == "dense" else
          {"attn_kernel": layout.split("-")[1]})
    eng = InferenceEngine(stages, CFG, n_slots=2, adapters=_store(),
                          device="cpu", **kw)
    handles = _mixed_run(
        eng, lambda n, s: eng.register_adapter(n, _adapter(s)))
    merged = {None: params,
              "t1": lora.merge_adapter(params, _adapter(1)),
              "t2": lora.merge_adapter(params, _adapter(2))}
    for h, s in zip(handles, MIXED):
        assert h.tokens == _solo(stages, merged[s.get("adapter")],
                                 s["prompt"], s["max_new_tokens"], s["seed"],
                                 s.get("temperature", 0.0), s.get("top_k"),
                                 s.get("top_p"))
    g = MIXED[2]
    assert handles[2].tokens != _solo(stages, params, g["prompt"],
                                      g["max_new_tokens"], g["seed"])
    if layout != "paged-dense":
        return
    jeng = JaxEngine(jst, jcfg, n_slots=2,
                     adapters=JaxAdapterStore(jcfg, 2, 2))
    jhandles = _mixed_run(
        jeng, lambda n, s: jeng.register_adapter(n, _np_adapter(s)))
    for h, j, s in zip(handles, jhandles, MIXED):
        if s.get("temperature", 0.0) == 0.0:
            assert h.tokens == [int(t) for t in j.tokens]
        assert len(h.tokens) == len(j.tokens)


@pytest.mark.parametrize("layout", [
    dict(), dict(attn_kernel="fused"), dict(kv_layout="dense"),
    dict(cache_dtype="int8")], ids=["paged", "fused", "dense", "int8"])
def test_base_row_streams_are_bit_identical_to_no_adapters(model, layout):
    """A request without an adapter rides the zero row: its stream (and
    the pool it leaves behind) equals an engine built without adapters,
    even beside tenants in the same ticks."""
    stages = model[2]
    specs = [dict(prompt=_prompt(6, 31), max_new_tokens=7, seed=41),
             dict(prompt=_prompt(4, 32), max_new_tokens=5, seed=42,
                  temperature=0.9, top_k=4)]
    plain = InferenceEngine(stages, CFG, n_slots=2, device="cpu", **layout)
    want = [plain.submit(**s) for s in specs]
    plain.drain()
    eng = InferenceEngine(stages, CFG, n_slots=3, device="cpu",
                          adapters=_store(n_slots=3), **layout)
    eng.register_adapter("t1", _adapter(1))
    got = [eng.submit(**s) for s in specs]
    eng.submit(_prompt(8, 33), max_new_tokens=6, seed=43, adapter="t1")
    eng.drain()
    for g, w in zip(got, want):
        assert g.tokens == w.tokens


def test_speculative_verify_with_adapters_equals_plain_adapter_decode(model):
    """The verify side carries the adapters (draft == target, spec_k 3):
    every greedy tenant stream equals the plain adapter engine's, while
    the base draft's proposals cost acceptance only."""
    stages = model[2]
    specs = [dict(prompt=_prompt(5, 51), max_new_tokens=9, seed=1,
                  adapter="t1"),
             dict(prompt=_prompt(6, 52), max_new_tokens=8, seed=2),
             dict(prompt=_prompt(4, 53), max_new_tokens=9, seed=3,
                  adapter="t2")]

    def run(**kw):
        eng = InferenceEngine(stages, CFG, n_slots=3, block_size=4,
                              attn_kernel="fused", adapters=_store(3),
                              device="cpu", **kw)
        eng.register_adapter("t1", _adapter(1))
        eng.register_adapter("t2", _adapter(2))
        hs = [eng.submit(**s) for s in specs]
        eng.drain()
        return [h.tokens for h in hs]

    spec = run(draft_stages=stages, draft_cfg=CFG, spec_k=3)
    assert spec == run()


def test_adapter_parity_int8_cache(model):
    """Engine-to-engine under the quantised cache, so quantisation cancels:
    the adapter engine equals an engine built from the merged weights."""
    stages, params = model[2], model[3]
    eng = InferenceEngine(stages, CFG, n_slots=2, cache_dtype="int8",
                          adapters=_store(), device="cpu")
    eng.register_adapter("t1", _adapter(6))
    merged = [dataclasses.replace(s, params=p) for s, p in
              zip(stages, lora.merge_adapter(params, _adapter(6)))]
    ref = InferenceEngine(merged, CFG, n_slots=2, cache_dtype="int8",
                          device="cpu")
    specs = [dict(prompt=_prompt(6, 21), max_new_tokens=6, seed=31),
             dict(prompt=_prompt(4, 22), max_new_tokens=5, seed=32,
                  temperature=0.9, top_k=4)]
    got = [eng.submit(**s, adapter="t1") for s in specs]
    want = [ref.submit(**s) for s in specs]
    eng.drain()
    ref.drain()
    for g, w in zip(got, want):
        assert g.tokens == w.tokens


def test_adapter_parity_survives_preemption(model):
    stages, params = model[2], model[3]
    eng = InferenceEngine(stages, CFG, n_slots=2, adapters=_store(),
                          device="cpu")
    eng.register_adapter("t1", _adapter(7))
    r1 = eng.submit(_prompt(5, 31), max_new_tokens=8, seed=41, adapter="t1")
    r2 = eng.submit(_prompt(7, 32), max_new_tokens=6, seed=42)
    for _ in range(3):
        eng.step()
    eng.preempt(r1.rid)
    assert r1._adapter_row == 0                 # its row ref was released
    eng.drain()
    assert r1.n_preempted == 1
    assert r1.tokens == _solo(stages, lora.merge_adapter(params, _adapter(7)),
                              r1.prompt, 8, 41)
    assert r2.tokens == _solo(stages, params, r2.prompt, 6, 42)
    assert eng._adapters._refs == [0, 0, 0]


def test_hot_swap_takes_effect_next_admission_not_inflight(model):
    stages, params = model[2], model[3]
    eng = InferenceEngine(stages, CFG, n_slots=2, adapters=_store(),
                          device="cpu")
    eng.register_adapter("t1", _adapter(8))
    r_old = eng.submit(_prompt(5, 33), max_new_tokens=8, seed=51,
                       adapter="t1")
    for _ in range(3):
        eng.step()
    eng.register_adapter("t1", _adapter(9))     # swap under load
    r_new = eng.submit(_prompt(4, 34), max_new_tokens=6, seed=52,
                       adapter="t1")
    eng.drain()
    assert r_old.tokens == _solo(stages,
                                 lora.merge_adapter(params, _adapter(8)),
                                 r_old.prompt, 8, 51)
    assert r_new.tokens == _solo(stages,
                                 lora.merge_adapter(params, _adapter(9)),
                                 r_new.prompt, 6, 52)


# -- journal grammar and crash recovery -----------------------------------------


def test_journal_adp_roundtrip_and_pre_adapter_journals_read_as_base(
        tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = RequestJournal(path, sync=False)
    j.log_submit(rid=0, prompt=[1, 2, 3], max_new=4, temp=0.0, top_k=None,
                 top_p=None, eos=None, seed=7, cls=None, prio=0,
                 ttft_dl=None, dl=None, t=0.0)           # pre-adapter shape
    j.log_submit(rid=1, prompt=[4, 5], max_new=3, temp=0.0, top_k=None,
                 top_p=None, eos=None, seed=8, cls=None, prio=0,
                 ttft_dl=None, dl=None, t=0.0, adapter="t9")
    j.close()
    with open(path) as f:
        base_line, tenant_line = f.read().splitlines()
    assert "adp" not in base_line and '"adp":"t9"' in tenant_line
    events, valid = read_journal(path)
    state = recover_state(events[:valid])
    assert state[0].adapter is None
    assert state[1].adapter == "t9"


@pytest.mark.parametrize("degrade_after", [None, 1],
                         ids=["paged", "degraded-dense"])
def test_crash_recovery_readmits_onto_correct_adapter(model, tmp_path,
                                                      degrade_after):
    """An engine crash mid-flight with mixed tenants: the rebuilt engine
    (a fresh store over the factory's shared host dict; with
    ``degrade_after=1`` the dense fallback) re-admits every journalled
    request onto its adapter, and the streams equal the uninterrupted
    run's, which equal the merged solos."""
    stages, params = model[2], model[3]
    specs = [
        dict(prompt=_prompt(5, 1), max_new_tokens=8, seed=11, adapter="t1"),
        dict(prompt=_prompt(9, 2), max_new_tokens=6, seed=12,
             temperature=0.8, top_k=5),
        dict(prompt=_prompt(3, 3), max_new_tokens=7, seed=13, adapter="t2"),
        dict(prompt=_prompt(7, 4), max_new_tokens=5, seed=14, adapter="t1",
             temperature=1.1, top_k=4),
    ]

    def run(name, chaos):
        if chaos:
            faults.install(faults.FaultPlan.parse(chaos))
        sup = ServeSupervisor(_factory(stages), str(tmp_path / name),
                              degrade_after=degrade_after)
        sup.register_adapter("t1", _adapter(1))
        sup.register_adapter("t2", _adapter(2))
        handles = [sup.submit(**s) for s in specs]
        sup.drain()
        sup.close()
        faults.uninstall()
        return sup, [list(h.tokens) for h in handles]

    _, base = run("base.jsonl", None)
    sup, crashed = run("crash.jsonl", "engine-crash@serve.tick=3")
    assert sup.restarts == 1
    if degrade_after:
        assert sup.engine.kv_layout == "dense"
        assert sup.engine._adapters is not None
    assert crashed == base
    merged = {None: params, "t1": lora.merge_adapter(params, _adapter(1)),
              "t2": lora.merge_adapter(params, _adapter(2))}
    for toks, s in zip(crashed, specs):
        assert toks == _solo(stages, merged[s.get("adapter")], s["prompt"],
                             s["max_new_tokens"], s["seed"],
                             s.get("temperature", 0.0), s.get("top_k"))
    events, valid = read_journal(str(tmp_path / "crash.jsonl"))
    assert [e.get("adp") for e in events[:valid] if e["ev"] == "submit"
            ] == [s.get("adapter") for s in specs]


def test_unknown_adapter_rejected_before_journaling(model, tmp_path):
    sup = ServeSupervisor(_factory(model[2]), str(tmp_path / "rej.jsonl"))
    with pytest.raises(KeyError):
        sup.submit(_prompt(4, 1), max_new_tokens=3, seed=1, adapter="nope")
    sup.close()
    events, valid = read_journal(str(tmp_path / "rej.jsonl"))
    assert [e for e in events[:valid] if e.get("ev") == "submit"] == []
    plain = ServeSupervisor(engine_factory(model[2], CFG, device="cpu"),
                            str(tmp_path / "plain.jsonl"))
    with pytest.raises(ValueError, match="adapter_rank"):
        plain.register_adapter("t1", _adapter(1))
    plain.close()


# -- prefix-cache isolation -----------------------------------------------------


def test_prefix_cache_isolated_per_tenant_and_orphaned_on_swap(model):
    store = _store()
    eng = InferenceEngine(model[2], CFG, n_slots=2, block_size=4,
                          prefill_chunk=None, adapters=store, device="cpu")
    eng.register_adapter("t1", _adapter(1))
    eng.register_adapter("t2", _adapter(2))
    p = _prompt(8, 71)
    eng.submit(p, max_new_tokens=2, seed=1, adapter="t1")
    eng.drain()
    ns1 = store.namespace_of("t1")
    assert eng.pool.shared_prefix_len(p, ns1) >= 4      # t1 re-use works
    assert eng.pool.shared_prefix_len(p, store.namespace_of("t2")) == 0
    assert eng.pool.shared_prefix_len(p, b"") == 0      # base isolated too
    eng.register_adapter("t1", _adapter(3))             # hot-swap
    assert eng.pool.shared_prefix_len(p, store.namespace_of("t1")) == 0
    assert eng.pool.shared_prefix_len(p, ns1) >= 4      # old ns orphaned


# -- fleet routing, the pinned scenario, metrics ---------------------------------


def test_affinity_routes_to_adapter_resident_replica(model, tmp_path):
    metrics = ServeMetrics()
    fleet = ServeFleet(_factory(model[2], metrics=metrics),
                       os.path.join(str(tmp_path), "aff"), n_replicas=2,
                       journal_sync=False, metrics=metrics,
                       clock=VirtualClock(0.001))
    fleet.register_adapter("t1", _adapter(1))
    h0 = fleet.submit(_prompt(8, 81), max_new_tokens=2, seed=1,
                      adapter="t1")
    fleet.drain()                    # t1 now resident on h0's home only
    h1 = fleet.submit(_prompt(6, 82), max_new_tokens=2, seed=2,
                      adapter="t1")  # fresh prompt: no prefix overlap
    assert fleet._home[h1.rid] == fleet._home[h0.rid]
    fleet.drain()
    fleet.close()
    assert int(metrics.route_adapter_hits.value) >= 1
    assert int(metrics.adapter_swaps.value) == 1       # one upload, reused
    s = metrics.summary()
    assert s["per_adapter_completed"] == {"t1": 2}
    assert s["adapter_resident_bytes"] == lora.bank_bytes(3, 2, 32, 2)


def test_hot_adapter_churn_affinity_beats_round_robin_equal_to_jax(model):
    """Both routing policies on both packages, exact pins: affinity keeps
    each tenant's row warm (3 uploads, all forced by the tick-6 swap),
    round-robin re-uploads across the fleet (7) and never scores an
    adapter-affinity hit."""
    jcfg, jst, stages, _ = model
    got = {}
    for route in ("affinity", "round-robin"):
        jr = jscen.run_scenario("hot-adapter-churn", jst, jcfg, route=route)
        tr = run_scenario("hot-adapter-churn", stages, CFG, route=route,
                          device="cpu")
        assert tr["adapters"] == jr["adapters"]
        assert tr["completed"] == jr["completed"] == 18
        assert tr["slo_ok"] is jr["slo_ok"] is True
        got[route] = tr["adapters"]
    aff, rr = got["affinity"], got["round-robin"]
    assert aff["rank"] == 2 and aff["tenants"] == ["tenant-a", "tenant-b"]
    assert (aff["swaps"], aff["adapter_affinity_hits"]) == (3, 15)
    assert (rr["swaps"], rr["adapter_affinity_hits"]) == (7, 0)


def test_metrics_sum_swaps_across_stores():
    m = ServeMetrics()
    s1 = {"resident_bytes": 2048, "swaps_total": 2, "n_resident": 1,
          "n_rows": 3, "rank": 2, "store": 101}
    s2 = dict(s1, swaps_total=3, store=102)
    m.on_tick(0, 0, 2, adapter_stats=s1)
    m.on_tick(0, 0, 2, adapter_stats=s2)
    assert int(m.adapter_swaps.value) == 5
    m.on_tick(0, 0, 2, adapter_stats=s1)               # no new swaps
    assert int(m.adapter_swaps.value) == 5
    m.on_tick(0, 0, 2, adapter_stats=dict(s1, swaps_total=4))
    assert int(m.adapter_swaps.value) == 7
    prom = m.registry.prometheus_text()
    for name in ("serve_adapter_resident_bytes", "serve_adapter_swaps_total",
                 "serve_route_adapter_affinity_hits_total"):
        assert f"# HELP {name}" in prom, name
