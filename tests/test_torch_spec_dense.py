"""Speculative decoding over the dense slot layout in the port, against the
JAX package's and against itself (``tests/test_serve.py``'s dense pins).

The models are ``tests/test_torch_spec_decode.py``'s: a JAX build of the
tiny GPT (vocab 32, seq 48, d 32, 2 heads, 2 layers) perturbed with
seeded numpy noise, a 1-layer layer-skip draft made of its embedding,
first block and head, both carried into the port by
``interop.params_from_numpy``.

Across packages: ``make_slot_verify_step`` on the same dense pools (a
slot with the full budget, one with 2 of K, one not decoding) leaves the
same K/V rows and emits the same tokens, counts and keys. The K/V rows
and the log-prob rows are held at rtol = 1e-5 with atol = 1e-5 of the
tensor's largest entry: the
noisy weights make rows of |x| up to ~15, and the second layer's rows
carry the first layer's K-query attention summed in another order (5e-5
apart at K = 12). The never-live trash row ``max_len - 1`` is excluded:
several rejected positions write it, and the order of such duplicate
writes is unspecified in both frameworks. whole dense speculative engines give equal
greedy streams. Within the port: greedy streams equal solo decode, also
through preemption; sampled streams replay per seed; draft == target
accepts everything; adapters ride the verify side; the TP and lint knobs
are still refused.
"""

import dataclasses

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
    adapter_from_numpy,
    params_from_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.ops import random as trng
from simple_distributed_machine_learning_tpu_torch.serve import (
    AdapterStore,
    InferenceEngine,
    ServeMetrics,
)

SMALL = dict(vocab=32, seq_len=48, d_model=32, n_heads=2, n_layers=2)
DRAFT = dict(SMALL, n_layers=1)


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
def models():
    """Target and draft in both packages over one set of numpy weights."""
    jcfg, jdcfg = jgpt.GPTConfig(**SMALL), jgpt.GPTConfig(**DRAFT)
    jst = jgpt.make_gpt_stages(jax.random.key(0), jcfg, 1)[0]
    jdst = jgpt.make_gpt_stages(jax.random.key(9), jdcfg, 1)[0]
    rng = np.random.default_rng(0)
    npar = jax.tree.map(lambda a: (np.asarray(a) + rng.normal(
        0.0, 0.5, a.shape)).astype(np.float32), [s.params for s in jst])
    ndpar = [dict(embed=npar[0]["embed"], blocks=npar[0]["blocks"][:1],
                  head=npar[0]["head"])]
    tcfg, tdcfg = tgpt.GPTConfig(**SMALL), tgpt.GPTConfig(**DRAFT)
    tst = tgpt.make_gpt_stages(0, tcfg, 1, device="cpu")[0]
    tst = [dataclasses.replace(s, params=p) for s, p in
           zip(tst, params_from_numpy(npar, "cpu"))]
    tdst = tgpt.make_gpt_stages(9, tdcfg, 1, device="cpu")[0]
    tdst = [dataclasses.replace(s, params=p) for s, p in
            zip(tdst, params_from_numpy(ndpar, "cpu"))]
    jdst = [dataclasses.replace(s, params=jax.tree.map(jnp.asarray, p))
            for s, p in zip(jdst, ndpar)]
    return dict(jcfg=jcfg, jst=jst, jparams=jax.tree.map(jnp.asarray, npar),
                jdcfg=jdcfg, jdst=jdst, tcfg=tcfg, tst=tst,
                tparams=[s.params for s in tst], tdcfg=tdcfg, tdst=tdst)


def _requests():
    rng = np.random.default_rng(3)
    return [dict(prompt=rng.integers(0, 32, n).astype(np.int32),
                 max_new_tokens=m, seed=70 + i)
            for i, (n, m) in enumerate([(3, 11), (9, 6), (5, 14)])]


def _solo(m, prompt, n_new, seed):
    dec = tgpt.make_cached_decoder(m["tst"], m["tcfg"], len(prompt), n_new,
                                   device="cpu")
    return dec(m["tparams"], prompt[None],
               trng.key_data(seed))[0, len(prompt):].tolist()


def _engine(m, spec_k=3, draft="draft", **kw):
    dst, dcfg = ((m["tst"], m["tcfg"]) if draft == "target"
                 else (m["tdst"], m["tdcfg"]))
    kw.setdefault("n_slots", 2)
    return InferenceEngine(m["tst"], m["tcfg"], kv_layout="dense",
                           draft_stages=dst, draft_cfg=dcfg, spec_k=spec_k,
                           device="cpu", **kw)


def _drain(engine, reqs):
    handles = [engine.submit(**r) for r in reqs]
    engine.drain()
    return [list(h.tokens) for h in handles]


# -- the dense verify against the JAX program --------------------------------

@pytest.mark.parametrize("K", [3, 12])
def test_slot_verify_step_matches_jax(models, K):
    """One verify step over random dense pools: slot 0 with the full K
    budget, slot 1 with 2 of K (its tail routed to the trash row), slot 2
    not decoding (valid 0: every write to the trash row)."""
    m = models
    L, S, H, ml, dh = 2, 3, 2, 40, 16
    rng = np.random.default_rng(K)
    kc = rng.standard_normal((L, S, H, ml, dh)).astype(np.float32)
    vc = rng.standard_normal(kc.shape).astype(np.float32)
    pos = np.array([20, 9, 0], np.int32)
    valid = np.array([K, 2, 0], np.int32)
    toks = rng.integers(0, 32, S).astype(np.int32)
    draft_rows = rng.standard_normal((S, K, 32)).astype(np.float32)
    drafts = draft_rows.argmax(-1).astype(np.int32)
    knobs = (np.zeros(S, np.float32), np.zeros(S, np.int32),
             np.full(S, 2.0, np.float32))
    kd = np.zeros((S, 2), np.uint32)
    jver = jgpt.make_slot_verify_step(m["jst"], m["jcfg"], ml, K)
    tver = tgpt.make_slot_verify_step(m["tst"], m["tcfg"], ml, K,
                                      device="cpu")
    jkc, jvc, jtoks, jn, jkd = jver(m["jparams"], jnp.asarray(kc),
                                    jnp.asarray(vc), toks, pos, drafts,
                                    draft_rows, valid, kd, *knobs)
    tkc, tvc, ttoks, tn, tkd = tver(m["tparams"],
                                    torch.from_numpy(kc.copy()),
                                    torch.from_numpy(vc.copy()), toks, pos,
                                    drafts, draft_rows, valid, kd, *knobs)
    live = np.s_[..., :ml - 1, :]
    for ours, ref in ((tkc, jkc), (tvc, jvc)):
        ref = np.asarray(ref)[live]
        np.testing.assert_allclose(ours.numpy()[live], ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())
    # the step wrote exactly slot 0's K and slot 1's 2 positions
    changed = (tkc.numpy()[live] != kc[live]).any(axis=(0, 2, 4))
    assert changed[0].nonzero()[0].tolist() == list(range(20, 20 + K))
    assert changed[1].nonzero()[0].tolist() == [9, 10]
    assert not changed[2].any()
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tkd.numpy(), np.asarray(jkd))
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    assert tn[2] == 0 and 1 <= tn[1] <= 2
    # the rows themselves, against the JAX forward on the same pools
    xs = np.concatenate([toks[:, None], drafts[:, :-1]], 1)
    jq, jw = jgpt._verify_positions(jnp.asarray(pos), jnp.asarray(valid), K,
                                    ml)
    tq, tw = tgpt._verify_positions(torch.from_numpy(pos).long(),
                                    torch.from_numpy(valid).long(), K, ml)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    embed, blocks, head = jgpt._merged_stage_trees(m["jparams"])
    _, _, jrows = jgpt._slot_verify_fwd(
        blocks, embed, head, jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(xs), jq, jw, H, jgpt._dense_attn_tail)
    embed, blocks, head = tgpt._merged_stage_trees(m["tparams"])
    with torch.no_grad():
        _, _, trows = tgpt._slot_verify_fwd(
            blocks, embed, head, torch.from_numpy(kc), torch.from_numpy(vc),
            torch.from_numpy(xs).long(), tq, tw, H)
    jrows = np.asarray(jrows)
    np.testing.assert_allclose(trows.numpy(), jrows, rtol=1e-5,
                               atol=1e-5 * np.abs(jrows).max())


@pytest.mark.parametrize("spec_k", [3, 12])
def test_greedy_dense_engine_matches_solo_and_jax(models, spec_k):
    """``tests/test_serve.py::test_spec_dense_layout_parity``'s shape with
    a queue: three requests through 2 dense slots and a layer-skip draft
    give the JAX dense engine's greedy streams, token for token, which
    are each request's solo decode."""
    m = models
    reqs = _requests()
    jeng = JaxEngine(m["jst"], m["jcfg"], params=m["jparams"], n_slots=2,
                     kv_layout="dense", draft_stages=m["jdst"],
                     draft_cfg=m["jdcfg"], spec_k=spec_k)
    jax_streams = _drain(jeng, reqs)
    metrics = ServeMetrics()
    ours = _drain(_engine(m, spec_k, metrics=metrics), reqs)
    assert ours == jax_streams
    assert ours == [_solo(m, r["prompt"], r["max_new_tokens"], r["seed"])
                    for r in reqs]
    assert metrics.summary()["spec_accepted_tokens"] > 0
    assert len({t for s in ours for t in s}) > 4


def test_sampled_dense_streams_are_deterministic_per_seed(models):
    m = models
    p1, p2 = np.arange(5, dtype=np.int32), np.arange(4, dtype=np.int32) + 3

    def run(seed):
        eng = _engine(m, 3)
        h1 = eng.submit(p1, max_new_tokens=7, seed=seed, temperature=0.9,
                        top_k=6)
        h2 = eng.submit(p2, max_new_tokens=6, seed=97)
        eng.drain()
        return h1.tokens, h2.tokens

    a, b, c = run(96), run(96), run(7)
    assert a == b and a[0] != c[0]
    assert a[1] == _solo(m, p2, 6, 97)
    assert len(a[0]) == 7


def test_accept_all_rate_and_tokens_per_tick(models):
    """draft == target over dense rows: the first tick prefills (1 token)
    and verifies a full spec_k; every proposal is accepted."""
    m = models
    metrics = ServeMetrics()
    eng = _engine(m, 4, draft="target", metrics=metrics)
    prompt = np.random.default_rng(95).integers(0, 32, 5).astype(np.int32)
    r = eng.submit(prompt, max_new_tokens=8, seed=95)
    emitted = []
    while r.state != "done":
        emitted.append(eng.step())
    assert emitted == [1 + 4, 3]
    assert r.tokens == _solo(m, prompt, 8, 95)
    s = metrics.summary()
    assert s["spec_accept_rate"] == 1.0
    assert s["spec_proposed_tokens"] == s["spec_accepted_tokens"] == 3 + 2
    assert s["spec_k"] == 4


def test_preemption_mid_stream_stays_bit_exact(models):
    """A victim requeues mid-stream, re-prefills its target and draft rows
    on boarding (draft key kept) and continues to its solo stream; an EOS
    inside an accepted run stops the co-resident there."""
    m = models
    rng = np.random.default_rng(90)
    p1, p2 = (rng.integers(0, 32, n).astype(np.int32) for n in (4, 6))
    eos_stream = _solo(m, p2, 8, 91)
    eos = eos_stream[2]
    cut = eos_stream.index(eos) + 1
    eng = _engine(m, 3)
    r1 = eng.submit(p1, max_new_tokens=10, seed=90)
    r2 = eng.submit(p2, max_new_tokens=8, seed=91, eos_id=eos)
    eng.step()
    eng.step()
    assert 0 < len(r1.tokens) < 10
    dkd = r1.draft_key_data.copy()
    eng.preempt(r1.rid)
    np.testing.assert_array_equal(r1.draft_key_data, dkd)
    eng.drain()
    assert r1.n_preempted == 1
    assert r1.tokens == _solo(m, p1, 10, 90)
    assert r2.tokens == eos_stream[:cut] and r2.finish_reason == "eos"


def test_dense_verify_with_adapters_equals_plain_adapter_decode(models):
    """The dense verify carries the adapters (draft == target, spec_k 3):
    every greedy tenant stream equals the plain dense adapter engine's,
    which differs from the base model's."""
    m = models
    rng = np.random.default_rng(5)
    L, d = SMALL["n_layers"], SMALL["d_model"]

    def adapter(seed):
        r = np.random.default_rng(seed)
        return adapter_from_numpy(
            {k: r.normal(0.0, 0.2, s).astype(np.float32)
             for k, s in (("aq", (L, d, 2)), ("bq", (L, 2, d)),
                          ("av", (L, d, 2)), ("bv", (L, 2, d)))}, "cpu")

    specs = [dict(prompt=rng.integers(0, 32, n).astype(np.int32),
                  max_new_tokens=9, seed=i, adapter=a)
             for i, (n, a) in enumerate([(5, "t1"), (6, None), (4, "t2")])]

    def run(spec=True, adapters=True):
        kw = dict(draft_stages=m["tst"], draft_cfg=m["tcfg"],
                  spec_k=3) if spec else {}
        eng = InferenceEngine(m["tst"], m["tcfg"], n_slots=3,
                              kv_layout="dense", device="cpu",
                              adapters=AdapterStore(m["tcfg"], 2, 3,
                                                    device="cpu"), **kw)
        eng.register_adapter("t1", adapter(1))
        eng.register_adapter("t2", adapter(2))
        hs = [eng.submit(**s) for s in specs]
        eng.drain()
        return [h.tokens for h in hs]

    got = run()
    assert got == run(spec=False)
    assert got[1] == _solo(m, specs[1]["prompt"], 9, 1)
    assert got[0] != _solo(m, specs[0]["prompt"], 9, 0)


@pytest.mark.parametrize("kw,item", [
    (dict(mesh=object()), "item 6"),
    (dict(lint=True), "item 7"),
], ids=["tp", "lint"])
def test_tp_and_lint_still_refused(models, kw, item):
    """Dense speculation builds and serves (the tests above); a TP target
    and the lint preflight still name their items, and so does the dense
    verify's TP twin."""
    m = models
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP\.md, Queue A: {item}"):
        _engine(m, 3, **kw)
    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP\.md, Queue A: item 6"):
        tgpt.make_slot_verify_step(m["tst"], m["tcfg"], 16, 3,
                                   mesh=object(), device="cpu")


def test_builders_validate_and_default_to_cuda(models):
    m = models
    with pytest.raises(ValueError, match="spec_k must be >= 2"):
        tgpt.make_slot_verify_step(m["tst"], m["tcfg"], 16, 1, device="cpu")
    with pytest.raises(ValueError, match="quantized cache_dtype"):
        tgpt.make_slot_verify_step(m["tst"], m["tcfg"], 16, 3,
                                   cache_dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="draft vocab"):
        tgpt.make_slot_spec_tick(m["tst"], m["tcfg"], m["tdst"],
                                 dataclasses.replace(m["tdcfg"], vocab=64),
                                 16, 3, device="cpu")
    if not torch.cuda.is_available():
        for build in (lambda: tgpt.make_slot_verify_step(
                          m["tst"], m["tcfg"], 16, 3),
                      lambda: tgpt.make_slot_spec_tick(
                          m["tst"], m["tcfg"], m["tdst"], m["tdcfg"], 16,
                          3)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                build()
