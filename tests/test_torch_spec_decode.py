"""The port's speculative decoding against the JAX package's, and against
itself.

Both packages get the same weights: a JAX build of a tiny GPT (vocab 32,
seq 48, d 32, 2 heads, 2 layers) perturbed with seeded numpy noise (std
0.5, so greedy decoding does not collapse onto one token), and a 1-layer
draft made of the target's embedding, first block and head (a layer-skip
draft: it agrees with the target often enough that ticks accept runs of
proposals), carried into the port by ``interop.params_from_numpy``.

Across packages: the draft's slot prefill and propose steps, and the
target's paged verify step at K = 3 and 12 queries per slot (the JAX
Pallas kernel in interpret mode with ``kernel="fused"``; the port's plain
version of K4 on CPU tensors), agree at rtol = atol = 1e-5 (f32 end to
end; the frameworks sum in other orders), and greedy tokens, accepted
counts and whole engine streams are equal token for token. Greedy
acceptance is integer work: it is held to the JAX function exactly.

Within the port, the JAX package's own pins (``tests/test_serve.py``):
greedy speculative streams equal solo decode through mid-flight
admission, EOS and preemption; a draft equal to the target accepts every
proposal; sampled streams are deterministic per seed; the residual
rejection sampler emits its first token with the target's distribution.
The JAX engines run without metrics, so their ticks never reach the
analysis import that is missing on this tree (ROADMAP Queue A item 4).
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
    params_from_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.ops import random as trng
from simple_distributed_machine_learning_tpu_torch.serve import (
    InferenceEngine,
    ServeMetrics,
)

SMALL = dict(vocab=32, seq_len=48, d_model=32, n_heads=2, n_layers=2)
DRAFT = dict(SMALL, n_layers=1)
TOL = dict(rtol=1e-5, atol=1e-5)
BS = 8


def _noisy(jst, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0.0, 0.5, a.shape)
                   ).astype(np.float32), [s.params for s in jst])


@pytest.fixture(scope="module")
def models():
    """Target and draft in both packages over one set of numpy weights:
    ``dict(jcfg, jst, jparams, jdcfg, jdst, tcfg, tst, tparams, tdcfg,
    tdst)`` — the draft stages carry their weights (the engines read the
    draft's params from its stages)."""
    jcfg, jdcfg = jgpt.GPTConfig(**SMALL), jgpt.GPTConfig(**DRAFT)
    jst = jgpt.make_gpt_stages(jax.random.key(0), jcfg, 1)[0]
    jdst = jgpt.make_gpt_stages(jax.random.key(9), jdcfg, 1)[0]
    npar = _noisy(jst, 0)
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


def _port_engine(m, spec_k=3, draft="draft", **kw):
    dst, dcfg = ((m["tst"], m["tcfg"]) if draft == "target"
                 else (m["tdst"], m["tdcfg"]))
    kw.setdefault("block_size", BS)
    kw.setdefault("n_slots", 2)
    return InferenceEngine(m["tst"], m["tcfg"], draft_stages=dst,
                           draft_cfg=dcfg, spec_k=spec_k, device="cpu",
                           **kw)


def _drain(engine, reqs):
    handles = [engine.submit(**r) for r in reqs]
    engine.drain()
    return [list(h.tokens) for h in handles]


# -- the slice's programs against the JAX package's ---------------------------

def test_slot_prefill_and_propose_match_jax(models):
    """The draft side: whole-prompt prefill into slot 1 of a dense pool,
    then 4 greedy propose steps for two slots (slot 0 near the end of its
    budget, so its later steps clamp to the trash row)."""
    m = models
    L, S, H, ml, dh = 1, 2, 2, 24, 16
    jpre = jgpt.make_slot_prefill(m["jdst"], m["jdcfg"], ml)
    tpre = tgpt.make_slot_prefill(m["tdst"], m["tdcfg"], ml, device="cpu")
    prompt = np.random.default_rng(5).integers(0, 32, (1, 7)).astype(np.int32)
    zeros = np.zeros((L, S, H, ml, dh), np.float32)
    jkc, jvc, jtok, _ = jpre([s.params for s in m["jdst"]], jnp.asarray(zeros),
                             jnp.asarray(zeros), prompt, 1,
                             jax.random.key_data(jax.random.key(0)),
                             0.0, 0, 2.0)
    tkc, tvc = torch.zeros(zeros.shape), torch.zeros(zeros.shape)
    tkc, tvc, ttok, _ = tpre([s.params for s in m["tdst"]], tkc, tvc, prompt,
                             1, trng.key_data(0), 0.0, 0, 2.0)
    assert int(ttok) == int(jtok)
    np.testing.assert_allclose(tkc.numpy(), np.asarray(jkc), **TOL)
    np.testing.assert_allclose(tvc.numpy(), np.asarray(jvc), **TOL)

    K = 4
    jprop = jgpt.make_slot_propose(m["jdst"], m["jdcfg"], ml, K)
    tprop = tgpt.make_slot_propose(m["tdst"], m["tdcfg"], ml, K,
                                   device="cpu")
    toks = np.array([5, int(ttok)], np.int32)
    pos = np.array([ml - 2, 7], np.int32)
    knobs = (np.zeros(S, np.float32), np.zeros(S, np.int32),
             np.full(S, 2.0, np.float32))
    jout = jprop([s.params for s in m["jdst"]], jkc, jvc, toks, pos,
                 np.zeros((S, 2), np.uint32), *knobs)
    tout = tprop([s.params for s in m["tdst"]], tkc, tvc, toks, pos,
                 np.zeros((S, 2), np.uint32), *knobs)
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
    for t, j in zip((tout[0], tout[1], tout[3]), (jout[0], jout[1], jout[3])):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("K", [3, 12])
@pytest.mark.parametrize("kernel", ["dense", "fused"])
def test_paged_verify_step_matches_jax(models, kernel, K):
    """The target side: one verify step over a random paged pool with
    ragged tables — slot 0 with the full K budget, slot 1 with 2 of K
    (its tail routed to the trash block), slot 2 not decoding (valid 0).
    Pools after the step, the verify rows (through each package's
    ``_paged_verify_fwd``: K4's K-query path with ``kernel="fused"``),
    greedy tokens and accepted counts agree."""
    m = models
    L, H, dh, ml, S = 2, 2, 16, 48, 3
    NB = ml // BS
    rng = np.random.default_rng(K)
    kc = rng.standard_normal((L, S * NB + 1, H, BS, dh)).astype(np.float32)
    vc = rng.standard_normal(kc.shape).astype(np.float32)
    tables = np.zeros((S, NB), np.int32)
    tables[0] = rng.permutation(S * NB)[:NB] + 1
    tables[1, :4] = rng.permutation(S * NB)[:4] + 1
    pos = np.array([20, 9, 0], np.int32)
    valid = np.array([K, 2, 0], np.int32)
    toks = rng.integers(0, 32, S).astype(np.int32)
    draft_rows = rng.standard_normal((S, K, 32)).astype(np.float32)
    drafts = draft_rows.argmax(-1).astype(np.int32)
    knobs = (np.zeros(S, np.float32), np.zeros(S, np.int32),
             np.full(S, 2.0, np.float32))
    kd = np.zeros((S, 2), np.uint32)
    jver = jgpt.make_paged_verify_step(m["jst"], m["jcfg"], ml, BS, K,
                                       kernel=kernel)
    tver = tgpt.make_paged_verify_step(m["tst"], m["tcfg"], ml, BS, K,
                                       kernel=kernel, device="cpu")
    jkc, jvc, jtoks, jn, jkd = jver(m["jparams"], jnp.asarray(kc),
                                    jnp.asarray(vc), toks, pos, drafts,
                                    draft_rows, valid, tables, kd, *knobs)
    tkc, tvc, ttoks, tn, tkd = tver(m["tparams"],
                                    torch.from_numpy(kc.copy()),
                                    torch.from_numpy(vc.copy()), toks, pos,
                                    drafts,
                                    draft_rows, valid, tables, kd, *knobs)
    np.testing.assert_allclose(tkc.numpy(), np.asarray(jkc), **TOL)
    np.testing.assert_allclose(tvc.numpy(), np.asarray(jvc), **TOL)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tkd.numpy(), np.asarray(jkd))
    for s in range(S):
        np.testing.assert_array_equal(ttoks[s, :int(tn[s])].numpy(),
                                      np.asarray(jtoks)[s, :int(jn[s])])
    # the rows themselves, from the pools after the step (the rows attend
    # the rows this very step wrote)
    xs = np.concatenate([toks[:, None], drafts[:, :-1]], 1)
    jq, jw, jo = jgpt._paged_verify_routing(jnp.asarray(pos),
                                            jnp.asarray(valid),
                                            jnp.asarray(tables), K, BS, ml)
    tq, tw, to = tgpt._paged_verify_routing(
        torch.from_numpy(pos).long(), torch.from_numpy(valid).long(),
        torch.from_numpy(tables).long(), K, BS, ml)
    for t, j in ((tq, jq), (tw, jw), (to, jo)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    embed, blocks, head = jgpt._merged_stage_trees(m["jparams"])
    _, _, jrows = jgpt._paged_verify_fwd(
        blocks, embed, head, jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(xs), jq, jw, jo, jnp.asarray(tables), H, BS, dh,
        jgpt._dense_attn_tail, kernel)
    embed, blocks, head = tgpt._merged_stage_trees(m["tparams"])
    with torch.no_grad():
        _, _, trows = tgpt._paged_verify_fwd(
            blocks, embed, head, torch.from_numpy(kc), torch.from_numpy(vc),
            torch.from_numpy(xs).long(), tq, tw, to,
            torch.from_numpy(tables).long(), H, BS, kernel)
    np.testing.assert_allclose(trows.numpy(), np.asarray(jrows), **TOL)


def test_greedy_acceptance_matches_jax_exactly():
    """``_spec_accept_rows`` on greedy slots, against the JAX function on
    the same rows: drafts that agree with the argmax for 0..K-1 leading
    positions, budgets from 0 to K. Integers: equal, and no key moves."""
    rng = np.random.default_rng(11)
    S, K, V = 8, 6, 16
    rows = rng.standard_normal((S, K, V)).astype(np.float32)
    g = rows.argmax(-1)
    drafts = rng.integers(0, V, (S, K)).astype(np.int32)
    for s in range(S):
        lead = s % K
        drafts[s, :lead] = g[s, :lead]
        if lead < K - 1:
            drafts[s, lead] = (g[s, lead] + 1) % V
    draft_rows = rng.standard_normal((S, K, V)).astype(np.float32)
    valid = np.array([K, K, 3, 0, 1, K, 2, K], np.int32)
    kd = rng.integers(0, 2 ** 32, (S, 2), dtype=np.uint32)
    knobs = (np.zeros(S, np.float32), np.zeros(S, np.int32),
             np.full(S, 2.0, np.float32))
    jt, jn, jkd = jgpt._spec_accept_rows(
        jnp.asarray(rows), jnp.asarray(drafts), jnp.asarray(draft_rows),
        jnp.asarray(valid), jnp.asarray(kd), *map(jnp.asarray, knobs))
    tt, tn, tkd = tgpt._spec_accept_rows(
        torch.from_numpy(rows), torch.from_numpy(drafts).long(),
        torch.from_numpy(draft_rows), torch.from_numpy(valid).long(),
        torch.from_numpy(kd.astype(np.int64)),
        torch.from_numpy(knobs[0]), torch.from_numpy(knobs[1]).long(),
        torch.from_numpy(knobs[2]))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tkd.numpy(), kd.astype(np.int64))
    assert {0, 1, 2, K} <= set(tn.tolist())


@pytest.mark.parametrize("spec_k", [3, 12])
@pytest.mark.parametrize("kernel", ["dense", "fused"])
def test_greedy_engine_streams_match_jax(models, kernel, spec_k):
    """The same three requests (mixed prompt lengths, a queue behind two
    slots) through both packages' speculative engines: equal greedy
    streams, token for token, equal to the port's solo decode."""
    m = models
    reqs = _requests()
    jeng = JaxEngine(m["jst"], m["jcfg"], params=m["jparams"], n_slots=2,
                     block_size=BS, attn_kernel=kernel,
                     draft_stages=m["jdst"], draft_cfg=m["jdcfg"],
                     spec_k=spec_k)
    jax_streams = _drain(jeng, reqs)
    metrics = ServeMetrics()
    ours = _drain(_port_engine(m, spec_k, attn_kernel=kernel,
                               metrics=metrics), reqs)
    assert ours == jax_streams
    # ticks that accepted runs of proposals, not only corrections
    assert metrics.summary()["spec_accepted_tokens"] > 0
    assert ours == [_solo(m, r["prompt"], r["max_new_tokens"], r["seed"])
                    for r in reqs]
    assert len({t for s in ours for t in s}) > 4


# -- the JAX package's pins, in the port ---------------------------------------

def test_midflight_admission_is_bit_exact_against_solo(models):
    m = models
    rng = np.random.default_rng(60)
    specs = [dict(prompt=rng.integers(0, 32, n).astype(np.int32),
                  max_new_tokens=k, seed=70 + i)
             for i, (n, k) in enumerate([(3, 9), (9, 5), (5, 8)])]
    eng = _port_engine(m, 4, attn_kernel="fused")
    handles = [eng.submit(**s) for s in specs]
    for _ in range(3):
        eng.step()
    late = dict(prompt=rng.integers(0, 32, 6).astype(np.int32),
                max_new_tokens=7, seed=73)
    handles.append(eng.submit(**late))
    eng.drain()
    for h, s in zip(handles, specs + [late]):
        assert h.tokens == _solo(m, s["prompt"], s["max_new_tokens"],
                                 s["seed"])


def test_eos_mid_verify_stops_the_stream_there(models):
    """An EOS inside an accepted run ends the request at (and including)
    it; the co-resident stays bit-exact."""
    m = models
    rng = np.random.default_rng(64)
    p1, p2 = (rng.integers(0, 32, n).astype(np.int32) for n in (5, 4))
    solo = _solo(m, p1, 8, 74)
    eos = solo[2]
    cut = solo.index(eos) + 1
    eng = _port_engine(m, 4, draft="target")
    r = eng.submit(p1, max_new_tokens=8, seed=74, eos_id=eos)
    r2 = eng.submit(p2, max_new_tokens=6, seed=75)
    eng.drain()
    assert r.finish_reason == "eos" and len(r.tokens) == cut < 8
    assert r.tokens == solo[:cut]
    assert r2.tokens == _solo(m, p2, 6, 75)


def test_preempted_request_resumes_to_its_solo_stream(models):
    """A victim requeues mid-stream, re-prefills (target and draft pools
    rebuilt, its draft key kept) and continues bit-exact."""
    m = models
    rng = np.random.default_rng(90)
    p1, p2 = (rng.integers(0, 32, n).astype(np.int32) for n in (4, 6))
    eng = _port_engine(m, 3, prefill_chunk=8)
    r1 = eng.submit(p1, max_new_tokens=10, seed=90)
    r2 = eng.submit(p2, max_new_tokens=8, seed=91)
    for _ in range(3):
        eng.step()
    assert 0 < len(r1.tokens) < 10
    dkd = r1.draft_key_data.copy()
    eng.preempt(r1.rid)
    assert r1.n_preempted == 1
    np.testing.assert_array_equal(r1.draft_key_data, dkd)
    eng.drain()
    assert r1.tokens == _solo(m, p1, 10, 90)
    assert r2.tokens == _solo(m, p2, 8, 91)


def test_accept_all_rate_and_tokens_per_tick(models):
    """draft == target: every greedy proposal verifies; the rate stays at
    1.0, a full-budget tick emits spec_k tokens, the request takes 2
    ticks (the first prefills and verifies), and the summary carries the
    deployment shape and the spec counters."""
    m = models
    metrics = ServeMetrics()
    eng = _port_engine(m, 4, draft="target", metrics=metrics,
                       attn_kernel="fused")
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
    assert s["spec_rejected_tokens"] == 0
    assert s["tp"] == 1 and s["spec_k"] == 4


def test_accept_all_doubles_tokens_per_tick_over_plain(models):
    """The JAX bench's gate (``bench.py::_measure_spec_vs_plain``): on the
    same workload, submitted up front, accept-all speculation serves at
    least 2x the plain engine's tokens per tick — tick counts, not time."""
    m = models
    rng = np.random.default_rng(0)
    reqs = [dict(prompt=rng.integers(0, 32, (4, 8)[i % 2]).astype(np.int32),
                 max_new_tokens=16) for i in range(6)]

    def ticks(engine):
        for r in reqs:
            engine.submit(**r)
        n = 0
        while engine.busy:
            engine.step()
            n += 1
        return n

    plain = InferenceEngine(m["tst"], m["tcfg"], n_slots=3, block_size=BS,
                            device="cpu")
    spec = _port_engine(m, 4, draft="target", n_slots=3)
    t_plain, t_spec = ticks(plain), ticks(spec)
    assert 6 * 16 / t_spec >= 2 * (6 * 16 / t_plain), (t_spec, t_plain)


def test_sampled_streams_are_deterministic_per_seed(models):
    """Sampled speculative streams replay exactly from their seeds (the
    accept and residual draws come from the request's own key, the
    proposals from its draft key) and differ under another seed; a greedy
    co-resident still equals its solo decode."""
    m = models
    p1, p2 = np.arange(5, dtype=np.int32), np.arange(4, dtype=np.int32) + 3

    def run(seed):
        eng = _port_engine(m, 3)
        h1 = eng.submit(p1, max_new_tokens=7, seed=seed, temperature=0.9,
                        top_k=6)
        h2 = eng.submit(p2, max_new_tokens=6, seed=97)
        eng.drain()
        return h1.tokens, h2.tokens

    a, b, c = run(96), run(96), run(7)
    assert a == b and a[0] != c[0]
    assert a[1] == _solo(m, p2, 6, 97)
    assert len(a[0]) == 7


def test_residual_rejection_emits_the_target_distribution():
    """The first token a sampled slot emits is distributed as the target's
    filtered distribution p, whatever the draft's q (speculative
    sampling's invariant): 20,000 slots, proposals drawn from q with
    numpy. A draft equal to the target is always accepted. Limit: 5
    binomial standard deviations per token."""
    V, S, K = 6, 20000, 2
    p = np.array([0.4, 0.25, 0.15, 0.1, 0.06, 0.04])
    q = np.array([0.05, 0.1, 0.5, 0.05, 0.2, 0.1])
    rng = np.random.default_rng(1)
    rows = torch.from_numpy(np.log(p)).float().expand(S, K, V).contiguous()
    qrows = torch.from_numpy(np.log(q)).float().expand(S, K, V).contiguous()
    drafts = torch.from_numpy(rng.choice(V, size=(S, K), p=q))
    kd = torch.stack([torch.zeros(S, dtype=torch.int64),
                      torch.arange(S, dtype=torch.int64)], 1)
    ones, nok = torch.ones(S), torch.zeros(S, dtype=torch.int64)
    nop = torch.full((S,), 2.0)
    valid = torch.full((S,), K, dtype=torch.int64)
    toks, n, kd2 = tgpt._spec_accept_rows(rows, drafts, qrows, valid, kd,
                                          ones, nok, nop)
    freq = np.bincount(toks[:, 0].numpy(), minlength=V) / S
    sigma = np.sqrt(p * (1 - p) / S)
    assert (np.abs(freq - p) <= 5 * sigma).all(), (freq, p)
    assert (n >= 1).all() and (n <= K).all()
    # a rejected position spends two splits, an accepted one one split
    rejected = n == 1
    one = trng.split(kd)[0]
    two = trng.split(one)[0]
    want = torch.where(rejected[:, None], two, trng.split(one)[0])
    assert torch.equal(kd2[rejected], want[rejected])
    # draft == target: every proposal survives
    toks, n, _ = tgpt._spec_accept_rows(rows, drafts, rows, valid, kd,
                                        ones, nok, nop)
    assert (n == K).all() and torch.equal(toks[:, 0].long(), drafts[:, 0])


def test_validation_messages_match_jax(models):
    m = models
    cases = [
        dict(draft="draft", spec_k=1),
        dict(draft="stages-only", spec_k=4),
        dict(draft=None, spec_k=4),
        dict(draft="bad-vocab", spec_k=4),
    ]
    bad_j = dataclasses.replace(m["jdcfg"], vocab=33)
    bad_t = dataclasses.replace(m["tdcfg"], vocab=33)
    for c in cases:
        kw_j, kw_t = {}, {}
        if c["draft"] == "draft":
            kw_j = dict(draft_stages=m["jdst"], draft_cfg=m["jdcfg"])
            kw_t = dict(draft_stages=m["tdst"], draft_cfg=m["tdcfg"])
        elif c["draft"] == "stages-only":
            kw_j = dict(draft_stages=m["jdst"])
            kw_t = dict(draft_stages=m["tdst"])
        elif c["draft"] == "bad-vocab":
            kw_j = dict(draft_stages=m["jdst"], draft_cfg=bad_j)
            kw_t = dict(draft_stages=m["tdst"], draft_cfg=bad_t)
        with pytest.raises(ValueError) as je:
            JaxEngine(m["jst"], m["jcfg"], n_slots=2, spec_k=c["spec_k"],
                      **kw_j)
        with pytest.raises(ValueError) as te:
            InferenceEngine(m["tst"], m["tcfg"], n_slots=2, device="cpu",
                            spec_k=c["spec_k"], **kw_t)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="spec_k must be >= 2"):
        tgpt.make_slot_propose(m["tdst"], m["tdcfg"], 16, 1, device="cpu")


@pytest.mark.parametrize("builder", ["make_slot_prefill",
                                     "make_slot_propose",
                                     "make_paged_verify_step",
                                     "make_paged_spec_tick"])
def test_new_builders_default_to_cuda_and_raise_without_it(models,
                                                           builder):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: device=None is valid here")
    m = models
    args = {"make_slot_prefill": (m["tdst"], m["tdcfg"], 16),
            "make_slot_propose": (m["tdst"], m["tdcfg"], 16, 3),
            "make_paged_verify_step": (m["tst"], m["tcfg"], 16, BS, 3),
            "make_paged_spec_tick": (m["tst"], m["tcfg"], m["tdst"],
                                     m["tdcfg"], 16, BS, 3)}[builder]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(tgpt, builder)(*args)
