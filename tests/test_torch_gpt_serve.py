"""The port's GPT serving programs against the JAX package's.

Both packages compute with the same weights: a JAX build's param trees,
perturbed with seeded numpy noise (std 0.5, so greedy decoding does not
collapse onto one token), carried into the port by
``interop.params_from_numpy``. Logits and K/V pools are compared at
rtol = atol = 1e-5 (f32 end to end: the two frameworks sum in different
orders, nothing else differs); greedy token streams must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu.models import gpt as jgpt
from simple_distributed_machine_learning_tpu_torch.interop import (
    params_from_numpy,
    params_to_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.ops.random import (
    key_data,
    split,
)

SMALL = dict(vocab=64, seq_len=32, d_model=32, n_heads=2, n_layers=2)
TOL = dict(rtol=1e-5, atol=1e-5)
BS = 4


def _weights(seed=0, n_stages=1, noise=0.5, **cfg):
    """``(jax_cfg, jax_stages, jax_params, port_cfg, port_stages,
    port_params)`` over one set of numpy weights."""
    kw = {**SMALL, **cfg}
    jcfg = jgpt.GPTConfig(**kw)
    jst = jgpt.make_gpt_stages(jax.random.key(seed), jcfg, n_stages)[0]
    rng = np.random.default_rng(seed)
    nparams = jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0.0, noise, a.shape)
                   ).astype(np.float32),
        [s.params for s in jst])
    tcfg = tgpt.GPTConfig(**kw)
    tst = tgpt.make_gpt_stages(seed, tcfg, n_stages, device="cpu")[0]
    return (jcfg, jst, jax.tree.map(jnp.asarray, nparams), tcfg, tst,
            params_from_numpy(nparams, "cpu"))


def test_params_from_numpy_round_trip_keeps_jax_paths():
    _, jst, jparams, _, _, tparams = _weights(n_stages=2)
    back = params_to_numpy(tparams)
    assert (jax.tree.structure(back)
            == jax.tree.structure(jax.tree.map(np.asarray, jparams)))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))
    keys0 = set(tparams[0].state_dict())
    keys1 = set(tparams[1].state_dict())
    assert {"embed.tok", "embed.pos", "blocks.0.attn.wq",
            "blocks.0.mlp_in.w", "blocks.0.ln1.scale"} <= keys0
    assert {"head.ln_f.scale", "head.out.w", "blocks.0.ln2.bias"} <= keys1
    assert not any(k.startswith("head") for k in keys0)
    # layouts are the JAX package's: linear [in, out], embeddings [V, d]
    assert tuple(tparams[0]["blocks"][0]["mlp_in"]["w"].shape) == (32, 128)
    assert tuple(tparams[0]["embed"]["tok"].shape) == (64, 32)


def test_make_gpt_stages_splits_like_jax():
    tst = tgpt.make_gpt_stages(0, tgpt.GPTConfig(**SMALL), 2,
                               device="cpu")[0]
    jst = jgpt.make_gpt_stages(jax.random.key(0),
                               jgpt.GPTConfig(**SMALL), 2)[0]
    for t, j in zip(tst, jst):
        assert len(t.params["blocks"]) == len(j.params["blocks"])
        assert ("embed" in t.params) == ("embed" in j.params)
        assert ("head" in t.params) == ("head" in j.params)
        assert t.in_shape == j.in_shape


def test_stage_forward_matches_jax():
    _, jst, jparams, _, tst, tparams = _weights(seed=1)
    x = np.random.default_rng(0).integers(0, 64, (2, 32)).astype(np.int32)
    ref = jst[0].apply(jparams[0], jnp.asarray(x), jax.random.key(0), True)
    with torch.no_grad():
        out = tst[0].apply(tparams[0], torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _pool_pair(L=2, n=12, H=2, dh=16):
    return (jnp.zeros((L, n + 1, H, BS, dh)), jnp.zeros((L, n + 1, H, BS, dh)),
            torch.zeros((L, n + 1, H, BS, dh)),
            torch.zeros((L, n + 1, H, BS, dh)))


@pytest.mark.parametrize("kernel", ["dense", "fused"])
def test_prefill_chunk_and_decode_logits_match_jax(kernel):
    """Two prefill chunks of one request, then three decode ticks with two
    trash-routed slots: every chunk's and tick's log-probs, and every
    layer's K/V rows in the live blocks, agree with JAX's programs."""
    _, _, jparams, _, _, tparams = _weights(seed=2)
    je, jb, jh = jgpt._merged_stage_trees(jparams)
    te, tb, th = tgpt._merged_stage_trees(tparams)
    jk, jv, tk, tv = _pool_pair()
    table = np.zeros(8, np.int32)
    table[:3] = [3, 7, 1]
    prompt = np.random.default_rng(5).integers(0, 64, 7).astype(np.int32)
    live = [3, 7, 1]

    def check_pools():
        for a, b in ((jk, tk), (jv, tv)):
            np.testing.assert_allclose(b[:, live].numpy(),
                                       np.asarray(a)[:, live], **TOL)

    for p0, p1 in ((0, 4), (4, 7)):
        jk, jv, jrow = jgpt._paged_chunk_fwd(
            jb, je, jh, jk, jv, jnp.asarray(prompt[None, p0:p1]), p0,
            jnp.asarray(table), 2, BS, 16, jgpt._dense_attn_tail)
        with torch.no_grad():
            tk, tv, trow = tgpt._paged_chunk_fwd(
                tb, te, th, tk, tv,
                torch.from_numpy(prompt[None, p0:p1]).long(), p0,
                torch.from_numpy(table).long(), 2, BS)
        np.testing.assert_allclose(trow.numpy(), np.asarray(jrow), **TOL)
        check_pools()
    tok = int(np.argmax(np.asarray(jrow)))
    tables = np.zeros((3, 8), np.int32)
    tables[0] = table
    for pos in (7, 8, 9):
        toks = np.array([tok, 0, 0], np.int32)
        posv = np.array([pos, 0, 0], np.int32)
        jk, jv, jrows = jgpt._paged_decode_fwd(
            jb, je, jh, jk, jv, jnp.asarray(toks), jnp.asarray(posv),
            jnp.asarray(tables), 2, BS, 16, jgpt._dense_attn_tail,
            kernel=kernel)
        with torch.no_grad():
            tk, tv, trows = tgpt._paged_decode_fwd(
                tb, te, th, tk, tv, torch.from_numpy(toks).long(),
                torch.from_numpy(posv).long(),
                torch.from_numpy(tables).long(), 2, BS, kernel=kernel)
        np.testing.assert_allclose(trows[0].numpy(), np.asarray(jrows)[0],
                                   **TOL)
        check_pools()
        tok = int(np.argmax(np.asarray(jrows)[0]))


@pytest.mark.parametrize("cache_dtype", [None, "bfloat16"])
def test_cached_decoder_greedy_tokens_match_jax(cache_dtype):
    jcfg, jst, jparams, tcfg, tst, tparams = _weights(seed=3)
    prompts = np.random.default_rng(1).integers(0, 64, (2, 5)).astype(
        np.int32)
    ref = jgpt.make_cached_decoder(jst, jcfg, 5, 12,
                                   cache_dtype=cache_dtype)(
        jparams, jnp.asarray(prompts), jax.random.key(0))
    out = tgpt.make_cached_decoder(tst, tcfg, 5, 12, cache_dtype=cache_dtype,
                                   device="cpu")(tparams, prompts)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert len(set(out[:, 5:].flatten().tolist())) > 3   # not collapsed


def test_sampling_key_discipline():
    """Greedy rows keep their key; sampled rows split it exactly once;
    the sentinels top_k=0 / top_p>1 disable the filters."""
    rows = torch.log_softmax(torch.randn(4, 64, generator=torch.Generator()
                                         .manual_seed(0)), -1)
    kd = torch.from_numpy(np.stack([key_data(s) for s in range(4)])
                          .astype(np.int64))
    temps = torch.tensor([0.0, 0.8, 0.0, 1.0])
    tok, kd2 = tgpt._sample_dyn(rows, kd, temps, torch.zeros(4, dtype=torch.int64),
                                torch.full((4,), 2.0))
    assert torch.equal(kd2[[0, 2]], kd[[0, 2]])
    assert torch.equal(kd2[[1, 3]], split(kd)[0][[1, 3]])
    assert torch.equal(tok[[0, 2]], rows[[0, 2]].argmax(-1).int())
    # the same key draws the same token, whatever batch it rides in
    tok_solo, _ = tgpt._sample_dyn(rows[1:2], kd[1:2], temps[1:2],
                                   torch.zeros(1, dtype=torch.int64),
                                   torch.full((1,), 2.0))
    assert int(tok_solo[0]) == int(tok[1])


def test_filter_top_dyn_matches_jax():
    rng = np.random.default_rng(4)
    rows = rng.standard_normal((6, 64)).astype(np.float32) * 2.0
    top_k = np.array([0, 1, 5, 64, 8, 0], np.int32)
    top_p = np.array([2.0, 2.0, 0.9, 0.5, 0.3, 1.0], np.float32)
    ref = jax.vmap(jgpt._filter_top_dyn)(jnp.asarray(rows),
                                         jnp.asarray(top_k),
                                         jnp.asarray(top_p))
    out = tgpt._filter_top_dyn(torch.from_numpy(rows),
                               torch.from_numpy(top_k),
                               torch.from_numpy(top_p))
    np.testing.assert_array_equal(np.isneginf(out.numpy()),
                                  np.isneginf(np.asarray(ref)))
    assert not np.isneginf(out.numpy()[0]).any()      # both disabled


def test_sampled_top1_equals_greedy_and_seeds_reproduce():
    _, _, _, tcfg, tst, tparams = _weights(seed=3)
    prompt = np.random.default_rng(2).integers(0, 64, (1, 5)).astype(
        np.int32)
    greedy = tgpt.make_cached_decoder(tst, tcfg, 5, 10, device="cpu")(
        tparams, prompt)
    top1 = tgpt.make_cached_decoder(tst, tcfg, 5, 10, temperature=0.7,
                                    top_k=1, device="cpu")(
        tparams, prompt, key_data(9))
    assert torch.equal(top1, greedy)
    dec = tgpt.make_cached_decoder(tst, tcfg, 5, 10, temperature=1.5,
                                   device="cpu")
    a = dec(tparams, prompt, key_data(1))
    assert torch.equal(a, dec(tparams, prompt, key_data(1)))
    assert not torch.equal(a, dec(tparams, prompt, key_data(2)))


@pytest.mark.parametrize("kw", [
    dict(attn_impl="ulysses", n_seq=2),
    dict(n_experts=4),
    dict(attn_impl="ring", n_seq=2),
    # tensor-parallel serving is ported: the programs slice a dense
    # build, and refuse a TP-sharded training build with the JAX text
    dict(tp_serving=dict(n_tensor_parallel=2), item="jax"),
    # serving builds: the dense slot-row target, speculation over it,
    # tracing and the flight recorder are ported; the TP slot programs
    # still name their item, as --tp and the linter name theirs
    dict(engine=dict(kv_layout="dense"), item=None),
    dict(engine=dict(kv_layout="dense", spec_k=2, draft=True), item=None),
    dict(engine=dict(trace=True), item=None),
    dict(engine=dict(flight=True), item=None),
    dict(cli=["--model", "gpt", "--tp", "2", "--overlap", "ring",
              "--dryrun", "1", "--data-root", "/nonexistent"], item=None),
    # the linter is ported: the CLI's --lint preflight runs, then trains
    dict(cli=["--lint", "--model", "gpt", "--dryrun", "1", "--data-root",
              "/nonexistent"], item=None),
    # a TP slot program without a serving mesh: the JAX builder's text
    dict(slot_decode=dict(n_tensor_parallel=2), item="jax"),
    # the adapters build on every serving program, the dense slot rows
    # (the degraded fallback) included
    dict(engine=dict(kv_layout="dense", adapters=True), item=None),
])
def test_unported_configs_raise_with_roadmap_item(kw):
    """MoE and sequence-parallel stages train (items 6d.2, 6d.3), and the
    serving programs refuse them with the JAX package's own texts;
    tensor-parallel stages train and serve (from the dense build, over a
    mesh: ``tests/test_torch_tp_serve.py``), refused with the JAX texts
    otherwise; the linter runs, and what is ported builds."""
    if "item" not in kw:
        cfg = tgpt.GPTConfig(**{**SMALL, **kw})
        stages = tgpt.make_gpt_stages(0, cfg, 1, device="cpu")[0]
        jcfg = jgpt.GPTConfig(**{**SMALL, **kw})
        jst = jgpt.make_gpt_stages(jax.random.key(0), jcfg, 1)[0]
        for build, jbuild in (
                (lambda: tgpt.make_cached_decoder(stages, cfg, 4, 2,
                                                  device="cpu"),
                 lambda: jgpt.make_cached_decoder(jst, jcfg, 4, 2)),
                (lambda: tgpt.make_paged_decode_step(stages, cfg, 16, 4,
                                                     device="cpu"),
                 lambda: jgpt.make_paged_decode_step(jst, jcfg, 16, 4))):
            with pytest.raises(ValueError) as ours:
                build()
            with pytest.raises(ValueError) as theirs:
                jbuild()
            assert str(ours.value) == str(theirs.value)
        return
    from simple_distributed_machine_learning_tpu_torch.serve import (
        InferenceEngine,
    )
    if "tp_serving" in kw:
        cfg = tgpt.GPTConfig(**{**SMALL, **kw["tp_serving"]})
        stages = tgpt.make_gpt_stages(0, cfg, 1, device="cpu")[0]
        assert stages[0].shards is not None
        jcfg = jgpt.GPTConfig(**{**SMALL, **kw["tp_serving"]})
        jst = jgpt.make_gpt_stages(jax.random.key(0), jcfg, 1)[0]
        with pytest.raises(ValueError) as ours:
            tgpt.make_paged_decode_step(stages, cfg, 16, 4, device="cpu")
        with pytest.raises(ValueError) as theirs:
            jgpt.make_paged_decode_step(jst, jcfg, 16, 4)
        assert str(ours.value) == str(theirs.value)
        return
    if "slot_decode" in kw:
        jcfg, jst, _, tcfg, tst, _ = _weights()
        with pytest.raises(ValueError) as ours:
            tgpt.make_slot_decode_step(
                tst, dataclasses.replace(tcfg, **kw["slot_decode"]), 16,
                device="cpu")
        with pytest.raises(ValueError) as theirs:
            jgpt.make_slot_decode_step(
                jst, dataclasses.replace(jcfg, **kw["slot_decode"]), 16)
        assert str(ours.value) == str(theirs.value)
        return
    if "cli" in kw:
        from simple_distributed_machine_learning_tpu_torch.cli import main
        if kw["item"] is None:
            main(["--rank", "0", "--device", "cpu"] + kw["cli"])
            return
        with pytest.raises(SystemExit,
                           match=rf"ROADMAP\.md, Queue A: {kw['item']}"):
            main(["--rank", "0", "--device", "cpu"] + kw["cli"])
        return
    from simple_distributed_machine_learning_tpu_torch.serve import (
        AdapterStore,
        FlightRecorder,
        ServeTrace,
    )
    _, _, _, tcfg, tst, tparams = _weights()
    if "engine" in kw:
        ekw = dict(kw["engine"])
        if ekw.pop("draft", False):
            ekw.update(draft_stages=tst, draft_cfg=tcfg)
        if ekw.get("trace"):
            ekw["trace"] = ServeTrace()
        if ekw.get("flight"):
            ekw["flight"] = FlightRecorder()
        if ekw.get("adapters"):
            ekw["adapters"] = AdapterStore(tcfg, 2, 4, device="cpu")

        def build():
            return InferenceEngine(tst, tcfg, params=tparams, device="cpu",
                                   **ekw)
    else:
        def build():
            return tgpt.make_slot_decode_step(tst, tcfg, 16, device="cpu",
                                              **kw["slot_decode"])
    if kw["item"] is None:
        eng = build()
        h = eng.submit(np.arange(5) % 64, max_new_tokens=4, seed=3)
        eng.drain()
        solo = tgpt.make_cached_decoder(tst, tcfg, 5, 4, device="cpu")(
            tparams, (np.arange(5) % 64)[None].astype(np.int32),
            key_data(3))
        assert h.tokens == solo[0, 5:].tolist()
        assert eng.kv_layout == ekw.get("kv_layout", "paged")
        if eng.trace is not None:
            assert [r["ev"] for r in eng.trace.rows][::len(
                eng.trace.rows) - 1] == ["submit", "done"]
        if eng.flight is not None:
            assert eng.flight.ticks_recorded == eng._tick_count > 0
        return
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP\.md, Queue A: {kw['item']}"):
        build()


def test_slot_decode_step_matches_the_jax_program():
    """The dense slot-row decode tick against the JAX ``make_slot_decode_
    step`` on one pool: same K/V rows written, same log-prob argmax,
    greedy and sampled slots side by side (sampled tokens come from each
    package's own generator, so only the greedy tokens are compared)."""
    jcfg, jst, jparams, tcfg, tst, tparams = _weights()
    S, ML, H, DH = 3, 16, SMALL["n_heads"], SMALL["d_model"] // 2
    rng = np.random.default_rng(4)
    kc = rng.normal(size=(2, S, H, ML, DH)).astype(np.float32)
    vc = rng.normal(size=(2, S, H, ML, DH)).astype(np.float32)
    toks = rng.integers(0, 64, S).astype(np.int32)
    pos = np.asarray([3, 0, 9], np.int32)
    kd = np.stack([key_data(s) for s in (1, 2, 3)])
    temps = np.asarray([0.0, 0.0, 0.9], np.float32)
    top_ks = np.asarray([0, 0, 5], np.int32)
    top_ps = np.full(S, 2.0, np.float32)
    jstep = jgpt.make_slot_decode_step(jst, jcfg, ML)
    jkc, jvc, jt, _ = jstep(jparams, jnp.asarray(kc), jnp.asarray(vc),
                            toks, pos, kd, temps, top_ks, top_ps)
    tstep = tgpt.make_slot_decode_step(tst, tcfg, ML, device="cpu")
    tkc, tvc, tt, tkd = tstep(tparams, torch.from_numpy(kc.copy()),
                              torch.from_numpy(vc.copy()), toks, pos, kd,
                              temps, top_ks, top_ps)
    np.testing.assert_allclose(tkc.numpy(), np.asarray(jkc), **TOL)
    np.testing.assert_allclose(tvc.numpy(), np.asarray(jvc), **TOL)
    assert tt[:2].tolist() == np.asarray(jt)[:2].tolist()
    assert tkd[:2].tolist() == kd[:2].astype(np.int64).tolist()  # greedy


def test_block_copy_moves_scale_plane_with_data():
    """Copy-on-write of a quantised pool copies each block's f32 scales
    with its narrow rows, in every layer."""
    shape = (2, 6, 2, BS, 16)
    gen = torch.Generator().manual_seed(0)
    kc = tgpt.QuantKV(*tgpt._quantize_rows(torch.randn(shape, generator=gen),
                                           "int8"))
    vc = tgpt.QuantKV(*tgpt._quantize_rows(torch.randn(shape, generator=gen),
                                           "int8"))
    kc2, vc2 = tgpt.make_paged_block_copy()(kc, vc, 5, 2)
    for buf in (kc2, vc2):
        assert torch.equal(buf.data[:, 5], buf.data[:, 2])
        assert torch.equal(buf.scale[:, 5], buf.scale[:, 2])
    assert kc2.data.data_ptr() == kc.data.data_ptr()    # in place
