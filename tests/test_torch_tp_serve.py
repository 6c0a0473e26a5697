"""Tensor-parallel serving (``models/gpt.py``'s TP serving programs, the
head-sharded pools of ``serve/slots.py``, ``InferenceEngine(mesh=)``)
against the JAX package's TP engine and against the port itself.

- The JAX pins ``tests/test_serve.py::test_tp2_matches_tp1_dense`` and
  ``tests/test_paged_attention.py::test_tp2_quantized_pool_token_parity``
  (green on this tree): the port's tp 2 engine emits the JAX tp 2
  engine's greedy tokens from the same weights, dense and paged, plain
  and fused attention (the port's plain K4 on the CPU, the JAX Pallas
  kernel in interpret mode), f32 and the int8 pool; both equal the solo
  decoder. The JAX engines run without ``metrics=`` (its tick calls an
  analyzer module that does not import on this tree).
- Within the port: sampled streams equal solo decode at tp 2 and 4;
  ``overlap="ring"`` serving equals the tp 1 streams; a TP target under
  speculation; LoRA tenants; copy-on-write on every shard; the per-shard
  ``kv_bytes_resident`` gauge against ``predict_kv_bytes_resident``; the
  fused tick's K4 launches (``tp x n_layers``, ``H/tp`` heads each); the
  degraded factory at tp 1; the JAX validation texts; ``--serve-tp`` in
  the CLI.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu.models import gpt as jgpt
from simple_distributed_machine_learning_tpu.parallel.mesh import (
    make_mesh as jmake_mesh,
)
from simple_distributed_machine_learning_tpu.serve import (
    InferenceEngine as JaxEngine,
)
from simple_distributed_machine_learning_tpu.serve import slots as jslots
from simple_distributed_machine_learning_tpu_torch.analysis import (
    programs,
)
from simple_distributed_machine_learning_tpu_torch.interop import (
    params_from_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.models import lora
from simple_distributed_machine_learning_tpu_torch.ops.random import key_data
from simple_distributed_machine_learning_tpu_torch.parallel import make_mesh
from simple_distributed_machine_learning_tpu_torch.serve import (
    AdapterStore,
    InferenceEngine,
    ServeMetrics,
    engine_factory,
)
from simple_distributed_machine_learning_tpu_torch.serve import (
    slots as tslots,
)

SMALL = dict(vocab=32, seq_len=48, d_model=32, n_heads=4, n_layers=2)
KW = dict(n_slots=2, block_size=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """One set of numpy weights (a JAX build plus seeded noise, std 1)
    in both packages: ``(jcfg, jstages, jparams, tcfg, tstages,
    tparams)``."""
    jcfg = jgpt.GPTConfig(**SMALL)
    jst = jgpt.make_gpt_stages(jax.random.key(0), jcfg, 1)[0]
    rng = np.random.default_rng(0)
    nparams = jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0.0, 1.0, a.shape)
                   ).astype(np.float32), [s.params for s in jst])
    tcfg = tgpt.GPTConfig(**SMALL)
    tst = tgpt.make_gpt_stages(0, tcfg, 1, device="cpu")[0]
    return (jcfg, jst, jax.tree.map(jnp.asarray, nparams), tcfg, tst,
            params_from_numpy(nparams, "cpu"))


def _reqs(sampled=False, n=3):
    rng = np.random.default_rng(3)
    out = []
    for i in range(n):
        r = dict(prompt=rng.integers(0, 32, 4 + 3 * i).astype(np.int32),
                 max_new_tokens=6, seed=100 + i)
        if sampled and i % 2:
            r.update(temperature=0.9, top_k=12)
        out.append(r)
    return out


def _run(engine, reqs):
    handles = [engine.submit(**r) for r in reqs]
    engine.drain()
    return [h.tokens for h in handles]


def _mesh(tp):
    return make_mesh(1, n_model=tp, devices=["cpu"] * tp)


def _port(weights, tp=1, overlap="none", **kw):
    _, _, _, tcfg, tst, tparams = weights
    cfg = dataclasses.replace(tcfg, n_tensor_parallel=tp, overlap=overlap)
    kw.setdefault("mesh", _mesh(tp) if tp > 1 else None)
    return InferenceEngine(tst, cfg, params=tparams, device="cpu",
                           **{**KW, **kw})


def _solo(weights, reqs, params=None):
    _, _, _, tcfg, tst, tparams = weights
    out = []
    for r in reqs:
        t0 = len(r["prompt"])
        dec = tgpt.make_cached_decoder(
            tst, tcfg, t0, r["max_new_tokens"],
            temperature=r.get("temperature", 0.0), top_k=r.get("top_k"),
            device="cpu")
        out.append(dec(params or tparams, r["prompt"][None],
                       key_data(r["seed"]))[0, t0:].tolist())
    return out


# ---- against the JAX TP engine -----------------------------------------------

@pytest.mark.parametrize("layout,kernel,cache_dtype", [
    ("dense", "dense", None), ("paged", "dense", None),
    ("paged", "fused", None), ("paged", "fused", "int8")])
def test_tp2_greedy_streams_equal_the_jax_tp2_engine(weights, layout,
                                                     kernel, cache_dtype):
    jcfg, jst, jparams, *_ = weights
    kw = dict(KW) if layout == "paged" else dict(n_slots=2)
    jeng = JaxEngine(jst, dataclasses.replace(jcfg, n_tensor_parallel=2),
                     params=jparams, kv_layout=layout, attn_kernel=kernel,
                     cache_dtype=cache_dtype,
                     mesh=jmake_mesh(n_stages=1, n_data=1, n_model=2),
                     **kw)
    teng = _port(weights, 2, kv_layout=layout, attn_kernel=kernel,
                 cache_dtype=cache_dtype, **kw)
    assert teng.pool.tp == jeng.pool.tp == 2
    reqs = _reqs()
    ref, out = _run(jeng, reqs), _run(teng, reqs)
    assert out == ref
    if cache_dtype is None:
        assert out == _solo(weights, reqs)
    else:
        assert out == _run(_port(weights, 1, cache_dtype=cache_dtype,
                                 attn_kernel=kernel), reqs)
    assert len({t for s in out for t in s}) > 3          # not collapsed


def test_pack_tp_serve_params_are_the_jax_slices(weights):
    _, _, jparams, _, _, tparams = weights
    jstk, jrep = jgpt.pack_tp_serve_params(jparams, 2)
    tstk, trep = tgpt.pack_tp_serve_params(tparams, 2)
    for jl, tl in zip(jstk, tstk):
        for m in range(2):
            for (path, a), b in zip(
                    jax.tree_util.tree_flatten_with_path(jl)[0],
                    jax.tree.leaves(jax.tree.map(
                        lambda t: t.numpy(), tl[m]))):
                np.testing.assert_array_equal(np.asarray(a)[m], b,
                                              err_msg=str(path))
    assert trep["embed"] is tgpt._merged_stage_trees(tparams)[0]


# ---- within the port ----------------------------------------------------------

@pytest.mark.parametrize("tp,layout,kernel", [
    (2, "paged", "fused"), (4, "paged", "fused"), (4, "dense", "dense")])
def test_tp_streams_greedy_and_sampled_equal_solo(weights, tp, layout,
                                                  kernel):
    kw = {} if layout == "paged" else dict(n_slots=2, block_size=16)
    reqs = _reqs(sampled=True, n=4)
    out = _run(_port(weights, tp, kv_layout=layout, attn_kernel=kernel,
                     **kw), reqs)
    assert out == _solo(weights, reqs)


@pytest.mark.parametrize("tp,layout", [(2, "paged"), (4, "paged"),
                                       (2, "dense")])
def test_ring_serving_equals_tp1_streams(weights, tp, layout):
    """``overlap="ring"``: the row-parallel closes by the ring (every
    replica the same bits), the streams the tp 1 engine's."""
    reqs = _reqs(sampled=True)
    kw = {} if layout == "paged" else dict(n_slots=2, block_size=16)
    ring = _run(_port(weights, tp, "ring", kv_layout=layout,
                      attn_kernel="dense", **kw), reqs)
    one = _run(_port(weights, 1, kv_layout=layout, attn_kernel="dense",
                     **kw), reqs)
    assert ring == one


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_tp_target_speculation_equals_solo(weights, layout):
    """A tp 2 target verifying a single-device draft's proposals (two
    dispatches a tick) reproduces the solo streams; a TP engine has no
    fused spec tick."""
    _, _, _, tcfg, tst, _ = weights
    draft_cfg = dataclasses.replace(tcfg, n_layers=1)
    draft = tgpt.make_gpt_stages(9, draft_cfg, 1, device="cpu")[0]
    kw = dict(n_slots=2) if layout == "dense" else {}
    eng = _port(weights, 2, kv_layout=layout, draft_stages=draft,
                draft_cfg=draft_cfg, spec_k=4,
                attn_kernel="fused" if layout == "paged" else "dense", **kw)
    assert eng._spec_fused is None
    reqs = _reqs()
    assert _run(eng, reqs) == _solo(weights, reqs)


def test_lora_tenants_under_tp_equal_merged_solo(weights):
    """A tenant's stream at tp 2 equals the solo decode of the merged
    weights; a base request equals the adapter-free engine's."""
    _, _, _, tcfg, tst, tparams = weights
    cfg2 = dataclasses.replace(tcfg, n_tensor_parallel=2)
    store = AdapterStore(cfg2, 4, KW["n_slots"], device="cpu")
    eng = _port(weights, 2, adapters=store, attn_kernel="fused")
    gen = torch.Generator().manual_seed(5)
    w = {k: 0.5 * torch.randn(v.shape, generator=gen)    # B nonzero too
         for k, v in lora.init_lora_adapter(gen, tcfg, 4,
                                            device="cpu").items()}
    eng.register_adapter("t0", w)
    reqs = _reqs()
    handles = [eng.submit(**r, adapter="t0" if i != 1 else None)
               for i, r in enumerate(reqs)]
    eng.drain()
    merged = lora.merge_adapter(tparams, w)
    for i, (h, r) in enumerate(zip(handles, reqs)):
        want = _solo(weights, [r], params=tparams if i == 1 else merged)[0]
        assert h.tokens == want, i
    assert _solo(weights, [reqs[0]], params=merged) != _solo(weights,
                                                             [reqs[0]])


def test_copy_on_write_acts_on_every_shard(weights):
    """A shared prefix and a prompt that is another's prefix: the tp 2
    engine's streams and its prefix-share and CoW counts are tp 1's."""
    rng = np.random.default_rng(7)
    pre = rng.integers(0, 32, 6).astype(np.int32)

    def body(n):
        return np.concatenate([pre, rng.integers(0, 32, n).astype(np.int32)])

    # r0's prompt IS the prefix and decodes long, so r3 (boarding once r1
    # and r2 retire) shares r0's partial tail block while r0 still holds
    # it: a copy-on-write
    reqs = [dict(prompt=p, max_new_tokens=n, seed=100 + i)
            for i, (p, n) in enumerate([(pre, 12), (body(2), 2),
                                        (body(5), 3), (body(3), 6),
                                        (pre[:5], 4)])]
    kw = dict(n_slots=3, block_size=4, prefill_chunk=3,
              metrics=ServeMetrics())
    out = {}
    for tp in (1, 2):
        eng = _port(weights, tp, attn_kernel="fused", **kw)
        kw["metrics"] = ServeMetrics()
        out[tp] = (_run(eng, reqs), eng.pool.cow_copies_total,
                   eng.pool.prefix_hit_blocks_total)
    assert out[2] == out[1]
    assert out[2][1] >= 1 and out[2][2] >= 2


def test_per_shard_kv_bytes_equal_the_byte_model(weights):
    """The gauge reports what one coordinate's pool pins — half of tp
    1's at tp 2 — and equals ``predict_kv_bytes_resident`` on the
    per-shard spec; the drift gauge stays 0 every tick."""
    eng = _port(weights, 2, attn_kernel="fused", metrics=ServeMetrics())
    one = _port(weights, 1, attn_kernel="fused")
    for r in _reqs():
        eng.submit(**r)
        one.submit(**r)
    seen = 0
    while eng.busy:
        eng.step()
        one.step()
        live, predicted = eng.kv_drift()
        assert live == predicted
        assert 2 * live == one.pool.bytes_resident()
        seen = max(seen, live)
        rows = [int(eng.pool.positions[s]) for s in eng.pool.active_slots()
                if eng.requests[eng.pool.occupant(s)].prefill_pos is None]
        if rows and all(rows):
            spec = programs.ServeSpec(eng.cfg, n_slots=2, kv_layout="paged",
                                      block_size=8)
            assert programs.predict_kv_bytes_resident(spec, rows) == live
    assert seen > 0
    assert eng.metrics.summary()["kv_drift_bytes"] == 0
    dense = _port(weights, 2, kv_layout="dense", n_slots=2)
    assert 2 * dense.pool.bytes_resident() == _port(
        weights, 1, kv_layout="dense", n_slots=2).pool.bytes_resident()
    assert all(k.shape[2] == SMALL["n_heads"] // 2 for k in dense.pool.kc)


@pytest.mark.parametrize("tp", [2, 4])
def test_fused_tp_tick_launches_k4_per_shard_and_layer(weights, tp):
    """One fused decode tick records ``tp x n_layers`` K4 launches, each
    over one shard's pool and ``H/tp`` heads (the kernel linter's
    recorder sees the plain version's calls on the CPU as well)."""
    eng = _port(weights, tp, attn_kernel="fused")
    eng.submit(np.arange(5, dtype=np.int32), max_new_tokens=4)
    launches = programs.tick_launches(eng)["paged_decode"]
    assert len(launches) == tp * SMALL["n_layers"]
    assert {s.grid[1] for s in launches} == {SMALL["n_heads"] // tp}
    assert {s.operand("k").shape[1] for s in launches} == {
        SMALL["n_heads"] // tp}
    report = programs.kernel_report(
        tgpt.make_gpt_stages(0, tgpt.GPTConfig(**SMALL), 1,
                             device="cpu")[0],
        programs.ServeSpec(eng.cfg, n_slots=2, kv_layout="paged",
                           block_size=8, attn_kernel="fused"),
        device="cpu")
    assert not [f for f in report.findings
                if f.rule.startswith("kernel.")], report.format()


def test_degraded_factory_serves_tp1_dense(weights):
    """``engine_factory(mesh=)`` builds the TP engine; ``degraded=True``
    applies the JAX fallback, tp -> 1 on dense rows, which
    ``degraded_spec`` mirrors; both serve the solo streams."""
    _, _, _, tcfg, tst, tparams = weights
    cfg2 = dataclasses.replace(tcfg, n_tensor_parallel=2)
    fac = engine_factory(tst, cfg2, mesh=_mesh(2), params=tparams,
                         device="cpu", n_slots=2, block_size=8,
                         attn_kernel="fused", cache_dtype="int8")
    full, deg = fac(False), fac(True)
    assert (full.tp, full.kv_layout, full.pool.tp) == (2, "paged", 2)
    assert (deg.tp, deg.kv_layout, deg.pool.tp, deg.mesh) == (1, "dense",
                                                              1, None)
    want = programs.degraded_spec(programs.engine_spec(full))
    got = programs.engine_spec(deg)
    assert (got.tp, got.kv_layout, got.spec_k, got.cfg) == (
        want.tp, want.kv_layout, want.spec_k, want.cfg)
    assert tgpt._cache_dtype(got.cache_dtype) == tgpt._cache_dtype(
        want.cache_dtype) == torch.float32
    reqs = _reqs()
    assert _run(deg, reqs) == _solo(weights, reqs)


def test_validation_texts_are_the_jax_ones(weights):
    jcfg, jst, jparams, tcfg, tst, tparams = weights
    j2 = dataclasses.replace(jcfg, n_tensor_parallel=2)
    t2 = dataclasses.replace(tcfg, n_tensor_parallel=2)

    def same(jcall, tcall, exc=ValueError):
        with pytest.raises(exc) as j:
            jcall()
        with pytest.raises(exc) as t:
            tcall()
        assert str(t.value) == str(j.value)
        return str(t.value)

    # a TP config without a mesh (the first builder the engine makes)
    assert "mesh" in same(
        lambda: JaxEngine(jst, j2, n_slots=2),
        lambda: InferenceEngine(tst, t2, n_slots=2, device="cpu"))
    assert "mesh" in same(
        lambda: JaxEngine(jst, j2, n_slots=2, kv_layout="dense"),
        lambda: InferenceEngine(tst, t2, n_slots=2, kv_layout="dense",
                                device="cpu"))
    assert "single-device" in same(
        lambda: jgpt.make_slot_propose(jst, j2, 16, 4),
        lambda: tgpt.make_slot_propose(tst, t2, 16, 4, device="cpu"))
    same(lambda: jslots.KVCachePool(2, 2, 4, 16, 8, tp=3),
         lambda: tslots.KVCachePool(2, 2, 4, 16, 8, tp=3, device="cpu"))
    same(lambda: jslots.PagedKVPool(2, 2, 4, 16, 8, tp=2,
                                    host_cache_blocks=2),
         lambda: tslots.PagedKVPool(2, 2, 4, 16, 8, tp=2,
                                    host_cache_blocks=2, device="cpu"))
    # a TP-sharded training build: the programs slice a dense one
    jsh = jgpt.make_gpt_stages(jax.random.key(0), j2, 1)[0]
    tsh = tgpt.make_gpt_stages(0, t2, 1, device="cpu")[0]
    assert "unsharded" in same(
        lambda: jgpt.make_paged_decode_step(jsh, j2, 16, 8),
        lambda: tgpt.make_paged_decode_step(tsh, t2, 16, 8, device="cpu"))
    # a mesh whose model axis is not the config's width
    with pytest.raises(ValueError, match="needs a mesh with a 'model' "
                                         "axis of that size"):
        InferenceEngine(tst, t2, n_slots=2, mesh=_mesh(4), device="cpu")
    # a tp 1 config ignores the mesh, as the JAX engine does
    assert _port(weights, 1, mesh=object()).mesh is None


def test_cli_serve_tp(capsys):
    from simple_distributed_machine_learning_tpu.cli import main as jmain
    from simple_distributed_machine_learning_tpu_torch.cli import main
    base = ["--rank", "0", "--model", "gpt", "--data-root", "/nonexistent",
            "--serve-sim", "8"]
    main(base + ["--serve-tp", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "| serving: tp 2 on cpu, cpu" in out
    assert "| serve: 8/8 requests completed" in out
    assert "| serve: tp 2\n" in out
    assert "| serve: kv drift 0 bytes" in out
    for bad in (["--serve-tp", "0"], ["--serve-tp", "3"]):
        with pytest.raises(SystemExit) as t:
            main(base + bad + ["--device", "cpu"])
        with pytest.raises(SystemExit) as j:
            jmain(base + bad)
        assert str(t.value) == str(j.value)
