"""Head dims past the port's whole-row kernels: the port against the JAX
package at dh 160, 256 and 320, where the JAX kernels pad the head dim to a
multiple of 128 lanes and the port's CUDA kernels switch to their wide
tilings (flash K1-K3 past 128, paged K4 past 256). Also the serving pool's
``begin_seq``/``end_seq``, which JAX callers drive directly.

On the CPU the port's wrappers compute their plain versions; the JAX side
runs its Pallas kernels in interpret mode. Inputs are made with numpy from
a seed and handed to both. Tolerances, each with its reason:

- f32 flash forward ``(o, l, m)`` within rtol = atol = 1e-5 and f32
  gradients within 1e-4: ``tests/test_torch_flash_attention.py``'s (both
  sum in f32 in another order);
- bf16 flash within ``tolerances.attn_tol(bfloat16)``: roundings of the
  same products' operands, summed in another order;
- paged attention within rtol = atol = 1e-5: both read the same values;
- the one-layer GPT at head dim 256: its loss within 1e-5 relative and
  its parameters after one SGD step within 1e-6, as
  ``tests/test_torch_gpt_train.py`` holds the narrow model; greedy tokens
  equal.

The CUDA kernels at these head dims are held against their plain versions
on the card in ``tests/test_torch_flash_attention_cuda.py`` and
``tests/test_torch_paged_attention_cuda.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tolerances import attn_tol

from simple_distributed_machine_learning_tpu import make_mesh
from simple_distributed_machine_learning_tpu.models import gpt as jgpt
from simple_distributed_machine_learning_tpu.ops import flash_attention as jfa
from simple_distributed_machine_learning_tpu.ops.paged_attention import (
    paged_attention as jax_paged_attention,
)
from simple_distributed_machine_learning_tpu.parallel.pipeline import (
    Pipeline as JaxPipeline,
)
from simple_distributed_machine_learning_tpu.serve.slots import (
    PagedKVPool as JaxPagedKVPool,
)
from simple_distributed_machine_learning_tpu.train import optimizer as jopt
from simple_distributed_machine_learning_tpu.train import step as jstep
from simple_distributed_machine_learning_tpu_torch import train as ttrain
from simple_distributed_machine_learning_tpu_torch.analysis import kernels
from simple_distributed_machine_learning_tpu_torch.interop import (
    params_from_numpy,
    params_to_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.ops import (
    flash_attention as tfa,
)
from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (
    MAX_KEY_PARTS,
    key_parts,
    paged_attention,
    part_blocks,
)
from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (
    launch_spec as paged_launch_spec,
)
from simple_distributed_machine_learning_tpu_torch.parallel import Pipeline
from simple_distributed_machine_learning_tpu_torch.serve.slots import (
    PagedKVPool,
)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
BLOCK = 32


def _arrays(seed, shape, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


# -- flash K1-K3 --------------------------------------------------------------


@pytest.mark.parametrize("dh", [160, 196, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_matches_jax_at_wide_head_dims(dtype, dh):
    """K1's ``(o, l, m)`` and the gradients of ``sum(o * w)`` through K2 and
    K3, at ``[1, 2, 64, dh]``: the JAX kernels pad dh to 256, the port's
    card kernels run their wide tilings (the plain versions here); dh 196
    is not a multiple of 8, which the card kernels take by plain copies."""
    q, k, v, w = _arrays(dh + len(dtype), (1, 2, 64, dh), 4)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    jo, jl, jm = jfa._flash_fwd_call(jq, jk, jv, BLOCK, BLOCK)

    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, BLOCK, BLOCK)
        return jnp.sum(o.astype(jnp.float32) * w)
    jgrads = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)

    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    o, l, m = tfa.flash_forward(tq, tk, tv)
    tq, tk, tv = (a.requires_grad_() for a in (tq, tk, tv))
    out = tfa.flash_attention(tq, tk, tv, BLOCK, BLOCK, device="cpu")
    (out.float() * torch.from_numpy(w)).sum().backward()
    if dtype == "float32":
        fwd_tol, grad_tol = F32_TOL, GRAD_TOL
    else:
        rtol, atol = attn_tol(jnp.bfloat16)
        fwd_tol = grad_tol = dict(rtol=rtol, atol=atol)
    for got, ref in ((o, jo), (l, jl), (m, jm)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   **fwd_tol)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), jgrads):
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   **grad_tol)


@pytest.mark.parametrize("dh", [129, 160, 256, 320, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_launch_specs_at_wide_head_dims_lint_clean(dtype, dh):
    """Past dh 128 each launch spec declares the wide kernels' tiling:
    grid ``(B*H, ceil(T/rows))`` and the loop (chunks, 64-row tiles,
    slices). K1 owns 128 q rows a cell, K2 and K3 64. All three: up to dh
    256 one chunk of dh, the own rows one kept ``(1, rows, dh)`` block,
    the contraction whole (bf16) or in 64-column slices (f32); past 256
    chunks of 256, the own rows streamed beside the other side's in
    slices of 128 (bf16) or 64 (f32). The linter proves every window in
    bounds and every output block written by one cell."""
    q = torch.empty((2, 16, 2048, dh), dtype=dtype, device="meta")
    f32 = dtype == torch.float32
    for name in ("flash_forward", "flash_dq", "flash_dkv"):
        spec = tfa.launch_spec(name, q)
        if dh <= 256:
            ds, dc = (64 if f32 else dh), dh
        else:
            ds, dc = (64 if f32 else 128), 256
        rows = 128 if name == "flash_forward" else 64
        assert tfa.wide_tiling(name, dh, dtype) == (ds, dc)
        assert spec.grid == (32, 2048 // rows)
        assert spec.loop == (-(-dh // dc), 32, -(-dh // ds))
        own = "q" if name != "flash_dkv" else "k"
        assert spec.operand(own).block == (1, rows, dh if dh <= 256 else ds)
        out = "o" if name == "flash_forward" else "dq" if own == "q" else "dk"
        assert spec.operand(out).block == (1, rows, dc)
        assert kernels.lint(spec) == [], name


def test_flash_launch_spec_keeps_whole_rows_up_to_128():
    q = torch.empty((2, 4, 200, 128), dtype=torch.bfloat16, device="meta")
    spec = tfa.launch_spec("flash_forward", q)
    assert spec.loop == (4,) and spec.operand("q").block == (1, 64, 128)
    assert tfa.wide_tiling("flash_forward", 128, torch.bfloat16) is None
    assert tfa.wide_tiling("flash_dkv", 129, torch.float32) == (64, 129)
    # the wide K1 tiles as K2 and K3: 128 q rows a cell, q kept whole up to
    # dh 256, chunks of 256 past it
    assert tfa.wide_tiling("flash_forward", 129, torch.bfloat16) == (129, 129)
    assert tfa.wide_tiling("flash_forward", 256, torch.float32) == (64, 256)
    assert tfa.wide_tiling("flash_forward", 512, torch.bfloat16) == (128, 256)
    assert tfa.WIDE_FORWARD_ROWS == 2 * tfa.TILE == 128


# -- paged K4 -----------------------------------------------------------------


_PLAIN_WIDE = ([("float32", 1, 320), ("int8", 1, 320), ("float32", 9, 320)]
               + [(name, K, dh) for dh in (160, 512)
                  for name in ("float32", "int8") for K in (1, 9)])


@pytest.mark.parametrize(
    "name,K,dh", _PLAIN_WIDE,
    ids=[f"{n}-{k}" + ("" if d == 320 else f"-dh{d}") for n, k, d in _PLAIN_WIDE])
def test_paged_plain_version_matches_jax_at_dh_320(name, K, dh):
    """K4's plain version against the JAX kernel past head dim 128, where
    the card runs the wide kernel: dh 320, and 160 and 512 in f32 and int8
    with one query group and two."""
    S, H, bs, NB = 3, 2, 4, 6
    rng = np.random.default_rng(dh + K)
    q = rng.standard_normal((S, H, K, dh)).astype(np.float32)
    kc = rng.standard_normal((12, H, bs, dh)).astype(np.float32)
    vc = rng.standard_normal((12, H, bs, dh)).astype(np.float32)
    tables = np.zeros((S, NB), np.int32)
    tables[0, :4] = [2, 5, 7, 8]
    tables[1, :2] = [1, 3]
    tables[2, :1] = [9]
    qpos = np.minimum(np.array([10, 4, 0])[:, None] + np.arange(K)[None, :],
                      NB * bs - 1).astype(np.int32)
    if name == "int8":
        jk, jks = jgpt._quantize_rows(jnp.asarray(kc), jnp.dtype(name))
        jv, jvs = jgpt._quantize_rows(jnp.asarray(vc), jnp.dtype(name))
        tk, tks = tgpt._quantize_rows(torch.from_numpy(kc), name)
        tv, tvs = tgpt._quantize_rows(torch.from_numpy(vc), name)
    else:
        jk, jv, jks, jvs = jnp.asarray(kc), jnp.asarray(vc), None, None
        tk, tv = torch.from_numpy(kc), torch.from_numpy(vc)
        tks = tvs = None
    ref = jax_paged_attention(jnp.asarray(q), jk, jv, jnp.asarray(tables),
                              jnp.asarray(qpos), block_size=bs, kscale=jks,
                              vscale=jvs)
    out = paged_attention(torch.from_numpy(q), tk, tv,
                          torch.from_numpy(tables), torch.from_numpy(qpos),
                          block_size=bs, kscale=tks, vscale=tvs,
                          device="cpu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)


def _meta_spec(dh, S=4, H=2, K=9, bs=16, NB=8):
    """K4's launch spec on ``meta`` tensors (an int8 pool with its scale
    planes), under the table contract ``[0, S * NB]``."""
    q = torch.empty((S, H, K, dh), device="meta")
    kc = torch.empty((S * NB + 1, H, bs, dh), dtype=torch.int8,
                     device="meta")
    sc = torch.empty((S * NB + 1, H, bs), device="meta")
    tables = torch.empty((S, NB), dtype=torch.int32, device="meta")
    qpos = torch.empty((S, K), dtype=torch.int32, device="meta")
    return paged_launch_spec(q, kc, kc, tables, qpos, block_size=bs,
                             kscale=sc, vscale=sc).with_contracts(
                                 tables=(0, S * NB))


@pytest.mark.parametrize("dh", [160, 256, 320, 512, 576])
def test_paged_launch_spec_chunks_past_256_lint_clean(dh):
    """Past head dim 128 the spec's grid gains the key-parts axis (S, H,
    query groups, P) and the loop runs NB / P blocks, part p taking
    logical blocks p NB / P + i; K and V are read whole, each part writes
    its ceil(dh / P) output columns. Lint-clean under the declared table
    contract."""
    S, H, K, bs, NB = 4, 2, 9, 16, 8
    spec = _meta_spec(dh, S, H, K, bs, NB)
    P = key_parts(dh, H, NB)
    assert P == MAX_KEY_PARTS == 8
    assert spec.grid == (S, H, 2, P)
    assert spec.loop == (NB // P,)
    assert spec.operand("k").block == spec.operand("v").block == (1, 1, bs,
                                                                  dh)
    assert spec.operand("out").block == (1, 1, 8, -(-dh // P))
    tbl = np.arange(S * NB).reshape(S, NB)
    # part p, step i reads logical block p NB / P + i: each block once
    seen = [kernels.concrete(spec, "k", 3, 1, 0, p, i, tables=(tbl, None))[0]
            for p in range(P) for i in range(NB // P)]
    assert seen == list(tbl[3])
    assert kernels.lint(spec) == []


@pytest.mark.parametrize("dh", [320, 512])
def test_paged_hbm_costs_bill_each_kv_row_once_past_256(dh):
    """``kernel_hbm_costs`` bills each K/V row (and its scales) once per
    query group past head dim 256, as the wide kernel reads it: no longer
    once per 256-column chunk."""
    S, H, K, bs, NB = 4, 2, 9, 16, 8
    groups = 2
    rows = S * groups * NB * H * bs
    costs = {c.op: c.bytes_per_tick
             for c in kernels.kernel_hbm_costs([_meta_spec(dh)])}
    assert costs["kernel.kv_stream"] == 2 * rows * dh + 2 * rows * 4


@pytest.mark.parametrize("NB,H,P", [(128, 16, 8), (16, 8, 8), (8, 2, 8),
                                    (6, 2, 2), (12, 2, 4), (5, 2, 1),
                                    (128, 32, 4), (128, 128, 1)])
def test_paged_key_split_covers_each_slot_once(NB, H, P):
    """The wide kernel's split: ``key_parts`` from the head count and the
    table width alone, and ``part_blocks`` cutting each slot's live blocks
    ``[0, n_kb)`` into consecutive parts that cover them once, in order,
    whatever the batch around the slot — position 0 (one live block), a
    trash-routed slot (table entries 0, one live block) and a full table
    included."""
    assert key_parts(256, H, NB) == P
    assert key_parts(128, H, NB) == 1              # the narrow kernel
    bs = 16
    for last in (0, 1, bs - 1, bs, 5 * bs + 3, NB * bs - 1):
        n_kb = min(last // bs + 1, NB)
        cuts = [part_blocks(n_kb, P, p) for p in range(P)]
        assert cuts[0][0] == 0 and cuts[-1][1] == n_kb
        assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
        assert all(0 <= hi - lo <= -(-n_kb // P) for lo, hi in cuts)
    # a slot's cut is its own, alone or among 8 slots at other positions
    lasts = [NB * bs - 1, 0, 0, 37, bs, 5 * bs + 3, 2, NB * bs // 2]

    def cut(last):
        n_kb = min(last // bs + 1, NB)
        return [part_blocks(n_kb, key_parts(256, H, NB), p) for p in range(P)]
    batch = [cut(last) for last in lasts]
    assert batch == [cut(last) for last in lasts[::-1]][::-1]
    assert all(batch[i] == cut(lasts[i]) for i in range(len(lasts)))


# -- a GPT at head dim 256 -------------------------------------------------

GPT256 = dict(vocab=32, seq_len=32, d_model=256, n_heads=1, n_layers=1,
              attn_impl="flash")


def _gpt256():
    """The JAX one-stage build and the port's on its weights."""
    jcfg = jgpt.GPTConfig(**GPT256)
    jst, wd, od = jgpt.make_gpt_stages(jax.random.key(0), jcfg, 1)
    nparams = jax.tree.map(np.asarray, [s.params for s in jst])
    tst, twd, tod = tgpt.make_gpt_stages(0, tgpt.GPTConfig(**GPT256), 1,
                                         device="cpu")
    assert (twd, tod) == (wd, od)
    tst = [dataclasses.replace(s, params=p)
           for s, p in zip(tst, params_from_numpy(nparams, "cpu"))]
    return jst, wd, od, tst


def test_gpt_at_head_dim_256_trains_as_jax():
    """One SGD step of a one-layer GPT whose only head is 256 wide
    (``attn_impl="flash"``): the loss and every parameter after the step
    against the JAX trivial-mesh pipeline's from the same weights and
    batch."""
    jst, wd, od, tst = _gpt256()
    jpipe = JaxPipeline(jst, make_mesh(n_stages=1, n_data=1), wd, od)
    tpipe = Pipeline(tst, None, wd, od, device="cpu")
    rng = np.random.default_rng(256)
    x = rng.integers(0, 32, (2, 32)).astype(np.float32)
    t = rng.integers(0, 32, (2, 32)).astype(np.int32)
    jo = jopt.sgd(0.1)
    buf = jpipe.init_params()
    buf, _, jloss = jstep.make_train_step(jpipe, jo)(
        buf, jo.init(buf), jnp.asarray(x), jnp.asarray(t), jax.random.key(1))
    to = ttrain.sgd(0.1)
    params = tpipe.init_params()
    params, _, tloss = ttrain.make_train_step(tpipe, to)(
        params, to.init(params), torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    ref = jax.tree.leaves(jax.tree.map(np.asarray, jpipe.unpack(buf)))
    got = jax.tree.leaves(params_to_numpy(params))
    assert len(ref) == len(got)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_gpt_at_head_dim_256_decodes_as_jax():
    """``make_decoder``'s greedy tokens (K1 once per layer per token, its
    plain version here) equal JAX ``generate``'s on the same weights."""
    jst, _wd, _od, tst = _gpt256()
    prompt = np.random.default_rng(7).integers(0, 32, (2, 5)).astype(
        np.int32)
    want = np.asarray(jgpt.generate(jst, jnp.asarray(prompt), 8))
    got = tgpt.make_decoder(tst, 5, 8, device="cpu")(
        [s.params for s in tst], torch.from_numpy(prompt))
    np.testing.assert_array_equal(np.asarray(got), want)


# -- PagedKVPool.begin_seq / end_seq ---------------------------------------


class _Req:
    """What the pool's admission reads from a request, duck-typed as the
    JAX package's serving tests drive it."""

    def __init__(self, prompt, max_new):
        self.prompt = np.asarray(prompt, np.int32)
        self.max_new_tokens = max_new
        self.slot = None
        self.prefill_pos = None


def _pool_state(pool) -> dict:
    return dict(tables=[list(map(int, t)) for t in pool.tables],
                ref=[int(r) for r in np.asarray(pool.ref)],
                resv=[int(r) for r in np.asarray(pool._resv)],
                reserved=int(pool._reserved),
                available=int(pool.blocks_available),
                cached=int(pool.blocks_cached),
                free=sorted(int(b) for b in pool._free_blocks),
                prefix_hits=int(pool.prefix_hit_blocks_total))


def _drive(pool_cls) -> list:
    """``tests/test_serve.py``'s pool sequences (the reclaimable-sharing
    regression and the pool invariants) on one pool class: the state and
    every error after each call."""
    log = []

    def call(fn, *args):
        try:
            out = fn(*args)
        except RuntimeError as e:
            out = ("RuntimeError", str(e))
        log.append((fn.__name__, out if not isinstance(out, np.integer)
                    else int(out), _pool_state(pool)))
        return out

    # the pool invariants: bind, the over-admit guard, contiguous writes,
    # registered prefixes, end_seq returning the reservation
    pool = pool_cls(2, 2, 2, 16, 4, block_size=4, n_blocks=6)
    r = _Req(np.arange(9), 8)
    call(pool.can_admit, r)
    r.slot = call(pool.acquire, 0)
    call(pool.bind_seq, r)
    call(pool.begin_seq, r.slot, r.prompt, 2)      # the live-table guard
    call(pool.can_admit, _Req(np.arange(9), 8))
    for p in range(9):
        call(pool.ensure_writable, r.slot, p)
    call(pool.ensure_writable, r.slot, 12)          # not contiguous
    call(pool.register_prefix, r.slot, r.prompt)
    call(pool.end_seq, r.slot)
    call(pool.release, r.slot)
    # the reclaimable-sharing regression: cached blocks revived by a share
    pool = pool_cls(1, 3, 1, 20, 2, block_size=4, n_blocks=6)
    a = _Req(np.arange(5), 4)
    a.slot = call(pool.acquire, 0)
    call(pool.bind_seq, a)
    for p in range(8):
        call(pool.ensure_writable, a.slot, p)
    call(pool.register_prefix, a.slot, a.prompt)
    call(pool.end_seq, a.slot)
    call(pool.release, a.slot)
    c = _Req(np.full(9, 31), 4)
    c.slot = call(pool.acquire, 1)
    call(pool.begin_seq, c.slot, c.prompt, c.max_new_tokens)
    b = _Req(np.concatenate([np.arange(5), np.full(7, 17)]), 5)
    call(pool.can_admit, b)
    b.slot = call(pool.acquire, 2)
    call(pool.begin_seq, b.slot, b.prompt, 40)      # short of blocks
    call(pool.end_seq, c.slot)
    call(pool.release, c.slot)
    call(pool.can_admit, b)
    call(pool.begin_seq, b.slot, b.prompt, b.max_new_tokens)
    # a fresh sequence evicts the cached blocks LRU under pressure
    d = _Req(np.full(13, 3), 6)
    d.slot = call(pool.acquire, 0)
    call(pool.can_admit, d)
    call(pool.end_seq, b.slot)
    call(pool.release, b.slot)
    call(pool.bind_seq, d)
    for p in range(19):
        call(pool.ensure_writable, d.slot, p)
    call(pool.unbind_seq, d.slot)
    return log


def test_pool_begin_and_end_seq_match_jax():
    """The JAX callers' ``begin_seq(slot, prompt, max_new_tokens, ns)`` /
    ``end_seq(slot)`` on the port's ``PagedKVPool``: the same sequence of
    calls, duck-typed requests included, leaves the same block tables,
    reference counts, reservations, cached and free blocks, and raises
    the same errors, as on the JAX pool."""
    want = _drive(JaxPagedKVPool)
    got = _drive(functools.partial(PagedKVPool, device="cpu"))
    assert len(got) == len(want)
    errors = 0
    for (name, w_out, w_state), (_n, g_out, g_state) in zip(want, got):
        assert g_out == w_out, name
        assert g_state == w_state, name
        errors += isinstance(w_out, tuple)
    assert errors == 3
