"""The overlapped collectives (``parallel/overlap.py``) against the JAX
package's and against the dense math, on the CPU.

- Each ring primitive at mp 2 and 4, forward and gradient, against the
  JAX primitive inside ``shard_map`` from the same numpy inputs (the green
  pins of ``tests/test_overlap.py``): the data movers and ``ring_psum``
  bit for bit (the port sums in the JAX ring order), the collective
  matmuls at ``rtol 1e-6``; every coordinate's replica of a replicated
  result the same bits; ``ring_psum``'s plain-sum fallback.
- ``moe_apply_ep(overlap="ring")`` against the JAX ring dispatch at ep 2
  and 4 (its green pin ``test_moe_ep_ring_matches_all_to_all``).
- ``tp_pair_apply``, ``make_mlp_tp_stages``, the GPT's TP blocks (the
  scattered MLP pair, and its chunked-psum fallback) and its EP blocks
  with ``"ring"`` against the port's ``"none"`` and the dense run: the JAX
  ring pins of the pair and the GPT are red on this tree (JAX 0.9's
  varying-manual-axes check), so the port is held to its own ``"none"``
  path and the dense model, within PR 16's TP tolerances.
- Two gloo processes: the primitives across processes equal one
  process's, every replica bit for bit; ``grad_sync(..., "ring")`` sums
  over processes; the CLI's ``--tp 2 --overlap ring`` over two ranks
  prints the one-process console.

Tolerances: f32 values ``rtol 1e-6`` where the math is one matmul chunked
the same way, ``rtol 1e-5, atol 1e-6`` for a model's losses.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from simple_distributed_machine_learning_tpu.parallel import expert as jexp
from simple_distributed_machine_learning_tpu.parallel import overlap as jov
from simple_distributed_machine_learning_tpu.parallel.compat import (
    shard_map,
)
from simple_distributed_machine_learning_tpu_torch import train as ttrain
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.parallel import (
    Pipeline,
    make_mesh,
)
from simple_distributed_machine_learning_tpu_torch.parallel import (
    expert as texp,
)
from simple_distributed_machine_learning_tpu_torch.parallel import (
    overlap as tov,
)
from simple_distributed_machine_learning_tpu_torch.parallel import (
    tensor as ttensor,
)
from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (
    AxisView,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIGHT = dict(rtol=1e-6, atol=1e-6)
F32 = dict(rtol=1e-5, atol=1e-6)
SMALL = dict(vocab=32, seq_len=8, d_model=32, n_heads=4, n_layers=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(mp, axis="model"):
    return Mesh(np.array(jax.devices()[:mp]), (axis,))


def _smap(fn, mp, in_specs, out_specs):
    return jax.jit(shard_map(fn, mesh=_mesh(mp), in_specs=in_specs,
                             out_specs=out_specs, check_vma=False))


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _leaves(xs):
    return [torch.tensor(x, requires_grad=True) for x in xs]


# ---- the primitives against JAX ----------------------------------------------

@pytest.mark.parametrize("mp", [2, 4])
def test_ring_all_gather_equals_jax_fwd_and_grad(mp):
    """Forward bits; the gradient of a replicated gather is each
    coordinate's rows of the cotangent (JAX: its reduce-scatter of the
    split cotangents)."""
    rng = _rng(mp)
    x, g = _f32(rng, 2 * mp, 3), _f32(rng, 2 * mp, 3)
    jy = _smap(lambda s: jov.ring_all_gather(s, "model"), mp, P("model"),
               P(None))(x)
    jg = jax.grad(lambda v: jnp.sum(shard_map(
        lambda s: jov.ring_all_gather(s, "model"), mesh=_mesh(mp),
        in_specs=P("model"), out_specs=P(None), check_vma=False)(v) * g))(x)
    xs = _leaves(np.split(x, mp))
    ys = tov.ring_all_gather(xs, AxisView.local("model", mp))
    assert len(ys) == mp
    for y in ys:
        np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
    (ys[0] * torch.tensor(g)).sum().backward()
    np.testing.assert_array_equal(torch.cat([t.grad for t in xs]).numpy(),
                                  np.asarray(jg))


@pytest.mark.parametrize("mp", [2, 4])
def test_ring_reduce_scatter_equals_jax_fwd_and_grad(mp):
    """Coordinate ``c``'s chunk of the sum, in the JAX ring order (bits);
    the gradient is the all-gather of the chunks' cotangents."""
    rng = _rng(10 + mp)
    x, g = _f32(rng, mp, 2 * mp, 5), _f32(rng, 2 * mp, 5)

    def jloss(v):
        y = shard_map(lambda s: jov.ring_reduce_scatter(s[0], "model"),
                      mesh=_mesh(mp), in_specs=P("model"),
                      out_specs=P("model"), check_vma=False)(v)
        return jnp.sum(y * g), y

    (_, jy), jg = jax.value_and_grad(jloss, has_aux=True)(x)
    xs = _leaves(list(x))
    ys = tov.ring_reduce_scatter(xs, AxisView.local("model", mp))
    np.testing.assert_array_equal(torch.cat(ys).detach().numpy(),
                                  np.asarray(jy))
    np.testing.assert_allclose(torch.cat(ys).detach().numpy(), x.sum(0),
                               **TIGHT)
    (torch.cat(ys) * torch.tensor(g)).sum().backward()
    np.testing.assert_array_equal(np.stack([t.grad for t in xs]),
                                  np.asarray(jg))


@pytest.mark.parametrize("mp", [2, 4])
def test_ring_psum_equals_jax_fwd_and_grad(mp):
    """The JAX pin ``test_ring_psum_matches_psum_fwd_and_grad``'s loss:
    every replica the JAX ring's bits, the loss and the gradient equal to
    the JAX ring's and to the dense math (the port's identity backward
    against JAX's psum of the split cotangents)."""
    rng = _rng(20 + mp)
    x = _f32(rng, 6, 8)
    # the partials made on the host: XLA would fuse a multiply into the
    # ring's first add
    parts = np.stack([x * (i + 1.0) for i in range(mp)])
    jtot = _smap(lambda v: jov.ring_psum(v[0], "model")[None], mp,
                 P("model"), P("model"))(parts)

    def jloss(v):
        return shard_map(lambda u: jnp.sum(jov.ring_psum(
            u * (lax.axis_index("model") + 1.0), "model") ** 2),
            mesh=_mesh(mp), in_specs=P(None), out_specs=P(),
            check_vma=False)(v)

    jl, jg = jax.value_and_grad(jloss)(x)
    xt = torch.tensor(x, requires_grad=True)
    tots = tov.ring_psum([xt * (i + 1.0) for i in range(mp)],
                         AxisView.local("model", mp))
    for t, j in zip(tots, np.asarray(jtot)):
        np.testing.assert_array_equal(t.detach().numpy(), j)
    for t in tots:
        np.testing.assert_array_equal(
            t.detach().numpy(), tov.ring_psum(
                [torch.tensor(p) for p in parts],
                AxisView.local("model", mp))[0].numpy())
    loss = (tots[0] ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), **TIGHT)
    s = mp * (mp + 1) / 2
    np.testing.assert_allclose(xt.grad.numpy(), 2 * s * s * x, rtol=1e-5)


@pytest.mark.parametrize("mp", [2, 4])
def test_ring_psum_indivisible_last_axis_falls_back(mp):
    """A last axis that does not divide by the ring takes the plain sum,
    as the JAX ``ring_psum`` does."""
    x = _f32(_rng(30), 4, 5)
    jy = _smap(lambda v: jov.ring_psum(v, "model"), mp, P(None),
               P(None, None))(x)
    ys = tov.ring_psum([torch.tensor(x)] * mp, AxisView.local("model", mp))
    np.testing.assert_allclose(ys[0].numpy(), np.asarray(jy), **TIGHT)
    np.testing.assert_allclose(ys[0].numpy(), x * mp, **TIGHT)


@pytest.mark.parametrize("mp", [2, 4])
def test_allgather_matmul_equals_jax_and_dense(mp):
    """The column-parallel collective matmul: values and both gradients
    against the JAX primitive and against ``X @ W``."""
    rng = _rng(40 + mp)
    N, d, k = 2 * mp, 12, 2 * mp
    X, W, G = _f32(rng, N, d), _f32(rng, d, k), _f32(rng, N, k)
    specs = (P("model"), P(None, "model"))

    def jloss(xx, ww):
        y = shard_map(lambda xs, ws: jov.allgather_matmul(xs, ws, "model"),
                      mesh=_mesh(mp), in_specs=specs,
                      out_specs=P(None, "model"), check_vma=False)(xx, ww)
        return jnp.sum(y * G), y

    (_, jy), (jgx, jgw) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(X, W)
    xs = _leaves(np.split(X, mp))
    ws = _leaves(np.split(W, mp, axis=1))
    ys = tov.allgather_matmul(xs, ws, AxisView.local("model", mp))
    y = torch.cat(ys, 1)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TIGHT)
    np.testing.assert_allclose(y.detach().numpy(), X @ W, rtol=1e-5,
                               atol=1e-5)
    (y * torch.tensor(G)).sum().backward()
    gx = torch.cat([t.grad for t in xs]).numpy()
    gw = torch.cat([t.grad for t in ws], 1).numpy()
    np.testing.assert_allclose(gx, np.asarray(jgx), **TIGHT)
    np.testing.assert_allclose(gw, np.asarray(jgw), **TIGHT)
    np.testing.assert_allclose(gx, G @ W.T, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gw, X.T @ G, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mp", [2, 4])
def test_matmul_reducescatter_equals_jax_and_dense(mp):
    """The row-parallel collective matmul: ring-accumulated partial
    products against the JAX primitive and against ``X @ W``'s rows."""
    rng = _rng(50 + mp)
    N, k = 2 * mp, 8
    X, W, G = _f32(rng, N, 4 * mp), _f32(rng, 4 * mp, k), _f32(rng, N, k)
    specs = (P(None, "model"), P("model"))

    def jloss(xx, ww):
        y = shard_map(lambda xs, ws: jov.matmul_reducescatter(xs, ws,
                                                              "model"),
                      mesh=_mesh(mp), in_specs=specs, out_specs=P("model"),
                      check_vma=False)(xx, ww)
        return jnp.sum(y * G), y

    (_, jy), (jgx, jgw) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(X, W)
    xs = _leaves(np.split(X, mp, axis=1))
    ws = _leaves(np.split(W, mp))
    ys = tov.matmul_reducescatter(xs, ws, AxisView.local("model", mp))
    y = torch.cat(ys)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TIGHT)
    np.testing.assert_allclose(y.detach().numpy(), X @ W, rtol=1e-5,
                               atol=1e-5)
    (y * torch.tensor(G)).sum().backward()
    gx = torch.cat([t.grad for t in xs], 1).numpy()
    gw = torch.cat([t.grad for t in ws]).numpy()
    np.testing.assert_allclose(gx, np.asarray(jgx), **TIGHT)
    np.testing.assert_allclose(gw, np.asarray(jgw), **TIGHT)
    np.testing.assert_allclose(gx, G @ W.T, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gw, X.T @ G, rtol=1e-5, atol=1e-5)


def test_one_wide_axis_is_the_local_math():
    view = AxisView.local("model", 1)
    x, w = torch.randn(4, 3), torch.randn(3, 2)
    assert tov.ring_psum([x], view)[0] is x
    assert tov.ring_all_gather([x], view)[0] is x
    assert torch.equal(tov.allgather_matmul([x], [w], view)[0], x @ w)
    assert torch.equal(tov.matmul_reducescatter([x], [w], view)[0], x @ w)
    with pytest.raises(ValueError, match="tensors for the owned"):
        tov.ring_psum([x, x], view)


def test_overlap_validation_is_the_jax_text():
    with pytest.raises(ValueError) as j:
        jov.check_overlap("diagonal")
    with pytest.raises(ValueError) as t:
        tov.check_overlap("diagonal")
    assert str(t.value) == str(j.value)
    with pytest.raises(ValueError, match="overlap"):
        tgpt.GPTConfig(overlap="diagonal")
    with pytest.raises(ValueError, match="overlap"):
        ttensor.grad_sync(torch.zeros(2), None, "diagonal")
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        pipeline,
    )
    assert pipeline.check_overlap is tov.check_overlap


# ---- the EP ring dispatch against JAX -----------------------------------------

E, D_MODEL, D_HID, T_LOCAL = 4, 8, 16, 12


def _jax_ep_loss(D, overlap):
    mesh = _mesh(D, "expert")

    def loss(stk, xs):
        def body(p, xv):
            p = jax.tree.map(lambda leaf: leaf[0], p)
            y, aux = jexp.moe_apply_ep(p, xv, k=2, capacity=6,
                                       overlap=overlap)
            return lax.psum(jnp.sum(y ** 2), "expert") + aux, y
        return shard_map(body, mesh=mesh,
                         in_specs=(P("expert"), P("expert")),
                         out_specs=(P(), P("expert")),
                         check_vma=False)(stk, xs)
    return loss


@pytest.mark.parametrize("D", [2, 4])
def test_moe_ep_ring_equals_jax_and_all_to_all(D):
    """The offset-hop dispatch: outputs, loss and every gradient against
    the JAX ring dispatch from the same weights, and against the port's
    two all-to-alls."""
    params = jax.tree.map(np.asarray, jexp.moe_init(jax.random.key(0),
                                                    D_MODEL, D_HID, E))
    x = _f32(_rng(60 + D), D * T_LOCAL, D_MODEL)
    per = E // D
    shards = [{"router": params["router"],
               "experts": jax.tree.map(lambda a, m=m: a[m * per:(m + 1)
                                                       * per],
                                       params["experts"])}
              for m in range(D)]
    stacked = jax.tree.map(lambda *ls: jnp.stack(ls), *shards)
    (jl, jy), jg = jax.value_and_grad(_jax_ep_loss(D, "ring"),
                                      has_aux=True)(stacked, jnp.asarray(x))
    got = {}
    for overlap in ("ring", "none"):
        tsh = [jax.tree.map(lambda a: torch.tensor(np.asarray(a),
                                                   requires_grad=True), s)
               for s in shards]
        ys, aux = texp.moe_apply_ep(
            tsh, [torch.tensor(x[i * T_LOCAL:(i + 1) * T_LOCAL])
                  for i in range(D)], k=2, capacity=6, overlap=overlap)
        loss = sum((y ** 2).sum() for y in ys) + aux
        loss.backward()
        got[overlap] = (loss.item(), torch.cat(ys).detach().numpy(), tsh)
    loss, y, tsh = got["ring"]
    np.testing.assert_allclose(loss, float(jl), rtol=1e-6)
    np.testing.assert_allclose(y, np.asarray(jy), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["none"][1], y, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["none"][0], loss, rtol=1e-6)
    # the JAX router gradient is per device (split 1/D); the port's tie
    # of the per-shard copies sums to the whole
    jrouter = np.asarray(jg["router"]).sum(0)
    for name, shards_ in (("ring", tsh), ("none", got["none"][2])):
        np.testing.assert_allclose(
            sum(s["router"].grad for s in shards_).numpy(), jrouter,
            rtol=1e-4, atol=1e-5, err_msg=name)
        for lay in ("in", "out"):
            for kk in ("w", "b"):
                np.testing.assert_allclose(
                    np.stack([s["experts"][lay][kk].grad.numpy()
                              for s in shards_]),
                    np.asarray(jg["experts"][lay][kk]), rtol=1e-4,
                    atol=1e-5, err_msg=name)


# ---- the TP pair and the MLP pipeline -------------------------------------------

def _pair_shards(mp, d_in=8, d_h=16, d_out=6):
    return [jax.tree.map(lambda t: t.requires_grad_(True), sh) for sh in
            ttensor.tp_pair_init(0, d_in, d_h, d_out, mp)]


@pytest.mark.parametrize("mp", [2, 4])
def test_tp_pair_ring_matches_none_and_dense(mp):
    """The JAX pin ``test_tp_pair_ring_matches_none_and_dense`` (red on
    this tree) on the port: ``'ring'`` equals ``'none'`` and the dense
    pair, values and every gradient."""
    x = torch.tensor(_f32(_rng(70), 4, 8))
    out = {}
    for overlap in ("ring", "none"):
        sh = _pair_shards(mp)
        y = ttensor.tp_pair_apply(sh, x, overlap=overlap)
        (y ** 2).sum().backward()
        out[overlap] = (y.detach(), sh)
    w1 = torch.cat([s["w1"]["w"] for s in out["none"][1]], 1)
    b1 = torch.cat([s["w1"]["b"] for s in out["none"][1]])
    w2 = torch.cat([s["w2"]["w"] for s in out["none"][1]])
    dense = torch.relu(x @ w1 + b1) @ w2 + out["none"][1][0]["w2"]["b"]
    np.testing.assert_allclose(out["ring"][0].numpy(), dense.detach().numpy(),
                               **F32)
    np.testing.assert_allclose(out["ring"][0].numpy(),
                               out["none"][0].numpy(), **F32)
    for a, b in zip(out["ring"][1], out["none"][1]):
        for la, lb in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_allclose(la.grad.numpy(), lb.grad.numpy(),
                                       **F32)


@pytest.mark.parametrize("mp", [2, 4])
def test_mlp_tp_stages_ring_trajectory_matches_none(mp):
    """``make_mlp_tp_stages(..., overlap='ring')`` through a 2-stage
    pipeline on a model mesh, with ``Pipeline(overlap='ring')``: 3 SGD
    steps equal the ``'none'`` run's."""
    dims = [8, 16, 12, 16, 10]
    x = torch.tensor(_f32(_rng(80), 8, 8))
    y = torch.tensor(_rng(81).integers(0, 10, 8))
    losses = {}
    for overlap in ("ring", "none"):
        st, wd, od = ttensor.make_mlp_tp_stages(0, dims, 2, mp,
                                                overlap=overlap,
                                                device="cpu")
        pipe = Pipeline(st, make_mesh(2, n_model=mp,
                                      devices=["cpu"] * (2 * mp)), wd, od,
                        n_microbatches=2, overlap=overlap)
        losses[overlap] = _train(pipe, 3, x, y)
    np.testing.assert_allclose(losses["ring"], losses["none"], **F32)
    assert losses["ring"][-1] < losses["ring"][0]


def _train(pipe, n, x, y, opt=None):
    opt = opt or ttrain.sgd(0.1, momentum=0.5)
    params = pipe.init_params()
    state, step = opt.init(params), ttrain.make_train_step(pipe, opt)
    out = []
    for i in range(n):
        params, state, loss = step(params, state, x, y, 10 + i)
        out.append(float(loss))
    return out


def test_pipeline_ring_knob_trains_replicated_stages_bit_for_bit():
    """A stage stored replicated over the model axis: the engine's ring
    knob has no sum to chunk under the port's accounting, so the run is
    the ``'none'`` run bit for bit."""
    from simple_distributed_machine_learning_tpu_torch.models import mlp
    x = torch.tensor(_f32(_rng(82), 8, 8))
    y = torch.tensor(_rng(83).integers(0, 4, 8))
    runs = []
    for overlap in ("ring", "none"):
        st, wd, od = mlp.make_mlp_stages(0, [8, 12, 4], 1, device="cpu")
        pipe = Pipeline(st, make_mesh(1, n_model=2, devices=["cpu"] * 2),
                        wd, od, n_microbatches=2, overlap=overlap)
        assert pipe.overlap == overlap
        runs.append(_train(pipe, 3, x, y))
    assert runs[0] == runs[1]


# ---- the GPT's TP and EP blocks ---------------------------------------------------

def _gpt_losses(cfg_kw, n=3, S=2, batch=8, M=2, mesh_kw=None):
    cfg = tgpt.GPTConfig(**cfg_kw)
    st, wd, od = tgpt.make_gpt_stages(0, cfg, S, device="cpu")
    mesh_kw = dict(mesh_kw or {})
    width = S * int(np.prod(list(mesh_kw.values()) or [1]))
    pipe = Pipeline(st, make_mesh(S, devices=["cpu"] * width, **mesh_kw),
                    wd, od, n_microbatches=M, overlap=cfg.overlap)
    rng = _rng(90)
    x = torch.tensor(rng.integers(0, cfg.vocab, (batch, cfg.seq_len))
                     .astype(np.float32))
    y = torch.tensor(rng.integers(0, cfg.vocab, (batch, cfg.seq_len)))
    opt = ttrain.clip_by_global_norm(ttrain.sgd(0.1, momentum=0.5), 0.5)
    return _train(pipe, n, x, y, opt)


@pytest.mark.parametrize("mp,kw", [
    (2, {}), (4, {}),
    # 6 tokens of one sequence per microbatch: not divisible by 4, the
    # ring-closed pair instead of the scattered one
    (4, dict(seq_len=6, batch=2)),
    (2, dict(dropout_rate=0.2)),
])
def test_gpt_tp_ring_matches_none_and_dense(mp, kw):
    """The JAX pins ``test_gpt_tp_ring_trajectory_matches_none`` and
    ``test_gpt_tp_matches_dense_pipeline`` (red on this tree) on the
    port: 3 clipped SGD steps of the TP GPT with ``'ring'`` equal the
    ``'none'`` run's and the dense run's."""
    kw = dict(kw)
    batch = kw.pop("batch", 8)
    cfg_kw = {**SMALL, **kw}
    ring = _gpt_losses({**cfg_kw, "n_tensor_parallel": mp,
                        "overlap": "ring"}, batch=batch,
                       mesh_kw=dict(n_model=mp))
    none = _gpt_losses({**cfg_kw, "n_tensor_parallel": mp}, batch=batch,
                       mesh_kw=dict(n_model=mp))
    dense = _gpt_losses(cfg_kw, batch=batch)
    np.testing.assert_allclose(ring, none, **F32)
    np.testing.assert_allclose(ring, dense, **F32)


@pytest.mark.parametrize("D", [2, 4])
def test_gpt_ep_ring_matches_all_to_all(D):
    """The MoE GPT at ep ``D`` with the ring dispatch equals the
    all-to-all run and the one-coordinate (ep 1) run."""
    cfg_kw = dict(SMALL, n_experts=4, moe_top_k=2)
    ring = _gpt_losses({**cfg_kw, "n_expert_parallel": D,
                        "overlap": "ring"}, mesh_kw=dict(n_expert=D))
    none = _gpt_losses({**cfg_kw, "n_expert_parallel": D},
                       mesh_kw=dict(n_expert=D))
    one = _gpt_losses(cfg_kw)
    np.testing.assert_allclose(ring, none, **F32)
    np.testing.assert_allclose(ring, one, rtol=1e-4, atol=1e-6)


def test_gpt_tp_ring_replicas_hold_the_same_bits():
    """After ring steps every model shard's copy of a replicated leaf is
    the same bits."""
    cfg = tgpt.GPTConfig(**SMALL, n_tensor_parallel=4, overlap="ring")
    st, wd, od = tgpt.make_gpt_stages(0, cfg, 1, device="cpu")
    pipe = Pipeline(st, make_mesh(1, n_model=4, devices=["cpu"] * 4), wd,
                    od, n_microbatches=2, overlap="ring")
    rng = _rng(91)
    x = torch.tensor(rng.integers(0, 32, (8, 8)).astype(np.float32))
    y = torch.tensor(rng.integers(0, 32, (8, 8)))
    opt = ttrain.adamw(1e-2)
    params = pipe.init_params()
    state, step = opt.init(params), ttrain.make_train_step(pipe, opt)
    for i in range(3):
        params, state, _ = step(params, state, x, y, i)
    shards = params[0]
    for name in ("ln1.scale", "ln2.bias", "mlp_out.b"):
        first = shards[0]["blocks"][1].state_dict()[name]
        for sh in shards[1:]:
            assert torch.equal(sh["blocks"][1].state_dict()[name], first)
    assert torch.equal(shards[3]["head"]["out"]["w"],
                       shards[0]["head"]["out"]["w"])


# ---- two gloo processes -----------------------------------------------------------

_WORKER = r"""
import json, sys
import numpy as np
import torch
from simple_distributed_machine_learning_tpu_torch.parallel import (
    bootstrap_distributed, make_mesh, overlap as ov, tensor as tt)
from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (
    AxisView)
rank, world, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
torch.set_num_threads(1)
bootstrap_distributed(rank, world, "localhost", port)


def lists(ts):
    return [t.detach().numpy().tolist() for t in ts]


out = {}
for mp in (2, 4):
    view = (make_mesh(1, n_model=mp, devices=["cpu"] * mp).view(0, 0, "model")
            if world > 1 else AxisView.local("model", mp))
    own = list(view.owned)
    rng = np.random.default_rng(mp)
    P = rng.standard_normal((mp, 2 * mp, 4 * mp)).astype(np.float32)
    X = rng.standard_normal((2 * mp, 4 * mp)).astype(np.float32)
    W = rng.standard_normal((4 * mp, 2 * mp)).astype(np.float32)
    G = rng.standard_normal((2 * mp, 2 * mp)).astype(np.float32)
    n = 2
    r = {}
    # ring_psum: the replicated sum, the full cotangent on every process
    xs = [torch.tensor(P[c], requires_grad=True) for c in own]
    ys = ov.ring_psum(xs, view)
    (ys[0] * torch.tensor(G[:, :1])).sum().backward()
    r["psum"] = (lists(ys[:1]), lists([x.grad for x in xs]))
    # reduce-scatter: each coordinate's own chunk and cotangent
    xs = [torch.tensor(P[c], requires_grad=True) for c in own]
    ys = ov.ring_reduce_scatter(xs, view)
    sum((y * torch.tensor(G[c * n:(c + 1) * n, :1])).sum()
        for y, c in zip(ys, own)).backward()
    r["rs"] = (lists(ys), lists([x.grad for x in xs]))
    # all-gather of row shards, replicated
    xs = [torch.tensor(X[c * n:(c + 1) * n], requires_grad=True) for c in own]
    ys = ov.ring_all_gather(xs, view)
    (ys[0] * torch.tensor(X)).sum().backward()
    r["ag"] = (lists(ys[:1]), lists([x.grad for x in xs]))
    # the collective matmuls
    xs = [torch.tensor(X[c * n:(c + 1) * n], requires_grad=True) for c in own]
    ws = [torch.tensor(W[:, c * 2:(c + 1) * 2], requires_grad=True)
          for c in own]
    ys = ov.allgather_matmul(xs, ws, view)
    sum((y * torch.tensor(G[:, c * 2:(c + 1) * 2])).sum()
        for y, c in zip(ys, own)).backward()
    r["agmm"] = (lists(ys), lists([x.grad for x in xs] +
                                  [w.grad for w in ws]))
    xs = [torch.tensor(X[:, c * 4:(c + 1) * 4], requires_grad=True)
          for c in own]
    ws = [torch.tensor(W[c * 4:(c + 1) * 4], requires_grad=True) for c in own]
    ys = ov.matmul_reducescatter(xs, ws, view)
    sum((y * torch.tensor(G[c * n:(c + 1) * n])).sum()
        for y, c in zip(ys, own)).backward()
    r["mmrs"] = (lists(ys), lists([x.grad for x in xs] +
                                  [w.grad for w in ws]))
    # grad_sync's ring: each process's own coordinates' contributions
    a = torch.tensor(X, requires_grad=True)
    s = tt.grad_sync(a, view.group, "ring", view)
    sum(((s * (c + 1.0)) ** 2).sum() for c in own).backward()
    r["grad_sync"] = (lists([a.grad]), [])
    out[mp] = {"owned": own, "r": r}
print(json.dumps(out))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")


def _run_workers(script, world, *extra):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(world), str(port),
         *extra], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=ENV, cwd=REPO) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_two_gloo_processes_run_the_rings_of_one():
    """The model axis at mp 2 (one coordinate per process) and mp 4 (two
    each) over two gloo processes: each coordinate's outputs are the
    one-process run's bits (the ring order does not depend on where the
    coordinates live), its gradients equal them, and both processes hold
    the same bits of every replicated result; ``grad_sync``'s ring sums
    the processes' cotangents."""
    one = _run_workers(_WORKER, 1)[0]
    two = _run_workers(_WORKER, 2)
    for mp in ("2", "4"):
        ref = one[mp]["r"]
        for rank in two:
            part = rank[mp]
            own = part["owned"]
            for name, (ys, gs) in part["r"].items():
                rys, rgs = ref[name]
                if name == "grad_sync":             # the summed gradient
                    np.testing.assert_allclose(ys, rys, **TIGHT)
                    continue
                if name in ("psum", "ag"):          # replicated
                    assert ys == rys, (mp, name)
                else:
                    assert ys == [rys[c] for c in own], (mp, name)
                want = [rgs[c] for c in own]
                if name in ("agmm", "mmrs"):        # then the weights'
                    want += [rgs[len(rgs) // 2 + c] for c in own]
                assert len(gs) == len(want)
                for g, w in zip(gs, want):
                    np.testing.assert_allclose(g, w, **TIGHT)
        assert two[0][mp]["r"]["psum"][0] == two[1][mp]["r"]["psum"][0]
        assert two[0][mp]["r"]["grad_sync"][0] == \
            two[1][mp]["r"]["grad_sync"][0]


CLI = [sys.executable, "-m",
       "simple_distributed_machine_learning_tpu_torch.cli", "--device", "cpu",
       "--data-root", "/nonexistent"]


def _console(out: str) -> list[str]:
    return [ln for ln in out.splitlines()
            if not ln.startswith(("| distributed:", "| epoch ",
                                  "| pipeline:"))]


def test_cli_tp_ring_over_two_processes_equals_one():
    """``--model gpt --tp 2 --overlap ring`` with the model axis split over
    two gloo ranks prints the one-process ring run's console, which is
    the ``--overlap none`` run's; rank 1 prints nothing."""
    args = ["--model", "gpt", "--dryrun", "3", "--stages", "1", "--tp", "2",
            "--overlap", "ring"]
    port, hb = _free_port(), _free_port()
    procs = [subprocess.Popen(
        CLI + ["--rank", str(r), "--world_size", "2", "--master_addr",
               "localhost", "--master_port", str(port), "--heartbeat-port",
               str(hb)] + args, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=ENV, cwd=REPO)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-2000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    singles = []
    for overlap in ("ring", "none"):
        a = [x if x != "ring" else overlap for x in args]
        one = subprocess.run(CLI + ["--rank", "0"] + a, capture_output=True,
                             text=True, env=ENV, cwd=REPO, timeout=180)
        assert one.returncode == 0, one.stderr[-2000:]
        singles.append(_console(one.stdout))
    assert _console(outs[0]) == singles[0] == singles[1]
    assert any(ln.startswith("Test set:") for ln in singles[0])
    assert outs[1].strip() == ""

