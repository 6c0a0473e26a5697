"""Experts in the port (``<port>/parallel/expert.py``) against the JAX
package's ``parallel/expert.py``, on weights drawn by ``moe_init`` of the
JAX package and tokens drawn with numpy:

- ``_route``: the dispatch tensor exactly equal (top-k ties to the lower
  expert, rank-major capacity priority, overflow dropped), combine and
  aux to tolerance;
- ``moe_apply``; ``moe_apply_ep`` at D = 2 and 4 against the JAX
  function inside ``shard_map`` and against the dense path per shard,
  values and gradients;
- the four pins of ``tests/test_expert_parallel.py``: EP per shard, EP
  gradients, capacity overflow drops tokens, a dense MoE that trains.

Tolerances: f32 values ``rtol 1e-5, atol 1e-5`` (the JAX pins'), gradients
``rtol 1e-4, atol 1e-5``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from simple_distributed_machine_learning_tpu.parallel import expert as jexp
from simple_distributed_machine_learning_tpu.parallel.compat import (
    shard_map,
)
from simple_distributed_machine_learning_tpu_torch.parallel import (
    expert as texp,
)

D_MODEL, D_HIDDEN, N_EXPERTS, T_LOCAL = 16, 32, 8, 12
VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(seed, n_experts=N_EXPERTS):
    return jax.tree.map(np.asarray, jexp.moe_init(
        jax.random.key(seed), D_MODEL, D_HIDDEN, n_experts))


def _t(tree, grad=False):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a),
                                               requires_grad=grad), tree)


def _tokens(seed, n):
    return np.random.default_rng(seed).standard_normal(
        (n, D_MODEL)).astype(np.float32)


def _shard(tree, i, D):
    per = N_EXPERTS // D
    return {"router": tree["router"],
            "experts": jax.tree.map(lambda a: a[i * per:(i + 1) * per],
                                    tree["experts"])}


def _jax_ep(D, k, cap):
    mesh = Mesh(np.array(jax.devices()[:D]), ("expert",))
    espec = jax.tree.map(lambda _: P("expert"),
                         {"in": {"w": 0, "b": 0}, "out": {"w": 0, "b": 0}})
    return jax.jit(shard_map(
        lambda p, xx: jexp.moe_apply_ep(p, xx, k=k, capacity=cap),
        mesh=mesh, in_specs=({"router": P(), "experts": espec},
                             P("expert")),
        out_specs=(P("expert"), P())))


def test_moe_init_has_the_jax_tree():
    got = texp.moe_init(0, D_MODEL, D_HIDDEN, 4)
    want = jexp.moe_init(jax.random.key(0), D_MODEL, D_HIDDEN, 4)
    assert jax.tree.structure(jax.tree.map(np.asarray, got)) == \
        jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert tuple(a.shape) == b.shape
    assert texp.n_experts_of(got) == 4
    assert texp.default_capacity(16, 8, 2, 2.0) == 8
    assert texp.default_capacity(10, 8, 2) == jexp.default_capacity(10, 8, 2)
    assert texp.default_capacity(1, 8, 1) == 1


@pytest.mark.parametrize("k,cap,tie", [(2, 6, False), (1, 2, False),
                                       (2, 3, True), (3, 4, True)])
def test_route_dispatch_is_exactly_jax(k, cap, tie):
    """Ties (a zero router: every gate equal) go to the lower experts;
    tight capacities drop the later choices rank-major."""
    w = _weights(1)
    if tie:
        w = dict(w, router=np.zeros_like(w["router"]))
    x = _tokens(2, T_LOCAL)
    jd, jc, ja = jexp._route(jax.tree.map(jnp.asarray, w), jnp.asarray(x),
                             k, cap)
    td, tc, ta = texp._route(_t(w), torch.tensor(x), k, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **VAL)
    np.testing.assert_allclose(float(ta), float(ja), **VAL)
    assert float(td.sum()) < k * T_LOCAL or cap * N_EXPERTS >= k * T_LOCAL


def test_moe_apply_and_batched_routing_equal_jax():
    """``moe_apply`` on [T, d], and on [B, T, d] (each sequence routes
    alone: the JAX ``vmap``)."""
    w = _weights(3)
    x = np.random.default_rng(4).standard_normal(
        (3, T_LOCAL, D_MODEL)).astype(np.float32)
    jw = jax.tree.map(jnp.asarray, w)
    jy, ja = jax.vmap(lambda t: jexp.moe_apply(jw, t, k=2, capacity=4))(
        jnp.asarray(x))
    ty, ta = texp.moe_apply(_t(w), torch.tensor(x), k=2, capacity=4)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **VAL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **VAL)
    y0, a0 = texp.moe_apply(_t(w), torch.tensor(x[0]))
    jy0, ja0 = jexp.moe_apply(jw, jnp.asarray(x[0]))
    np.testing.assert_allclose(y0.numpy(), np.asarray(jy0), **VAL)
    np.testing.assert_allclose(float(a0), float(ja0), **VAL)


@pytest.mark.parametrize("D", [2, 4])
def test_ep_matches_jax_and_dense_per_shard(D):
    w = _weights(0)
    x = _tokens(1, D * T_LOCAL)
    k, cap = 2, T_LOCAL * 2
    jy, jaux = _jax_ep(D, k, cap)(jax.tree.map(jnp.asarray, w),
                                  jnp.asarray(x))
    ys, aux = texp.moe_apply_ep(
        [_t(_shard(w, i, D)) for i in range(D)],
        [torch.tensor(x[i * T_LOCAL:(i + 1) * T_LOCAL]) for i in range(D)],
        k=k, capacity=cap)
    np.testing.assert_allclose(torch.cat(ys).numpy(), np.asarray(jy), **VAL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    dense = [texp.moe_apply(_t(w), torch.tensor(
        x[i * T_LOCAL:(i + 1) * T_LOCAL]), k=k, capacity=cap)
        for i in range(D)]
    np.testing.assert_allclose(torch.cat(ys).numpy(),
                               torch.cat([y for y, _ in dense]).numpy(),
                               **VAL)
    np.testing.assert_allclose(float(aux),
                               float(np.mean([float(a) for _, a in dense])),
                               rtol=1e-5)


@pytest.mark.parametrize("D", [2, 4])
def test_ep_grads_match_jax(D):
    """``mean(y**2)`` through the two all-to-alls: the router's gradient
    (summed over its per-shard copies), each shard's expert slice and the
    tokens, against the JAX EP gradients."""
    w = _weights(2)
    x = _tokens(3, D * T_LOCAL)
    k, cap = 1, T_LOCAL
    ep = _jax_ep(D, k, cap)

    def jloss(p, xx):
        return jnp.mean(ep(p, xx)[0] ** 2)

    jg = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, w),
                                         jnp.asarray(x))
    shards = [_t(_shard(w, i, D), grad=True) for i in range(D)]
    tx = torch.tensor(x, requires_grad=True)
    ys, _ = texp.moe_apply_ep(
        shards, [tx[i * T_LOCAL:(i + 1) * T_LOCAL] for i in range(D)],
        k=k, capacity=cap)
    (torch.cat(ys) ** 2).mean().backward()
    np.testing.assert_allclose(sum(s["router"].grad for s in shards).numpy(),
                               np.asarray(jg[0]["router"]), **GRAD)
    for lay in ("in", "out"):
        for kk in ("w", "b"):
            got = torch.cat([s["experts"][lay][kk].grad for s in shards])
            np.testing.assert_allclose(
                got.numpy(), np.asarray(jg[0]["experts"][lay][kk]), **GRAD)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]), **GRAD)


def test_capacity_overflow_drops_tokens():
    """Every token forced onto expert 0 with capacity 1: the first token
    wins the slot, the rest come out zero (the residual carries them) —
    as in the JAX package."""
    w = dict(_weights(4), router=np.zeros((D_MODEL, N_EXPERTS), np.float32))
    w["router"][:, 0] = 10.0
    x = np.abs(_tokens(5, 6)) + 0.1
    y, _ = texp.moe_apply(_t(w), torch.tensor(x), k=1, capacity=1)
    norms = np.linalg.norm(y.numpy(), axis=-1)
    assert norms[0] > 0
    np.testing.assert_allclose(norms[1:], 0.0, atol=1e-6)
    jy, _ = jexp.moe_apply(jax.tree.map(jnp.asarray, w), jnp.asarray(x),
                           k=1, capacity=1)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **VAL)


def test_dense_moe_trains():
    """A dense-MoE regression head learns: the loss falls below 0.3 of
    its first value in 100 SGD steps, as the JAX pin's does."""
    gen = torch.Generator().manual_seed(6)
    params = texp.moe_init(gen, D_MODEL, D_HIDDEN, 4)
    for t in jax.tree.leaves(params):
        t.requires_grad_(True)
    w_true = 0.3 * torch.randn((D_MODEL, D_MODEL), generator=gen)
    x = torch.randn((64, D_MODEL), generator=gen)
    y_true = x @ w_true
    leaves = jax.tree.leaves(params)
    losses = []
    for _ in range(101):
        y, aux = texp.moe_apply(params, x, k=2)
        loss = ((x + y - y_true) ** 2).mean() + 0.01 * aux
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p.sub_(0.5 * g)
        losses.append(float(loss.detach()))
    assert losses[-1] < 0.3 * losses[0]


def test_ep_ring_overlap_names_its_item():
    """The ring dispatch runs (``tests/test_torch_overlap.py`` holds it
    against JAX's): at ep 2 its outputs are the all-to-alls'; an unknown
    schedule is the JAX ``check_overlap`` error."""
    w = _weights(0)
    x = [torch.tensor(_tokens(5 + i, T_LOCAL)) for i in range(2)]
    ys = {o: texp.moe_apply_ep([_t(_shard(w, i, 2)) for i in range(2)], x,
                               overlap=o)[0] for o in ("ring", "none")}
    for a, b in zip(ys["ring"], ys["none"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **VAL)
    with pytest.raises(ValueError, match="overlap must be one of"):
        texp.moe_apply_ep([_t(w)], [torch.zeros(4, D_MODEL)],
                          overlap="tree")
