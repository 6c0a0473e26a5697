"""Sequence parallelism in the port: ring attention
(``<port>/ops/attention.py``) and Ulysses attention
(``<port>/parallel/sequence.py``) against the JAX functions run inside
``shard_map`` on the CPU devices ``conftest.py`` provides, at ``n_seq`` 2
and 4, forward and gradients, from one set of weights and inputs drawn
with numpy; the axis collectives they ride (``<port>/parallel/mesh.py``)
on one process, and the indivisible-heads refusal with JAX's text.

Tolerances: f32 outputs ``rtol 2e-5, atol 2e-5`` (the JAX tests' own);
gradients ``rtol 1e-4, atol 1e-5`` (blockwise softmax in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from simple_distributed_machine_learning_tpu.ops import attention as jatt
from simple_distributed_machine_learning_tpu.parallel import sequence as jseq
from simple_distributed_machine_learning_tpu.parallel.compat import (
    shard_map,
)
from simple_distributed_machine_learning_tpu_torch.ops import attention as tatt
from simple_distributed_machine_learning_tpu_torch.parallel import mesh as tmesh
from simple_distributed_machine_learning_tpu_torch.parallel import (
    sequence as tseq,
)

OUT = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
B, T, D, H = 2, 16, 16, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(D)
    params = {k: rng.uniform(-bound, bound, (D, D)).astype(np.float32)
              for k in ("wq", "wk", "wv", "wo")}
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    return params, x


def _jax_sp(fn, n_seq):
    mesh = Mesh(np.array(jax.devices()[:n_seq]), ("seq",))
    return shard_map(lambda p, xx: fn(p, xx, H, "seq"), mesh=mesh,
                     in_specs=(P(), P(None, "seq", None)),
                     out_specs=P(None, "seq", None))


def _port_sp(fn, n_seq):
    def run(params, x):
        return torch.cat(fn(params, tseq.seq_shards(x, n_seq), H), 1)
    return run


FNS = {"ring": (jatt.ring_attention, tatt.ring_attention),
       "ulysses": (jseq.ulysses_attention, tseq.ulysses_attention)}


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
@pytest.mark.parametrize("n_seq", [2, 4])
def test_sp_attention_equals_jax(attn, n_seq):
    """Forward and the gradients of ``sum(y**2)`` in the params and the
    input, against the JAX function on ``n_seq`` CPU devices and against
    the dense attention of the port."""
    jfn, tfn = FNS[attn]
    params, x = _inputs(n_seq)

    def jloss(p, xx):
        return jnp.sum(_jax_sp(jfn, n_seq)(p, xx) ** 2)

    jp = jax.tree.map(jnp.asarray, params)
    want = np.asarray(jax.jit(_jax_sp(jfn, n_seq))(jp, jnp.asarray(x)))
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    got = _port_sp(tfn, n_seq)(tp, tx)
    np.testing.assert_allclose(got.detach().numpy(), want, **OUT)
    np.testing.assert_allclose(
        got.detach().numpy(),
        tatt.causal_attention(tp, tx, H).detach().numpy(), **OUT)
    grads = torch.autograd.grad((got ** 2).sum(), [tp[k] for k in
                                                   sorted(tp)] + [tx])
    for g, k in zip(grads, sorted(tp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[0][k]), **GRAD)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jg[1]), **GRAD)


def test_block_accumulate_equals_jax():
    """One flash-style block with masked rows and a running max, against
    ``ops/attention.py::_block_accumulate``: a block from the future
    (every score masked) leaves the accumulator as it was."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((1, 2, 4, 8)).astype(np.float32)
               for _ in range(3))
    o0 = rng.standard_normal((1, 2, 4, 8)).astype(np.float32)
    l0 = rng.uniform(0.5, 2.0, (1, 2, 4)).astype(np.float32)
    m0 = rng.standard_normal((1, 2, 4)).astype(np.float32)
    for q_off, k_off in ((4, 0), (4, 4), (0, 4)):
        want = jatt._block_accumulate(
            *(jnp.asarray(a) for a in (q, k, v)),
            tuple(jnp.asarray(a) for a in (o0, l0, m0)), q_off, k_off, 0.3)
        got = tatt._block_accumulate(
            *(torch.tensor(a) for a in (q, k, v)),
            tuple(torch.tensor(a) for a in (o0, l0, m0)), q_off, k_off, 0.3)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **OUT)
    np.testing.assert_array_equal(got[0].numpy(), o0)


def test_ulysses_rejects_indivisible_heads_with_the_jax_text():
    params, x = _inputs(5)
    jp = jax.tree.map(jnp.asarray, params)
    with pytest.raises(ValueError) as je:
        jax.eval_shape(shard_map(
            lambda p, xx: jseq.ulysses_attention(p, xx, 2, "seq"),
            mesh=Mesh(np.array(jax.devices()[:4]), ("seq",)),
            in_specs=(P(), P(None, "seq", None)),
            out_specs=P(None, "seq", None)), jp, jnp.asarray(x))
    tp = {k: torch.tensor(v) for k, v in params.items()}
    with pytest.raises(ValueError) as te:
        tseq.ulysses_attention(tp, tseq.seq_shards(torch.tensor(x), 4), 2)
    assert str(te.value) == str(je.value) == \
        "2 heads not divisible by axis size 4"


def test_local_axis_collectives_are_the_jax_ones():
    """On one process: ``ring_shift`` moves coordinate i's tensor to i + 1
    (``ppermute`` with ``(i, i + 1)``), ``all_to_all`` is the tiled
    ``lax.all_to_all`` and ``all_gather`` the tiled gather."""
    view = tmesh.AxisView.local("seq", 4)
    xs = [torch.full((2, 8), float(i)) for i in range(4)]
    assert [float(t[0, 0]) for t in tmesh.ring_shift(xs, view)] == \
        [3.0, 0.0, 1.0, 2.0]
    a = np.arange(4 * 2 * 8, dtype=np.float32).reshape(4, 2, 8)
    mesh = Mesh(np.array(jax.devices()[:4]), ("seq",))
    want = shard_map(
        lambda v: jax.lax.all_to_all(v[0], "seq", 1, 0, tiled=True)[None],
        mesh=mesh, in_specs=P("seq"), out_specs=P("seq"))(jnp.asarray(a))
    got = tmesh.all_to_all([torch.tensor(r) for r in a], view, 1, 0)
    np.testing.assert_array_equal(torch.stack(got).numpy(),
                                  np.asarray(want))
    np.testing.assert_array_equal(
        tmesh.all_gather([torch.tensor(r) for r in a], view, 0).numpy(),
        a.reshape(8, 8))
    with pytest.raises(ValueError, match="does not split 4 ways"):
        tmesh.all_to_all([torch.zeros(2, 6)] * 4, view, 1, 0)


def test_seq_shards_hold_their_coordinates():
    x = torch.arange(2 * 8).reshape(2, 8)
    view = tmesh.AxisView("seq", 4, range(2, 4), (0, 0, 1, 1), None)
    ch = tseq.seq_shards(x, 4, view)
    assert [c.tolist() for c in ch] == [[[4, 5], [12, 13]],
                                        [[6, 7], [14, 15]]]
    assert ch.map(lambda c: c * 2).view is view
    with pytest.raises(ValueError, match="not divisible by the seq axis"):
        tseq.seq_shards(x, 3)
    with pytest.raises(ValueError, match="chunks for the seq coordinates"):
        tseq.SeqShards([x], view)
