"""The token gather on ids outside the table, against the JAX package's.

The JAX GPT casts its float token wire with ``x.astype(jnp.int32)`` (XLA's
convert: NaN -> 0, saturated to the int32 range, truncated toward zero)
and gathers with ``jnp.take(table, ids, axis=0)``, whose default mode
wraps ids in ``[-V, 0)`` and fills a row of NaN for any id outside
``[-V, V)``, passing no gradient to the table from it. The port's
``token_ids`` and ``embedding_lookup`` compute the same, with no
out-of-range index reaching the gather; ids in ``[0, V)`` give exactly
what a plain ``table[ids]`` gives, values and gradients. Tolerance: equal
(a gather moves values; the gradient sums the same cotangents per row, at
most three here, in f32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu.models import gpt as jgpt
from simple_distributed_machine_learning_tpu.ops import layers as jl
from simple_distributed_machine_learning_tpu_torch.interop import (
    params_from_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.ops import layers as tl

V, D = 6, 3
# NaN, +-1e30, V, -1, -V-1, -V, truncation toward zero, ids in range
WIRE = np.array([1.0, np.nan, 3e30, -1e30, V, -1.0, -V - 1.0, -V, 2.7,
                 -2.7, 0.0, V - 1.0], np.float32)


def _table():
    return np.random.default_rng(0).normal(size=(V, D)).astype(np.float32)


def _jax_lookup(table, wire):
    ids = jnp.asarray(wire).astype(jnp.int32)
    ct = np.random.default_rng(1).normal(size=(len(wire), D)).astype(
        np.float32)
    out, vjp = jax.vjp(lambda t: jl.embedding_lookup(t, ids), table)
    return np.asarray(ids), np.asarray(out), np.asarray(vjp(ct)[0]), ct


def test_token_ids_are_xlas_convert():
    want = np.asarray(jnp.asarray(WIRE).astype(jnp.int32))
    got = tl.token_ids(torch.from_numpy(WIRE))
    assert got.dtype == torch.int64
    assert got.tolist() == want.tolist()
    assert want[:4].tolist() == [1, 0, 2147483647, -2147483648]
    ints = torch.tensor([3, -1], dtype=torch.int32)
    assert tl.token_ids(ints).tolist() == [3, -1]


def test_lookup_equals_jnp_take_forward_and_table_gradient():
    table = _table()
    ids, ref, ref_grad, ct = _jax_lookup(table, WIRE)
    t = torch.from_numpy(table.copy()).requires_grad_(True)
    out = tl.embedding_lookup(t, tl.token_ids(torch.from_numpy(WIRE)))
    np.testing.assert_array_equal(out.detach().numpy(), ref)
    # the rows of NaN: 1e30, -1e30 (saturated), V and -V-1
    assert np.isnan(ref).all(axis=1).tolist() == [
        False, False, True, True, True, False, True, False, False, False,
        False, False]
    out.backward(torch.from_numpy(ct))
    np.testing.assert_array_equal(t.grad.numpy(), ref_grad)
    assert np.isfinite(ref_grad).all()


def test_valid_ids_give_the_plain_gather_bit_for_bit():
    table = torch.from_numpy(_table())
    ids = torch.tensor([[0, 5, 2], [2, 2, 1]])
    ct = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 3, D)).astype(np.float32))
    a = table.clone().requires_grad_(True)
    b = table.clone().requires_grad_(True)
    out = tl.embedding_lookup(a, ids)
    plain = b[ids]
    assert torch.equal(out, plain)
    out.backward(ct)
    plain.backward(ct)
    assert torch.equal(a.grad, b.grad)


def test_gpt_stage_on_a_bad_wire_equals_the_jax_stage():
    """The first GPT stage on float ids with NaN and overflowed entries:
    the same NaN positions as the JAX stage, the finite values within
    1e-5. A NaN row poisons its whole sequence (the attention's masked
    products, 0 x NaN, included) and no other."""
    cfg = dict(vocab=16, seq_len=6, d_model=8, n_heads=2, n_layers=1)
    jst = jgpt.make_gpt_stages(jax.random.key(0), jgpt.GPTConfig(**cfg),
                               1)[0]
    nparams = jax.tree.map(np.asarray, [s.params for s in jst])
    tst = tgpt.make_gpt_stages(0, tgpt.GPTConfig(**cfg), 1, device="cpu")[0]
    tst = [dataclasses.replace(tst[0],
                               params=params_from_numpy(nparams, "cpu")[0])]
    x = np.array([[1, 2, 3, 4, 5, 6], [1, np.nan, 3, 4, 5, 6],
                  [1, 2, 1e30, 4, 5, 6], [1, 2, 3, 4, 16, -17]],
                 np.float32)
    ref = np.asarray(jst[0].apply(jst[0].params, jnp.asarray(x),
                                  jax.random.key(1), True))
    got = tst[0].apply(tst[0].params, torch.from_numpy(x), None,
                       True).detach().numpy()
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(ref[2:]).all()
    assert not np.isnan(ref[:2]).any()        # NaN id -> id 0
    fin = ~np.isnan(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lookup_keeps_the_table_dtype(dtype):
    table = torch.from_numpy(_table()).to(dtype)
    out = tl.embedding_lookup(table, torch.tensor([0, V, -1]))
    assert out.dtype == dtype
    assert torch.isnan(out[1]).all() and torch.equal(out[2], table[V - 1])
