"""The port's flash attention (K1 forward, K2 dq, K3 dk/dv) against the JAX
package's Pallas kernels, and the CUDA kernels against their plain versions.

On the CPU the port's wrappers compute the plain versions
(``flash_forward_reference``, ``flash_backward_reference``); the JAX side
runs its real kernel code in Pallas interpret mode. Inputs are made with
numpy from a seed and handed to both. Tolerances:

- f32 forward ``(o, l, m)`` within rtol = atol = 1e-5: both sum in f32, in
  another order (the JAX kernel by blocks, the plain version by rows);
- f32 gradients within 1e-4, the JAX package's own gradient tolerance
  (``tests/test_flash_attention.py``);
- bf16 inputs within ``tolerances.attn_tol(bfloat16)``: the two frameworks
  round bf16 products' operands at the same places but sum in another
  order, and the JAX kernel rounds p against its running max.

The CUDA kernels against their plain versions on the card are in
``tests/test_torch_flash_attention_cuda.py``, which needs no JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu.ops import attention as jattn
from simple_distributed_machine_learning_tpu.ops import flash_attention as jfa
from simple_distributed_machine_learning_tpu_torch.ops import attention as tattn
from simple_distributed_machine_learning_tpu_torch.ops import (
    flash_attention as tfa,
)
from tolerances import attn_tol

F32_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _qkv(seed, shape, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("t,dh,bq,bk", [
    (64, 32, 16, 16),     # blocks divide T
    (48, 32, 16, 16),     # T not a multiple of the block: the ragged tail
    (64, 32, 64, 64),     # single block
    (64, 32, 16, 32),     # block_q < block_k: diagonal crosses mid k-block
    (64, 32, 32, 16),     # block_q > block_k: several k blocks per q block
])
def test_plain_forward_matches_jax_kernel(t, dh, bq, bk):
    q, k, v = _qkv(t + dh + bq + bk, (2, 3, t, dh))
    jo, jl, jm = jfa._flash_fwd_call(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), bq, bk)
    o, l, m = tfa.flash_forward(*_t(q, k, v))
    for got, ref in ((o, jo), (l, jl), (m, jm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


def _jax_grads(q, k, v, w, bq, bk, dtype=jnp.float32):
    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, bq, bk)
        return jnp.sum(o.astype(jnp.float32) * w)
    return jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a).astype(dtype) for a in (q, k, v)))


def _port_grads(q, k, v, w, bq, bk, dtype=torch.float32):
    q, k, v = (a.requires_grad_() for a in _t(q, k, v, dtype=dtype))
    o = tfa.flash_attention(q, k, v, bq, bk, device="cpu")
    (o.float() * torch.from_numpy(w)).sum().backward()
    return q.grad, k.grad, v.grad


@pytest.mark.parametrize("t,bq,bk", [
    (48, 16, 16),     # ragged T: the backward's padded rows
    (32, 32, 32),     # single block each way
    (64, 16, 32),     # asymmetric: dq's diagonal crosses mid k-block
    (64, 32, 16),     # asymmetric: dkv starts mid q-block
])
def test_gradients_match_jax_kernels(t, bq, bk):
    """The autograd Function's backward (the plain K2/K3 from the saved
    l, m) against ``jax.grad`` through the JAX custom_vjp (the Pallas dq
    and dk/dv kernels), for the cotangent of ``sum(o * w)``."""
    shape = (2, 2, t, 16)
    q, k, v, w = _qkv(7 + t + bq, shape, n=4)
    for got, ref in zip(_port_grads(q, k, v, w, bq, bk),
                        _jax_grads(q, k, v, w, bq, bk)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD_TOL)


@pytest.mark.parametrize("t,dh,bq,bk", [
    (32, 16, 16, 16),
    (65, 40, 16, 32),     # a ragged tail past the card's 64-row tile
    (80, 64, 32, 16),     # the training head dim, several k blocks a row
])
def test_bf16_inputs_match_jax_kernel(t, dh, bq, bk):
    """The plain K1-K3 in bf16 against the JAX kernels at the shapes the
    card holds the tensor-core kernels to: with blocks smaller than T the
    JAX K1 rounds p against a running max, as the card's K1 does."""
    q, k, v, w = _qkv(4 if t == 32 else t + dh, (1, 2, t, dh), n=4)
    rtol, atol = attn_tol(jnp.bfloat16)
    jo, jl, jm = jfa._flash_fwd_call(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)), bq, bk)
    o, l, m = tfa.flash_forward(*_t(q, k, v, dtype=torch.bfloat16))
    assert o.dtype == torch.bfloat16 and l.dtype == m.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=rtol,
                               atol=atol)
    got = _port_grads(q, k, v, w, bq, bk, torch.bfloat16)
    ref = _jax_grads(q, k, v, w, bq, bk, jnp.bfloat16)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(r.astype(jnp.float32)),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("t,bq,bk", [(80, 16, 32), (80, 32, 16)])
def test_bf16_backward_matches_jax_kernels(t, bq, bk):
    """The function the bf16 K2/K3 compute, at the training head dim (64)
    and a ragged T: the port's plain ``flash_dq_reference`` /
    ``flash_dkv_reference`` against the JAX ``_flash_bwd`` (the Pallas dq
    and dk/dv kernels in interpret mode), both fed the same residuals (q, k,
    v and the JAX forward's o, l, m) and the same cotangent."""
    q, k, v, do = _qkv(11 + t + bq, (1, 2, t, 64), n=4)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jnp.bfloat16)
                       for a in (q, k, v, do))
    jo, jl, jm = jfa._flash_fwd_call(jq, jk, jv, bq, bk)
    jdq, jdk, jdv = jfa._flash_bwd(bq, bk, (jq, jk, jv, jo, jl, jm), jdo)
    tq, tk, tv, tdo = _t(q, k, v, do, dtype=torch.bfloat16)
    to, tl, tm = _t(*(np.array(a.astype(jnp.float32))
                      for a in (jo, jl, jm)))
    to = to.to(torch.bfloat16)                  # exact: jo holds bf16 values
    linv, delta = tfa._backward_stats(to, tl, tdo)
    bwd = (tq, tk, tv, tdo, tm, linv, delta)
    rtol, atol = attn_tol(jnp.bfloat16)
    for got, ref in zip((tfa.flash_dq_reference(*bwd),
                         *tfa.flash_dkv_reference(*bwd)), (jdq, jdk, jdv)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   rtol=rtol, atol=atol)


def test_kernel_build_hash_follows_included_headers(tmp_path, monkeypatch):
    """A kernel library is named by a hash that covers the ``csrc`` headers
    its sources include, through other headers too, so an edited header
    never loads a stale build; the flash kernels include ``mma_bf16.cuh``,
    ``mma_tf32.cuh`` and ``wgmma_bf16.cuh``."""
    from simple_distributed_machine_learning_tpu_torch.ops import (
        _cuda_build as cb,
    )
    assert [p.name for p in cb._hashed_files(["flash_attention.cu"])] == [
        "flash_attention.cu", "mma_bf16.cuh", "mma_tf32.cuh",
        "wgmma_bf16.cuh"]
    monkeypatch.setattr(cb, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <stdint.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    assert [p.name for p in cb._hashed_files(["k.cu"])] == [
        "k.cu", "a.cuh", "b.cuh"]
    before = cb.library_path("k", ["k.cu"])
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    after = cb.library_path("k", ["k.cu"])
    assert before != after and after.parent == cb.BUILD_DIR


def test_gradcheck_in_float64():
    """The Function's backward (plain K2/K3 from the saved statistics)
    is the derivative of its forward: finite differences in f64."""
    q, k, v = (torch.from_numpy(a).double().requires_grad_()
               for a in _qkv(3, (1, 2, 9, 4)))
    assert torch.autograd.gradcheck(
        lambda q, k, v: tfa.flash_attention(q, k, v, device="cpu"),
        (q, k, v))


def test_flash_mha_matches_causal_attention():
    rng = np.random.default_rng(2)
    d, h, t, b = 64, 4, 32, 2
    params = {n: torch.from_numpy(
        (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32))
        for n in ("wq", "wk", "wv", "wo")}
    x = torch.from_numpy(rng.standard_normal((b, t, d)).astype(np.float32))
    out = tfa.flash_mha(params, x, h, block_q=16, block_k=16, device="cpu")
    ref = tattn.causal_attention(params, x, h)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **F32_TOL)
    jref = jattn.causal_attention({n: jnp.asarray(p.numpy())
                                   for n, p in params.items()},
                                  jnp.asarray(x.numpy()), h)
    np.testing.assert_allclose(out.numpy(), np.asarray(jref), **F32_TOL)


def test_cpu_calls_launch_no_kernel():
    before = (tfa.flash_forward.launches, tfa.flash_dq.launches,
              tfa.flash_dkv.launches)
    q, k, v, w = _qkv(5, (1, 2, 16, 8), n=4)
    _port_grads(q, k, v, w, 16, 16)
    assert (tfa.flash_forward.launches, tfa.flash_dq.launches,
            tfa.flash_dkv.launches) == before == (0, 0, 0)


def test_default_device_without_cuda_raises():
    """``device=None`` means CUDA: without a card the call raises instead
    of carrying on silently on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: device=None is valid here")
    q, k, v = _t(*_qkv(6, (1, 1, 8, 4)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfa.flash_attention(q, k, v)


@pytest.mark.parametrize("bad", ["shape", "dtype", "blocks"])
def test_bad_inputs_raise(bad):
    q, k, v = _t(*_qkv(8, (1, 2, 8, 4)))
    if bad == "shape":
        k = k[:, :, :4]
    elif bad == "dtype":
        v = v.double()
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, v, 0 if bad == "blocks" else 16, 16,
                            device="cpu")

