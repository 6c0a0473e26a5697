"""The port's paged attention against the JAX package's Pallas kernel.

The JAX kernel runs as its own tests run it on the CPU (Pallas interpret
mode); the port's wrapper, given CPU tensors, computes its plain version.
Both packages get the same pool numbers, made with numpy from a seed:
f32 and bf16 pools are the same values cast by each framework, quantised
pools are quantised by each package's own ``_quantize_rows`` (which must
agree exactly). Where both sides read the same stored bytes and scales,
only f32 summation order differs, so they are held at
``SAME_BYTES_TOL`` (rtol = atol = 1e-5) for every storage dtype.
``tolerances.attn_tol`` of the storage dtype (bf16 5e-2, int8 6e-2, fp8
1.5e-1) is used only where a narrow pool's answer is compared with the
unquantised f32 pool's.

The CUDA kernel itself runs only on the card: its test, which needs no
JAX, is ``tests/test_torch_paged_attention_cuda.py``; ``chip_smoke.py``
holds it against the plain version at the serving shapes on every chip
run.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tolerances import attn_tol

from simple_distributed_machine_learning_tpu.models import gpt as jgpt
from simple_distributed_machine_learning_tpu.ops.paged_attention import (
    paged_attention as jax_paged_attention,
    paged_flash_decode as jax_paged_flash_decode,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (
    QUERIES_PER_GROUP,
    paged_attention,
    paged_attention_reference,
    paged_flash_decode,
    query_groups,
)

DTYPES = ["float32", "bfloat16", "int8", "float8_e4m3fn", "float8_e5m2"]
QUANT = ("int8", "float8_e4m3fn", "float8_e5m2")
BS = 4
#: (rtol, atol) where both sides read the same stored values and scales
SAME_BYTES_TOL = (1e-5, 1e-5)


def _toy_pool(seed, S=3, H=2, K=1, dh=16, NB=6, NBtot=12):
    """Ragged tables with trash entries (the JAX test's ``_toy_pool``):
    slot 0 spans 4 blocks, slot 1 two, slot 2 one; the rest point at the
    trash block 0. K > 1 queries sit at ``pos + j``."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, H, K, dh)).astype(np.float32)
    kc = rng.standard_normal((NBtot, H, BS, dh)).astype(np.float32)
    vc = rng.standard_normal((NBtot, H, BS, dh)).astype(np.float32)
    tables = np.zeros((S, NB), np.int32)
    tables[0, :4] = [2, 5, 7, 8]
    tables[1, :2] = [1, 3]
    tables[2, :1] = [9]
    pos = np.array([10, 4, 0], np.int32)
    qpos = np.minimum(pos[:, None] + np.arange(K)[None, :],
                      NB * BS - 1).astype(np.int32)
    return q, kc, vc, tables, qpos


def _pools(name, kc, vc):
    """``(jax_args, torch_args)``: each package's (k, v, kscale, vscale)."""
    if name in QUANT:
        jk, jks = jgpt._quantize_rows(jnp.asarray(kc), jnp.dtype(name))
        jv, jvs = jgpt._quantize_rows(jnp.asarray(vc), jnp.dtype(name))
        tk, tks = tgpt._quantize_rows(torch.from_numpy(kc), name)
        tv, tvs = tgpt._quantize_rows(torch.from_numpy(vc), name)
        return (jk, jv, jks, jvs), (tk, tv, tks, tvs)
    return ((jnp.asarray(kc).astype(name), jnp.asarray(vc).astype(name),
             None, None),
            (torch.from_numpy(kc).to(getattr(torch, name)),
             torch.from_numpy(vc).to(getattr(torch, name)), None, None))


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("name", DTYPES)
def test_plain_version_matches_jax_kernel(name, K):
    q, kc, vc, tables, qpos = _toy_pool(10 * DTYPES.index(name) + K, K=K)
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _pools(name, kc, vc)
    # both packages hold the same stored values
    np.testing.assert_array_equal(np.asarray(jk.astype(jnp.float32)),
                                  tk.float().numpy())
    ref = jax_paged_attention(jnp.asarray(q), jk, jv, jnp.asarray(tables),
                              jnp.asarray(qpos), block_size=BS,
                              kscale=jks, vscale=jvs)
    out = paged_attention(torch.from_numpy(q), tk, tv,
                          torch.from_numpy(tables), torch.from_numpy(qpos),
                          block_size=BS, kscale=tks, vscale=tvs,
                          device="cpu")
    assert out.dtype == torch.float32 and out.shape == q.shape
    rtol, atol = SAME_BYTES_TOL
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)
    # the narrow pool's answer stays within its storage tolerance of the
    # unquantised f32 pool's
    wide = paged_attention(torch.from_numpy(q), torch.from_numpy(kc),
                           torch.from_numpy(vc), torch.from_numpy(tables),
                           torch.from_numpy(qpos), block_size=BS,
                           device="cpu")
    rtol, atol = attn_tol(jnp.dtype(name))
    np.testing.assert_allclose(out.numpy(), wide.numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("name", DTYPES)
def test_plain_version_matches_jax_kernel_at_kernel_edges(name):
    """The shapes the card holds the CUDA kernel to beside the serving
    ones: K = 8 queries, blocks of 8 with a table of 20 (longer than 16
    blocks), head dim 40; slot 0 at the last position its table spans,
    slot 1 at position 0 with a real block, slot 2 routed to the trash."""
    S, H, K, dh, bs, NB = 3, 2, 8, 40, 8, 20
    n = S * NB + 1
    rng = np.random.default_rng(40 + DTYPES.index(name))
    q = rng.standard_normal((S, H, K, dh)).astype(np.float32)
    kc = rng.standard_normal((n, H, bs, dh)).astype(np.float32)
    vc = rng.standard_normal((n, H, bs, dh)).astype(np.float32)
    pos = np.array([NB * bs - K, 0, 0])
    qpos = (pos[:, None] + np.arange(K)[None, :]).astype(np.int32)
    tables = np.zeros((S, NB), np.int32)
    tables[0] = rng.permutation(n - 1)[:NB] + 1
    tables[1, :1] = [n - 1]
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _pools(name, kc, vc)
    ref = jax_paged_attention(jnp.asarray(q), jk, jv, jnp.asarray(tables),
                              jnp.asarray(qpos), block_size=bs,
                              kscale=jks, vscale=jvs)
    out = paged_attention(torch.from_numpy(q), tk, tv,
                          torch.from_numpy(tables), torch.from_numpy(qpos),
                          block_size=bs, kscale=tks, vscale=tvs,
                          device="cpu")
    rtol, atol = SAME_BYTES_TOL
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("K", [9, 16])
@pytest.mark.parametrize("name", ["float32", "int8"])
def test_plain_version_matches_jax_kernel_beyond_8_queries(name, K):
    """More queries per slot than one block of the CUDA kernel takes (the
    verify step at spec_k > 8): the plain version, the card's yardstick,
    against the JAX kernel, which takes any K. Slot 0's queries run past
    the table's last position and are clamped there (K = 16: positions
    repeat), and every slot's queries straddle block boundaries."""
    q, kc, vc, tables, qpos = _toy_pool(60 + K, K=K)
    assert (np.diff(qpos, axis=1) >= 0).all()
    if K == 16:
        assert (qpos[0, -3:] == qpos[0, -1]).all()
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _pools(name, kc, vc)
    ref = jax_paged_attention(jnp.asarray(q), jk, jv, jnp.asarray(tables),
                              jnp.asarray(qpos), block_size=BS,
                              kscale=jks, vscale=jvs)
    out = paged_attention(torch.from_numpy(q), tk, tv,
                          torch.from_numpy(tables), torch.from_numpy(qpos),
                          block_size=BS, kscale=tks, vscale=tvs,
                          device="cpu")
    rtol, atol = SAME_BYTES_TOL
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


def test_kernel_takes_at_most_8_queries():
    """A block of the CUDA kernel holds each of its queries' output
    columns in registers, for at most 8 queries: one launch splits a
    slot's K queries into ceil(K / 8) groups along the grid, each reading
    the slot's K/V rows up to its own newest position. The wrapper no
    longer refuses K > 8, and the plain version takes any K."""
    assert QUERIES_PER_GROUP == 8
    assert [query_groups(k) for k in (1, 4, 8, 9, 12, 16, 17)] == \
        [1, 1, 1, 2, 2, 2, 3]
    q, kc, vc, tables, qpos = _toy_pool(2, K=9)
    args = [torch.from_numpy(a) for a in (q, kc, vc, tables, qpos)]
    out = paged_attention(*args, block_size=BS, device="cpu")
    assert out.shape == q.shape and torch.isfinite(out).all()


def test_paged_flash_decode_matches_jax():
    q, kc, vc, tables, qpos = _toy_pool(7)
    pos = qpos[:, 0]
    ref = jax_paged_flash_decode(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(tables),
                                 jnp.asarray(pos), block_size=BS)
    out = paged_flash_decode(torch.from_numpy(q), torch.from_numpy(kc),
                             torch.from_numpy(vc), torch.from_numpy(tables),
                             torch.from_numpy(pos), block_size=BS,
                             device="cpu")
    rtol, atol = SAME_BYTES_TOL
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", QUANT)
def test_quantize_rows_matches_jax_exactly(name):
    """Same scales bit for bit, same stored data bit for bit — including
    an all-zero row, which the 1e-8 scale floor keeps finite."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((5, 4, 8, 32)) * 3.0).astype(np.float32)
    x[0, 0, 0] = 0.0
    jd, js = jgpt._quantize_rows(jnp.asarray(x), jnp.dtype(name))
    td, ts = tgpt._quantize_rows(torch.from_numpy(x), name)
    assert td.dtype == getattr(torch, name) and ts.dtype == torch.float32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(td.float().numpy(),
                                  np.asarray(jd.astype(jnp.float32)))
    assert float(ts[0, 0, 0]) == np.float32(1e-8)


def _call(**kw):
    q, kc, vc, tables, qpos = _toy_pool(0)
    args = dict(block_size=BS, device="cpu")
    args.update(kw)
    return paged_attention(torch.from_numpy(q), torch.from_numpy(kc),
                           torch.from_numpy(vc), torch.from_numpy(tables),
                           torch.from_numpy(qpos), **args)


def test_unknown_layout_raises():
    with pytest.raises(ValueError, match="_layout"):
        _call(_layout="tiled")


def test_kscale_without_vscale_raises():
    with pytest.raises(ValueError, match="both kscale and vscale"):
        _call(kscale=torch.ones(12, 2, BS))


def test_quantized_pool_without_scales_raises():
    q, kc, vc, tables, qpos = _toy_pool(0)
    k8 = torch.from_numpy(kc).to(torch.int8)
    with pytest.raises(ValueError, match="kscale/vscale"):
        paged_attention(torch.from_numpy(q), k8, k8,
                        torch.from_numpy(tables), torch.from_numpy(qpos),
                        block_size=BS, device="cpu")


def test_block_size_mismatch_raises():
    with pytest.raises(ValueError, match="block_size"):
        _call(block_size=BS + 1)


def test_every_layout_value_gives_the_same_result():
    """The packed layout was a TPU tiling workaround: on the port every
    accepted value runs the one natural-layout computation."""
    outs = [_call(_layout=lay) for lay in ("auto", "natural", "packed")]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_trash_routed_slots_stay_finite():
    """A non-decoding slot (pos 0, all-trash table) reads trash block 0's
    row 0 and must still produce finite output."""
    q, kc, vc, _tables, _qpos = _toy_pool(1)
    tables = torch.zeros((3, 6), dtype=torch.int32)
    qpos = torch.zeros((3, 1), dtype=torch.int32)
    out = paged_attention(torch.from_numpy(q), torch.from_numpy(kc),
                          torch.from_numpy(vc), tables, qpos,
                          block_size=BS, device="cpu")
    assert torch.isfinite(out).all()
    # with one live row the output is exactly that row's V
    np.testing.assert_allclose(out[:, :, 0].numpy(),
                               np.broadcast_to(vc[0, :, 0], (3, 2, 16)),
                               rtol=1e-6, atol=1e-6)


def test_default_device_without_cuda_raises():
    """``device=None`` means CUDA: without a card the call raises instead
    of carrying on silently on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: device=None is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _call(device=None)


def test_tensors_off_the_requested_device_raise():
    q, kc, vc, tables, qpos = _toy_pool(0)
    with pytest.raises((RuntimeError, ValueError)):
        paged_attention(torch.from_numpy(q), torch.from_numpy(kc),
                        torch.from_numpy(vc), torch.from_numpy(tables),
                        torch.from_numpy(qpos), block_size=BS,
                        device="cuda")

