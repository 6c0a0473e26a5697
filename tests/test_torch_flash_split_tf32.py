"""The numerics of the f32 flash kernels' split-TF32 design, on the CPU.

The f32 K1 (forward), K2 (dq) and K3 (dk/dv) in
``ops/csrc/flash_attention.cu`` run every product on the TF32 tensor cores
as three products: each f32 operand
is split as ``x = hi + lo`` with both parts rounded to TF32 (nearest, ties
away from zero), and ``a·b`` becomes ``lo_a·hi_b + hi_a·lo_b + hi_a·hi_b``
summed in f32 (``ops/csrc/mma_tf32.cuh``). No card is needed to check that
this keeps the kernels' parity: here the same rounding is emulated in
torch by bit masking, the products are taken as the design takes them, and
the result is held against the plain versions (``flash_forward_reference``,
``flash_dq_reference``, ``flash_dkv_reference``) and the JAX kernels in
Pallas interpret mode, with
``chip_smoke.py``'s ``FLASH_TOL``: f32 ``(o, l, m)`` within rtol = atol =
1e-5, f32 gradients within 1e-4. Single-pass TF32, which the design
rejects, misses the forward's limit at the full-prefix decoder's shape;
its gap is printed beside the design's.

Shapes: the tiny ``gpt`` row's f32 attention (batch 32, 4 heads, seq 64,
dh 32) and the full-prefix decoder's (1 and 2 sequences of the serving
model's 8 heads x 256 x 64). Inputs come from numpy seeds.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu.ops import flash_attention as jfa
from simple_distributed_machine_learning_tpu_torch.ops import (
    flash_attention as tfa,
)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
GPT_ROW = (32, 4, 64, 32)
DECODE = (1, 8, 256, 64)
DECODE_B2 = (2, 8, 256, 64)


def _inputs(seed, shape, n=3):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for _ in range(n)]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32, to nearest with ties away from zero: half a
    TF32 ulp added to the magnitude's bits, the 13 low bits cleared (the
    kernels' rule, ``mma_tf32.cuh::split_tf32``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_split(a, b):
    """``a @ b`` as the kernels take it: lo·hi + hi·lo first, then hi·hi,
    each TF32 x TF32 product exact in f32, the sums in f32."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    small = a_lo @ b_hi + a_hi @ b_lo
    return small + a_hi @ b_hi


def mm_single(a, b):
    """``a @ b`` in single-pass TF32 (each operand rounded once)."""
    return tf32(a) @ tf32(b)


def forward(q, k, v, mm):
    """K1's function with its two products through ``mm``: ``(o, l, m)``."""
    t, dh = q.shape[2], q.shape[3]
    s = mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    pos = torch.arange(t)
    live = pos[:, None] >= pos[None, :]
    s = torch.where(live, s, tfa.NEG_INF)
    m = s.amax(-1)
    p = torch.where(live, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    o = mm(p, v) / torch.clamp_min(l, 1e-30)[..., None]
    return o, l, m


def dq(q, k, v, do, m, linv, delta, mm):
    """K2's function with its three products through ``mm``: ``dq``."""
    t, dh = q.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(dh)
    pos = torch.arange(t)
    live = pos[:, None] >= pos[None, :]
    s = mm(q, k.transpose(-1, -2)) * scale
    p = torch.where(live, torch.exp(s - m[..., None]) * linv[..., None], 0.0)
    dp = mm(do, v.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    return mm(ds, k)


def dkv(q, k, v, do, m, linv, delta, mm):
    """K3's function with its four products through ``mm``: ``(dk, dv)``."""
    t, dh = q.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(dh)
    pos = torch.arange(t)
    live = pos[:, None] >= pos[None, :]
    s = mm(q, k.transpose(-1, -2)) * scale
    p = torch.where(live, torch.exp(s - m[..., None]) * linv[..., None], 0.0)
    dp = mm(do, v.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    return (mm(ds.transpose(-1, -2), q), mm(p.transpose(-1, -2), do))


def _excess(got, ref, rtol, atol) -> float:
    """The largest ``|got - ref| - (atol + rtol |ref|)``: > 0 means the
    pair misses the limit."""
    return float(((got - ref).abs() - (atol + rtol * ref.abs())).max())


def test_tf32_rounding_is_nearest_ties_away():
    """The bit-mask rounding against a float64 reference: the mantissa cut
    to 11 significant bits, rounded half away from zero; exact ties (the
    13 dropped bits exactly 0x1000) round away from zero on both signs."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * 2.0 ** rng.integers(-20, 20, 4096)
         ).astype(np.float32)
    ties = (np.arange(1, 65, dtype=np.uint32) << 13) | np.uint32(0x1000)
    ties = np.concatenate([ties | np.uint32(0x3F800000),
                           ties | np.uint32(0xBF800000)]).view(np.float32)
    x = np.concatenate([x, ties, np.float32([0.0, -0.0, 1.0, -1.5])])
    mant, exp = np.frexp(x.astype(np.float64))
    want = (np.sign(mant) * np.floor(np.abs(mant) * 2.0 ** 11 + 0.5)
            * 2.0 ** (exp - 11))
    got = tf32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.astype(np.float64), want)
    assert (got.view(np.uint32) & 0x1FFF == 0).all()
    # the ties went away from zero
    t = got[4096:4096 + 128].astype(np.float64)
    assert (np.abs(t) > np.abs(x[4096:4096 + 128])).all()


def test_split_keeps_22_bits():
    """hi + lo carries x to ~2^-22 relative; hi alone to ~2^-11."""
    (x,) = _inputs(1, (1 << 16,), n=1)
    hi, lo = split(x)
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max()
    assert rel <= 2.0 ** -22
    assert ((hi.double() - x.double()).abs() / x.double().abs()).max() > (
        2.0 ** -13)


@pytest.mark.parametrize("shape", [GPT_ROW, DECODE, DECODE_B2])
def test_split_tf32_forward_matches_plain(shape):
    """K1's design, scores and p·v in split TF32, against the plain
    version within ``FLASH_TOL``'s f32 limits."""
    q, k, v = _inputs(sum(shape), shape)
    ref = tfa.flash_forward_reference(q, k, v)
    got = forward(q, k, v, mm_split)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **F32_TOL)


@pytest.mark.parametrize("shape", [GPT_ROW, DECODE])
def test_split_tf32_dkv_matches_plain(shape):
    """K3's design, its four products in split TF32, against the plain
    version within the f32 gradient limit, fed the plain forward's
    statistics as the kernel is."""
    q, k, v, do = _inputs(sum(shape) + 1, shape, n=4)
    o, l, m = tfa.flash_forward_reference(q, k, v)
    linv, delta = tfa._backward_stats(o, l, do)
    ref = tfa.flash_dkv_reference(q, k, v, do, m, linv, delta)
    got = dkv(q, k, v, do, m, linv, delta, mm_split)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **GRAD_TOL)


@pytest.mark.parametrize("shape", [GPT_ROW, DECODE])
def test_split_tf32_dq_matches_plain(shape):
    """K2's design, its three products in split TF32, against the plain
    version within the f32 gradient limit, fed the plain forward's
    statistics as the kernel is."""
    q, k, v, do = _inputs(sum(shape) + 2, shape, n=4)
    o, l, m = tfa.flash_forward_reference(q, k, v)
    linv, delta = tfa._backward_stats(o, l, do)
    ref = tfa.flash_dq_reference(q, k, v, do, m, linv, delta)
    got = dq(q, k, v, do, m, linv, delta, mm_split)
    print(f"split TF32 dq at {shape}: max abs gap to the plain version "
          f"{float((got - ref).abs().max()):.3e}")
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **GRAD_TOL)


def test_split_tf32_dq_matches_jax_kernel():
    """At one small shape, the card's f32 chain in split TF32 (K1's
    statistics into K2) against the JAX package's dq, taken by
    ``jax.grad`` through its custom_vjp: the Pallas ``_dq_kernel`` in
    interpret mode (blocks of 16), for the cotangent of ``sum(o * w)``."""
    q, k, v, w = _inputs(11, (2, 3, 64, 32), n=4)

    def loss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, 16, 16) * w.numpy())

    jdq = jax.grad(loss)(*(jnp.asarray(a.numpy()) for a in (q, k, v)))
    o, l, m = forward(q, k, v, mm_split)
    linv, delta = tfa._backward_stats(o, l, w)
    got = dq(q, k, v, w, m, linv, delta, mm_split)
    np.testing.assert_allclose(got.numpy(), np.asarray(jdq), **GRAD_TOL)


def test_split_tf32_forward_matches_jax_kernel():
    """At one small shape, the design against the JAX ``_flash_kernel``
    run in Pallas interpret mode (blocks of 16)."""
    q, k, v = _inputs(7, (2, 3, 64, 32))
    jo, jl, jm = jfa._flash_fwd_call(*(jnp.asarray(a.numpy())
                                       for a in (q, k, v)), 16, 16)
    got = forward(q, k, v, mm_split)
    for g, r in zip(got, (jo, jl, jm)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **F32_TOL)


def test_single_pass_tf32_misses_the_limit_at_the_decoder_shape():
    """The design's reason: single-pass TF32 leaves the forward outside
    rtol = atol = 1e-5 at the decoder's shape, where split TF32 stays
    inside. Both gaps are printed."""
    q, k, v = _inputs(sum(DECODE), DECODE)
    ref = tfa.flash_forward_reference(q, k, v)
    single = forward(q, k, v, mm_single)
    three = forward(q, k, v, mm_split)
    for name, got in (("single-pass TF32", single), ("split TF32", three)):
        gaps = {p: float((g - r).abs().max())
                for p, g, r in zip("olm", got, ref)}
        print(f"{name} at {DECODE}: max abs gap to the plain version "
              + ", ".join(f"{p} {e:.3e}" for p, e in gaps.items()))
    assert max(_excess(g, r, **F32_TOL) for g, r in zip(single, ref)) > 0
    assert max(_excess(g, r, **F32_TOL) for g, r in zip(three, ref)) <= 0
