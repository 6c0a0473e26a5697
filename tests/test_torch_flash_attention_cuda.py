"""The port's CUDA flash-attention kernels (K1 forward, K2 dq, K3 dk/dv)
against their plain versions on the card.

These tests import torch and the port only, so they run on a GPU machine
without JAX; the repo's ``tests/conftest.py`` sets JAX up, so skip it there:

    python -m pytest --noconftest -m cuda tests/test_torch_*_cuda.py

Without a card every test here skips. In bf16 all three kernels run on
the tensor cores; in f32 they run on them in split TF32 (three TF32
products per f32 one, close to f32 accuracy). Tolerances are
``chip_smoke.py``'s:
f32 ``(o, l, m)`` within rtol = atol = 1e-5 (f32 sums in another order),
f32 gradients within 1e-4 (the JAX package's gradient tolerance,
``tests/test_flash_attention.py``), bf16 outputs within two bf16 ulps at 1.0
(K1 rounds p against its running max, the plain version against the final
one; the tensor-core kernels sum in f32 in another order, which can move a
bf16 rounding of p, ds or an output by one ulp); l and m stay f32 in both
dtypes.
"""

import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu_torch.ops import attention as tattn
from simple_distributed_machine_learning_tpu_torch.ops import (
    flash_attention as tfa,
)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_KERNEL_TOL = dict(rtol=2.0 ** -6, atol=2.0 ** -6)


def _inputs(seed, shape, device, dtype=torch.float32, n=3, unaligned=False):
    """``n`` tensors from a seed; ``unaligned``: each contiguous with its
    storage one element into a buffer, so not 16-byte aligned."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        if unaligned:
            buf = torch.empty(x.numel() + 1, dtype=dtype, device=device)
            out.append(buf[1:].view(shape).copy_(x))
        else:
            out.append(x.to(device, dtype))
    return out


def _launches():
    return (tfa.flash_forward.launches, tfa.flash_dq.launches,
            tfa.flash_dkv.launches)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# (dtype, [B, H, T, dh]): f32 (split-TF32 K1-K3) and bf16 (tensor-core
# K1-K3) at one T row (1), one row past a tile (65), a ragged tail (200)
# and whole tiles (256), for head dims padded to 16 (8, the smallest
# instantiation), 32, 64 and 128 and one that is not a multiple of 16 (40);
# f32 also at the full-prefix decoder's shape (one sequence of the serving
# model: 8 heads x 256 x 64) and the tiny ``gpt`` row's (batch 32, 4 heads
# x 64 x 32)
_CASES = ([(torch.float32, (2, 4, t, dh)) for dh in (8, 32, 40, 64, 128)
           for t in (1, 65, 200, 256)]
          + [(torch.float32, (1, 8, 256, 64)),
             (torch.float32, (32, 4, 64, 32))]
          + [(torch.bfloat16, (2, 4, t, dh)) for dh in (32, 64, 128, 40)
             for t in (1, 65, 200, 256)]
          + [(torch.bfloat16, (2, 4, t, 8)) for t in (65, 200)]
          # head dims past 128: the wide kernels (the own rows resident, the
          # outputs in chunks of 256 past dh 256; K1 128 q rows a block),
          # both dtypes, T = 1, 65, 129 (past a K1 block) and 200; dh 196
          # is not a multiple of 8, which TMA cannot take
          + [(dt, (1, 2, t, dh)) for dt in (torch.float32, torch.bfloat16)
             for dh in (160, 192, 196, 256, 320, 512)
             for t in (1, 65, 129, 200)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", _CASES)
def test_cuda_kernels_match_plain_versions(cuda_device, dtype, shape):
    """K1, K2 and K3 on the card against their plain versions on the same
    inputs; K2 and K3 take the plain forward's statistics, so each kernel
    is held alone. T = 200 leaves the last tile's tail masked, T = 65 puts
    one row in a second tile, T = 1 is a single row."""
    t, dh = shape[2:]
    q, k, v, do = _inputs(9 + t + dh, shape, cuda_device, dtype, n=4)
    before = _launches()
    got_f = tfa.flash_forward(q, k, v)
    ref_f = tfa.flash_forward_reference(q, k, v)
    linv, delta = tfa._backward_stats(ref_f[0], ref_f[1], do)
    bwd = (q, k, v, do, ref_f[2], linv, delta)
    got_b = (tfa.flash_dq(*bwd), *tfa.flash_dkv(*bwd))
    ref_b = (tfa.flash_dq_reference(*bwd), *tfa.flash_dkv_reference(*bwd))
    torch.cuda.synchronize()
    assert _launches() == tuple(n + 1 for n in before)
    f32 = dtype == torch.float32
    for i, (g, r) in enumerate(zip(got_f, ref_f)):
        tol = F32_TOL if f32 or i > 0 else BF16_KERNEL_TOL   # l, m are f32
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   r.float().cpu().numpy(), **tol)
    for g, r in zip(got_b, ref_b):
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   r.float().cpu().numpy(),
                                   **(GRAD_TOL if f32 else BF16_KERNEL_TOL))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2, 65, 160), (1, 2, 200, 256),
                                   (1, 2, 129, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_wide_kernels_take_unaligned_inputs(cuda_device, dtype, shape):
    """K1, K2 and K3 past dh 128 on contiguous inputs whose storage starts
    one element into a buffer (not 16-byte aligned, so no TMA box or
    16-byte copy can take them): the kernels' plain copies, against the
    plain versions on the same inputs."""
    t, dh = shape[2:]
    q, k, v, do = _inputs(11 + t + dh, shape, cuda_device, dtype, n=4,
                          unaligned=True)
    assert q.data_ptr() % 16 != 0 and q.is_contiguous()
    before = _launches()
    got_f = tfa.flash_forward(q, k, v)
    ref_f = tfa.flash_forward_reference(q, k, v)
    linv, delta = tfa._backward_stats(ref_f[0], ref_f[1], do)
    bwd = (q, k, v, do, ref_f[2], linv, delta)
    got_b = (tfa.flash_dq(*bwd), *tfa.flash_dkv(*bwd))
    ref_b = (tfa.flash_dq_reference(*bwd), *tfa.flash_dkv_reference(*bwd))
    torch.cuda.synchronize()
    assert _launches() == tuple(n + 1 for n in before)
    f32 = dtype == torch.float32
    for i, (g, r) in enumerate(zip(got_f, ref_f)):
        tol = F32_TOL if f32 or i > 0 else BF16_KERNEL_TOL
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   r.float().cpu().numpy(), **tol)
    for g, r in zip(got_b, ref_b):
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   r.float().cpu().numpy(),
                                   **(GRAD_TOL if f32 else BF16_KERNEL_TOL))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", [(torch.float32, (2, 2, 96, 32)),
                                         (torch.float32, (1, 8, 256, 64)),
                                         (torch.bfloat16, (2, 4, 200, 64)),
                                         (torch.float32, (1, 2, 130, 256)),
                                         (torch.bfloat16, (1, 2, 130, 256))])
def test_cuda_autograd_goes_through_the_kernels(cuda_device, dtype, shape):
    """``flash_attention``'s gradients (K1 forward, K2 + K3 backward)
    against autograd through the dense ``causal_attention_core``. bf16
    inputs are held against the dense core in f32 on the same (bf16)
    values: the function the kernels compute, before their bf16 roundings
    of p, ds and the outputs."""
    q, k, v, w = _inputs(10, shape, cuda_device, dtype, n=4)
    w = w.float()
    q, k, v = (a.requires_grad_() for a in (q, k, v))
    before = _launches()
    (tfa.flash_attention(q, k, v) * w).sum().backward()
    torch.cuda.synchronize()
    assert _launches() == tuple(n + 1 for n in before)
    qr, kr, vr = (a.detach().float().requires_grad_() for a in (q, k, v))
    (tattn.causal_attention_core(qr, kr, vr) * w).sum().backward()
    tol = GRAD_TOL if dtype == torch.float32 else BF16_KERNEL_TOL
    for g, r in ((q.grad, qr.grad), (k.grad, kr.grad), (v.grad, vr.grad)):
        assert g.dtype == dtype
        np.testing.assert_allclose(g.float().cpu().numpy(), r.cpu().numpy(),
                                   **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [2112, 2100])
def test_cuda_wide_backward_long_sequence_f32(cuda_device, t):
    """K2 and K3 at dh 256 in f32 over 33 tiles (T 2112 whole, T 2100 with
    a ragged tail): the longest output sums of the wide backward kernels'
    checks (every tile pair adds to dq, dk and dv in registers) within the
    f32 gradient tolerance of their plain versions."""
    shape = (1, 2, t, 256)
    q, k, v, do = _inputs(t, shape, cuda_device, torch.float32, n=4)
    o, l, m = tfa.flash_forward_reference(q, k, v)
    linv, delta = tfa._backward_stats(o, l, do)
    bwd = (q, k, v, do, m, linv, delta)
    before = _launches()
    got = (tfa.flash_dq(*bwd), *tfa.flash_dkv(*bwd))
    torch.cuda.synchronize()
    assert _launches() == (before[0], before[1] + 1, before[2] + 1)
    ref = (tfa.flash_dq_reference(*bwd), *tfa.flash_dkv_reference(*bwd))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   **GRAD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [2112, 2100])
def test_cuda_wide_forward_long_sequence_f32(cuda_device, t):
    """K1 at dh 256 in f32 over 33 k tiles (T 2112 whole, T 2100 with a
    ragged tail): the longest online softmax of the wide forward (o, l and
    m carried over every k tile, the scores summed per 64-column slice)
    within the f32 ``1e-5`` of its plain version."""
    shape = (1, 2, t, 256)
    q, k, v = _inputs(t + 1, shape, cuda_device, torch.float32)
    before = _launches()
    got = tfa.flash_forward(q, k, v)
    torch.cuda.synchronize()
    assert _launches() == (before[0] + 1, before[1], before[2])
    ref = tfa.flash_forward_reference(q, k, v)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   **F32_TOL)
