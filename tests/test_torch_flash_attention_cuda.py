"""The port's CUDA flash-attention kernels (K1 forward, K2 dq, K3 dk/dv)
against their plain versions on the card.

These tests import torch and the port only, so they run on a GPU machine
without JAX; the repo's ``tests/conftest.py`` sets JAX up, so skip it there:

    python -m pytest --noconftest -m cuda tests/test_torch_*_cuda.py

Without a card every test here skips. Tolerances are ``chip_smoke.py``'s:
f32 ``(o, l, m)`` within rtol = atol = 1e-5 (f32 sums in another order),
f32 gradients within 1e-4 (the JAX package's gradient tolerance,
``tests/test_flash_attention.py``), bf16 outputs within two bf16 ulps at 1.0
(the kernel rounds p against its running max, the plain version against
the final one); l and m stay f32 in both dtypes.
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


def _inputs(seed, shape, device, dtype=torch.float32, n=3):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(device, dtype) for _ in range(n)]


def _launches():
    return (tfa.flash_forward.launches, tfa.flash_dq.launches,
            tfa.flash_dkv.launches)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("t", [256, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain_versions(cuda_device, dtype, t):
    """K1, K2 and K3 on the card against their plain versions on the same
    inputs; K2 and K3 take the plain forward's statistics, so each kernel
    is held alone. T = 200 leaves the last tile's tail masked."""
    q, k, v, do = _inputs(9 + t, (2, 4, t, 64), cuda_device, dtype, n=4)
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
def test_cuda_autograd_goes_through_the_kernels(cuda_device):
    q, k, v, w = _inputs(10, (2, 2, 96, 32), cuda_device, n=4)
    q, k, v = (a.requires_grad_() for a in (q, k, v))
    before = _launches()
    (tfa.flash_attention(q, k, v) * w).sum().backward()
    torch.cuda.synchronize()
    assert _launches() == tuple(n + 1 for n in before)
    qr, kr, vr = (a.detach().clone().requires_grad_() for a in (q, k, v))
    (tattn.causal_attention_core(qr, kr, vr) * w).sum().backward()
    for g, r in ((q.grad, qr.grad), (k.grad, kr.grad), (v.grad, vr.grad)):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   **GRAD_TOL)
