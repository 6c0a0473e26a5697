"""The port's CUDA flash-attention kernels (K1 forward, K2 dq, K3 dk/dv)
against their plain versions on the card.

These tests import torch and the port only, so they run on a GPU machine
without JAX; the repo's ``tests/conftest.py`` sets JAX up, so skip it there:

    python -m pytest --noconftest -m cuda tests/test_torch_*_cuda.py

Without a card every test here skips. In bf16 all three kernels run on
the tensor cores (K1 since its redesign, beside K2 and K3); in f32 on the
CUDA cores. Tolerances are ``chip_smoke.py``'s:
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


# (dtype, T, dh): f32 through the SIMT kernels at the training head dim, a
# full and a ragged T; bf16 through the tensor-core K1-K3 at one T row (1),
# one row past a tile (65), a ragged tail (200) and whole tiles (256), for
# head dims padded to 32, 64 and 128 and one that is not a multiple of 16;
# and dh 8, padded to 16 (the smallest instantiation)
_CASES = ([(torch.float32, t, 64) for t in (256, 200)]
          + [(torch.bfloat16, t, dh) for dh in (32, 64, 128, 40)
             for t in (1, 65, 200, 256)]
          + [(torch.bfloat16, t, 8) for t in (65, 200)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,t,dh", _CASES)
def test_cuda_kernels_match_plain_versions(cuda_device, dtype, t, dh):
    """K1, K2 and K3 on the card against their plain versions on the same
    inputs; K2 and K3 take the plain forward's statistics, so each kernel
    is held alone. T = 200 leaves the last tile's tail masked, T = 65 puts
    one row in a second tile, T = 1 is a single row."""
    q, k, v, do = _inputs(9 + t + dh, (2, 4, t, dh), cuda_device, dtype,
                          n=4)
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
@pytest.mark.parametrize("dtype,shape", [(torch.float32, (2, 2, 96, 32)),
                                         (torch.bfloat16, (2, 4, 200, 64))])
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
