"""The port's CUDA paged-attention kernel (K4) against its plain version on
the card.

These tests import torch and the port only, so they run on a GPU machine
without JAX; the repo's ``tests/conftest.py`` sets JAX up, so skip it there:

    python -m pytest --noconftest -m cuda tests/test_torch_*_cuda.py

Without a card every test here skips. Kernel and plain version read the
same stored bytes and scales, so only f32 summation order differs: rtol =
atol = 1e-5 for every storage dtype.
"""

import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_reference,
)

DTYPES = ["float32", "bfloat16", "int8", "float8_e4m3fn", "float8_e5m2"]
BS = 4
SAME_BYTES_TOL = dict(rtol=1e-5, atol=1e-5)


def _toy_pool(seed, K, S=3, H=2, dh=16, NB=6, NBtot=12):
    """Ragged tables with trash entries: slot 0 spans 4 blocks, slot 1 two,
    slot 2 one; the rest point at the trash block 0. K > 1 queries sit at
    ``pos + j``."""
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


def _stored(name, a):
    """The pool ``a`` as stored in ``name``: ``(values, scales or None)``."""
    if name in ("int8", "float8_e4m3fn", "float8_e5m2"):
        return tgpt._quantize_rows(torch.from_numpy(a), name)
    return torch.from_numpy(a).to(getattr(torch, name)), None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("name", DTYPES)
def test_cuda_kernel_matches_plain_version(cuda_device, name, K):
    q, kc, vc, tables, qpos = _toy_pool(11, K=K)
    (tk, tks), (tv, tvs) = _stored(name, kc), _stored(name, vc)
    args = [torch.from_numpy(q), tk, tv, torch.from_numpy(tables),
            torch.from_numpy(qpos), tks, tvs]
    args = [None if a is None else a.to(cuda_device) for a in args]
    before = paged_attention.launches
    out = paged_attention(*args[:5], block_size=BS, kscale=args[5],
                          vscale=args[6])
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    ref = paged_attention_reference(*args[:5], block_size=BS,
                                    kscale=args[5], vscale=args[6])
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               **SAME_BYTES_TOL)
