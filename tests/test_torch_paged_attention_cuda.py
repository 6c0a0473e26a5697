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
# (storage dtype, K, _toy_pool options): every dtype at K = 1 and 4, then
# K4's edge cases as chip_smoke.py holds them at full size: head dims 40,
# 128 and 256, blocks of 8 (a table of 40 blocks, longer than the 16 warps
# that split it) and 32, K = 8, pool views strided past other layers or
# misaligned for the kernel's vector loads; then K = 9, 12 and 16 (two
# query groups in one launch; slot 1's later queries clamped to the table's
# last position, so positions repeat)
_CASES = ([(name, K, {}) for name in DTYPES for K in (1, 4)]
          + [("float32", 1, dict(dh=40)), ("float32", 1, dict(dh=128)),
             ("float32", 1, dict(dh=256)), ("bfloat16", 1, dict(dh=256)),
             ("int8", 1, dict(dh=40)), ("float32", 1, dict(bs=8, NB=40)),
             ("float32", 4, dict(bs=8, NB=40)), ("float32", 1, dict(bs=32)),
             ("float32", 8, {}), ("int8", 8, dict(dh=128)),
             ("float8_e4m3fn", 4, dict(dh=40, bs=32)),
             ("float32", 1, dict(layout="block-major")),
             ("bfloat16", 4, dict(layout="misaligned"))]
          + [("float32", 9, {}), ("int8", 9, {}), ("float32", 12, {}),
             ("bfloat16", 12, {}), ("float8_e4m3fn", 12, {}),
             ("float32", 16, {}), ("int8", 16, dict(dh=128)),
             ("float8_e5m2", 16, dict(bs=8, NB=12)),
             ("float32", 16, dict(layout="misaligned"))]
          # head dims past 256: output chunks of 256 columns, a block each,
          # f32 and int8, one query group and two; one misaligned view
          + [(name, K, dict(dh=dh)) for name in ("float32", "int8")
             for dh in (320, 512) for K in (1, 9)]
          + [("bfloat16", 4, dict(dh=320)),
             ("float32", 1, dict(dh=321, layout="misaligned"))])


def _toy_pool(seed, K, dh=16, bs=BS, NB=6, layout="layer"):
    """Random tables over 4 slots: slot 0 at the last position its table
    spans, slot 1 halfway, slot 2 at position 0 with a real block, slot 3
    routed to the trash block 0 like a non-decoding slot. K > 1 queries sit
    at ``pos + j``. ``layout``: "layer" (blocks [n, H, bs, dh]),
    "block-major" (two layers [n, 2, H, bs, dh], the second taken as a
    view that strides the block axis past the first) or "misaligned" (rows
    of dh + 1, the view starting one element in)."""
    S, H, n = 4, 2, 4 * NB + 1
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, H, K, dh)).astype(np.float32)
    shape = {"layer": (n, H, bs, dh), "block-major": (n, 2, H, bs, dh),
             "misaligned": (n, H, bs, dh + 1)}[layout]
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    span = NB * bs
    pos = np.array([span - K, span // 2, 0, 0])
    qpos = np.minimum(pos[:, None] + np.arange(K)[None, :],
                      span - 1).astype(np.int32)
    tables = np.zeros((S, NB), np.int32)
    perm = rng.permutation(n - 1) + 1
    for s in range(S - 1):
        used = qpos[s, -1] // bs + 1
        tables[s, :used] = perm[s * NB:s * NB + used]
    return q, kc, vc, tables, qpos


def _layer_view(t, layout, rows=True):
    """The pool view the kernel is handed (``rows``: values, not scales)."""
    if t is None:
        return None
    if layout == "block-major":
        return t[:, 1]
    return t[..., 1:] if layout == "misaligned" and rows else t


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


def _case_id(case):
    name, K, opts = case
    return "-".join([name, f"K{K}"] + [f"{k}{v}" for k, v in opts.items()])


@pytest.mark.cuda
@pytest.mark.parametrize("name,K,opts", _CASES, ids=map(_case_id, _CASES))
def test_cuda_kernel_matches_plain_version(cuda_device, name, K, opts):
    layout = opts.get("layout", "layer")
    q, kc, vc, tables, qpos = _toy_pool(11, K, **opts)
    (tk, tks), (tv, tvs) = _stored(name, kc), _stored(name, vc)
    dev = cuda_device
    args = [torch.from_numpy(q).to(dev), _layer_view(tk.to(dev), layout),
            _layer_view(tv.to(dev), layout), torch.from_numpy(tables).to(dev),
            torch.from_numpy(qpos).to(dev)]
    scales = [None if t is None else _layer_view(t.to(dev), layout, False)
              for t in (tks, tvs)]
    bs = args[1].shape[-2]
    before = paged_attention.launches
    out = paged_attention(*args, block_size=bs, kscale=scales[0],
                          vscale=scales[1])
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    ref = paged_attention_reference(*args, block_size=bs, kscale=scales[0],
                                    vscale=scales[1])
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               **SAME_BYTES_TOL)


@pytest.mark.cuda
def test_cuda_kernel_groups_of_8_queries_equal_one_group_each(cuda_device):
    """K = 16 in one launch (two query groups) equals the same slots'
    queries 0-7 and 8-15 in two launches of 8, bit for bit: a group reads
    only its own queries and positions and writes only its own rows."""
    q, kc, vc, tables, qpos = _toy_pool(5, 16)
    t = [torch.from_numpy(a).to(cuda_device)
         for a in (q, kc, vc, tables, qpos)]
    both = paged_attention(*t, block_size=BS)
    halves = [paged_attention(t[0][:, :, j:j + 8].contiguous(), t[1], t[2],
                              t[3], t[4][:, j:j + 8].contiguous(),
                              block_size=BS) for j in (0, 8)]
    torch.cuda.synchronize()
    assert torch.equal(both, torch.cat(halves, dim=2))
