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
          # head dims past 256 (the wide kernel since dh 129),
          # f32 and int8, one query group and two; one misaligned view
          + [(name, K, dict(dh=dh)) for name in ("float32", "int8")
             for dh in (320, 512) for K in (1, 9)]
          + [("bfloat16", 4, dict(dh=320)),
             ("float32", 1, dict(dh=321, layout="misaligned"))])
# past head dim 128 the wide kernel (key_parts blocks a slot, whole slabs
# through shared memory): every storage dtype at every wide head dim (129
# and 196 too narrow a row for 16-byte copies in some dtypes), K = 1, 4, 9
# and 16, blocks of 8, 16 and 32 and tables of 5, 6, 12 and 40 blocks (1,
# 2, 4 and 8 parts), and block-major and misaligned views
WIDE_DIMS = (129, 160, 196, 256, 320, 512, 576)
_WIDE_CASES = ([(name, 1, dict(dh=dh)) for name in DTYPES for dh in WIDE_DIMS]
               + [(name, K, dict(dh=dh))
                  for dh in WIDE_DIMS for K in (4, 9, 16)
                  for name in ("float32", DTYPES[(dh + K) % 4 + 1])]
               + [(name, K, dict(dh=dh, bs=bs, NB=NB))
                  for name, K in (("float32", 1), ("int8", 9))
                  for dh in (160, 256, 512)
                  for bs, NB in ((8, 40), (16, 12), (32, 5))]
               + [(name, K, dict(dh=dh, layout=layout))
                  for layout in ("block-major", "misaligned")
                  for name, K in (("float32", 1), ("bfloat16", 4),
                                  ("float8_e5m2", 9))
                  for dh in (129, 256, 576)])


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


def _against_plain(dev, name, K, opts, seed=11):
    """The kernel on ``_toy_pool``'s case against the plain version, one
    launch counted."""
    layout = opts.get("layout", "layer")
    q, kc, vc, tables, qpos = _toy_pool(seed, K, **opts)
    (tk, tks), (tv, tvs) = _stored(name, kc), _stored(name, vc)
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
@pytest.mark.parametrize("name,K,opts", _CASES, ids=map(_case_id, _CASES))
def test_cuda_kernel_matches_plain_version(cuda_device, name, K, opts):
    _against_plain(cuda_device, name, K, opts)


@pytest.mark.cuda
@pytest.mark.parametrize("name,K,opts", _WIDE_CASES,
                         ids=map(_case_id, _WIDE_CASES))
def test_cuda_wide_kernel_matches_plain_version(cuda_device, name, K, opts):
    _against_plain(cuda_device, name, K, opts, seed=29)


@pytest.mark.cuda
@pytest.mark.parametrize("name,K,dh", [("float32", 1, 256), ("int8", 1, 512),
                                       ("bfloat16", 9, 576),
                                       ("float32", 16, 160)])
def test_cuda_wide_kernel_at_2048_positions(cuda_device, name, K, dh):
    """A slot at position 2047 (128 blocks of 16, 8 parts) beside a slot at
    position 0 and a trash-routed one."""
    _against_plain(cuda_device, name, K, dict(dh=dh, bs=16, NB=128), seed=7)


@pytest.mark.cuda
@pytest.mark.parametrize("name,K,dh", [("float32", 1, 256), ("int8", 9, 512),
                                       ("float8_e4m3fn", 4, 160)])
def test_cuda_wide_kernel_slot_alone_equals_slot_in_batch(cuda_device, name,
                                                          K, dh):
    """Each of 8 slots launched alone (S = 1) gives its rows of the batch's
    launch (S = 8) bit for bit: the parts and the cut of a slot's blocks
    never depend on the other slots."""
    rng = np.random.default_rng(dh + K)
    S, H, bs, NB, n = 8, 2, 16, 12, 8 * 12 + 1
    q = rng.standard_normal((S, H, K, dh)).astype(np.float32)
    kc, vc = (rng.standard_normal((n, H, bs, dh)).astype(np.float32)
              for _ in range(2))
    pos = np.array([191, 100, 0, 17, 64, 150, 3, 0])
    qpos = np.minimum(pos[:, None] + np.arange(K)[None, :],
                      NB * bs - 1).astype(np.int32)
    tables = (rng.permutation(n - 1)[:S * NB] + 1).reshape(S, NB)
    tables[S - 1] = 0                              # trash-routed
    (tk, tks), (tv, tvs) = _stored(name, kc), _stored(name, vc)
    dev = cuda_device
    t = dict(kc=tk.to(dev), vc=tv.to(dev),
             kscale=None if tks is None else tks.to(dev),
             vscale=None if tvs is None else tvs.to(dev))
    qd = torch.from_numpy(q).to(dev)
    td = torch.from_numpy(tables.astype(np.int32)).to(dev)
    pd = torch.from_numpy(qpos).to(dev)
    batch = paged_attention(qd, t["kc"], t["vc"], td, pd, block_size=bs,
                            kscale=t["kscale"], vscale=t["vscale"])
    alone = [paged_attention(qd[i:i + 1].contiguous(), t["kc"], t["vc"],
                             td[i:i + 1].contiguous(),
                             pd[i:i + 1].contiguous(), block_size=bs,
                             kscale=t["kscale"], vscale=t["vscale"])
             for i in range(S)]
    torch.cuda.synchronize()
    assert torch.equal(batch, torch.cat(alone, dim=0))


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
