"""Tensor-parallel serving on the card: the paged-attention kernel K4 on
one model coordinate's head-sharded pool (``H/tp`` heads, a view of the
coordinate's own ``[L, ...]`` pool) against its plain version, and a tp 2
and 4 engine's greedy streams against the tp 1 engine's, with K4 launched
``tp x n_layers`` times per decode tick.

These tests import torch and the port only, so they run on a GPU machine
without JAX; the repo's ``tests/conftest.py`` sets JAX up, so skip it there:

    python -m pytest --noconftest -m cuda tests/test_torch_*_cuda.py

Without a card every test here skips. Tolerance: K4 against its plain
version ``2e-5`` absolute for f32 pools and ``6e-2`` for int8 (the
phase 2 gates of ``chip_smoke.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu_torch.models import gpt
from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (  # noqa: E501
    paged_attention,
    paged_attention_reference,
)
from simple_distributed_machine_learning_tpu_torch.parallel import make_mesh
from simple_distributed_machine_learning_tpu_torch.serve import (
    InferenceEngine,
)

CFG = dict(vocab=64, seq_len=64, d_model=64, n_heads=8, n_layers=2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the paged-attention kernel runs "
                    "on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_k4_on_a_shard_pool_equals_its_plain_version(cuda_device, tp,
                                                     cache_dtype):
    """The kernel on layer 1 of one coordinate's pool ``[L, NB, H/tp, bs,
    dh]`` (a strided view, as the TP tick passes it) with K = 1 and 4."""
    torch.manual_seed(0)
    S, H, dh, bs, NB, L = 8, CFG["n_heads"] // tp, 64, 16, 4, 2
    pool = torch.randn(L, S * NB + 1, H, bs, dh, device=cuda_device)
    scale = None
    if cache_dtype == "int8":
        amax = pool.abs().amax(-1).clamp_min(1e-6)
        scale = amax / 127.0
        pool = torch.round(pool / scale[..., None]).to(torch.int8)
    tables = (1 + torch.randperm(S * NB, device=cuda_device)
              ).reshape(S, NB).to(torch.int32)
    for K in (1, 4):
        q = torch.randn(S, H, K, dh, device=cuda_device)
        qpos = (torch.randint(0, NB * bs - K, (S, 1), device=cuda_device)
                + torch.arange(K, device=cuda_device)).to(torch.int32)
        kw = dict(block_size=bs, kscale=None if scale is None else scale[1],
                  vscale=None if scale is None else scale[1])
        before = paged_attention.launches
        got = paged_attention(q, pool[1], pool[1], tables, qpos,
                              device=cuda_device, **kw)
        assert paged_attention.launches == before + 1
        want = paged_attention_reference(q, pool[1], pool[1], tables,
                                         qpos, **kw)
        tol = 2e-5 if cache_dtype is None else 6e-2
        assert float((got - want).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("tp,overlap", [(2, "none"), (4, "none"),
                                        (2, "ring")])
def test_tp_engine_streams_equal_tp1_with_per_shard_launches(
        cuda_device, tp, overlap):
    cfg = gpt.GPTConfig(**CFG)
    stages = gpt.make_gpt_stages(0, cfg, 1, device=cuda_device)[0]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, n).astype(np.int32) for n in (5, 9, 13)]

    def run(t):
        c = dataclasses.replace(cfg, n_tensor_parallel=t,
                                overlap=overlap if t > 1 else "none")
        eng = InferenceEngine(
            stages, c, n_slots=4, block_size=8, attn_kernel="fused",
            mesh=(make_mesh(1, n_model=t, devices=[cuda_device] * t)
                  if t > 1 else None), device=cuda_device)
        hs = [eng.submit(p, max_new_tokens=8, seed=i)
              for i, p in enumerate(prompts)]
        while eng.busy:
            eng.step()
        return [h.tokens for h in hs], eng

    base, _ = run(1)
    got, eng = run(tp)
    assert got == base
    eng.submit(prompts[0], max_new_tokens=3)
    while eng.busy and not eng._decoding_slots():
        eng.step()
    before = paged_attention.launches
    eng.step()
    assert paged_attention.launches - before == tp * CFG["n_layers"]
