"""Dense multi-head attention math (port of ``ops/attention.py``).

Plain torch: the QKVO projection init, the head split/merge, the masked
softmax core that the cached decoder's prefill and the dense training
blocks share, and ``causal_attention`` (the whole dense MHA). Ring
attention waits for the sequence-parallel slice.
"""

from __future__ import annotations

import math

import torch

from simple_distributed_machine_learning_tpu_torch.ops.layers import _uniform


def mha_init(gen: torch.Generator, d_model: int, n_heads: int,
             dtype=torch.float32) -> dict:
    """QKVO projection params for multi-head attention, each ``[d, d]``."""
    if d_model % n_heads:
        raise ValueError(f"d_model {d_model} not divisible by {n_heads} heads")
    bound = 1.0 / math.sqrt(d_model)
    return {name: _uniform(gen, (d_model, d_model), bound, dtype)
            for name in ("wq", "wk", "wv", "wo")}


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads).permute(0, 2, 1, 3)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t, h * dh)


def causal_attention_core(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Dense causal softmax attention on split heads: [B, H, T, Dh] each."""
    dh = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(dh)
    t = q.shape[2]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=q.device))
    scores = torch.where(mask, scores, -math.inf)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1), v)


def causal_attention(params, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Standard causal MHA on one device. x: [B, T, D] -> [B, T, D]."""
    q = _split_heads(x @ params["wq"], n_heads)
    k = _split_heads(x @ params["wk"], n_heads)
    v = _split_heads(x @ params["wv"], n_heads)
    return _merge_heads(causal_attention_core(q, k, v)) @ params["wo"]
