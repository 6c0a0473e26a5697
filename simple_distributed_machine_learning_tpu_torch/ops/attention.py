"""Dense multi-head attention math (port of ``ops/attention.py``).

Plain torch: the QKVO projection init, the head split/merge, the masked
softmax core that the cached decoder's prefill and the dense training
blocks share, ``causal_attention`` (the whole dense MHA), and ring
attention over the mesh's ``seq`` axis (:func:`ring_attention`): the
sequence sharded in chunks, K/V blocks rotating around the ring
(``parallel/mesh.py::ring_shift``) and folded into a blockwise-stable
(flash-style) softmax.
"""

from __future__ import annotations

import math

import torch

from simple_distributed_machine_learning_tpu_torch.ops.layers import _uniform

SEQ_AXIS = "seq"


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


def _block_accumulate(q, k, v, acc, q_off: int, k_off: int, scale: float):
    """One flash-style block: fold ``(k, v)`` into the running ``(o, l,
    m)`` for ``q``. q: [B,H,Tq,Dh]; k/v: [B,H,Tk,Dh]; ``q_off``/``k_off``
    are the blocks' global positions for the causal mask. Rows masked
    everywhere so far keep ``m = -inf`` and a zero correction."""
    o, l, m = acc
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    tq, tk = q.shape[2], k.shape[2]
    qpos = q_off + torch.arange(tq, device=q.device)[:, None]
    kpos = k_off + torch.arange(tk, device=q.device)[None, :]
    scores = torch.where(qpos >= kpos, scores, -math.inf)
    m_new = torch.maximum(m, scores.amax(-1))
    # guard: exp(-inf - -inf) is nan; a row still masked everywhere takes
    # a zero correction (its exponent is read at 0 so no nan reaches the
    # gradient either)
    dead = torch.isneginf(m_new)
    corr = torch.where(dead, 0.0,
                       torch.exp(m - torch.where(dead, 0.0, m_new)))
    p = torch.exp(scores - m_new[..., None])
    p = torch.where(torch.isneginf(scores), 0.0, p)
    o = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v)
    l = l * corr + p.sum(-1)
    return o, l, m_new


def ring_attention(params, x, n_heads: int, axis: str = SEQ_AXIS):
    """Causal MHA with the sequence sharded over the mesh's seq axis.

    ``x`` is this process's seq chunks (``parallel/sequence.py::
    SeqShards``: ``[B, T_local, D]`` each, chunk ``i`` the global positions
    ``[i*T_local, (i+1)*T_local)``, with the axis's view); the result is
    the chunks' outputs in the same form. Each chunk's K/V block travels
    the ring one hop per step (coordinate ``i`` sends to ``i + 1``, so at
    step ``r`` chunk ``i`` holds block ``i - r``): a shift of the list
    within the process, the wire across processes. Equals
    :func:`causal_attention` on the gathered sequence to float
    tolerance."""
    from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (  # noqa: E501
        ring_shift,
    )
    view = x.view
    if view.name != axis:
        raise ValueError(f"ring_attention over axis {axis!r} got chunks "
                         f"of axis {view.name!r}")
    s = view.size
    qs = [_split_heads(c @ params["wq"], n_heads) for c in x]
    kv = [torch.stack([_split_heads(c @ params["wk"], n_heads),
                       _split_heads(c @ params["wv"], n_heads)])
          for c in x]
    t_loc, dh = qs[0].shape[2], qs[0].shape[3]
    scale = 1.0 / math.sqrt(dh)
    accs = [(torch.zeros_like(q), torch.zeros_like(q[..., 0]),
             torch.full_like(q[..., 0], -math.inf)) for q in qs]
    for r in range(s):
        for j, idx in enumerate(view.owned):
            src = (idx - r) % s            # whose block this chunk holds
            accs[j] = _block_accumulate(qs[j], kv[j][0], kv[j][1], accs[j],
                                        idx * t_loc, src * t_loc, scale)
        if r + 1 < s:
            kv = ring_shift(kv, view)
    outs = [_merge_heads(o / torch.clamp_min(l, 1e-30)[..., None])
            @ params["wo"] for o, l, _ in accs]
    return type(x)(outs, view)
