"""Beam-search decoding on the KV-cache infrastructure.

Port of ``models/beam.py``. ``make_beam_decoder(stages, cfg, prompt_len,
n_new, beam_size)`` returns ``decode(params, prompt, key=None) ->
(tokens int32 [B, total], scores f32 [B])``: the highest
cumulative-log-prob continuation among ``beam_size`` beams per sequence,
decoded with the same per-layer K/V caches as
:func:`~.gpt.make_cached_decoder` (one prefill, one token per step). The
beams ride the batch axis as ``B*K`` rows, beam-major within each
sequence (row ``b*K + k``), and each step's beam reordering gathers the
cache rows along that axis.

Scoring is the plain sum of token log-probs over the generated suffix
(no length normalization: every beam has the same fixed length).
``beam_size=1`` is exactly greedy decoding.

EOS termination (``eos_id``): a beam that emits ``eos_id`` is finished —
its score freezes at the log-prob of its sequence up to and including
EOS, and its only continuation is EOS itself at log-prob 0, so it rides
the remaining steps as an eos-padded row competing on its frozen score.

Top-K selections break ties toward the lower index, as ``lax.top_k``
does (``torch.topk``'s tie order is unspecified): a stable descending
sort, first K. Plain torch math, no hand kernel: the JAX decoder uses
plain ``jnp`` too.
"""

from __future__ import annotations

import math

import torch

from simple_distributed_machine_learning_tpu_torch._device import (
    resolve_device,
)
from simple_distributed_machine_learning_tpu_torch.models.gpt import (
    GPTConfig,
    _cache_dtype,
    _check_cache_quantization,
    _dense_block_prefill,
    _dense_block_step,
    _head_logprobs,
    _merged_stage_trees,
    _on,
    _validate_decode_build,
)
from simple_distributed_machine_learning_tpu_torch.ops.layers import (
    embedding_lookup,
)


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest values, ties to
    the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def make_beam_decoder(stages, cfg: GPTConfig, prompt_len: int, n_new: int,
                      beam_size: int = 4, cache_dtype=None,
                      eos_id: int | None = None, device=None):
    """Build the beam decoder on ``device`` (None = ``"cuda"``; raises
    without CUDA unless ``"cpu"``). Single-device dense builds only (the
    :func:`~.gpt.make_cached_decoder` restrictions; ``cache_dtype`` f32 or
    bf16, as there). ``eos_id``: beams finishing on this token freeze
    their score and eos-pad (module docstring). The decode's ``key`` is
    accepted and ignored: beam search is deterministic."""
    if cfg.n_seq > 1:
        raise ValueError(
            "beam decode is single-device; rebuild the stages with n_seq=1")
    if not 1 <= beam_size <= cfg.vocab:
        raise ValueError(
            f"beam_size={beam_size} out of range [1, vocab={cfg.vocab}]")
    if eos_id is not None and not 0 <= eos_id < cfg.vocab:
        raise ValueError(
            f"eos_id={eos_id} outside [0, vocab={cfg.vocab})")
    _check_cache_quantization(cache_dtype, "make_beam_decoder", paged=False)
    total = _validate_decode_build(stages, cfg, prompt_len, n_new,
                                   "make_beam_decoder")
    dev = resolve_device(device)
    K = beam_size
    H = cfg.n_heads
    dh = cfg.d_model // H
    V = cfg.vocab
    cd = _cache_dtype(cache_dtype)

    @torch.no_grad()
    def decode(params, prompt, key=None):
        del key                                  # beam search is deterministic
        embed, blocks, head = _merged_stage_trees(params)
        prompt = _on(prompt, dev, torch.int64)
        b = prompt.shape[0]
        L = len(blocks)

        # prefill at batch B (the beams share the prompt prefix)
        kc = torch.zeros((L, b, H, total, dh), dtype=cd, device=dev)
        vc = torch.zeros_like(kc)
        h = embedding_lookup(embed["tok"], prompt) + embed["pos"][:prompt_len]
        for li, bp in enumerate(blocks):
            h = _dense_block_prefill(bp, h, li, kc, vc, prompt_len, H)
        row = _head_logprobs(head, h[:, -1])                     # [B, V]

        # beam init: the top-K first tokens; the caches tile to B*K rows
        scores, t0 = _top_k(row, K)                              # [B, K]
        toks = torch.zeros((b, K, n_new), dtype=torch.int64, device=dev)
        toks[:, :, 0] = t0
        kc = kc.repeat_interleave(K, dim=1)                      # [L, B*K, ..]
        vc = vc.repeat_interleave(K, dim=1)
        done = (t0 == eos_id if eos_id is not None
                else torch.zeros((b, K), dtype=torch.bool, device=dev))
        if eos_id is not None:
            # a finished beam's only continuation: EOS at log-prob 0
            pad = torch.full((V,), -math.inf, device=dev)
            pad[eos_id] = 0.0
        base = (torch.arange(b, device=dev) * K)[:, None]        # [B, 1]
        for i in range(1, n_new):
            # the token chosen at step i-1 sits at global position
            # prompt_len + i - 1; consume it there
            pos_i = prompt_len + i - 1
            h = (embedding_lookup(embed["tok"], toks[:, :, i - 1].reshape(
                b * K, 1)) + embed["pos"][pos_i:pos_i + 1])
            for li, bp in enumerate(blocks):
                h = _dense_block_step(bp, h, li, kc, vc, pos_i, total, H)
            row = _head_logprobs(head, h[:, 0]).reshape(b, K, V)
            if eos_id is not None:
                row = torch.where(done[:, :, None], pad, row)
            cand = scores[:, :, None] + row                      # [B, K, V]
            scores, flat = _top_k(cand.reshape(b, K * V), K)
            beam_idx = flat // V                                 # [B, K]
            new_tok = flat % V
            # reorder every beam-indexed structure by its source beam: a
            # gather along the B*K row axis
            rows = (base + beam_idx).reshape(-1)
            kc = kc.index_select(1, rows)
            vc = vc.index_select(1, rows)
            toks = toks.gather(1, beam_idx[:, :, None].expand(b, K, n_new))
            toks[:, :, i] = new_tok
            if eos_id is not None:
                done = done.gather(1, beam_idx) | (new_tok == eos_id)
        best = torch.argmax(scores, dim=1)                       # [B]
        best_toks = toks[torch.arange(b, device=dev), best]      # [B, n_new]
        out = torch.cat([prompt, best_toks], dim=1).to(torch.int32)
        return out, scores.gather(1, best[:, None])[:, 0]

    return decode
