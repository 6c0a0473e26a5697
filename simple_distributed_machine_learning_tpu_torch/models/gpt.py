"""The GPT, its training forward and its serving decode programs (port of
``models/gpt.py``).

The model is a tree of ``nn.Module`` parameter containers — :class:`GPT`
(the whole model, or one pipeline stage's slice of it), :class:`Block`,
:class:`Attention`, :class:`Linear`, :class:`LayerNorm`, :class:`Embed`,
:class:`Head` — whose ``state_dict`` keys are the JAX param tree's paths
(``blocks.0.attn.wq``, ``embed.tok``, ``head.out.w``) and whose layouts are
the JAX package's (``[in, out]`` linear weights, ``[vocab, d]`` token and
``[seq_len, d]`` position embeddings), so weights cross between the
packages with no transposes (``interop.params_from_numpy``). Containers
index like the JAX dicts (``bp["attn"]["wq"]``), so the math below reads
as the reference's does.

Training runs each stage's ``Stage.apply`` (:func:`_stage_apply`): dense-MLP
blocks whose attention is the dense core or, with ``attn_impl="flash"``,
the CUDA flash kernels K1-K3 (``ops/flash_attention.py``), with dropout
drawn from an explicit ``torch.Generator``.

The serving programs are plain closures over the shape scalars — the
JAX package's ``jit`` builders without ``jit``: PyTorch runs eagerly.

- :func:`make_cached_decoder` — solo KV-cache decode, the correctness
  anchor every served stream is held against;
- :func:`make_paged_prefill_chunk` — one prompt chunk of one request into
  its paged blocks;
- :func:`make_paged_decode_step` — the batched one-token tick over all
  slots; ``kernel="fused"`` attends through the CUDA paged-attention
  kernel (``ops/paged_attention.py``), ``"dense"`` gathers each slot's
  blocks and runs masked softmax einsums;
- :func:`make_paged_block_copy` — the copy-on-write block copy;
- speculative decoding: :func:`make_slot_prefill` and
  :func:`make_slot_propose` over the draft's dense slot pool
  (``[L, n_slots, H, max_len, dh]``), :func:`make_paged_verify_step`
  (the target scores ``spec_k`` tokens per slot in one pass; ``"fused"``
  runs the CUDA kernel with ``spec_k`` queries per slot) and
  :func:`make_paged_spec_tick`, the two composed.

Every decode-path builder takes ``adapters=True`` for multi-tenant LoRA
serving: the program then takes a trailing ``(bank, aids)`` — the stacked
adapter bank (``models/lora.py``) and each slot's row in it — and adds
each slot's low-rank delta to its q and v (:func:`_dense_qkv`); row 0 is
all zeros, so a base request's stream is the adapter-free one.

The pool tensors are updated IN PLACE (the JAX programs donate them); the
programs return them anyway, so the engine's call shape is the JAX one.

Sampling keeps the JAX split discipline on the port's own counter-based
generator (``ops/random.py``): greedy consumes no randomness, every
sampled token splits the request's key exactly once, ``top_k == 0`` and
``top_p > 1`` disable the filters.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from simple_distributed_machine_learning_tpu_torch import _roadmap
from simple_distributed_machine_learning_tpu_torch._device import (
    resolve_device,
)
from simple_distributed_machine_learning_tpu_torch._tree import Tree
from simple_distributed_machine_learning_tpu_torch.models.lora import (
    BANK_KEYS,
    lora_delta,
)
from simple_distributed_machine_learning_tpu_torch.ops import random as _rng
from simple_distributed_machine_learning_tpu_torch.ops.attention import (
    _merge_heads,
    _split_heads,
    causal_attention_core,
    mha_init,
)
from simple_distributed_machine_learning_tpu_torch.ops.flash_attention import (
    flash_attention,
)
from simple_distributed_machine_learning_tpu_torch.ops.layers import (
    dropout,
    embedding_init,
    embedding_lookup,
    layer_norm,
    layer_norm_init,
    linear,
    linear_init,
    token_ids,
)
from simple_distributed_machine_learning_tpu_torch.ops.losses import (
    log_softmax,
)
from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (
    gather_paged_rows as _gather_paged_rows,
    paged_attention,
    paged_attention_reference,
)
from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (
    Stage,
)

# sampling-param sentinels: 0 disables top-k, anything > 1 disables top-p
_NO_TOP_K = 0
_NO_TOP_P = 2.0


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """The JAX package's ``GPTConfig``, field for field and check for
    check, so one config describes one model in both packages and a config
    one rejects the other rejects too. The port builds dense-MLP blocks
    with ``attn_impl="dense"`` or ``"flash"`` (``ring``/``ulysses`` at
    ``n_seq == 1`` are the dense math, as in the JAX package); sequence
    parallelism, MoE and the sharded axes raise ``NotImplementedError``
    where ``make_gpt_stages`` or a serving program meets them."""
    vocab: int = 128
    seq_len: int = 64
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    mlp_ratio: int = 4
    dropout_rate: float = 0.0
    attn_impl: str = "dense"
    flash_block_q: int = 128
    flash_block_k: int = 128
    n_seq: int = 1
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 0.01
    n_expert_parallel: int = 1
    n_tensor_parallel: int = 1
    overlap: str = "none"

    def __post_init__(self):
        if self.attn_impl not in ("dense", "flash", "ring", "ulysses"):
            raise ValueError(
                f"attn_impl must be one of dense/flash/ring/ulysses, got "
                f"{self.attn_impl!r}")
        if self.flash_block_q < 1 or self.flash_block_k < 1:
            raise ValueError(
                f"flash blocks must be positive, got "
                f"{self.flash_block_q}/{self.flash_block_k}")
        if self.n_seq < 1 or self.seq_len % self.n_seq:
            raise ValueError(
                f"seq_len {self.seq_len} not divisible by n_seq {self.n_seq}")
        if self.n_seq > 1 and self.attn_impl not in ("ring", "ulysses"):
            raise ValueError(
                f"n_seq={self.n_seq} needs a sequence-parallel attention "
                f"(ring or ulysses), got {self.attn_impl!r}")
        if (self.attn_impl == "ulysses" and self.n_seq > 1
                and self.n_heads % self.n_seq):
            raise ValueError(
                f"ulysses needs n_heads ({self.n_heads}) divisible by "
                f"n_seq ({self.n_seq})")
        if self.n_experts < 0 or (self.n_experts > 0 and not
                                  1 <= self.moe_top_k <= self.n_experts):
            raise ValueError(
                f"invalid MoE config: n_experts={self.n_experts}, "
                f"top_k={self.moe_top_k}")
        if self.n_expert_parallel < 1 or (
                self.n_expert_parallel > 1
                and (self.n_experts == 0
                     or self.n_experts % self.n_expert_parallel)):
            raise ValueError(
                f"n_expert_parallel={self.n_expert_parallel} needs "
                f"n_experts ({self.n_experts}) > 0 and divisible by it")
        if self.overlap not in ("none", "ring"):
            raise ValueError(
                f"overlap must be 'none' or 'ring', got {self.overlap!r}")
        self._check_tensor_parallel()

    def _check_tensor_parallel(self) -> None:
        ntp = self.n_tensor_parallel
        if ntp < 1:
            raise ValueError(f"n_tensor_parallel must be >= 1, got {ntp}")
        if ntp == 1:
            return
        if self.n_heads % ntp:
            raise ValueError(
                f"n_tensor_parallel={ntp} needs n_heads ({self.n_heads}) "
                f"divisible by it")
        if (self.mlp_ratio * self.d_model) % ntp:
            raise ValueError(
                f"n_tensor_parallel={ntp} needs the MLP hidden width "
                f"({self.mlp_ratio * self.d_model}) divisible by it")
        if self.attn_impl != "dense":
            raise ValueError(
                f"tensor parallelism shards attention by head and computes "
                f"dense math on the local heads; attn_impl="
                f"{self.attn_impl!r} is not composable with it")
        if self.n_experts > 0 or self.n_expert_parallel > 1:
            raise ValueError(
                "a stage cannot be both tensor- and expert-sharded: use "
                "n_tensor_parallel with dense-MLP blocks only")
        if self.n_seq > 1:
            raise ValueError(
                "n_tensor_parallel > 1 with n_seq > 1 is not supported (the "
                "wire's token sharding and the TP row scatter would both "
                "claim the token axis)")


def _check_ported(cfg: GPTConfig, caller: str) -> None:
    """Raise for the config values whose code paths this port has not
    reached yet, naming the ROADMAP item that ports each. Every
    ``attn_impl`` is ported at ``n_seq == 1``: serving attends with the
    dense einsums whatever the config (as the JAX engine does), and
    training runs dense or flash blocks."""
    if cfg.n_experts > 0 or cfg.n_expert_parallel > 1:
        raise _roadmap.not_ported(f"{caller}: MoE blocks (n_experts > 0)",
                                  _roadmap.PARALLEL_AXES)
    if cfg.n_seq > 1:
        raise _roadmap.not_ported(
            f"{caller}: sequence parallelism ({cfg.attn_impl}, n_seq="
            f"{cfg.n_seq})", _roadmap.PARALLEL_AXES)
    if cfg.n_tensor_parallel > 1:
        raise _roadmap.not_ported(f"{caller}: n_tensor_parallel > 1",
                                  _roadmap.PARALLEL_AXES)


# -- the model as parameter containers -------------------------------------

class Linear(Tree):
    def __init__(self, w: torch.Tensor, b: torch.Tensor) -> None:
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


class LayerNorm(Tree):
    def __init__(self, scale: torch.Tensor, bias: torch.Tensor) -> None:
        super().__init__()
        self.scale = nn.Parameter(scale)
        self.bias = nn.Parameter(bias)


class Attention(Tree):
    """QKVO projections, each ``[d, d]`` (heads split on the output)."""

    def __init__(self, wq, wk, wv, wo) -> None:
        super().__init__()
        self.wq = nn.Parameter(wq)
        self.wk = nn.Parameter(wk)
        self.wv = nn.Parameter(wv)
        self.wo = nn.Parameter(wo)


class Embed(Tree):
    def __init__(self, tok: torch.Tensor, pos: torch.Tensor) -> None:
        super().__init__()
        self.tok = nn.Parameter(tok)
        self.pos = nn.Parameter(pos)


class Head(Tree):
    def __init__(self, ln_f: dict, out: dict) -> None:
        super().__init__()
        self.ln_f = LayerNorm(**ln_f)
        self.out = Linear(**out)


class Block(Tree):
    """One pre-LN transformer block: causal MHA + GELU MLP."""

    def __init__(self, tree: dict) -> None:
        super().__init__()
        self.ln1 = LayerNorm(**tree["ln1"])
        self.attn = Attention(**tree["attn"])
        self.ln2 = LayerNorm(**tree["ln2"])
        self.mlp_in = Linear(**tree["mlp_in"])
        self.mlp_out = Linear(**tree["mlp_out"])


class GPT(Tree):
    """The GPT, or one pipeline stage of it: ``blocks`` always, ``embed``
    on the first stage, ``head`` (final LN + untied vocab projection) on
    the last. Built from JAX-shaped trees of tensors."""

    def __init__(self, blocks: list[dict], embed: dict | None = None,
                 head: dict | None = None) -> None:
        super().__init__()
        if embed is not None:
            self.embed = Embed(**embed)
        self.blocks = nn.ModuleList(Block(b) for b in blocks)
        if head is not None:
            self.head = Head(**head)


def _block_init(gen: torch.Generator, cfg: GPTConfig) -> dict:
    d, dff = cfg.d_model, cfg.mlp_ratio * cfg.d_model
    return {"ln1": layer_norm_init(d), "attn": mha_init(gen, d, cfg.n_heads),
            "ln2": layer_norm_init(d), "mlp_in": linear_init(gen, d, dff),
            "mlp_out": linear_init(gen, dff, d)}


def make_gpt_stages(seed=0, cfg: GPTConfig = GPTConfig(), n_stages: int = 2,
                    device=None) -> tuple[list[Stage], int, tuple[int, int]]:
    """Build the GPT as ``n_stages`` pipeline stages on ``device``.

    ``seed`` is an int or a CPU ``torch.Generator``; weights are drawn on
    the CPU (one seed, one model, whatever the device) and moved.
    Returns ``(stages, wire_dim, (seq_len, vocab))`` like the JAX builder;
    each stage's ``params`` is a :class:`GPT` module holding its
    contiguous share of the blocks."""
    from simple_distributed_machine_learning_tpu_torch.parallel.staging import (
        contiguous_split,
    )
    dev = resolve_device(device)
    _check_ported(cfg, "make_gpt_stages")
    if cfg.n_layers < n_stages and not (n_stages == 1 and cfg.n_layers == 0):
        raise ValueError(
            f"{cfg.n_layers} layers cannot fill {n_stages} stages")
    gen = (seed if isinstance(seed, torch.Generator)
           else torch.Generator().manual_seed(int(seed)))
    embed = {"tok": embedding_init(gen, cfg.vocab, cfg.d_model),
             "pos": 0.02 * torch.randn((cfg.seq_len, cfg.d_model),
                                       generator=gen)}
    head = {"ln_f": layer_norm_init(cfg.d_model),
            "out": linear_init(gen, cfg.d_model, cfg.vocab)}
    blocks = [_block_init(gen, cfg) for _ in range(cfg.n_layers)]
    split = (contiguous_split(blocks, n_stages) if blocks
             else [[] for _ in range(n_stages)])
    apply = functools.partial(_stage_apply, cfg=cfg)
    stages = []
    for s in range(n_stages):
        first, last = s == 0, s == n_stages - 1
        module = GPT(split[s], embed if first else None,
                     head if last else None).to(dev)
        in_shape = (cfg.seq_len,) if first else (cfg.seq_len, cfg.d_model)
        stages.append(Stage(apply=apply, params=module, in_shape=in_shape))
    return stages, cfg.seq_len * cfg.d_model, (cfg.seq_len, cfg.vocab)


def _stage_apply(params, x, key=None, deterministic=True, *, cfg):
    """``Stage.apply(params, x, key, deterministic)``, the JAX signature:
    token ids ``[B, T]`` (integer, or float as the JAX wire carries them)
    on the first stage, hidden ``[B, T, d]`` after it -> hidden, or
    log-probs ``[B, T, V]`` on the last stage.

    ``params`` is the stage's :class:`GPT` module or a tree of tensors that
    indexes the same way (the pipeline's ``compute_dtype`` casts). ``key``
    is a ``torch.Generator`` on x's device (None = torch's default there)
    that the blocks' dropout draws from, in block order; with
    ``deterministic`` (or ``dropout_rate == 0``) it draws nothing."""
    if "embed" in params:
        ids = token_ids(x)                          # XLA's convert
        h = (embedding_lookup(params["embed"]["tok"], ids)
             + params["embed"]["pos"][:ids.shape[1]])
    else:
        h = x
    for bp in params["blocks"]:
        h = _block_train(bp, h, cfg, key, deterministic)
    if "head" in params:
        h = _head_logprobs(params["head"], h)
    return h


def _block_train(bp, h, cfg: GPTConfig, gen, deterministic: bool):
    """One dense-MLP block of the training forward (the JAX package's
    ``_block_apply``): ln1, causal attention by ``cfg.attn_impl`` — the
    flash kernels (``ops/flash_attention.py``, K1 forward and K2 + K3 in
    the backward) or the dense core — then dropout, residual, ln2, tanh
    GELU MLP, dropout, residual. ``ring``/``ulysses`` at ``n_seq == 1``
    are the dense math, as in the JAX package."""
    q, k, v = _dense_qkv(bp, h, cfg.n_heads)
    if cfg.attn_impl == "flash":
        a = flash_attention(q, k, v, cfg.flash_block_q, cfg.flash_block_k,
                            device=h.device)
    else:
        a = causal_attention_core(q, k, v)

    def drop(x):
        return dropout(gen, x, cfg.dropout_rate, deterministic)

    return _dense_attn_tail(bp, h, a, drop)


# -- shared block math -------------------------------------------------------

def _dense_qkv(bp, h, n_heads, ab=None):
    """ln1 + QKV projections of one dense block, split to [B, H, T, dh].

    ``ab``: this layer's LoRA factors ``(aq, bq, av, bv)`` for the
    serving programs' merge-free per-request delta, ``q += (hn @ aq) @
    bq`` and the same for v (k unadapted), unbatched ``[d, r]`` in a
    one-request prefill or ``[S, d, r]`` in the batched ticks
    (``lora.lora_delta``). The base row's zero factors add an exact 0."""
    hn = layer_norm(bp["ln1"], h)
    q = hn @ bp["attn"]["wq"]
    v = hn @ bp["attn"]["wv"]
    if ab is not None:
        aq, bq, av, bv = ab
        q = q + lora_delta(hn, aq, bq)
        v = v + lora_delta(hn, av, bv)
    return (_split_heads(q, n_heads),
            _split_heads(hn @ bp["attn"]["wk"], n_heads),
            _split_heads(v, n_heads))


def _adapter_layers(bank, aid):
    """Per-request adapter slices for the serving programs: gather row(s)
    ``aid`` (an int for a one-request prefill, a ``[S]`` index tensor for
    the batched ticks) of the stacked bank ``{"aq": [N, L, d, r], "bq":
    [N, L, r, d], ...}`` once per call and return ``at(li) -> (aq, bq,
    av, bv)`` for :func:`_dense_qkv`. The gather is data: one program
    serves any adapter mix, and a bank-row write needs no rebuild."""
    sel = {k: bank[k][aid] for k in BANK_KEYS}

    def at(li):
        return tuple(sel[k][..., li, :, :] for k in BANK_KEYS)

    return at


def _bank_lookup(adapters: bool, bank, aids, dev, caller: str):
    """The per-layer lookup of a builder's trailing ``(bank, aids)``
    arguments, or None for a build without adapters. ``aids`` (an int or
    a host array) becomes one index tensor per call."""
    if not adapters:
        if bank is not None or aids is not None:
            raise ValueError(f"{caller} was built without adapters: drop "
                             f"the (bank, aids) arguments")
        return None
    if bank is None or aids is None:
        raise ValueError(f"{caller} was built with adapters=True: pass the "
                         f"adapter bank and the row indices")
    if not isinstance(aids, int):
        aids = _on(aids, dev, torch.int64)
    return _adapter_layers(bank, aids)


def _dense_attn_tail(bp, h, a, drop=None):
    """wo merge + residual + ln2 + MLP (tanh GELU, ``jax.nn.gelu``'s
    default) + residual; ``drop`` (training) is applied to both residual
    branches before they are added."""
    drop = drop or (lambda x: x)
    h = h + drop(_merge_heads(a) @ bp["attn"]["wo"])
    hn2 = layer_norm(bp["ln2"], h)
    mid = F.gelu(linear(bp["mlp_in"], hn2), approximate="tanh")
    return h + drop(linear(bp["mlp_out"], mid))


def _head_logprobs(head, h_last):
    """[..., d] final hidden -> [..., V] log-probs (ln_f + untied head)."""
    return log_softmax(linear(head["out"], layer_norm(head["ln_f"], h_last)))


def _merged_stage_trees(params_list):
    """Re-join per-stage params into ``(embed, blocks, head)``."""
    embed = head = None
    blocks = []
    for p in params_list:
        blocks.extend(p["blocks"])
        embed = p.get("embed", embed)
        head = p.get("head", head)
    return embed, blocks, head


def _check_embed_matches(stages, cfg: GPTConfig) -> None:
    """A cfg that does not match the stages' embedding table raises
    instead of silently slicing past the real position table."""
    embed = next((s.params.get("embed") for s in stages
                  if "embed" in s.params), None)
    got = None if embed is None else tuple(embed["pos"].shape)
    if got != (cfg.seq_len, cfg.d_model):
        raise ValueError(
            f"cfg (seq_len={cfg.seq_len}, d_model={cfg.d_model}) does not "
            f"match the stages' embedding table {got} — pass the GPTConfig "
            f"the stages were built with")


# -- cache dtypes and quantised blocks ---------------------------------------

_QUANT_QMAX = {"int8": 127.0, "float8_e4m3fn": 448.0, "float8_e5m2": 57344.0}


def _cache_dtype(cache_dtype) -> torch.dtype:
    """K/V cache storage dtype (None = f32). Accepts a ``torch.dtype`` or
    a dtype name (``"bfloat16"``, ``"int8"``, ``"float8_e4m3fn"``, ...)."""
    if cache_dtype is None:
        return torch.float32
    if isinstance(cache_dtype, torch.dtype):
        return cache_dtype
    name = str(getattr(cache_dtype, "name", cache_dtype))
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown cache_dtype {cache_dtype!r}")
    return dt


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def _is_quantized_dtype(cache_dtype) -> bool:
    """Whether ``cache_dtype`` selects the quantised (data + scales)
    block format."""
    return (cache_dtype is not None
            and _dtype_name(_cache_dtype(cache_dtype)) in _QUANT_QMAX)


class QuantKV(NamedTuple):
    """One quantised K or V pool buffer: narrow block ``data``
    ``[L, n_blocks+1, H, bs, dh]`` and the per-row f32 ``scale`` plane
    ``[L, n_blocks+1, H, bs]``, kept and moved together."""
    data: torch.Tensor
    scale: torch.Tensor

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nbytes(self) -> int:
        return self.data.nbytes + self.scale.nbytes

    @property
    def shape(self):
        return self.data.shape


def _quantize_rows(rows: torch.Tensor, dtype
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantise rows ``[..., dh]`` with one f32 scale per row: ``scale =
    max(amax|row| / qmax, 1e-8)``; data = ``round(row / scale)`` (half to
    even) clipped to ±127 for int8, the plain cast for fp8."""
    dtype = _cache_dtype(dtype)
    name = _dtype_name(dtype)
    qmax = _QUANT_QMAX[name]
    rows = rows.float()
    scale = torch.clamp_min(rows.abs().amax(dim=-1) / qmax, 1e-8)
    q = rows / scale[..., None]
    if name == "int8":
        q = torch.clamp(torch.round(q), -127.0, 127.0)
    return q.to(dtype), scale


def _check_cache_quantization(cache_dtype, caller: str, paged: bool) -> None:
    """Quantised caches are paged-pool-only (the dense layouts are the
    parity anchors); unknown dtype names raise here."""
    if cache_dtype is None:
        return
    _cache_dtype(cache_dtype)
    if _is_quantized_dtype(cache_dtype) and not paged:
        raise ValueError(
            f"{caller}: quantized cache_dtype="
            f"{_dtype_name(_cache_dtype(cache_dtype))} is a paged-pool "
            f"feature (per-block scales live beside physical blocks); "
            f"dense layouts are the parity anchors — use f32/bf16")


# -- sampling ------------------------------------------------------------------

def _check_sampling_args(temperature, top_k, top_p, vocab=None):
    if (top_k is not None or top_p is not None) and temperature <= 0.0:
        raise ValueError("top_k/top_p filtering needs temperature > 0 "
                         "(greedy decoding ignores the filtered tail)")
    if top_k is not None and (top_k < 1 or
                              (vocab is not None and top_k > vocab)):
        raise ValueError(f"top_k={top_k} out of range [1, vocab={vocab}]")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p={top_p} out of range (0, 1]")


def _filter_top_dyn(scaled: torch.Tensor, top_k: torch.Tensor,
                    top_p: torch.Tensor) -> torch.Tensor:
    """Per-row top-k then nucleus filtering on temperature-scaled rows
    [N, V] with per-row knobs [N]; masked entries become ``-inf``. The
    top-1 token always survives (the exclusive-cumsum rule)."""
    V = scaled.shape[-1]
    srt = torch.sort(scaled, dim=-1, descending=True).values
    kth = srt.gather(-1, (top_k.clamp(1, V) - 1).long()[:, None])
    scaled = torch.where((top_k >= 1)[:, None] & (scaled < kth), -math.inf,
                         scaled)
    srt = torch.sort(scaled, dim=-1, descending=True).values
    p = torch.softmax(srt, dim=-1)
    exclusive = torch.cumsum(p, dim=-1) - p
    keep = exclusive < top_p[:, None]
    thresh = torch.where(keep, srt, math.inf).amin(dim=-1, keepdim=True)
    return torch.where((top_p <= 1.0)[:, None] & (scaled < thresh),
                       -math.inf, scaled)


def _sample_dyn(rows: torch.Tensor, key_data: torch.Tensor,
                temperature: torch.Tensor, top_k: torch.Tensor,
                top_p: torch.Tensor, ctr0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step on rows [N, V] with per-row sampling params ->
    ``(tokens int32 [N], next_key_data int64 [N, 2])``. Greedy rows
    (``temperature == 0``) take the argmax and keep their key; sampled
    rows split their key once and draw by Gumbel-max from the filtered,
    temperature-scaled row."""
    nk, ks = _rng.split(key_data)
    hot = temperature > 0
    safe_t = torch.where(hot, temperature, torch.ones_like(temperature))
    filtered = _filter_top_dyn(rows / safe_t[:, None], top_k, top_p)
    samp = torch.argmax(filtered + _rng.gumbel(ks, rows.shape[-1], ctr0),
                        dim=-1)
    tok = torch.where(hot, samp, torch.argmax(rows, dim=-1))
    kd = torch.where(hot[:, None], nk, key_data)
    return tok.to(torch.int32), kd


def _on(x, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A host array (numpy/list/scalar) or tensor as ``dtype`` on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    arr = np.asarray(x)
    if arr.dtype == np.uint32:      # key data: widen on the host
        arr = arr.astype(np.int64)
    return torch.as_tensor(arr).to(device=dev, dtype=dtype)


def _sampling_tensors(n: int, temperature, top_k, top_p, dev):
    """Per-row sampling knobs [n] on ``dev`` (sentinels for None)."""
    def col(v, dtype):
        t = _on(v, dev, dtype)
        return t.expand(n).contiguous() if t.dim() == 0 else t
    return (col(temperature, torch.float32),
            col(_NO_TOP_K if top_k is None else top_k, torch.int64),
            col(_NO_TOP_P if top_p is None else top_p, torch.float32))


# -- solo cached decode --------------------------------------------------------

def _validate_decode_build(stages, cfg, prompt_len, n_new, caller):
    _check_ported(cfg, caller)
    if prompt_len < 1:
        raise ValueError(f"{caller} needs a non-empty prompt (t0 >= 1)")
    if n_new < 1:
        raise ValueError(f"{caller} needs n_new >= 1")
    total = prompt_len + n_new
    if total > cfg.seq_len:
        raise ValueError(
            f"prompt {prompt_len} + n_new {n_new} exceeds the model's "
            f"sequence length {cfg.seq_len}")
    _check_embed_matches(stages, cfg)
    return total


def _dense_block_prefill(bp, h, li, kc, vc, prompt_len, n_heads):
    """One block over the whole prompt [b, T0, d]; records cache rows
    ``[0, prompt_len)`` of layer ``li`` in place, attends the fresh K/V."""
    q, k, v = _dense_qkv(bp, h, n_heads)
    kc[li, :, :, :prompt_len] = k.to(kc.dtype)
    vc[li, :, :, :prompt_len] = v.to(vc.dtype)
    return _dense_attn_tail(bp, h, causal_attention_core(q, k, v))


def _dense_block_step(bp, h, li, kc, vc, i, total, n_heads):
    """One block on ONE token [b, 1, d] against cache layer ``li``; writes
    K/V at position ``i`` in place, attends positions ``[0, i]``."""
    dh = h.shape[-1] // n_heads
    q, knew, vnew = _dense_qkv(bp, h, n_heads)          # [B, H, 1, dh]
    kc[li, :, :, i] = knew[:, :, 0].to(kc.dtype)
    vc[li, :, :, i] = vnew[:, :, 0].to(vc.dtype)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, kc[li].float()) / math.sqrt(dh)
    live = (torch.arange(total, device=h.device) <= i)[None, None, None, :]
    scores = torch.where(live, scores, -math.inf)
    a = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1),
                     vc[li].float())
    return _dense_attn_tail(bp, h, a)


def make_cached_decoder(stages, cfg: GPTConfig, prompt_len: int, n_new: int,
                        temperature: float = 0.0, top_k: int | None = None,
                        top_p: float | None = None, cache_dtype=None,
                        device=None):
    """KV-cache decode: ``decode(params, prompt, key_data=None) -> int32
    [B, prompt_len + n_new]`` on ``device``.

    One prefill pass records every layer's K/V for the prompt into
    ``[L, B, H, total, dh]`` buffers, then one token per step attends the
    cache. ``key_data`` is uint32[2] (``ops.random.key_data(seed)``;
    None = seed 0), shared by the batch, each row drawing from its own
    counter range — for B = 1 exactly the draws the serving engine makes
    for a request with the same key, so a served stream equals its solo
    decode. Dense f32/bf16 caches only (quantised caches are paged)."""
    dev = resolve_device(device)
    _check_sampling_args(temperature, top_k, top_p, cfg.vocab)
    _check_cache_quantization(cache_dtype, "make_cached_decoder", paged=False)
    total = _validate_decode_build(stages, cfg, prompt_len, n_new,
                                   "make_cached_decoder")
    sampling = (temperature, top_k, top_p)

    @torch.no_grad()
    def decode(params, prompt, key_data=None):
        embed, blocks, head = _merged_stage_trees(params)
        return _relay_decode(embed, [blocks], head, [dev], prompt, key_data,
                             cfg, prompt_len, total, cache_dtype, sampling)

    return decode


def _relay_decode(embed, stage_blocks, head, devs, prompt, key_data,
                  cfg: GPTConfig, prompt_len: int, total: int, cache_dtype,
                  sampling) -> torch.Tensor:
    """The cached decode over blocks split into stages: stage s's blocks
    (``stage_blocks[s]``) run on ``devs[s]`` against a K/V cache of their
    own depth there, the hidden state hops stage to stage, the head samples
    on the last device and the token goes back to the first. One stage on
    one device is :func:`make_cached_decoder`; several are
    ``models/pp_decode.py``. Returns the tokens on the last device."""
    H = cfg.n_heads
    dh = cfg.d_model // H
    cd = _cache_dtype(cache_dtype)
    out_dev = devs[-1]
    prompt = _on(prompt, devs[0], torch.int64)
    b = prompt.shape[0]
    caches = []
    for blocks, d in zip(stage_blocks, devs):
        kc = torch.zeros((len(blocks), b, H, total, dh), dtype=cd, device=d)
        caches.append((kc, torch.zeros_like(kc)))
    kd = _on(_rng.key_data(0) if key_data is None else key_data, out_dev,
             torch.int64).reshape(1, 2).expand(b, 2)
    knobs = _sampling_tensors(b, *sampling, out_dev)
    ctr0 = torch.arange(b, device=out_dev) * cfg.vocab

    def pick(row, kd):
        tok, kd2 = _sample_dyn(row, kd, *knobs, ctr0=ctr0)
        return tok, kd2[:1].expand(b, 2)

    def relay(h, block):
        for blocks, d, (kc, vc) in zip(stage_blocks, devs, caches):
            h = h.to(d)
            for li, bp in enumerate(blocks):
                h = block(bp, h, li, kc, vc)
        return h

    h = embedding_lookup(embed["tok"], prompt) + embed["pos"][:prompt_len]
    h = relay(h, lambda bp, h, li, kc, vc: _dense_block_prefill(
        bp, h, li, kc, vc, prompt_len, H))
    tok, kd = pick(_head_logprobs(head, h[:, -1]), kd)
    out = [tok]
    # each step consumes the token at position i and samples i + 1
    for i in range(prompt_len, total - 1):
        h = (embedding_lookup(embed["tok"], tok.to(devs[0])[:, None])
             + embed["pos"][i:i + 1])
        h = relay(h, lambda bp, h, li, kc, vc, i=i: _dense_block_step(
            bp, h, li, kc, vc, i, total, H))
        tok, kd = pick(_head_logprobs(head, h[:, 0]), kd)
        out.append(tok)
    return torch.cat([prompt.to(device=out_dev, dtype=torch.int32),
                      torch.stack(out, 1)], 1)


# -- dense slot-row programs (the degraded target's and the draft's pool) ----

def _validate_slot_build(stages, cfg: GPTConfig, max_len: int, caller: str,
                         cache_dtype=None) -> None:
    """The slot programs' checks: a ported single-device dense-MLP config,
    no quantised cache (dense slot rows hold no scales), ``max_len``
    within the position table, and a cfg that matches the stages."""
    _check_ported(cfg, caller)
    _check_cache_quantization(cache_dtype, caller, paged=False)
    if not 2 <= max_len <= cfg.seq_len:
        raise ValueError(
            f"slot max_len={max_len} outside [2, seq_len={cfg.seq_len}] "
            f"(the position table bounds every slot's sequence budget)")
    _check_embed_matches(stages, cfg)


def make_slot_prefill(stages, cfg: GPTConfig, max_len: int,
                      cache_dtype=None, mesh=None, adapters: bool = False,
                      device=None):
    """Prefill into one slot row of a dense pool: ``prefill(params, kc,
    vc, prompt [1, T0], slot, key_data, temperature, top_k, top_p) ->
    (kc, vc, token, key_data)``.

    Runs one request's whole prompt through every block with the solo
    decoder's math, writes each layer's K/V into pool row ``slot`` at
    positions ``[0, T0)`` and samples the first token. ``kc``/``vc`` are
    ``[L, n_slots, H, max_len, dh]`` f32 or bf16 tensors, updated in
    place. The speculative engine prefills its draft pool with it.
    ``adapters=True`` appends ``(bank, aid)``: the adapter bank
    (``models/lora.py``) and the request's row in it."""
    _validate_slot_build(stages, cfg, max_len, "make_slot_prefill",
                         cache_dtype)
    if mesh is not None:
        raise _roadmap.not_ported("make_slot_prefill: tensor-parallel "
                                  "serving (mesh)", _roadmap.PARALLEL_AXES)
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill(params, kc, vc, prompt, slot, key_data, temperature, top_k,
                top_p, bank=None, aid=None):
        embed, blocks, head = _merged_stage_trees(params)
        at = _bank_lookup(adapters, bank, None if aid is None else int(aid),
                          dev, "make_slot_prefill")
        kc, vc, row = _slot_prefill_fwd(blocks, embed, head, kc, vc,
                                        _on(prompt, dev, torch.int64),
                                        int(slot), cfg.n_heads, at=at)
        tok, kd = _sample_dyn(row[None],
                              _on(key_data, dev, torch.int64)[None],
                              *_sampling_tensors(1, temperature, top_k,
                                                 top_p, dev))
        return kc, vc, tok[0], kd[0]

    return prefill


def _slot_prefill_fwd(blocks, embed, head, kc, vc, prompt, slot, H,
                      at=None):
    """One request's whole-prompt prefill into pool row ``slot``; returns
    ``(kc, vc, row)``, the last position's log-probs [V]. ``at``: the
    per-layer adapter lookup (:func:`_adapter_layers`), or None."""
    t0 = prompt.shape[1]
    h = embedding_lookup(embed["tok"], prompt) + embed["pos"][:t0]
    for li, bp in enumerate(blocks):
        q, k, v = _dense_qkv(bp, h, H,                     # [1, H, T0, dh]
                             None if at is None else at(li))
        kc[li, slot, :, :t0] = k[0].to(kc.dtype)
        vc[li, slot, :, :t0] = v[0].to(vc.dtype)
        h = _dense_attn_tail(bp, h, causal_attention_core(q, k, v))
    return kc, vc, _head_logprobs(head, h[:, -1])[0]


def _dense_block_step_slots(bp, h, li, kc, vc, pos, n_heads, ab=None):
    """One block on one token per slot (``h`` [S, 1, d]) against pool
    layer ``li``: each slot writes its K/V at its own position ``pos``
    [S] in place and attends ``[0, pos]``, with the solo decoder's
    per-slot math, so a slot's output depends on its own row only."""
    q, knew, vnew = _dense_qkv(bp, h, n_heads, ab)        # [S, H, 1, dh]
    dh = q.shape[-1]
    rows = torch.arange(h.shape[0], device=h.device)
    kl, vl = kc[li], vc[li]                               # [S, H, ml, dh]
    kl[rows, :, pos] = knew[:, :, 0].to(kl.dtype)
    vl[rows, :, pos] = vnew[:, :, 0].to(vl.dtype)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, kl.float()) / math.sqrt(dh)
    live = (torch.arange(kl.shape[-2], device=h.device)[None, None, None, :]
            <= pos[:, None, None, None])
    scores = torch.where(live, scores, -math.inf)
    a = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1),
                     vl.float())
    return _dense_attn_tail(bp, h, a)


def _slot_decode_fwd(blocks, embed, head, kc, vc, toks, pos, H, at=None):
    """The batched one-token-per-slot step's forward over a dense pool:
    ``toks``/``pos`` [S] int64 -> ``(kc, vc, rows)``, log-probs [S, V].
    The speculative draft's propose loop runs it ``spec_k`` times. ``at``:
    the per-layer adapter lookup over ``[S]`` rows, or None."""
    h = (embedding_lookup(embed["tok"], toks[:, None])
         + embed["pos"][pos][:, None])                      # [S, 1, d]
    for li, bp in enumerate(blocks):
        h = _dense_block_step_slots(bp, h, li, kc, vc, pos, H,
                                    None if at is None else at(li))
    return kc, vc, _head_logprobs(head, h[:, 0])


def make_slot_decode_step(stages, cfg: GPTConfig, max_len: int,
                          cache_dtype=None, mesh=None, adapters: bool = False,
                          device=None):
    """Serving decode tick over a dense slot pool: ``step(params, kc, vc,
    toks [S], pos [S], key_data [S, 2], temps [S], top_ks [S], top_ps
    [S]) -> (kc, vc, next_toks [S], next_key_data [S, 2])``.

    ONE batched token step over ALL slots: each slot consumes its carried
    token at its own position, lands its K/V row in place, attends its
    masked cache row and samples with its own params and key stream.
    Inactive slots compute garbage the engine discards; their stale
    writes are invisible by construction (``serve/slots.py``). The
    degraded rebuild of the serve supervisor decodes with it, adapters
    included: ``adapters=True`` appends ``(bank, aids [S])``."""
    _validate_slot_build(stages, cfg, max_len, "make_slot_decode_step",
                         cache_dtype)
    if mesh is not None:
        raise _roadmap.not_ported("make_slot_decode_step: tensor-parallel "
                                  "serving (mesh)", _roadmap.PARALLEL_AXES)
    dev = resolve_device(device)

    @torch.no_grad()
    def step(params, kc, vc, toks, pos, key_data, temps, top_ks, top_ps,
             bank=None, aids=None):
        embed, blocks, head = _merged_stage_trees(params)
        at = _bank_lookup(adapters, bank, aids, dev, "make_slot_decode_step")
        kc, vc, rows = _slot_decode_fwd(
            blocks, embed, head, kc, vc, _on(toks, dev, torch.int64),
            _on(pos, dev, torch.int64), cfg.n_heads, at=at)
        toks2, kd2 = _sample_dyn(rows, _on(key_data, dev, torch.int64),
                                 *_sampling_tensors(rows.shape[0], temps,
                                                    top_ks, top_ps, dev))
        return kc, vc, toks2, kd2

    return step


# -- paged serving programs ----------------------------------------------------

def _validate_paged_build(stages, cfg: GPTConfig, max_len: int,
                          block_size: int, caller: str, cache_dtype=None,
                          mesh=None) -> None:
    _check_ported(cfg, caller)
    if mesh is not None:
        raise _roadmap.not_ported(f"{caller}: tensor-parallel serving (mesh)",
                                  _roadmap.PARALLEL_AXES)
    _check_cache_quantization(cache_dtype, caller, paged=True)
    if not 2 <= max_len <= cfg.seq_len:
        raise ValueError(
            f"slot max_len={max_len} outside [2, seq_len={cfg.seq_len}] "
            f"(the position table bounds every slot's sequence budget)")
    if block_size < 1:
        raise ValueError(f"{caller} needs block_size >= 1, got {block_size}")
    _check_embed_matches(stages, cfg)


def _layer_put(layer: torch.Tensor, phys, off, rows: torch.Tensor) -> None:
    """``layer[phys, :, off] = rows`` (rows [..., H, (dh)] aligned with the
    index arrays), through a byte view for one-byte storage."""
    if layer.element_size() == 1:
        layer.view(torch.uint8)[phys, :, off] = rows.view(torch.uint8)
    else:
        layer[phys, :, off] = rows


def _paged_scatter(kc, li, phys, off, rows):
    """Land K/V ``rows`` ``[..., H, dh]`` at layer ``li``, physical block
    ``phys``, offset ``off`` — in place. Plain buffers cast to the storage
    dtype; :class:`QuantKV` buffers quantise each row and land its scale
    in the matching plane in the same call."""
    if isinstance(kc, QuantKV):
        qd, sc = _quantize_rows(rows, kc.data.dtype)
        _layer_put(kc.data[li], phys, off, qd)
        kc.scale[li][phys, :, off] = sc
        return kc
    _layer_put(kc[li], phys, off, rows.to(kc.dtype))
    return kc


def _paged_gather(kc, li, table):
    """Layer ``li``'s gathered sequence rows ``[..., H, span, dh]`` for the
    dense attention path; :class:`QuantKV` buffers dequantise to f32."""
    if isinstance(kc, QuantKV):
        rows = _gather_paged_rows(kc.data[li], table).float()
        return rows * _gather_paged_rows(kc.scale[li], table)[..., None]
    return _gather_paged_rows(kc[li], table)


def _paged_attend(kc, vc, li, q, tables, qpos, bs, dev, kernel="fused"):
    """Attention over layer ``li``'s physical blocks
    (``ops/paged_attention.py``): ``"fused"`` is one kernel pass,
    ``"dense"`` its plain version (gather, mask, softmax, einsum). ``q``
    [S, H, K, dh]; ``tables``/``qpos`` int32. Returns f32 [S, H, K, dh]."""
    if isinstance(kc, QuantKV):
        k, v, ks, vs = kc.data[li], vc.data[li], kc.scale[li], vc.scale[li]
    else:
        k, v, ks, vs = kc[li], vc[li], None, None
    if kernel == "dense":
        return paged_attention_reference(q, k, v, tables, qpos, block_size=bs,
                                         kscale=ks, vscale=vs)
    return paged_attention(q.contiguous(), k, v, tables, qpos, block_size=bs,
                           kscale=ks, vscale=vs, device=dev)


def _check_attn_kernel(kernel: str, caller: str) -> str:
    if kernel not in ("dense", "fused"):
        raise ValueError(
            f"{caller}: kernel must be 'dense' (gather-then-dense "
            f"attention, the parity anchor) or 'fused' (the CUDA "
            f"paged-attention kernel), got {kernel!r}")
    return kernel


def make_paged_prefill_chunk(stages, cfg: GPTConfig, max_len: int,
                             block_size: int, cache_dtype=None, mesh=None,
                             adapters: bool = False, device=None):
    """Chunked serving prefill into paged blocks: ``chunk(params, kc, vc,
    tokens [1, c], p0, table [NB], key_data, temperature, top_k, top_p) ->
    (kc, vc, token, key_data)``.

    Runs ONE request's prompt positions ``[p0, p0+c)`` through every
    block, scattering each position's K/V into its physical block
    (``table[p // bs]``, offset ``p % bs``) and attending the gathered
    block row masked to ``<= position`` — earlier chunks, shared prefix
    blocks and the chunk's own rows alike. The last position's row is
    sampled; the engine discards token and key for non-final chunks.
    ``kc``/``vc`` are updated in place. ``adapters=True`` appends
    ``(bank, aid)``, the request's adapter row."""
    _validate_paged_build(stages, cfg, max_len, block_size,
                          "make_paged_prefill_chunk", cache_dtype, mesh)
    dev = resolve_device(device)

    @torch.no_grad()
    def chunk(params, kc, vc, tokens, p0, table, key_data, temperature,
              top_k, top_p, bank=None, aid=None):
        embed, blocks, head = _merged_stage_trees(params)
        at = _bank_lookup(adapters, bank, None if aid is None else int(aid),
                          dev, "make_paged_prefill_chunk")
        kc, vc, row = _paged_chunk_fwd(
            blocks, embed, head, kc, vc, _on(tokens, dev, torch.int64),
            int(p0), _on(table, dev, torch.int64), cfg.n_heads, block_size,
            at=at)
        tok, kd = _sample_dyn(row[None],
                              _on(key_data, dev, torch.int64)[None],
                              *_sampling_tensors(1, temperature, top_k,
                                                 top_p, dev))
        return kc, vc, tok[0], kd[0]

    return chunk


def _paged_chunk_fwd(blocks, embed, head, kc, vc, tokens, p0, table, H, bs,
                     at=None):
    """One prompt chunk's scatter + block-gather attention: ``tokens``
    [1, c] at positions ``[p0, p0+c)``, ``table`` [NB] int64, ``at`` the
    per-layer adapter lookup or None. Returns ``(kc, vc, row)`` — the last
    position's log-probs [V]."""
    dev = tokens.device
    c = tokens.shape[1]
    dh = embed["tok"].shape[1] // H
    h = embedding_lookup(embed["tok"], tokens) + embed["pos"][p0:p0 + c]
    idx = p0 + torch.arange(c, device=dev)
    phys = table[idx // bs]
    off = idx % bs
    span = table.shape[0] * bs
    live = (torch.arange(span, device=dev)[None, :]
            <= idx[:, None])[None, None]
    for li, bp in enumerate(blocks):
        q, k, v = _dense_qkv(bp, h, H,                     # [1, H, c, dh]
                             None if at is None else at(li))
        _paged_scatter(kc, li, phys, off, k[0].transpose(0, 1))
        _paged_scatter(vc, li, phys, off, v[0].transpose(0, 1))
        krow = _paged_gather(kc, li, table).float()        # [H, span, dh]
        vrow = _paged_gather(vc, li, table).float()
        scores = torch.einsum("bhqd,hkd->bhqk", q, krow) / math.sqrt(dh)
        scores = torch.where(live, scores, -math.inf)
        a = torch.einsum("bhqk,hkd->bhqd", torch.softmax(scores, dim=-1),
                         vrow)
        h = _dense_attn_tail(bp, h, a)
    return kc, vc, _head_logprobs(head, h[:, -1])[0]


def make_paged_decode_step(stages, cfg: GPTConfig, max_len: int,
                           block_size: int, cache_dtype=None, mesh=None,
                           kernel: str = "dense", adapters: bool = False,
                           device=None):
    """Paged serving decode tick: ``step(params, kc, vc, toks [S], pos [S],
    tables [S, NB], key_data [S, 2], temps [S], top_ks [S], top_ps [S]) ->
    (kc, vc, next_toks [S], next_key_data [S, 2])``.

    ONE batched token step over all slots: each slot's new K/V lands in
    physical block ``tables[s, pos // bs]`` at offset ``pos % bs`` (in
    place) before attention reads it. The engine routes non-decoding
    slots to the trash block 0 (``pos = 0``, all-trash table): their
    writes all land there, where no real table points, so duplicate
    indices in that scatter are harmless.

    ``kernel="fused"`` attends through the CUDA paged-attention kernel
    (one read of the resident K/V per layer); ``"dense"`` gathers each
    slot's table span and runs masked softmax einsums (gather, then a
    second read). Quantised pools dequantise inside either path.
    ``adapters=True`` appends ``(bank, aids [S])``: each slot's q and v
    take its adapter row's delta before either attention path."""
    _validate_paged_build(stages, cfg, max_len, block_size,
                          "make_paged_decode_step", cache_dtype, mesh)
    _check_attn_kernel(kernel, "make_paged_decode_step")
    dev = resolve_device(device)

    @torch.no_grad()
    def step(params, kc, vc, toks, pos, tables, key_data, temps, top_ks,
             top_ps, bank=None, aids=None):
        embed, blocks, head = _merged_stage_trees(params)
        at = _bank_lookup(adapters, bank, aids, dev,
                          "make_paged_decode_step")
        kc, vc, rows = _paged_decode_fwd(
            blocks, embed, head, kc, vc, _on(toks, dev, torch.int64),
            _on(pos, dev, torch.int64), _on(tables, dev, torch.int64),
            cfg.n_heads, block_size, kernel, at=at)
        toks2, kd2 = _sample_dyn(rows, _on(key_data, dev, torch.int64),
                                 *_sampling_tensors(rows.shape[0], temps,
                                                    top_ks, top_ps, dev))
        return kc, vc, toks2, kd2

    return step


def _paged_decode_fwd(blocks, embed, head, kc, vc, toks, pos, tables, H, bs,
                      kernel="dense", at=None):
    """The batched one-token-per-slot step's forward: ``toks``/``pos``
    [S] and ``tables`` [S, NB] int64. Scatter (and quantise) happens
    before either attention path reads, so the new token's row is visible
    at its own position. Returns ``(kc, vc, rows)`` — log-probs [S, V]."""
    h = (embedding_lookup(embed["tok"], toks[:, None])
         + embed["pos"][pos][:, None])                      # [S, 1, d]
    phys = tables.gather(1, (pos // bs)[:, None])[:, 0]
    off = pos % bs
    tables_k = tables.to(torch.int32)
    qpos_k = pos.to(torch.int32)[:, None].contiguous()
    for li, bp in enumerate(blocks):
        q, knew, vnew = _dense_qkv(bp, h, H,               # [S, H, 1, dh]
                                   None if at is None else at(li))
        _paged_scatter(kc, li, phys, off, knew[:, :, 0, :])
        _paged_scatter(vc, li, phys, off, vnew[:, :, 0, :])
        a = _paged_attend(kc, vc, li, q, tables_k, qpos_k, bs, toks.device,
                          kernel)
        h = _dense_attn_tail(bp, h, a)
    return kc, vc, _head_logprobs(head, h[:, 0])


def make_paged_block_copy():
    """The copy-on-write op: ``copy(kc, vc, dst, src) -> (kc, vc)``
    duplicates physical block ``src`` into ``dst`` across every layer, in
    place. A :class:`QuantKV` buffer copies its scale plane with its
    data — a copy that moved rows without their scales would silently
    rescale the destination block."""

    @torch.no_grad()
    def copy(kc, vc, dst, src):
        dst, src = int(dst), int(src)
        for buf in (kc, vc):
            for leaf in (buf if isinstance(buf, QuantKV) else (buf,)):
                leaf[:, dst] = leaf[:, src]
        return kc, vc

    return copy


# -- speculative decoding --------------------------------------------------------
#
# A small draft model proposes tokens with cheap sequential steps over its
# dense slot pool; the target scores all of them in one batched K-token
# verify step over its own pool (paged blocks or dense slot rows) and
# emits the longest prefix it agrees
# with, plus its own token at the first disagreement: 1..K tokens per slot
# per tick, from one draft loop and one target pass.
#
# Index discipline: a slot at position p with pending input t0 would
# solo-decode by consuming t0@p -> g0, g0@p+1 -> g1, ... The draft's K
# steps consume t0, d0, .., d_{K-2} at p..p+K-1 and propose d0..d_{K-1};
# verify consumes [t0, d0, .., d_{K-2}] at p..p+K-1 in one forward, and
# its row r_j is exactly the row solo decode samples token j+1 from, as
# long as d0..d_{j-1} matched. Greedy acceptance emits argmax(r_j) up to
# and including the first mismatch, so greedy speculative streams equal
# solo decode token for token. The last proposal d_{K-1} is never
# verified: that step keeps the draft cache one position ahead, so a tick
# that accepts everything needs no catch-up step.
#
# Verify writes all K positions before it knows how many survive.
# Positions inside the slot's remaining budget (j < valid_n) land in its
# own blocks (or row), where the next tick overwrites them before they can
# be attended; positions past it go to the trash block 0 (paged) or the
# never-live row max_len - 1 (dense), so a rejected tail never lands past
# the reservation or in a neighbour's blocks.
#
# Sampled requests use residual rejection: accept draft token d with
# probability min(1, p(d)/q(d)) on the filtered target/draft
# distributions, else emit a sample from the normalised positive part of
# p - q; the first rejection ends the slot's tick. The request's key
# spends TWO splits on a rejected position (the accept draw, then the
# residual draw), so sampled speculative streams are deterministic per
# seed but not the solo stream; only greedy carries that anchor. The
# draft samples from its own key stream (``serve/request.py::
# draft_key_data``).

def _check_spec_k(spec_k: int, caller: str) -> None:
    if spec_k < 2:
        raise ValueError(
            f"{caller}: spec_k must be >= 2 (spec_k=1 is plain one-token "
            f"decode — use the decode step), got {spec_k}")


def _spec_accept_sampled(rows, drafts, draft_rows, valid_n, key_data,
                         temperature, top_k, top_p):
    """Residual-rejection acceptance for every slot at once: ``rows``
    [S, K, V], ``drafts`` [S, K-1], ``draft_rows`` [S, K-1, V] ->
    ``(toks [S, K], n_acc [S], key_data [S, 2])``; ``toks[s, :n_acc[s]]``
    are slot s's emitted tokens. A host loop over the K positions; the
    caller keeps only the sampled slots' results (``temperature`` is
    guarded so greedy rows stay finite)."""
    S, K, V = rows.shape
    safe_t = torch.where(temperature > 0, temperature,
                         torch.ones_like(temperature))[:, None]
    kd = key_data
    alive = torch.ones(S, dtype=torch.bool, device=rows.device)
    toks, emits = [], []
    for j in range(K):
        nk, ks = _rng.split(kd)                    # _sample_dyn's split
        pt_log = _filter_top_dyn(rows[:, j] / safe_t, top_k, top_p)
        pt = torch.softmax(pt_log, dim=-1)
        jj = min(j, K - 2)
        d = drafts[:, jj].long()
        qt = torch.softmax(_filter_top_dyn(draft_rows[:, jj] / safe_t,
                                           top_k, top_p), dim=-1)
        pd = pt.gather(1, d[:, None])[:, 0]
        qd = qt.gather(1, d[:, None])[:, 0]
        accept = _rng.uniform(ks) < torch.clamp(
            pd / torch.clamp_min(qd, 1e-30), max=1.0)
        # a rejection spends one more split on the residual draw; an empty
        # residual (q >= p wherever it matters, a numerical corner) falls
        # back to the filtered target distribution
        nk2, kr = _rng.split(nk)
        resid = torch.clamp_min(pt - qt, 0.0)
        resid_log = torch.where(resid.sum(-1, keepdim=True) > 0,
                                torch.log(torch.clamp_min(resid, 1e-38)),
                                pt_log)
        r_tok = torch.argmax(resid_log + _rng.gumbel(kr, V), dim=-1)
        # the bonus row (j == K-1 has no draft): a plain solo-style sample
        bonus = torch.argmax(pt_log + _rng.gumbel(ks, V), dim=-1)
        has_draft = j < K - 1
        tok = (torch.where(accept, d, r_tok) if has_draft else bonus)
        kd_next = (torch.where(~accept[:, None], nk2, nk) if has_draft
                   else nk)
        emit = alive & (j < valid_n)
        kd = torch.where(emit[:, None], kd_next, kd)
        alive = emit & accept & has_draft
        toks.append(tok)
        emits.append(emit)
    return (torch.stack(toks, 1).to(torch.int32),
            torch.stack(emits, 1).sum(1).to(torch.int32), kd)


def _spec_accept_rows(rows, drafts, draft_rows, valid_n, key_data, temps,
                      top_ks, top_ps, any_hot: bool | None = None):
    """Speculative acceptance over every slot: ``(rows [S, K, V], drafts
    [S, K], draft_rows [S, K, V] — the propose outputs as they are, of
    which the first K-1 proposals are verified — valid_n [S], key_data
    [S, 2], temps/top_ks/top_ps [S]) -> (toks [S, K], n_acc [S], key_data
    [S, 2])``.

    Greedy (``temps[s] == 0``): the tokens are the target's argmaxes and
    the emitted count is one more than the leading run of draft == argmax
    matches, capped at ``valid_n``; no key is consumed, so the key stream
    stays aligned with solo decode. Sampled: :func:`_spec_accept_sampled`.
    ``any_hot`` (None: read from ``temps``) says whether any slot samples;
    an all-greedy tick skips the sampled loop on the host."""
    g = torch.argmax(rows, dim=-1).to(torch.int32)          # [S, K]
    lead = torch.cumprod((drafts[:, :-1] == g[:, :-1]).to(torch.int32),
                         dim=1)
    m_greedy = torch.minimum(1 + lead.sum(1), valid_n).to(torch.int32)
    if any_hot is None:
        any_hot = bool((temps > 0).any())
    if not any_hot:
        return g, m_greedy, key_data
    toks_s, n_s, kd_s = _spec_accept_sampled(
        rows, drafts[:, :-1], draft_rows[:, :-1], valid_n, key_data, temps,
        top_ks, top_ps)
    sm = temps > 0
    return (torch.where(sm[:, None], toks_s, g),
            torch.where(sm, n_s, m_greedy),
            torch.where(sm[:, None], kd_s, key_data))


def make_slot_propose(stages, cfg: GPTConfig, max_len: int, spec_k: int,
                      cache_dtype=None, device=None):
    """The draft proposer: ``propose(params, kc, vc, toks [S], pos [S],
    key_data [S, 2], temps [S], top_ks [S], top_ps [S]) -> (kc, vc,
    drafts [S, K], draft_rows [S, K, V], key_data [S, 2])``.

    ``spec_k`` sequential draft decode steps over the draft's dense slot
    pool (``kc``/``vc`` updated in place). Step j consumes the carried
    token at position ``pos + j``, clamped to the never-live trash row
    ``max_len - 1`` past the budget, with the decode tick's per-slot math,
    so the draft's K/V rows stay valid for every accepted continuation.
    ``key_data`` is the requests' draft key stream; greedy proposals
    consume none of it. The log-prob rows feed the sampled acceptance."""
    _validate_slot_build(stages, cfg, max_len, "make_slot_propose",
                         cache_dtype)
    _check_spec_k(spec_k, "make_slot_propose")
    dev = resolve_device(device)
    H, ml = cfg.n_heads, max_len

    @torch.no_grad()
    def propose(params, kc, vc, toks, pos, key_data, temps, top_ks, top_ps):
        embed, blocks, head = _merged_stage_trees(params)
        tok = _on(toks, dev, torch.int64)
        pos = _on(pos, dev, torch.int64)
        kd = _on(key_data, dev, torch.int64)
        knobs = _sampling_tensors(tok.shape[0], temps, top_ks, top_ps, dev)
        drafts, rows = [], []
        for j in range(spec_k):
            kc, vc, row = _slot_decode_fwd(blocks, embed, head, kc, vc, tok,
                                           torch.clamp(pos + j, max=ml - 1),
                                           H)
            nxt, kd = _sample_dyn(row, kd, *knobs)
            tok = nxt.long()
            drafts.append(nxt)
            rows.append(row)
        return kc, vc, torch.stack(drafts, 1), torch.stack(rows, 1), kd

    return propose


def _verify_positions(pos, valid_n, K, ml):
    """The dense verify's position plan: queries at ``pos + j`` (clamped
    in-table) and their K/V writes, routed to the never-live trash row
    ``ml - 1`` once past the slot's budget (``j >= valid_n``)."""
    j = torch.arange(K, device=pos.device)[None, :]
    qpos = torch.clamp(pos[:, None] + j, max=ml - 1)            # [S, K]
    wpos = torch.where(j < valid_n[:, None], qpos, ml - 1)
    return qpos, wpos


def _slot_verify_fwd(blocks, embed, head, kc, vc, xs, qpos, wpos, H,
                     at=None):
    """The K-tokens-per-slot verify forward over the dense slot pool:
    ``xs`` [S, K] input tokens at query positions ``qpos`` [S, K], each
    position's K/V written at ``wpos`` [S, K] (``qpos`` in budget, the
    trash row past it) before attention reads the row. The per-position
    math is the decode tick's (:func:`_dense_block_step_slots`): the same
    projections and the same masked-row softmax. Returns ``(kc, vc,
    rows)``, log-probs [S, K, V]."""
    S = xs.shape[0]
    h = embedding_lookup(embed["tok"], xs) + embed["pos"][qpos]  # [S, K, d]
    ml = kc.shape[-2]
    live = (torch.arange(ml, device=xs.device)[None, None, None, :]
            <= qpos[:, None, :, None])                           # [S,1,K,ml]
    rows = torch.arange(S, device=xs.device)[:, None]
    for li, bp in enumerate(blocks):
        q, knew, vnew = _dense_qkv(bp, h, H,                    # [S, H, K, dh]
                                   None if at is None else at(li))
        dh = q.shape[-1]
        kl, vl = kc[li], vc[li]                                  # [S, H, ml, dh]
        kl[rows, :, wpos] = knew.transpose(1, 2).to(kl.dtype)
        vl[rows, :, wpos] = vnew.transpose(1, 2).to(vl.dtype)
        scores = torch.einsum("bhqd,bhkd->bhqk", q, kl.float()) / math.sqrt(dh)
        scores = torch.where(live, scores, -math.inf)
        a = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1),
                         vl.float())
        h = _dense_attn_tail(bp, h, a)
    return kc, vc, _head_logprobs(head, h)


def make_slot_verify_step(stages, cfg: GPTConfig, max_len: int, spec_k: int,
                          cache_dtype=None, mesh=None, adapters: bool = False,
                          device=None):
    """The target's verify tick over the dense slot pool: ``verify(params,
    kc, vc, toks [S], pos [S], drafts [S, K], draft_rows [S, K, V],
    valid_n [S], key_data [S, 2], temps [S], top_ks [S], top_ps [S]) ->
    (kc, vc, toks [S, K], n_acc [S], key_data [S, 2])``.

    ONE batched forward scores all ``spec_k`` positions of every slot
    (inputs ``[t0, d0, .., d_{K-2}]`` at ``pos .. pos+K-1``) and runs
    :func:`_spec_accept_rows`. ``valid_n`` is each slot's ``min(spec_k,
    remaining budget)`` (0 for non-decoding slots): it bounds emission
    and which positions write real K/V; the rest go to the never-live
    trash row ``max_len - 1``. ``kc``/``vc`` are updated in place. Plain
    attention: K4 is the paged pool's kernel. ``adapters=True`` appends
    ``(bank, aids [S])``."""
    _validate_slot_build(stages, cfg, max_len, "make_slot_verify_step",
                         cache_dtype)
    _check_spec_k(spec_k, "make_slot_verify_step")
    if mesh is not None:
        raise _roadmap.not_ported("make_slot_verify_step: tensor-parallel "
                                  "serving (mesh)", _roadmap.PARALLEL_AXES)
    dev = resolve_device(device)
    K, ml = spec_k, max_len

    @torch.no_grad()
    def verify(params, kc, vc, toks, pos, drafts, draft_rows, valid_n,
               key_data, temps, top_ks, top_ps, bank=None, aids=None):
        embed, blocks, head = _merged_stage_trees(params)
        at = _bank_lookup(adapters, bank, aids, dev, "make_slot_verify_step")
        toks = _on(toks, dev, torch.int64)
        drafts = _on(drafts, dev, torch.int64)
        valid_n = _on(valid_n, dev, torch.int64)
        xs = torch.cat([toks[:, None], drafts[:, :-1]], dim=1)
        qpos, wpos = _verify_positions(_on(pos, dev, torch.int64), valid_n,
                                       K, ml)
        kc, vc, rows = _slot_verify_fwd(blocks, embed, head, kc, vc, xs,
                                        qpos, wpos, cfg.n_heads, at=at)
        any_hot = (None if isinstance(temps, torch.Tensor)
                   else bool(np.any(np.asarray(temps) > 0)))
        knobs = _sampling_tensors(toks.shape[0], temps, top_ks, top_ps, dev)
        toks2, n_acc, kd2 = _spec_accept_rows(
            rows, drafts, _on(draft_rows, dev, torch.float32), valid_n,
            _on(key_data, dev, torch.int64), *knobs, any_hot=any_hot)
        return kc, vc, toks2, n_acc, kd2

    return verify


def _paged_verify_routing(pos, valid_n, tables, K, bs, ml):
    """Query positions ``pos + j`` (clamped in-table) and each position's
    write target: its physical block and offset, the trash block 0 once
    past the slot's budget (``j >= valid_n``)."""
    j = torch.arange(K, device=pos.device)[None, :]
    qpos = torch.clamp(pos[:, None] + j, max=ml - 1)           # [S, K]
    NB = tables.shape[1]
    phys = tables.gather(1, torch.clamp(qpos // bs, 0, NB - 1))
    wphys = torch.where(j < valid_n[:, None], phys, 0)         # 0 == trash
    return qpos, wphys, qpos % bs


def _paged_verify_fwd(blocks, embed, head, kc, vc, xs, qpos, wphys, woff,
                      tables, H, bs, kernel="dense", at=None):
    """The K-tokens-per-slot verify forward over the paged pool: each
    position's K/V lands at ``(wphys, woff)`` before attention reads it;
    attention runs over the slot's table span with the ``[S, K]`` ``qpos``
    plan as the per-query mask — the CUDA kernel K4 at K = spec_k
    (``kernel="fused"``) or its plain version (``"dense"``). ``xs``,
    ``qpos``, ``wphys``, ``woff`` [S, K] and ``tables`` [S, NB] int64.
    Returns ``(kc, vc, rows)``, log-probs [S, K, V]."""
    h = embedding_lookup(embed["tok"], xs) + embed["pos"][qpos]   # [S, K, d]
    tables_k = tables.to(torch.int32)
    qpos_k = qpos.to(torch.int32).contiguous()
    for li, bp in enumerate(blocks):
        q, knew, vnew = _dense_qkv(bp, h, H,               # [S, H, K, dh]
                                   None if at is None else at(li))
        _paged_scatter(kc, li, wphys, woff, knew.transpose(1, 2))
        _paged_scatter(vc, li, wphys, woff, vnew.transpose(1, 2))
        a = _paged_attend(kc, vc, li, q, tables_k, qpos_k, bs, xs.device,
                          kernel)
        h = _dense_attn_tail(bp, h, a)
    return kc, vc, _head_logprobs(head, h)


def make_paged_verify_step(stages, cfg: GPTConfig, max_len: int,
                           block_size: int, spec_k: int, cache_dtype=None,
                           mesh=None, kernel: str = "dense",
                           adapters: bool = False, device=None):
    """The target's verify tick over the paged pool: ``verify(params, kc,
    vc, toks [S], pos [S], drafts [S, K], draft_rows [S, K, V],
    valid_n [S], tables [S, NB], key_data [S, 2], temps [S], top_ks [S],
    top_ps [S]) -> (kc, vc, toks [S, K], n_acc [S], key_data [S, 2])``.

    One batched forward scores all ``spec_k`` positions of every slot
    (inputs ``[t0, d0, .., d_{K-2}]`` at ``pos .. pos+K-1``) and runs
    :func:`_spec_accept_rows`. ``valid_n`` is each slot's
    ``min(spec_k, remaining budget)`` (0 for non-decoding slots): it
    bounds emission and which positions write real K/V; the rest go to
    the trash block. The engine must have made positions
    ``pos .. pos+valid_n-1`` writable first. ``kernel="fused"`` attends
    through K4 with ``spec_k`` queries per slot, one launch per layer.
    ``adapters=True`` appends ``(bank, aids [S])``: the verify rows are
    the adapted model's, so they decide every emission."""
    _validate_paged_build(stages, cfg, max_len, block_size,
                          "make_paged_verify_step", cache_dtype, mesh)
    _check_spec_k(spec_k, "make_paged_verify_step")
    _check_attn_kernel(kernel, "make_paged_verify_step")
    dev = resolve_device(device)
    K, ml = spec_k, max_len

    @torch.no_grad()
    def verify(params, kc, vc, toks, pos, drafts, draft_rows, valid_n,
               tables, key_data, temps, top_ks, top_ps, bank=None,
               aids=None):
        embed, blocks, head = _merged_stage_trees(params)
        at = _bank_lookup(adapters, bank, aids, dev,
                          "make_paged_verify_step")
        toks = _on(toks, dev, torch.int64)
        pos = _on(pos, dev, torch.int64)
        drafts = _on(drafts, dev, torch.int64)
        valid_n = _on(valid_n, dev, torch.int64)
        tables = _on(tables, dev, torch.int64)
        xs = torch.cat([toks[:, None], drafts[:, :-1]], dim=1)
        qpos, wphys, woff = _paged_verify_routing(pos, valid_n, tables, K,
                                                  block_size, ml)
        kc, vc, rows = _paged_verify_fwd(blocks, embed, head, kc, vc, xs,
                                         qpos, wphys, woff, tables,
                                         cfg.n_heads, block_size, kernel,
                                         at=at)
        any_hot = (None if isinstance(temps, torch.Tensor)
                   else bool(np.any(np.asarray(temps) > 0)))
        knobs = _sampling_tensors(toks.shape[0], temps, top_ks, top_ps, dev)
        toks2, n_acc, kd2 = _spec_accept_rows(
            rows, drafts, _on(draft_rows, dev, torch.float32), valid_n,
            _on(key_data, dev, torch.int64), *knobs, any_hot=any_hot)
        return kc, vc, toks2, n_acc, kd2

    return verify


def _check_spec_tick_build(cfg: GPTConfig, draft_cfg: GPTConfig,
                           caller: str) -> None:
    if draft_cfg.vocab != cfg.vocab:
        raise ValueError(
            f"{caller}: draft vocab {draft_cfg.vocab} != target vocab "
            f"{cfg.vocab}")


def make_slot_spec_tick(stages, cfg: GPTConfig, draft_stages,
                        draft_cfg: GPTConfig, max_len: int, spec_k: int,
                        cache_dtype=None, adapters: bool = False,
                        device=None):
    """One speculative tick over dense slot pools: ``tick(dparams, dkc,
    dvc, params, kc, vc, toks [S], pos [S], valid_n [S], dkd [S, 2],
    kd [S, 2], temps, top_ks, top_ps) -> (dkc, dvc, kc, vc, toks [S, K],
    n_acc [S], key_data, draft_key_data)`` — :func:`make_slot_propose`
    over the draft's pool composed with :func:`make_slot_verify_step`
    over the target's, the proposals staying on the device between the
    two, so the greedy bit-exactness contract carries over unchanged.
    ``adapters=True`` appends ``(bank, aids [S])``, which ride the verify
    side only: the draft proposes as the base model."""
    _check_spec_tick_build(cfg, draft_cfg, "make_slot_spec_tick")
    propose = make_slot_propose(draft_stages, draft_cfg, max_len, spec_k,
                                cache_dtype, device=device)
    verify = make_slot_verify_step(stages, cfg, max_len, spec_k,
                                   cache_dtype, adapters=adapters,
                                   device=device)
    dev = resolve_device(device)

    def tick(dparams, dkc, dvc, params, kc, vc, toks, pos, valid_n, dkd, kd,
             temps, top_ks, top_ps, bank=None, aids=None):
        toks, pos = _on(toks, dev, torch.int64), _on(pos, dev, torch.int64)
        dkc, dvc, drafts, qrows, dkd2 = propose(
            dparams, dkc, dvc, toks, pos, dkd, temps, top_ks, top_ps)
        kc, vc, otoks, nacc, kd2 = verify(
            params, kc, vc, toks, pos, drafts, qrows, valid_n, kd, temps,
            top_ks, top_ps, bank, aids)
        return dkc, dvc, kc, vc, otoks, nacc, kd2, dkd2

    return tick


def make_paged_spec_tick(stages, cfg: GPTConfig, draft_stages,
                         draft_cfg: GPTConfig, max_len: int,
                         block_size: int, spec_k: int, cache_dtype=None,
                         kernel: str = "dense", adapters: bool = False,
                         device=None):
    """One speculative tick: ``tick(dparams, dkc, dvc, params, kc, vc,
    toks [S], pos [S], valid_n [S], tables [S, NB], dkd [S, 2], kd [S, 2],
    temps, top_ks, top_ps) -> (dkc, dvc, kc, vc, toks [S, K], n_acc [S],
    key_data, draft_key_data)`` — :func:`make_slot_propose` over the
    draft's dense pool composed with :func:`make_paged_verify_step` over
    the target's paged pool (``kernel="fused"``: K4 at K = spec_k). The
    proposals stay on the device between the two. A quantised target
    cache gives the draft an f32 pool: dense slot rows hold no scales.
    ``adapters=True`` appends ``(bank, aids [S])``, which ride the verify
    side only: the draft proposes as the base model (a wrong proposal
    costs acceptance rate, never correctness)."""
    _check_spec_tick_build(cfg, draft_cfg, "make_paged_spec_tick")
    draft_cd = None if _is_quantized_dtype(cache_dtype) else cache_dtype
    propose = make_slot_propose(draft_stages, draft_cfg, max_len, spec_k,
                                draft_cd, device=device)
    verify = make_paged_verify_step(stages, cfg, max_len, block_size,
                                    spec_k, cache_dtype, kernel=kernel,
                                    adapters=adapters, device=device)
    dev = resolve_device(device)

    def tick(dparams, dkc, dvc, params, kc, vc, toks, pos, valid_n, tables,
             dkd, kd, temps, top_ks, top_ps, bank=None, aids=None):
        toks, pos = _on(toks, dev, torch.int64), _on(pos, dev, torch.int64)
        dkc, dvc, drafts, qrows, dkd2 = propose(
            dparams, dkc, dvc, toks, pos, dkd, temps, top_ks, top_ps)
        kc, vc, otoks, nacc, kd2 = verify(
            params, kc, vc, toks, pos, drafts, qrows, valid_n, tables, kd,
            temps, top_ks, top_ps, bank, aids)
        return dkc, dvc, kc, vc, otoks, nacc, kd2, dkd2

    return tick
