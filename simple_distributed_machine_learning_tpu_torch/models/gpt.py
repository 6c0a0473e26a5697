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

Training runs each stage's ``Stage.apply`` (:func:`_stage_apply`): blocks
whose attention is the dense core or, with ``attn_impl="flash"``, the CUDA
flash kernels K1-K3 (``ops/flash_attention.py``), and whose MLP is dense
or, with ``n_experts > 0``, a mixture of experts (``parallel/expert.py``;
the stage then returns ``(y, aux)``), with dropout drawn from an explicit
``torch.Generator``. Three mesh axes shard a stage: ``n_tensor_parallel``
(Megatron blocks over ``Stage.shards``), ``n_seq`` (the token axis in
chunks, attention by ring or Ulysses) and ``n_expert_parallel`` (the
experts over ``Stage.expert_shards``, tokens dispatched by all-to-all).

The serving programs are plain closures over the shape scalars — the
JAX package's ``jit`` builders without ``jit``: PyTorch runs eagerly.

- :func:`make_decoder` — full-prefix decode, the training forward rerun
  per token: every single-device build (MoE and flash included);
  :func:`generate` and :func:`decoder_from_pipeline` wrap it and the
  cached decoder;
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

from simple_distributed_machine_learning_tpu_torch._device import (
    resolve_device,
)
from simple_distributed_machine_learning_tpu_torch._tree import (
    Tree,
    to_module,
    tree_leaves,
)
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
    ring_attention,
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
from simple_distributed_machine_learning_tpu_torch.parallel.expert import (
    is_expert_leaf,
    moe_init,
)
from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (
    Stage,
    fused_reference,
)
from simple_distributed_machine_learning_tpu_torch.parallel.sequence import (
    SeqShards,
    ulysses_attention,
)

# sampling-param sentinels: 0 disables top-k, anything > 1 disables top-p
_NO_TOP_K = 0
_NO_TOP_P = 2.0


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """The JAX package's ``GPTConfig``, field for field and check for
    check, so one config describes one model in both packages and a config
    one rejects the other rejects too. Training builds every config
    (``ring``/``ulysses`` at ``n_seq == 1`` are the dense math, as in the
    JAX package); the serving programs take single-device dense-MLP
    builds, refusing MoE and ``n_seq > 1`` with the JAX package's
    ``ValueError`` texts; ``n_tensor_parallel > 1`` serves head-sharded
    over a model mesh."""
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


def _check_ported(cfg: GPTConfig, caller: str, training: bool = False,
                  decode: bool = False) -> None:
    """Raise for a config a program cannot run. Training runs every config.
    The serving programs take dense-MLP builds, refusing MoE (MoE capacity
    is a full-sequence quantity) and ``n_seq > 1`` with the JAX package's
    texts (``decode``: the solo decoders' wording); ``n_tensor_parallel >
    1`` serves over a model mesh (:func:`_validate_tp_serve`)."""
    if training:
        return
    if cfg.n_experts > 0:
        raise ValueError(
            f"{caller} supports dense-MLP blocks only — MoE capacity is a "
            f"full-sequence quantity, so per-token cached routing would "
            f"change overflow behavior; use make_decoder" if decode else
            f"{caller} supports dense-MLP blocks only — MoE capacity is a "
            f"full-sequence quantity (make_cached_decoder's restriction)")
    if cfg.n_seq > 1:
        raise ValueError(
            f"{caller} is single-device; rebuild the stages with n_seq=1")


def _check_unsharded(stages, caller: str) -> None:
    """The serving programs slice a dense build themselves (the JAX
    ``_validate_slot_build`` rule)."""
    if any(getattr(s, "shards", None) is not None
           or getattr(s, "expert_shards", None) is not None for s in stages):
        raise ValueError(
            f"{caller} needs unsharded stage params — gather tensor/expert "
            f"shards into a dense build first")


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
    """One pre-LN transformer block: causal MHA + GELU MLP, or + a
    mixture of experts (``moe``: the router and the ``[E, ...]``-stacked
    experts, ``parallel/expert.py::moe_init``'s tree)."""

    def __init__(self, tree: dict) -> None:
        super().__init__()
        self.ln1 = LayerNorm(**tree["ln1"])
        self.attn = Attention(**tree["attn"])
        self.ln2 = LayerNorm(**tree["ln2"])
        if "moe" in tree:
            self.moe = to_module(tree["moe"])
        else:
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
    tree = {"ln1": layer_norm_init(d), "attn": mha_init(gen, d, cfg.n_heads),
            "ln2": layer_norm_init(d)}
    if cfg.n_experts > 0:
        tree["moe"] = moe_init(gen, d, dff, cfg.n_experts)
    else:
        tree["mlp_in"] = linear_init(gen, d, dff)
        tree["mlp_out"] = linear_init(gen, dff, d)
    return tree


def make_gpt_stages(seed=0, cfg: GPTConfig = GPTConfig(), n_stages: int = 2,
                    device=None) -> tuple[list[Stage], int, tuple[int, int]]:
    """Build the GPT as ``n_stages`` pipeline stages on ``device``.

    ``seed`` is an int or a CPU ``torch.Generator``; weights are drawn on
    the CPU (one seed, one model, whatever the device) and moved.
    Returns ``(stages, wire_dim, (seq_len, vocab))`` like the JAX builder;
    each stage's ``params`` is a :class:`GPT` module holding its
    contiguous share of the blocks.

    With ``cfg.n_tensor_parallel > 1`` the stages are tensor-parallel
    (Megatron, ``Stage.shards``): every block's QKV/O projections shard by
    head and the MLP hidden width column -> row, each shard sliced from
    the same dense init (:func:`_slice_tp_stage`), so the run is the dense
    run to float tolerance. Build the ``Pipeline`` on a ``make_mesh(...,
    n_model=cfg.n_tensor_parallel)`` mesh.

    With ``cfg.n_seq > 1`` the stages are sequence-parallel: ``in_shape``
    and ``wire_dim`` are per chunk (``seq_len / n_seq`` tokens), the
    embedding stage offsets each chunk's positions by its global start,
    and attention runs as ``cfg.attn_impl`` (ring or Ulysses) across the
    chunks; build on a ``make_mesh(..., n_seq=cfg.n_seq)`` mesh. The
    returned out_dim stays global.

    With ``cfg.n_expert_parallel > 1`` every MoE block's experts shard
    ``E / D`` per expert coordinate (``Stage.expert_shards``, sliced from
    the same dense init, everything else replicated); each coordinate
    routes its ``b / D`` sequences of a microbatch and an all-gather makes
    the MLP output whole again, so the run is the dense-MoE run. Build on a
    ``make_mesh(..., n_expert=cfg.n_expert_parallel)`` mesh.

    The decode programs need a dense single-device build of the same
    weights."""
    from simple_distributed_machine_learning_tpu_torch.parallel.staging import (
        contiguous_split,
    )
    dev = resolve_device(device)
    _check_ported(cfg, "make_gpt_stages", training=True)
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
    mp, ep = cfg.n_tensor_parallel, cfg.n_expert_parallel
    apply = functools.partial(
        _stage_apply_tp if mp > 1 else _stage_apply_ep if ep > 1
        else _stage_apply, cfg=cfg)
    t_loc = cfg.seq_len // cfg.n_seq            # tokens per seq chunk
    stages = []
    for s in range(n_stages):
        first, last = s == 0, s == n_stages - 1
        in_shape = (t_loc,) if first else (t_loc, cfg.d_model)
        tree = {"blocks": split[s]}
        if first:
            tree["embed"] = embed
        if last:
            tree["head"] = head
        if mp > 1:
            shards = tuple(GPT(**_slice_tp_stage(tree, m, mp)).to(dev)
                           for m in range(mp))
            stages.append(Stage(apply=apply, params=shards[0],
                                in_shape=in_shape, shards=shards))
        elif ep > 1:
            shards = tuple(GPT(**_slice_expert_shard(tree, e, cfg)).to(dev)
                           for e in range(ep))
            stages.append(Stage(apply=apply, params=shards[0],
                                in_shape=in_shape, expert_shards=shards))
        else:
            stages.append(Stage(apply=apply, params=GPT(**tree).to(dev),
                                in_shape=in_shape))
    return stages, t_loc * cfg.d_model, (cfg.seq_len, cfg.vocab)


def _stage_apply(params, x, key=None, deterministic=True, *, cfg, ep=None):
    """``Stage.apply(params, x, key, deterministic)``, the JAX signature:
    token ids ``[B, T]`` (integer, or float as the JAX wire carries them)
    on the first stage, hidden ``[B, T, d]`` after it -> hidden, or
    log-probs ``[B, T, V]`` on the last stage; with MoE blocks ``(y,
    aux)``, aux the blocks' load-balancing terms times
    ``cfg.moe_aux_weight``.

    ``params`` is the stage's :class:`GPT` module or a tree of tensors that
    indexes the same way (the pipeline's ``compute_dtype`` casts). ``key``
    is a ``torch.Generator`` on x's device (None = torch's default there)
    that the blocks' dropout draws from, in block order; with
    ``deterministic`` (or ``dropout_rate == 0``) it draws nothing. On a
    seq mesh ``x`` is this process's chunks (``parallel/sequence.py::
    SeqShards``), ``key`` one generator per chunk, and the output chunks
    come back the same way. ``ep`` (from :func:`_stage_apply_ep`): the
    expert-parallel stage's per-coordinate trees and the expert axis's
    view, for its MoE blocks."""
    seq = isinstance(x, SeqShards)
    xs = list(x) if seq else [x]
    if seq:
        t_loc = cfg.seq_len // cfg.n_seq
        offs = [q * t_loc for q in x.view.owned]
        gens = list(key) if key is not None else [None] * len(xs)
    else:
        offs, gens = [0], [key]
    if "embed" in params:
        hs = []
        for c, off in zip(xs, offs):
            ids = token_ids(c)                  # XLA's convert
            hs.append(embedding_lookup(params["embed"]["tok"], ids)
                      + params["embed"]["pos"][off:off + ids.shape[1]])
    else:
        hs = xs
    aux = None
    for i, bp in enumerate(params["blocks"]):
        layer = None if ep is None else ([t["blocks"][i] for t in ep[0]],
                                         ep[1])
        hs, a = _block_train(bp, hs, cfg, gens, deterministic,
                             x.view if seq else None, layer)
        if a is not None:
            aux = a if aux is None else aux + a
    if "head" in params:
        hs = [_head_logprobs(params["head"], h) for h in hs]
    out = SeqShards(hs, x.view) if seq else hs[0]
    if cfg.n_experts == 0:
        return out
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=hs[0].device)
    return out, cfg.moe_aux_weight * aux


def _slice_tp_block(bp: dict, m: int, mp: int, device=None) -> dict:
    """Model shard ``m``'s slice of one dense block's params (Megatron):
    QKV columns / O rows by head, MLP hidden width column -> row; norms
    and the MLP output bias replicated. Every leaf is a copy of its own
    (on ``device``; None: where it lies), so the optimizer updates each
    shard's replicas in place apart."""
    d = bp["attn"]["wq"].shape[0]
    dc = d // mp                      # head-aligned qkv column chunk
    hc = bp["mlp_in"]["w"].shape[1] // mp
    return _clone_tree({
        "ln1": bp["ln1"],
        "attn": {"wq": bp["attn"]["wq"][:, m * dc:(m + 1) * dc],
                 "wk": bp["attn"]["wk"][:, m * dc:(m + 1) * dc],
                 "wv": bp["attn"]["wv"][:, m * dc:(m + 1) * dc],
                 "wo": bp["attn"]["wo"][m * dc:(m + 1) * dc, :]},
        "ln2": bp["ln2"],
        "mlp_in": {"w": bp["mlp_in"]["w"][:, m * hc:(m + 1) * hc],
                   "b": bp["mlp_in"]["b"][m * hc:(m + 1) * hc]},
        "mlp_out": {"w": bp["mlp_out"]["w"][m * hc:(m + 1) * hc, :],
                    "b": bp["mlp_out"]["b"]},
    }, device)


def _slice_tp_stage(params: dict, m: int, mp: int) -> dict:
    """Model shard ``m``'s stage tree: blocks sliced, ``embed``/``head``
    replicated (stored per shard, like the MLP pair's output bias)."""
    out = {"blocks": [_slice_tp_block(bp, m, mp) for bp in params["blocks"]]}
    for k in ("embed", "head"):
        if params.get(k) is not None:
            out[k] = _clone_tree(params[k])
    return out


def _clone_tree(tree, device=None):
    """A copy of its own of every leaf of ``tree`` (dicts, or the GPT's
    containers) on ``device`` (None: where it lies), as plain dicts."""
    from simple_distributed_machine_learning_tpu_torch._tree import (
        _children,
    )
    kids = _children(tree)
    if kids is None:
        return tree.detach().to(device=device, copy=True)
    return {k: _clone_tree(v, device) for k, v in kids}


def _grad_sync_non_tp(shards, axis: str, path=(), sharded=None) -> list:
    """This process's shard trees on ``axis`` with every replicated leaf
    tied across them (``parallel/tensor.py::tie``: one value forward, the
    full gradient to each copy) and the sharded leaves (``sharded(path)``,
    default ``tensor.is_sharded_leaf``) as they are: per shard, a tree of
    plain dicts and lists."""
    from simple_distributed_machine_learning_tpu_torch._tree import (
        _children,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel.tensor import (  # noqa: E501
        is_sharded_leaf,
        tie,
    )
    sharded = is_sharded_leaf if sharded is None else sharded
    kids = _children(shards[0])
    if kids is None:
        if sharded(path):
            return list(shards)
        return [tie(shards, axis)] * len(shards)
    cols = {k: _grad_sync_non_tp([sh[k] for sh in shards], axis,
                                 path + (k,), sharded)
            for k, _ in kids}
    if isinstance(shards[0], (list, nn.ModuleList)):
        return [[cols[k][i] for k, _ in kids] for i in range(len(shards))]
    return [{k: cols[k][i] for k in cols} for i in range(len(shards))]


def _slice_expert_shard(tree: dict, e: int, cfg: GPTConfig) -> dict:
    """Expert coordinate ``e``'s stage tree: each block's ``experts``
    leaves sliced ``[e*E/D, (e+1)*E/D)`` on their leading axis, everything
    else copied whole (every leaf a copy of its own, so the optimizer
    updates each shard's replicas in place apart)."""
    per = cfg.n_experts // cfg.n_expert_parallel

    def cut(t, path=()):
        if isinstance(t, dict):
            return {k: cut(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, list):
            return [cut(v, path + (i,)) for i, v in enumerate(t)]
        t = t[e * per:(e + 1) * per] if is_expert_leaf(path) else t
        return t.detach().clone()

    return cut(tree)


def _stage_apply_ep(params, x, key=None, deterministic=True, *, cfg):
    """The expert-parallel ``Stage.apply``: ``params`` is this process's
    expert shards of the stage (``parallel/tensor.py::Shards`` on the
    expert axis, with its view; one shard's tree is a one-wide axis). The
    replicated leaves are tied across them and run once; each MoE block
    routes each coordinate's sequences through :func:`~..parallel.expert.
    moe_apply_ep`. Returns ``(y, aux)``, ``y`` the same on every expert
    coordinate."""
    from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (
        EXPERT_AXIS,
        AxisView,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel.tensor import (  # noqa: E501
        as_shards,
    )
    shards = as_shards(params)
    view = getattr(shards, "view", None) or AxisView.local(
        EXPERT_AXIS, cfg.n_expert_parallel)
    trees = _grad_sync_non_tp(list(shards), view.name,
                              sharded=is_expert_leaf)
    return _stage_apply(trees[0], x, key, deterministic, cfg=cfg,
                        ep=(trees, view))


def _stage_apply_tp(params, x, key=None, deterministic=True, *, cfg):
    """The tensor-parallel ``Stage.apply``: ``params`` is this process's
    :class:`~..parallel.tensor.Shards` of the stage (or one shard's tree);
    the stage's replicated leaves are tied across them, every block runs
    :func:`_block_apply_tp`, and the result is the replicated activation
    every model coordinate holds."""
    from simple_distributed_machine_learning_tpu_torch.parallel.tensor import (  # noqa: E501
        as_shards,
    )
    shards = as_shards(params)
    trees = _grad_sync_non_tp(list(shards), shards.axis)
    p0 = trees[0]
    if "embed" in p0:
        ids = token_ids(x)
        h = (embedding_lookup(p0["embed"]["tok"], ids)
             + p0["embed"]["pos"][:ids.shape[1]])
    else:
        h = x
    for i in range(len(p0["blocks"])):
        h = _block_apply_tp([t["blocks"][i] for t in trees], h, cfg, key,
                            deterministic, shards.group, shards.view)
    if "head" in p0:
        h = _head_logprobs(p0["head"], h)
    return h


def _block_apply_tp(shard_blocks, h, cfg: GPTConfig, gen,
                    deterministic: bool, group=None, view=None):
    """One transformer block, tensor-parallel over the model axis:
    ``shard_blocks`` are this process's shards of the block
    (:func:`_slice_tp_block`, replicated leaves tied), ``view`` the model
    axis (``mesh.AxisView``; None: every coordinate here); ``h`` is
    replicated and the return is too. QKV project onto each shard's
    ``H/mp`` heads, dense causal attention runs on them, and the output
    projection is row-parallel, closed by the sum over the model
    coordinates (``cfg.overlap='none'``) or the ring of
    ``parallel/overlap.py::ring_psum``.

    The MLP with ``'none'`` is column -> row, summed the same way, its
    bias added after. With ``'ring'`` it is the scattered pair (JAX
    ``gpt.py:_block_apply_tp``): each coordinate takes its ``1/mp`` row
    slice of the tokens, ``allgather_matmul`` re-gathers them under the
    column matmul, ``matmul_reducescatter`` ring-accumulates the row
    matmul's partial products, and ``ring_all_gather`` restores the
    replicated rows before the bias; ``B*T`` not divisible by ``mp``
    falls back to the ring-closed pair. Dropout draws on the replicated
    activations only, in the dense block's order, so every coordinate
    draws the same masks."""
    from simple_distributed_machine_learning_tpu_torch.parallel.overlap import (  # noqa: E501
        allgather_matmul,
        matmul_reducescatter,
        ring_all_gather,
        ring_psum,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel.tensor import (  # noqa: E501
        _model_view,
        grad_sync,
        model_sum,
    )

    def drop(t):
        return dropout(gen, t, cfg.dropout_rate, deterministic)

    mp = cfg.n_tensor_parallel
    ring = cfg.overlap == "ring"
    view = view or _model_view(shard_blocks, group)

    def close(parts):
        return ring_psum(parts, view)[0] if ring else model_sum(parts, group)

    rb = shard_blocks[0]
    h_loc = cfg.n_heads // mp
    hn = grad_sync(layer_norm(rb["ln1"], h), group, cfg.overlap, view)
    parts = []
    for bp in shard_blocks:
        q = _split_heads(hn @ bp["attn"]["wq"], h_loc)
        k = _split_heads(hn @ bp["attn"]["wk"], h_loc)
        v = _split_heads(hn @ bp["attn"]["wv"], h_loc)
        parts.append(_merge_heads(causal_attention_core(q, k, v))
                     @ bp["attn"]["wo"])
    h = h + drop(close(parts))
    hn2 = grad_sync(layer_norm(rb["ln2"], h), group, cfg.overlap, view)
    b, t, d = hn2.shape
    if ring and (b * t) % mp == 0:
        rows = hn2.reshape(b * t, d)
        n_loc = (b * t) // mp
        mids = allgather_matmul(
            [rows[i * n_loc:(i + 1) * n_loc] for i in view.owned],
            [bp["mlp_in"]["w"] for bp in shard_blocks], view)
        mids = [F.gelu(y + bp["mlp_in"]["b"], approximate="tanh")
                for y, bp in zip(mids, shard_blocks)]
        ys = matmul_reducescatter(
            mids, [bp["mlp_out"]["w"] for bp in shard_blocks], view)
        m = ring_all_gather(ys, view)[0].reshape(b, t, d)
    else:
        m = close([F.gelu(hn2 @ bp["mlp_in"]["w"] + bp["mlp_in"]["b"],
                          approximate="tanh") @ bp["mlp_out"]["w"]
                   for bp in shard_blocks])
    return h + drop(m + rb["mlp_out"]["b"])


def _block_train(bp, hs: list, cfg: GPTConfig, gens: list,
                 deterministic: bool, seq_view=None, ep=None):
    """One block of the training forward (the JAX package's
    ``_block_apply``) on ``hs``, the whole sequence as one tensor or this
    process's seq chunks (``seq_view`` their axis), each chunk's dropout
    drawn from its own generator: ln1, causal attention by
    ``cfg.attn_impl`` — the flash kernels (``ops/flash_attention.py``, K1
    forward and K2 + K3 in the backward), the dense core, or across the
    chunks ring or Ulysses — then dropout, residual, ln2, the tanh GELU
    MLP or the mixture of experts (``ep``: the expert-parallel shards and
    view), dropout, residual. ``ring``/``ulysses`` on one chunk are the
    dense math, as in the JAX package. Returns ``(hs, aux)``, aux None
    for a dense MLP."""
    def drop(x, g):
        return dropout(g, x, cfg.dropout_rate, deterministic)

    if seq_view is None:
        q, k, v = _dense_qkv(bp, hs[0], cfg.n_heads)
        if cfg.attn_impl == "flash":
            a = flash_attention(q, k, v, cfg.flash_block_q,
                                cfg.flash_block_k, device=hs[0].device)
        else:
            a = causal_attention_core(q, k, v)
        attn = [_merge_heads(a) @ bp["attn"]["wo"]]
    else:
        hn = SeqShards([layer_norm(bp["ln1"], h) for h in hs], seq_view)
        if cfg.attn_impl == "ring":
            attn = ring_attention(bp["attn"], hn, cfg.n_heads)
        else:
            attn = ulysses_attention(bp["attn"], hn, cfg.n_heads)
    hs = [h + drop(a, g) for h, a, g in zip(hs, attn, gens)]
    hn2 = [layer_norm(bp["ln2"], h) for h in hs]
    aux = None
    if "moe" in bp:
        ms, aux = _moe_train(bp, hn2, cfg, ep)
    else:
        ms = [linear(bp["mlp_out"], F.gelu(linear(bp["mlp_in"], x),
                                           approximate="tanh"))
              for x in hn2]
    return [h + drop(m, g) for h, m, g in zip(hs, ms, gens)], aux


def _moe_train(bp, hn2: list, cfg: GPTConfig, ep=None):
    """The MoE MLP of one block on each chunk ``[b, T, d]``: each sequence
    routes on its own (the JAX ``vmap``), capacity
    ``default_capacity(T, E, k, cfg.moe_capacity_factor)``. With ``ep``
    (``(trees, view)``: this process's expert coordinates' block trees,
    replicated leaves tied, and the expert axis) coordinate ``e`` routes
    sequences ``[e*b/D, (e+1)*b/D)`` through ``moe_apply_ep`` and the
    all-gather makes the output whole again. Returns ``(ms, aux)``, aux
    the mean load-balancing term summed over the chunks."""
    from simple_distributed_machine_learning_tpu_torch.parallel.expert import (  # noqa: E501
        default_capacity,
        moe_apply,
        moe_apply_ep,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (
        all_gather,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel.tensor import (  # noqa: E501
        Shards,
        grad_sync,
    )
    k = cfg.moe_top_k
    cap = default_capacity(hn2[0].shape[1], cfg.n_experts, k,
                           cfg.moe_capacity_factor)
    ms, aux = [], 0
    for x in hn2:
        if ep is None:
            m, aux_v = moe_apply(bp["moe"], x, k=k, capacity=cap)
        else:
            trees, view = ep
            D, b = view.size, x.shape[0]
            if b % D:
                raise ValueError(
                    f"microbatch of {b} sequences not divisible by "
                    f"n_expert_parallel={D}")
            nb = b // D
            # each process routes only its own sequences: the cotangents
            # of the MoE input and of the router sum over the axis
            xg = grad_sync(x, view.group, axis=view.name)
            router = grad_sync(trees[0]["moe"]["router"], view.group,
                               axis=view.name)
            moe = Shards([{"router": router, "experts": t["moe"]["experts"]}
                          for t in trees], view.group, view.name, view)
            ys, aux_v = moe_apply_ep(
                moe, [xg[e * nb:(e + 1) * nb] for e in view.owned], k=k,
                capacity=cap, overlap=cfg.overlap)
            m = all_gather(ys, view, 0)
        ms.append(m)
        aux = aux + aux_v.float().mean()
    return ms, aux


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


def _bank_lookup(adapters: bool, bank, aids, dev, caller: str,
                 shards=None):
    """The per-layer lookup of a builder's trailing ``(bank, aids)``
    arguments, or None for a build without adapters. ``aids`` (an int or
    a host array) becomes one index tensor per call. ``shards``: a TP
    program's :class:`_TPShards` (:func:`_tp_adapter_layers`)."""
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
    if shards is not None:
        return _tp_adapter_layers(bank, aids, shards.tp, shards.devices,
                                  shards.owned)
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


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return t if t.device == dev else t.to(dev)


def _device_copies(*ts):
    """``at(dev)`` -> ``ts`` on ``dev``, each device's copies made once
    per call of a serving program (the shards of a TP program may sit on
    several cards)."""
    memo = {}

    def at(dev):
        if dev not in memo:
            memo[dev] = tuple(_to(t, dev) for t in ts)
        return memo[dev]

    return at


def _serve_block(bp, h, li, kc, vc, H, ab, attend, tail=None):
    """One block of a serving program. ``attend(kc, vc, li, q, k, v) ->
    a`` lands the layer's new K/V rows in a pool and attends them.
    Single-device (``tail`` None): ``bp`` is the block, ``kc``/``vc`` the
    pool, ``ab`` the layer's adapter factors, and the dense tail closes
    it. Tensor-parallel: ``bp`` is the layer's shard trees, ``kc``/``vc``
    and ``ab`` one per shard, ``H`` the local head count; each shard
    projects onto its heads and attends its own pool on its own device,
    and ``tail`` (:func:`_tp_attn_tail`) closes the block."""
    if tail is None:
        q, k, v = _dense_qkv(bp, h, H, ab)
        return _dense_attn_tail(bp, h, attend(kc, vc, li, q, k, v))
    parts = []
    for m, bpm in enumerate(bp):
        q, k, v = _dense_qkv(bpm, _to(h, bpm["attn"]["wq"].device), H,
                             None if ab is None else ab[m])
        parts.append(attend(kc[m], vc[m], li, q, k, v))
    return tail(bp, h, parts)


# -- tensor-parallel serving -----------------------------------------------------
#
# A TP serving program runs the dense build's blocks sliced Megatron-style
# per model coordinate (pack_tp_serve_params: training's _slice_tp_block
# slices, so a TP engine serves the model the dense build trains and
# solo-decodes). Each coordinate projects QKV onto its H/tp heads, writes
# and attends its own head-sharded K/V pool — one tensor per coordinate,
# on its device; the fused paged programs launch K4 once per coordinate
# and layer on its H/tp heads — and the attention output projection and
# the MLP pair close with one sum over the coordinates, plain or the ring
# of parallel/overlap.py. A process holds the coordinates of the mesh it
# owns (tp_serve_shards: all of them in one process, tp / W of them in
# each of W processes) and the sums cross processes over the mesh's model
# group. The residual stream, the embedding, the head and the sampling run
# in every process on its first coordinate's device: the sums give every
# process the same bits, so every process samples the same tokens — the
# counterpart of the JAX programs' re-replication of the rows
# (_close_rows, a pmean over the model axis).

def pack_tp_serve_params(params_list, tp: int, devices=None, shards=None):
    """Slice dense per-stage trees into the TP serving layout: ``([per
    layer, the owned shard trees], {"embed": ..., "head": ...})`` — the
    trees of the model coordinates ``shards`` (None: all ``tp``; a
    process of a mesh across processes: :func:`tp_serve_shards`), shard
    ``m``'s exactly :func:`_slice_tp_block`'s, a copy of its own on its
    entry of ``devices`` (one per owned shard; None: where the weights
    lie); embed and head stay the dense build's, replicated."""
    embed, blocks, head = _merged_stage_trees(params_list)
    shards = list(range(tp) if shards is None else shards)
    devices = list(devices) if devices is not None else [None] * len(shards)
    stacked = [[_slice_tp_block(bp, m, tp, dev)
                for m, dev in zip(shards, devices)] for bp in blocks]
    return stacked, {"embed": embed, "head": head}


def _tp_local_trees(params):
    """The TP serving params as the programs read them: the per-layer
    shard trees and the replicated embed and head."""
    stacked, rep = params
    return stacked, rep["embed"], rep["head"]


def _tp_attn_tail(bps, h, parts, view, overlap="none"):
    """TP twin of :func:`_dense_attn_tail`: ``bps`` the layer's owned
    shard trees, ``parts`` each shard's attention over its ``H/tp``
    heads. The output projection is row-parallel (``wo`` rows are
    head-aligned), closed by one sum over the coordinates
    (``overlap='none'``: the owned parts summed, then over ``view``'s
    process group) or the ring of ``overlap.ring_psum`` over ``view``
    (gloo hops across processes); the MLP is the training path's column
    -> row pair (``tensor.tp_pair_apply``, tanh GELU). ``view``: the
    model axis as this process sees it (:func:`tp_serve_view`)."""
    from simple_distributed_machine_learning_tpu_torch.parallel.overlap import (  # noqa: E501
        ring_psum,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel.tensor import (  # noqa: E501
        Shards,
        model_sum,
        tp_pair_apply,
    )
    zs = [_merge_heads(a) @ bp["attn"]["wo"] for bp, a in zip(bps, parts)]
    red = (ring_psum(zs, view)[0] if overlap == "ring"
           else model_sum(zs, view.group, size=view.size))
    h = h + _to(red, h.device)
    hn2 = layer_norm(bps[0]["ln2"], h)
    return h + tp_pair_apply(
        Shards([{"w1": bp["mlp_in"], "w2": bp["mlp_out"]} for bp in bps],
               group=view.group, view=view), hn2,
        activation=_gelu, overlap=overlap)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _tp_adapter_layers(bank, aid, tp, devices, shards=None):
    """TP twin of :func:`_adapter_layers`: the bank is replicated; each
    owned shard (``shards``, None: all ``tp``) takes its own output
    columns of the B factors (``bq``/``bv`` columns are head-aligned like
    ``wq``/``wv``'s Megatron column shards, and a column slice commutes
    with the matmul), on its entry of ``devices``. ``at(li)`` is the list
    of the owned shards' factors."""
    at_full = _adapter_layers(bank, aid)
    shards = list(range(tp) if shards is None else shards)

    def at(li):
        aq, bq, av, bv = at_full(li)
        dc = bq.shape[-1] // tp
        return [tuple(_to(t, dev) for t in (
            aq, bq[..., m * dc:(m + 1) * dc], av,
            bv[..., m * dc:(m + 1) * dc]))
            for m, dev in zip(shards, devices)]

    return at


def _validate_tp_serve(cfg: GPTConfig, mesh, caller: str):
    """Serving TP validation: ``n_tensor_parallel > 1`` needs a mesh whose
    ``model`` axis is exactly that size (its coordinates in this process
    or split over several); tp == 1 normalises the mesh to None."""
    from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (
        MODEL_AXIS,
    )
    tp = cfg.n_tensor_parallel
    if tp == 1:
        return None
    if mesh is None or mesh.shape.get(MODEL_AXIS, 1) != tp:
        got = None if mesh is None else dict(mesh.shape)
        raise ValueError(
            f"{caller}: cfg.n_tensor_parallel={tp} needs a mesh with a "
            f"'{MODEL_AXIS}' axis of that size, got {got}")
    return mesh


def tp_serve_view(mesh):
    """The model axis of a serving mesh (replica 0, stage 0) as this
    process sees it: its owned coordinates and, when they are split over
    processes, the model group the sums and the lockstep clock use."""
    from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (
        MODEL_AXIS,
    )
    return mesh.view(0, 0, MODEL_AXIS)


def tp_serve_shards(mesh) -> range:
    """The model coordinates of a serving mesh this process owns: all
    ``tp`` in one process, ``tp / W`` of them in each of W processes."""
    return tp_serve_view(mesh).owned


def tp_serve_devices(mesh) -> list[torch.device]:
    """The device of each model coordinate of a serving mesh that this
    process owns (:func:`tp_serve_shards`), in coordinate order."""
    return [mesh.device(0, 0, m) for m in tp_serve_shards(mesh)]


class _TPShards(NamedTuple):
    """The model coordinates a TP serving program runs in this process:
    the axis width, the owned coordinates and their devices."""
    tp: int
    owned: range
    devices: list


def _serve_plan(cfg: GPTConfig, mesh, dev: torch.device, caller: str):
    """A serving builder's split: ``(tp, local heads, tail, shards)``, the
    tail and :class:`_TPShards` None at tp 1. This process's first
    coordinate's device is the program's own (``dev``), where the
    replicated stream and the sampling run."""
    mesh = _validate_tp_serve(cfg, mesh, caller)
    if mesh is None:
        return 1, cfg.n_heads, None, None
    tp = cfg.n_tensor_parallel
    devices = tp_serve_devices(mesh)
    if (devices[0].type, devices[0].index or 0) != (dev.type,
                                                    dev.index or 0):
        raise ValueError(f"{caller}: device={dev} differs from the mesh's "
                         f"first model coordinate's {devices[0]}")
    return (tp, cfg.n_heads // tp,
            functools.partial(_tp_attn_tail, overlap=cfg.overlap,
                              view=tp_serve_view(mesh)),
            _TPShards(tp, tp_serve_shards(mesh), devices))


def _serve_trees(params, tp: int):
    """``(embed, blocks, head)`` of a program's params: the dense stage
    trees at tp 1, the packed TP layout above it."""
    if tp == 1:
        return _merged_stage_trees(params)
    blocks, embed, head = _tp_local_trees(params)
    return embed, blocks, head


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


# -- the build memo -------------------------------------------------------------

#: built serving programs by static config (the JAX ``_DECODE_BUILD_CACHE``):
#: key -> (program, weak references to the stages it was built for)
_DECODE_BUILD_CACHE: dict = {}


def _memo_builder(build):
    """Memoize a decode builder on its static config, as the JAX package's
    ``_memo_build`` does: two calls with the same stages (by identity),
    config, lengths, cache dtype, mesh, kernel and device return the SAME
    program, so every engine and test built alike shares it. The program
    reads the weights from its ``params`` argument, never from the stages
    it was built for; an entry whose stages are gone is rebuilt. An
    unhashable argument builds afresh."""
    import functools
    import inspect
    import weakref

    sig = inspect.signature(build)

    @functools.wraps(build)
    def memo(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        key, refs = [build.__name__], []
        for name, value in bound.arguments.items():
            if name in ("stages", "draft_stages"):
                key.append((name, tuple(id(s) for s in value)))
                refs.extend(value)
                continue
            try:
                hash(value)
            except TypeError:
                return build(*args, **kwargs)
            key.append((name, value))
        key = tuple(key)
        hit = _DECODE_BUILD_CACHE.get(key)
        if hit is not None and all(r() is s for r, s in zip(hit[1], refs)):
            return hit[0]
        fn = build(*args, **kwargs)
        _DECODE_BUILD_CACHE[key] = (fn, [weakref.ref(s) for s in refs])
        return fn

    return memo


def _validate_decode_build(stages, cfg, prompt_len, n_new, caller):
    _check_ported(cfg, caller, decode=True)
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


@_memo_builder
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
    if cfg.n_seq > 1:
        raise ValueError(
            "cached decode is single-device; rebuild the stages with n_seq=1 "
            "(same weights) as make_decoder requires too")
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
                  sampling, wire=None) -> torch.Tensor | None:
    """The cached decode over blocks split into stages: stage s's blocks
    (``stage_blocks[s]``) run on ``devs[s]`` against a K/V cache of their
    own depth there, the hidden state hops stage to stage, the head samples
    on the last device and the token goes back to the first. One stage on
    one device is :func:`make_cached_decoder`; several are
    ``models/pp_decode.py``, which across processes passes this process's
    stages only and a ``wire``: the hidden state comes in over it where
    this process holds no ``embed`` and goes out where it holds no
    ``head``, and each token goes back over it (``wire.token``). Returns
    the tokens on the last device (the first where it holds no head), None
    on a process that holds neither end."""
    H = cfg.n_heads
    dh = cfg.d_model // H
    cd = _cache_dtype(cache_dtype)
    prompt = _on(prompt, devs[0], torch.int64)
    b = prompt.shape[0]
    caches = []
    for blocks, d in zip(stage_blocks, devs):
        kc = torch.zeros((len(blocks), b, H, total, dh), dtype=cd, device=d)
        caches.append((kc, torch.zeros_like(kc)))
    if head is not None:
        out_dev = devs[-1]
        kd = _on(_rng.key_data(0) if key_data is None else key_data,
                 out_dev, torch.int64).reshape(1, 2).expand(b, 2)
        knobs = _sampling_tensors(b, *sampling, out_dev)
        ctr0 = torch.arange(b, device=out_dev) * cfg.vocab

    def relay(h, t, block):
        if embed is None:
            h = wire.recv_hidden((b, t, cfg.d_model), devs[0])
        for blocks, d, (kc, vc) in zip(stage_blocks, devs, caches):
            h = h.to(d)
            for li, bp in enumerate(blocks):
                h = block(bp, h, li, kc, vc)
        if head is None:
            wire.send_hidden(h)
        return h

    def pick(h, row):
        nonlocal kd
        tok = None
        if head is not None:
            tok, kd2 = _sample_dyn(_head_logprobs(head, row(h)), kd, *knobs,
                                   ctr0=ctr0)
            kd = kd2[:1].expand(b, 2)
        return tok if wire is None else wire.token(tok, b, devs[0])

    h = None
    if embed is not None:
        h = embedding_lookup(embed["tok"], prompt) + embed["pos"][:prompt_len]
    h = relay(h, prompt_len, lambda bp, h, li, kc, vc: _dense_block_prefill(
        bp, h, li, kc, vc, prompt_len, H))
    tok = pick(h, lambda h: h[:, -1])
    out = [tok]
    # each step consumes the token at position i and samples i + 1
    for i in range(prompt_len, total - 1):
        if embed is not None:
            h = (embedding_lookup(embed["tok"], tok.to(devs[0])[:, None])
                 + embed["pos"][i:i + 1])
        h = relay(h, 1, lambda bp, h, li, kc, vc, i=i: _dense_block_step(
            bp, h, li, kc, vc, i, total, H))
        tok = pick(h, lambda h: h[:, 0])
        out.append(tok)
    if wire is not None:
        wire.close()
    if tok is None:
        return None
    dev = tok.device
    return torch.cat([prompt.to(device=dev, dtype=torch.int32),
                      torch.stack([t.to(dev) for t in out], 1)], 1)


# -- full-prefix decode ----------------------------------------------------------

def make_decoder(stages, prompt_len: int, n_new: int,
                 temperature: float = 0.0, top_k: int | None = None,
                 top_p: float | None = None, device=None):
    """Full-prefix decode: ``decode(params, prompt, key_data=None) -> int32
    [B, prompt_len + n_new]`` on ``device``.

    Each new token reruns the whole stage composition
    (``parallel/pipeline.py::fused_reference``, deterministic) over a
    zero-padded token buffer of the first stage's sequence length and
    reads the prediction for position ``i`` at ``i - 1``; causal attention
    keeps the padding after it out of sight. Any single-device build
    decodes so: MoE blocks route the whole buffer, as in training, and
    ``attn_impl="flash"`` runs K1 once per layer per token at the full
    sequence length. ``params`` is the stages' param list on ``device``.
    Sampling is :func:`make_cached_decoder`'s (the same key splits and
    counter ranges), so with the same ``key_data`` both draw the same
    tokens. The JAX decoder is one jitted ``lax.scan``; this one loops on
    the host, one fused forward per token, with no host sync inside."""
    dev = resolve_device(device)
    if prompt_len < 1:
        raise ValueError(
            "generate needs a non-empty prompt (t0 >= 1): the first decoded "
            "token is conditioned on the prompt's last position")
    _check_sampling_args(temperature, top_k, top_p)
    _check_unsharded(stages, "make_decoder")
    cfgs = [getattr(s.apply, "keywords", {}).get("cfg") for s in stages]
    if any(c is not None and c.n_seq > 1 for c in cfgs):
        raise ValueError(
            "make_decoder is single-device: the stages of an n_seq > 1 "
            "build run mesh collectives in their applies — decode with an "
            "n_seq=1 build of the same weights")
    seq_len = int(stages[0].in_shape[0])
    total = prompt_len + n_new
    if total > seq_len:
        raise ValueError(
            f"prompt {prompt_len} + n_new {n_new} exceeds the model's "
            f"sequence length {seq_len}")
    fused = fused_reference(stages)

    @torch.no_grad()
    def decode(params, prompt, key_data=None):
        prompt = _on(prompt, dev, torch.int64)
        b = prompt.shape[0]
        buf = torch.zeros((b, seq_len), dtype=torch.int64, device=dev)
        buf[:, :prompt_len] = prompt
        kd = _on(_rng.key_data(0) if key_data is None else key_data, dev,
                 torch.int64).reshape(1, 2).expand(b, 2)
        knobs = _sampling_tensors(b, temperature, top_k, top_p, dev)
        ctr0 = None
        for i in range(prompt_len, total):
            row = fused(params, buf, None, True)[:, i - 1]
            if temperature <= 0.0:          # greedy: no key, no sampler
                buf[:, i] = torch.argmax(row, dim=-1)
                continue
            if ctr0 is None:
                width = row.shape[-1]
                if top_k is not None and top_k > width:
                    raise ValueError(
                        f"top_k={top_k} exceeds the row width {width} "
                        f"(the model's vocab)")
                ctr0 = torch.arange(b, device=dev) * width
            tok, kd2 = _sample_dyn(row, kd, *knobs, ctr0=ctr0)
            kd = kd2[:1].expand(b, 2)
            buf[:, i] = tok
        return buf[:, :total].to(torch.int32)

    return decode


def generate(stages, prompt, n_new: int, key_data=None,
             temperature: float = 0.0, cfg: GPTConfig | None = None,
             top_k: int | None = None, top_p: float | None = None,
             device=None) -> torch.Tensor:
    """One-shot decode of ``prompt`` ``[B, T0]`` from the stages' own
    params -> int32 ``[B, T0 + n_new]``: through the KV cache
    (:func:`make_cached_decoder`) when given the stages' ``cfg``, else by
    full-prefix recompute (:func:`make_decoder`). ``key_data``: see
    :func:`make_cached_decoder`; sampling needs one."""
    if temperature > 0.0 and key_data is None:
        raise ValueError("sampling (temperature > 0) needs a PRNG key")
    t0 = int(prompt.shape[1])
    if cfg is not None:
        dec = make_cached_decoder(stages, cfg, t0, n_new,
                                  temperature=temperature, top_k=top_k,
                                  top_p=top_p, device=device)
    else:
        dec = make_decoder(stages, t0, n_new, temperature=temperature,
                           top_k=top_k, top_p=top_p, device=device)
    return dec([s.params for s in stages], prompt, key_data)


def decoder_from_pipeline(pipe, cfg: GPTConfig, prompt_len: int, n_new: int,
                          temperature: float = 0.0, top_k: int | None = None,
                          top_p: float | None = None, cache_dtype=None):
    """Cached decode bound to a training ``Pipeline``: ``decode(params,
    prompt, key_data=None)`` takes the pipeline's live per-stage params
    (``pipe.init_params()``, which a train step updates in place), so a
    decode after training or a restore reads the weights as they are now.
    Stages away from ``pipe.device`` are copied there on each call; the
    single-device :func:`make_cached_decoder` then runs on them. Tensor-
    or expert-sharded stages and a mesh that spans processes are
    refused."""
    _check_unsharded(pipe.stages, "decoder_from_pipeline")
    if pipe.mesh is not None and pipe.mesh.distributed:
        raise ValueError(
            "decoder_from_pipeline runs in one process and this mesh spans "
            "processes — decode stage by stage with models.make_pp_decoder")
    dev = pipe.device
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    dec = make_cached_decoder(pipe.stages, cfg, prompt_len, n_new,
                              temperature=temperature, top_k=top_k,
                              top_p=top_p, cache_dtype=cache_dtype,
                              device=dev)

    def local(p):
        if all(t.device == dev for t in tree_leaves(p)):
            return p
        return _clone_tree(p, dev)

    def decode(params, prompt, key_data=None):
        return dec([local(p) for p in params], prompt, key_data)

    return decode


# -- dense slot-row programs (the degraded target's and the draft's pool) ----

def _validate_slot_build(stages, cfg: GPTConfig, max_len: int, caller: str,
                         cache_dtype=None) -> None:
    """The slot programs' checks: a ported single-device dense-MLP config,
    no quantised cache (dense slot rows hold no scales), ``max_len``
    within the position table, and a cfg that matches the stages."""
    _check_ported(cfg, caller)
    _check_cache_quantization(cache_dtype, caller, paged=False)
    _check_unsharded(stages, caller)
    if not 2 <= max_len <= cfg.seq_len:
        raise ValueError(
            f"slot max_len={max_len} outside [2, seq_len={cfg.seq_len}] "
            f"(the position table bounds every slot's sequence budget)")
    _check_embed_matches(stages, cfg)


@_memo_builder
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
    (``models/lora.py``) and the request's row in it.

    With ``cfg.n_tensor_parallel = tp > 1`` pass the serving ``mesh``
    (its ``model`` axis ``tp``): ``params`` is
    :func:`pack_tp_serve_params`'s layout and ``kc``/``vc`` the lists of
    the coordinates' ``[L, n_slots, H/tp, max_len, dh]`` pools (tensor-
    parallel serving section above)."""
    _validate_slot_build(stages, cfg, max_len, "make_slot_prefill",
                         cache_dtype)
    dev = resolve_device(device)
    tp, H, tail, shards = _serve_plan(cfg, mesh, dev, "make_slot_prefill")

    @torch.no_grad()
    def prefill(params, kc, vc, prompt, slot, key_data, temperature, top_k,
                top_p, bank=None, aid=None):
        embed, blocks, head = _serve_trees(params, tp)
        at = _bank_lookup(adapters, bank, None if aid is None else int(aid),
                          dev, "make_slot_prefill", shards)
        kc, vc, row = _slot_prefill_fwd(blocks, embed, head, kc, vc,
                                        _on(prompt, dev, torch.int64),
                                        int(slot), H, at=at, tail=tail)
        tok, kd = _sample_dyn(row[None],
                              _on(key_data, dev, torch.int64)[None],
                              *_sampling_tensors(1, temperature, top_k,
                                                 top_p, dev))
        return kc, vc, tok[0], kd[0]

    return prefill


def _slot_prefill_fwd(blocks, embed, head, kc, vc, prompt, slot, H,
                      at=None, tail=None):
    """One request's whole-prompt prefill into pool row ``slot``; returns
    ``(kc, vc, row)``, the last position's log-probs [V]. ``at``: the
    per-layer adapter lookup (:func:`_adapter_layers`), or None; ``tail``
    and the per-shard ``blocks``/pools of a TP program
    (:func:`_serve_block`)."""
    t0 = prompt.shape[1]
    h = embedding_lookup(embed["tok"], prompt) + embed["pos"][:t0]

    def attend(kc, vc, li, q, k, v):                       # [1, H, T0, dh]
        kc[li, slot, :, :t0] = k[0].to(kc.dtype)
        vc[li, slot, :, :t0] = v[0].to(vc.dtype)
        return causal_attention_core(q, k, v)

    for li, bp in enumerate(blocks):
        h = _serve_block(bp, h, li, kc, vc, H,
                         None if at is None else at(li), attend, tail)
    return kc, vc, _head_logprobs(head, h[:, -1])[0]


def _slot_decode_fwd(blocks, embed, head, kc, vc, toks, pos, H, at=None,
                     tail=None):
    """The batched one-token-per-slot step's forward over a dense pool:
    ``toks``/``pos`` [S] int64 -> ``(kc, vc, rows)``, log-probs [S, V].
    Each slot writes its K/V at its own position ``pos`` in place and
    attends ``[0, pos]`` with the solo decoder's per-slot math, so a
    slot's output depends on its own row only. The speculative draft's
    propose loop runs it ``spec_k`` times. ``at``: the per-layer adapter
    lookup over ``[S]`` rows, or None; ``tail``: a TP program's."""
    h = (embedding_lookup(embed["tok"], toks[:, None])
         + embed["pos"][pos][:, None])                      # [S, 1, d]
    on = _device_copies(pos, torch.arange(toks.shape[0], device=pos.device))

    def attend(kc, vc, li, q, knew, vnew):                 # [S, H, 1, dh]
        p, rows = on(q.device)
        kl, vl = kc[li], vc[li]                            # [S, H, ml, dh]
        kl[rows, :, p] = knew[:, :, 0].to(kl.dtype)
        vl[rows, :, p] = vnew[:, :, 0].to(vl.dtype)
        # the scale from the projected head dim, never d_model / H: the
        # local head count of a TP shard is not the model's
        scores = (torch.einsum("bhqd,bhkd->bhqk", q, kl.float())
                  / math.sqrt(q.shape[-1]))
        live = (torch.arange(kl.shape[-2], device=q.device)
                [None, None, None, :] <= p[:, None, None, None])
        scores = torch.where(live, scores, -math.inf)
        return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1),
                            vl.float())

    for li, bp in enumerate(blocks):
        h = _serve_block(bp, h, li, kc, vc, H,
                         None if at is None else at(li), attend, tail)
    return kc, vc, _head_logprobs(head, h[:, 0])


@_memo_builder
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
    included: ``adapters=True`` appends ``(bank, aids [S])``. A TP build
    (``mesh``) takes :func:`make_slot_prefill`'s TP layout."""
    _validate_slot_build(stages, cfg, max_len, "make_slot_decode_step",
                         cache_dtype)
    dev = resolve_device(device)
    tp, H, tail, shards = _serve_plan(cfg, mesh, dev,
                                       "make_slot_decode_step")

    @torch.no_grad()
    def step(params, kc, vc, toks, pos, key_data, temps, top_ks, top_ps,
             bank=None, aids=None):
        embed, blocks, head = _serve_trees(params, tp)
        at = _bank_lookup(adapters, bank, aids, dev, "make_slot_decode_step",
                          shards)
        kc, vc, rows = _slot_decode_fwd(
            blocks, embed, head, kc, vc, _on(toks, dev, torch.int64),
            _on(pos, dev, torch.int64), H, at=at, tail=tail)
        toks2, kd2 = _sample_dyn(rows, _on(key_data, dev, torch.int64),
                                 *_sampling_tensors(rows.shape[0], temps,
                                                    top_ks, top_ps, dev))
        return kc, vc, toks2, kd2

    return step


# -- paged serving programs ----------------------------------------------------

def _validate_paged_build(stages, cfg: GPTConfig, max_len: int,
                          block_size: int, caller: str,
                          cache_dtype=None) -> None:
    _check_ported(cfg, caller)
    _check_unsharded(stages, caller)
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


@_memo_builder
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
    ``(bank, aid)``, the request's adapter row. A TP build (``mesh``)
    takes :func:`make_slot_prefill`'s TP layout, the pools the lists of
    the coordinates' ``[L, n_blocks+1, H/tp, bs, dh]`` pools."""
    _validate_paged_build(stages, cfg, max_len, block_size,
                          "make_paged_prefill_chunk", cache_dtype)
    dev = resolve_device(device)
    tp, H, tail, shards = _serve_plan(cfg, mesh, dev,
                                       "make_paged_prefill_chunk")

    @torch.no_grad()
    def chunk(params, kc, vc, tokens, p0, table, key_data, temperature,
              top_k, top_p, bank=None, aid=None):
        embed, blocks, head = _serve_trees(params, tp)
        at = _bank_lookup(adapters, bank, None if aid is None else int(aid),
                          dev, "make_paged_prefill_chunk", shards)
        kc, vc, row = _paged_chunk_fwd(
            blocks, embed, head, kc, vc, _on(tokens, dev, torch.int64),
            int(p0), _on(table, dev, torch.int64), H, block_size, at=at,
            tail=tail)
        tok, kd = _sample_dyn(row[None],
                              _on(key_data, dev, torch.int64)[None],
                              *_sampling_tensors(1, temperature, top_k,
                                                 top_p, dev))
        return kc, vc, tok[0], kd[0]

    return chunk


def _paged_chunk_fwd(blocks, embed, head, kc, vc, tokens, p0, table, H, bs,
                     at=None, tail=None):
    """One prompt chunk's scatter + block-gather attention: ``tokens``
    [1, c] at positions ``[p0, p0+c)``, ``table`` [NB] int64, ``at`` the
    per-layer adapter lookup or None, ``tail`` a TP program's. Returns
    ``(kc, vc, row)`` — the last position's log-probs [V]."""
    dev = tokens.device
    c = tokens.shape[1]
    h = embedding_lookup(embed["tok"], tokens) + embed["pos"][p0:p0 + c]
    idx = p0 + torch.arange(c, device=dev)
    span = table.shape[0] * bs
    on = _device_copies(table[idx // bs], idx % bs, table,
                        (torch.arange(span, device=dev)[None, :]
                         <= idx[:, None])[None, None])

    def attend(kc, vc, li, q, k, v):                       # [1, H, c, dh]
        phys, off, tbl, live = on(q.device)
        _paged_scatter(kc, li, phys, off, k[0].transpose(0, 1))
        _paged_scatter(vc, li, phys, off, v[0].transpose(0, 1))
        krow = _paged_gather(kc, li, tbl).float()          # [H, span, dh]
        vrow = _paged_gather(vc, li, tbl).float()
        scores = (torch.einsum("bhqd,hkd->bhqk", q, krow)
                  / math.sqrt(q.shape[-1]))
        scores = torch.where(live, scores, -math.inf)
        return torch.einsum("bhqk,hkd->bhqd", torch.softmax(scores, dim=-1),
                            vrow)

    for li, bp in enumerate(blocks):
        h = _serve_block(bp, h, li, kc, vc, H,
                         None if at is None else at(li), attend, tail)
    return kc, vc, _head_logprobs(head, h[:, -1])[0]


@_memo_builder
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
    take its adapter row's delta before either attention path. A TP build
    (``mesh``) takes :func:`make_paged_prefill_chunk`'s TP layout; its
    fused tick launches the kernel once per coordinate and layer, on the
    coordinate's pool and ``H/tp`` heads."""
    _validate_paged_build(stages, cfg, max_len, block_size,
                          "make_paged_decode_step", cache_dtype)
    _check_attn_kernel(kernel, "make_paged_decode_step")
    dev = resolve_device(device)
    tp, H, tail, shards = _serve_plan(cfg, mesh, dev,
                                       "make_paged_decode_step")

    @torch.no_grad()
    def step(params, kc, vc, toks, pos, tables, key_data, temps, top_ks,
             top_ps, bank=None, aids=None):
        embed, blocks, head = _serve_trees(params, tp)
        at = _bank_lookup(adapters, bank, aids, dev,
                          "make_paged_decode_step", shards)
        kc, vc, rows = _paged_decode_fwd(
            blocks, embed, head, kc, vc, _on(toks, dev, torch.int64),
            _on(pos, dev, torch.int64), _on(tables, dev, torch.int64),
            H, block_size, kernel, at=at, tail=tail)
        toks2, kd2 = _sample_dyn(rows, _on(key_data, dev, torch.int64),
                                 *_sampling_tensors(rows.shape[0], temps,
                                                    top_ks, top_ps, dev))
        return kc, vc, toks2, kd2

    return step


def _paged_decode_fwd(blocks, embed, head, kc, vc, toks, pos, tables, H, bs,
                      kernel="dense", at=None, tail=None):
    """The batched one-token-per-slot step's forward: ``toks``/``pos``
    [S] and ``tables`` [S, NB] int64. Scatter (and quantise) happens
    before either attention path reads, so the new token's row is visible
    at its own position. ``tail``: a TP program's. Returns ``(kc, vc,
    rows)`` — log-probs [S, V]."""
    h = (embedding_lookup(embed["tok"], toks[:, None])
         + embed["pos"][pos][:, None])                      # [S, 1, d]
    on = _device_copies(tables.gather(1, (pos // bs)[:, None])[:, 0],
                        pos % bs, tables.to(torch.int32),
                        pos.to(torch.int32)[:, None].contiguous())

    def attend(kc, vc, li, q, knew, vnew):                 # [S, H, 1, dh]
        phys, off, tables_k, qpos_k = on(q.device)
        _paged_scatter(kc, li, phys, off, knew[:, :, 0, :])
        _paged_scatter(vc, li, phys, off, vnew[:, :, 0, :])
        return _paged_attend(kc, vc, li, q, tables_k, qpos_k, bs, q.device,
                             kernel)

    for li, bp in enumerate(blocks):
        h = _serve_block(bp, h, li, kc, vc, H,
                         None if at is None else at(li), attend, tail)
    return kc, vc, _head_logprobs(head, h[:, 0])


@_memo_builder
def make_paged_block_copy():
    """The copy-on-write op: ``copy(kc, vc, dst, src) -> (kc, vc)``
    duplicates physical block ``src`` into ``dst`` across every layer (and
    every shard of a TP pool), in place. A :class:`QuantKV` buffer copies its scale plane with its
    data — a copy that moved rows without their scales would silently
    rescale the destination block."""

    @torch.no_grad()
    def copy(kc, vc, dst, src):
        dst, src = int(dst), int(src)
        for pool in (kc, vc):
            # a TP pool is one buffer per model coordinate: every shard
            # copies, since the block tables are shared
            for buf in (pool if isinstance(pool, list) else (pool,)):
                for leaf in (buf if isinstance(buf, QuantKV) else (buf,)):
                    leaf[:, dst] = leaf[:, src]
        return kc, vc

    return copy


@_memo_builder
def make_adapter_bank_update():
    """The tick-boundary adapter upload: ``update(bank, idx, adapter) ->
    bank`` rewrites ONE row of the stacked adapter bank in place (the JAX
    program donates the bank). The decode builders read the bank as data,
    so a row rewrite needs no rebuild of any program."""

    @torch.no_grad()
    def update(bank, idx, adapter):
        for k in BANK_KEYS:
            bank[k][int(idx)].copy_(adapter[k])
        return bank

    return update


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


@_memo_builder
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
    consume none of it. The log-prob rows feed the sampled acceptance.
    The draft runs single-device even under a TP target: it is small by
    design."""
    _validate_slot_build(stages, cfg, max_len, "make_slot_propose",
                         cache_dtype)
    _check_spec_k(spec_k, "make_slot_propose")
    if cfg.n_tensor_parallel > 1:
        raise ValueError(
            "make_slot_propose runs the draft model single-device "
            "(replicated under a TP target): build the draft with "
            "n_tensor_parallel=1")
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
                     at=None, tail=None):
    """The K-tokens-per-slot verify forward over the dense slot pool:
    ``xs`` [S, K] input tokens at query positions ``qpos`` [S, K], each
    position's K/V written at ``wpos`` [S, K] (``qpos`` in budget, the
    trash row past it) before attention reads the row. The per-position
    math is the decode tick's (:func:`_slot_decode_fwd`): the same
    projections and the same masked-row softmax. ``tail``: a TP
    program's. Returns ``(kc, vc, rows)``, log-probs [S, K, V]."""
    S = xs.shape[0]
    h = embedding_lookup(embed["tok"], xs) + embed["pos"][qpos]  # [S, K, d]
    ml = (kc[0] if isinstance(kc, list) else kc).shape[-2]
    on = _device_copies(
        torch.arange(S, device=xs.device)[:, None], wpos,
        (torch.arange(ml, device=xs.device)[None, None, None, :]
         <= qpos[:, None, :, None]))                               # [S,1,K,ml]

    def attend(kc, vc, li, q, knew, vnew):                 # [S, H, K, dh]
        rows, wp, live = on(q.device)
        kl, vl = kc[li], vc[li]                            # [S, H, ml, dh]
        kl[rows, :, wp] = knew.transpose(1, 2).to(kl.dtype)
        vl[rows, :, wp] = vnew.transpose(1, 2).to(vl.dtype)
        scores = (torch.einsum("bhqd,bhkd->bhqk", q, kl.float())
                  / math.sqrt(q.shape[-1]))
        scores = torch.where(live, scores, -math.inf)
        return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1),
                            vl.float())

    for li, bp in enumerate(blocks):
        h = _serve_block(bp, h, li, kc, vc, H,
                         None if at is None else at(li), attend, tail)
    return kc, vc, _head_logprobs(head, h)


@_memo_builder
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
    ``(bank, aids [S])``. A TP build (``mesh``) takes
    :func:`make_slot_prefill`'s TP layout."""
    _validate_slot_build(stages, cfg, max_len, "make_slot_verify_step",
                         cache_dtype)
    _check_spec_k(spec_k, "make_slot_verify_step")
    dev = resolve_device(device)
    tp, H, tail, shards = _serve_plan(cfg, mesh, dev,
                                       "make_slot_verify_step")
    K, ml = spec_k, max_len

    @torch.no_grad()
    def verify(params, kc, vc, toks, pos, drafts, draft_rows, valid_n,
               key_data, temps, top_ks, top_ps, bank=None, aids=None):
        embed, blocks, head = _serve_trees(params, tp)
        at = _bank_lookup(adapters, bank, aids, dev, "make_slot_verify_step",
                          shards)
        toks = _on(toks, dev, torch.int64)
        drafts = _on(drafts, dev, torch.int64)
        valid_n = _on(valid_n, dev, torch.int64)
        xs = torch.cat([toks[:, None], drafts[:, :-1]], dim=1)
        qpos, wpos = _verify_positions(_on(pos, dev, torch.int64), valid_n,
                                       K, ml)
        kc, vc, rows = _slot_verify_fwd(blocks, embed, head, kc, vc, xs,
                                        qpos, wpos, H, at=at, tail=tail)
        return (kc, vc) + _verify_accept(rows, toks, drafts, draft_rows,
                                         valid_n, key_data, temps, top_ks,
                                         top_ps, dev)

    return verify


def _verify_accept(rows, toks, drafts, draft_rows, valid_n, key_data, temps,
                   top_ks, top_ps, dev):
    """The verify steps' acceptance over their rows: ``(toks [S, K],
    n_acc [S], key_data [S, 2])``."""
    any_hot = (None if isinstance(temps, torch.Tensor)
               else bool(np.any(np.asarray(temps) > 0)))
    knobs = _sampling_tensors(toks.shape[0], temps, top_ks, top_ps, dev)
    return _spec_accept_rows(
        rows, drafts, _on(draft_rows, dev, torch.float32), valid_n,
        _on(key_data, dev, torch.int64), *knobs, any_hot=any_hot)


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
                      tables, H, bs, kernel="dense", at=None, tail=None):
    """The K-tokens-per-slot verify forward over the paged pool: each
    position's K/V lands at ``(wphys, woff)`` before attention reads it;
    attention runs over the slot's table span with the ``[S, K]`` ``qpos``
    plan as the per-query mask — the CUDA kernel K4 at K = spec_k
    (``kernel="fused"``; once per coordinate and layer in a TP program)
    or its plain version (``"dense"``). ``xs``, ``qpos``, ``wphys``,
    ``woff`` [S, K] and ``tables`` [S, NB] int64. Returns ``(kc, vc,
    rows)``, log-probs [S, K, V]."""
    h = embedding_lookup(embed["tok"], xs) + embed["pos"][qpos]   # [S, K, d]
    on = _device_copies(wphys, woff, tables.to(torch.int32),
                        qpos.to(torch.int32).contiguous())

    def attend(kc, vc, li, q, knew, vnew):                 # [S, H, K, dh]
        wp, wo, tables_k, qpos_k = on(q.device)
        _paged_scatter(kc, li, wp, wo, knew.transpose(1, 2))
        _paged_scatter(vc, li, wp, wo, vnew.transpose(1, 2))
        return _paged_attend(kc, vc, li, q, tables_k, qpos_k, bs, q.device,
                             kernel)

    for li, bp in enumerate(blocks):
        h = _serve_block(bp, h, li, kc, vc, H,
                         None if at is None else at(li), attend, tail)
    return kc, vc, _head_logprobs(head, h)


@_memo_builder
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
    through K4 with ``spec_k`` queries per slot, one launch per layer
    (per coordinate and layer in a TP build, ``mesh``: the layout of
    :func:`make_paged_prefill_chunk`). ``adapters=True`` appends
    ``(bank, aids [S])``: the verify rows are the adapted model's, so
    they decide every emission."""
    _validate_paged_build(stages, cfg, max_len, block_size,
                          "make_paged_verify_step", cache_dtype)
    _check_spec_k(spec_k, "make_paged_verify_step")
    _check_attn_kernel(kernel, "make_paged_verify_step")
    dev = resolve_device(device)
    tp, H, tail, shards = _serve_plan(cfg, mesh, dev,
                                       "make_paged_verify_step")
    K, ml = spec_k, max_len

    @torch.no_grad()
    def verify(params, kc, vc, toks, pos, drafts, draft_rows, valid_n,
               tables, key_data, temps, top_ks, top_ps, bank=None,
               aids=None):
        embed, blocks, head = _serve_trees(params, tp)
        at = _bank_lookup(adapters, bank, aids, dev,
                          "make_paged_verify_step", shards)
        toks = _on(toks, dev, torch.int64)
        pos = _on(pos, dev, torch.int64)
        drafts = _on(drafts, dev, torch.int64)
        valid_n = _on(valid_n, dev, torch.int64)
        tables = _on(tables, dev, torch.int64)
        xs = torch.cat([toks[:, None], drafts[:, :-1]], dim=1)
        qpos, wphys, woff = _paged_verify_routing(pos, valid_n, tables, K,
                                                  block_size, ml)
        kc, vc, rows = _paged_verify_fwd(blocks, embed, head, kc, vc, xs,
                                         qpos, wphys, woff, tables, H,
                                         block_size, kernel, at=at,
                                         tail=tail)
        return (kc, vc) + _verify_accept(rows, toks, drafts, draft_rows,
                                         valid_n, key_data, temps, top_ks,
                                         top_ps, dev)

    return verify


def _check_spec_tick_build(cfg: GPTConfig, draft_cfg: GPTConfig,
                           caller: str) -> None:
    if draft_cfg.vocab != cfg.vocab:
        raise ValueError(
            f"{caller}: draft vocab {draft_cfg.vocab} != target vocab "
            f"{cfg.vocab}")


@_memo_builder
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


@_memo_builder
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


# The serving programs, by the JAX package's names (its
# ``models/gpt.py::DECODE_BUILDERS``); ``analysis/hostlint.py`` checks the
# table against the JAX list and against this module's definitions.
DECODE_BUILDERS = {
    "make_cached_decoder": make_cached_decoder,
    "make_slot_prefill": make_slot_prefill,
    "make_slot_decode_step": make_slot_decode_step,
    "make_paged_prefill_chunk": make_paged_prefill_chunk,
    "make_paged_decode_step": make_paged_decode_step,
    "make_paged_block_copy": make_paged_block_copy,
    "make_adapter_bank_update": make_adapter_bank_update,
    "make_slot_propose": make_slot_propose,
    "make_slot_verify_step": make_slot_verify_step,
    "make_paged_verify_step": make_paged_verify_step,
    "make_slot_spec_tick": make_slot_spec_tick,
    "make_paged_spec_tick": make_paged_spec_tick,
}
