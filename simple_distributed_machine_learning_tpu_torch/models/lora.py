"""Low-rank adapters (LoRA) over the GPT's attention weights (port of
``models/lora.py``): multi-tenant serving's per-tenant model deltas.

One *adapter* is a per-layer pair of low-rank factors for each adapted
projection: the served model computes ``q = hn @ wq + (hn @ aq) @ bq``
(the same for ``v``). The base weights are never mutated, and the rank
``r`` is tiny next to ``d_model``, so many tenants share one resident
copy of the base model. ``B`` starts at zero, so a fresh adapter IS the
base model.

Serving applies adapters merge-free and batched: the engine stacks the
resident adapters into per-matrix BANKS with a leading row axis
(:func:`stack_adapters`, ``{"aq": [N, L, d, r], "bq": [N, L, r, d],
...}`` f32 on the device), and every decode-path program gathers each
slot's rows by a per-slot index, so one program serves any adapter mix
per tick and a hot-swap is a bank-row write. Row 0 is the all-zero BASE
row: ``q + (hn @ 0) @ 0`` adds an exact ``0.0``, so a request without an
adapter keeps the token stream of an engine with no adapters at all.

The correctness anchor is the MERGED form: :func:`merge_adapter` bakes
``W + A @ B`` into a copy of the stage weights, and a solo engine on
those weights emits the tenant's stream. :func:`bank_bytes` is the one
formula for the bank's device bytes (the ``serve_adapter_resident_bytes``
gauge).
"""

from __future__ import annotations

import copy

import torch

from simple_distributed_machine_learning_tpu_torch._device import (
    resolve_device,
)

#: the adapted projections (attention query and value)
LORA_TARGETS = ("wq", "wv")

#: bank keys in gather order: A then B for each target
BANK_KEYS = ("aq", "bq", "av", "bv")


def _check_rank(d_model: int, rank: int) -> None:
    if not 1 <= rank <= d_model:
        raise ValueError(
            f"adapter rank {rank} outside [1, d_model={d_model}] — a rank "
            f"above d_model is no longer LOW-rank (and wastes the bank)")


def _shapes(cfg, rank: int) -> dict:
    L, d = cfg.n_layers, cfg.d_model
    return {"aq": (L, d, rank), "bq": (L, rank, d),
            "av": (L, d, rank), "bv": (L, rank, d)}


def init_lora_adapter(gen: torch.Generator, cfg, rank: int,
                      a_std: float = 0.02, device=None) -> dict:
    """One adapter's weights ``{"aq": [L, d, r], "bq": [L, r, d], "av":
    [L, d, r], "bv": [L, r, d]}`` (f32, L = ``cfg.n_layers``) on
    ``device`` (None = ``"cuda"``), A drawn from the CPU generator ``gen``
    (one seed, one adapter, whatever the device), B zero: the fresh
    adapter's delta is exactly 0, the base model."""
    _check_rank(cfg.d_model, rank)
    dev = resolve_device(device)
    sh = _shapes(cfg, rank)
    aq = a_std * torch.randn(sh["aq"], generator=gen)
    av = a_std * torch.randn(sh["av"], generator=gen)
    return {"aq": aq.to(dev), "bq": torch.zeros(sh["bq"], device=dev),
            "av": av.to(dev), "bv": torch.zeros(sh["bv"], device=dev)}


def zero_adapter(cfg, rank: int, device=None) -> dict:
    """The all-zero adapter: bank row 0, the base model's delta."""
    _check_rank(cfg.d_model, rank)
    dev = resolve_device(device)
    return {k: torch.zeros(s, device=dev)
            for k, s in _shapes(cfg, rank).items()}


def check_adapter_shapes(adapter: dict, cfg, rank: int) -> None:
    """Validate one adapter tree against a deployment's (L, d, r) on the
    host, before any upload."""
    want = _shapes(cfg, rank)
    for k in BANK_KEYS:
        if k not in adapter:
            raise ValueError(f"adapter tree missing key {k!r} "
                             f"(want keys {BANK_KEYS})")
        got = tuple(adapter[k].shape)
        if got != want[k]:
            raise ValueError(
                f"adapter[{k!r}] shape {got} != {want[k]} for "
                f"n_layers={cfg.n_layers}, d_model={cfg.d_model}, "
                f"rank={rank}")


def stack_adapters(adapters: list) -> dict:
    """Stack adapter trees into the BANK the decode programs gather from:
    ``[N, L, ...]`` per key, row i = ``adapters[i]`` (row 0 should be
    :func:`zero_adapter`; the ``AdapterStore`` makes it so)."""
    if not adapters:
        raise ValueError("stack_adapters needs at least the base row")
    return {k: torch.stack([a[k] for a in adapters]) for k in BANK_KEYS}


def lora_delta(hn: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """The merge-free low-rank apply ``(hn @ a) @ b``: one expression for
    the one-request prefill (``hn [1, T, d]``, ``a [d, r]``) and the
    batched ticks (``hn [S, K, d]``, ``a [S, d, r]``, each slot's own
    gathered rows), by matmul broadcasting. Kept as two products and
    added to the base projection by the caller — folding it into an
    ``addmm`` or into ``hn @ (W + A @ B)`` would round differently, and
    the base row's exact ``+ 0.0`` would no longer hold."""
    return torch.matmul(torch.matmul(hn, a), b)


@torch.no_grad()
def merge_adapter(params_list: list, adapter: dict) -> list:
    """The merged-dense twin: copies of the stage param modules with ``W
    + A @ B`` baked into every block's ``wq``/``wv`` — what a dedicated
    single-tenant engine would serve, the anchor a tenant's batched
    stream is held against. The layer index runs globally across the
    stage split. The copies are deep (the port's params are modules), so
    the originals are untouched."""
    li = 0
    out = []
    for p in params_list:
        q = copy.deepcopy(p)
        for bp in q["blocks"]:
            attn = bp["attn"]
            for w, a, b in (("wq", "aq", "bq"), ("wv", "av", "bv")):
                dev = attn[w].device
                attn[w].copy_(attn[w] + adapter[a][li].to(dev)
                              @ adapter[b][li].to(dev))
            li += 1
        out.append(q)
    return out


def bank_bytes(n_rows: int, n_layers: int, d_model: int, rank: int) -> int:
    """Device bytes one resident adapter bank pins: ``n_rows`` adapters x
    ``n_layers`` x (aq + bq + av + bv = 4 * d * r f32 values)."""
    return int(n_rows) * int(n_layers) * 4 * int(d_model) * int(rank) * 4
