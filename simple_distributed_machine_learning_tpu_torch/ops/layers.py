"""Layer ops as plain functions over explicit params (port of ``ops/layers.py``).

Layouts are the JAX package's, so a parameter tree crosses between the two
packages with no transposes: linear weights ``[in, out]`` (``x @ w``),
token embeddings ``[vocab, d]``. ``params`` is any mapping with the JAX
tree's keys — a plain dict or one of the port's ``nn.Module`` parameter
containers (``models/gpt.py``), which index the same way.

Initialisers draw from an explicit ``torch.Generator`` on the CPU (so a
seed gives the same weights whatever device they later move to) with the
reference's distributions: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for linear
weight and bias, N(0, 0.02) for embeddings. The numbers differ from
``jax.random``'s; tests that compare the packages carry weights across
with ``interop.params_from_numpy``.
"""

from __future__ import annotations

import math

import torch


def _uniform(gen: torch.Generator, shape, bound: float,
             dtype=torch.float32) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, dtype=dtype) * 2.0 - 1.0) * bound


def linear_init(gen: torch.Generator, in_features: int, out_features: int,
                dtype=torch.float32) -> dict:
    """Params for a dense layer: ``{'w': [in, out], 'b': [out]}``."""
    bound = 1.0 / math.sqrt(in_features)
    return {"w": _uniform(gen, (in_features, out_features), bound, dtype),
            "b": _uniform(gen, (out_features,), bound, dtype)}


def linear(params, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b``. x: [..., in] -> [..., out]."""
    return torch.matmul(x, params["w"]) + params["b"]


def layer_norm_init(d: int, dtype=torch.float32) -> dict:
    return {"scale": torch.ones(d, dtype=dtype),
            "bias": torch.zeros(d, dtype=dtype)}


def layer_norm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the trailing feature axis (the reference's formula:
    biased variance, ``rsqrt(var + eps)``)."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]


def embedding_init(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32) -> torch.Tensor:
    """Token-embedding table [vocab, d] (normal 0.02, GPT convention)."""
    return 0.02 * torch.randn((vocab, d), generator=gen, dtype=dtype)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids.long()]


def dropout(gen: torch.Generator | None, x: torch.Tensor, rate: float = 0.5,
            deterministic: bool = False) -> torch.Tensor:
    """Inverted dropout with an explicit generator and mode (the JAX
    package's ``dropout(key, x, rate, deterministic)``): each entry is kept
    with probability ``1 - rate`` and scaled by ``1 / (1 - rate)``; the
    identity when ``deterministic`` or ``rate == 0``. ``gen`` lies on x's
    device (None draws from torch's default generator there); its bits
    differ from ``jax.random``'s by design."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
