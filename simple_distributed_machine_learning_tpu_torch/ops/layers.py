"""Layer ops as plain functions over explicit params (port of ``ops/layers.py``).

Layouts are the JAX package's, so a parameter tree crosses between the two
packages with no transposes: linear weights ``[in, out]`` (``x @ w``),
token embeddings ``[vocab, d]``, conv weights HWIO ``[kh, kw, in, out]``
over NHWC activations (the convs permute to torch's NCHW/OIHW inside). ``params`` is any mapping with the JAX
tree's keys — a plain dict or one of the port's ``nn.Module`` parameter
containers (``models/gpt.py``), which index the same way.

Initialisers draw from an explicit ``torch.Generator`` on the CPU (so a
seed gives the same weights whatever device they later move to) with the
reference's distributions: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for linear
and conv weight and bias (a conv's fan_in is ``in * kh * kw``), N(0, 0.02)
for embeddings. The numbers differ from
``jax.random``'s; tests that compare the packages carry weights across
with ``interop.params_from_numpy``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F


def init_generator(seed) -> torch.Generator:
    """The CPU generator an initialiser draws from: ``seed`` is an int or
    already a ``torch.Generator``."""
    return (seed if isinstance(seed, torch.Generator)
            else torch.Generator().manual_seed(int(seed)))


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


def conv2d_init(gen: torch.Generator, in_channels: int, out_channels: int,
                kernel_size: int | Sequence[int], dtype=torch.float32) -> dict:
    """Params for a 2-D conv in HWIO layout: ``{'w': [kh, kw, in, out],
    'b': [out]}``."""
    kh, kw = ((kernel_size, kernel_size) if isinstance(kernel_size, int)
              else kernel_size)
    bound = 1.0 / math.sqrt(in_channels * kh * kw)
    return {"w": _uniform(gen, (kh, kw, in_channels, out_channels), bound,
                          dtype),
            "b": _uniform(gen, (out_channels,), bound, dtype)}


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: ``(low, high)`` with
    the odd pixel on the high side."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(params, x: torch.Tensor, stride: int = 1,
           padding: str = "VALID") -> torch.Tensor:
    """2-D convolution, NHWC activations / HWIO weights (the JAX layout).

    x: [N, H, W, C_in] -> [N, H', W', C_out]. ``padding`` is ``"VALID"``
    or ``"SAME"`` (XLA's rule, which ``F.conv2d(padding="same")`` does not
    take at stride > 1)."""
    w = params["w"]
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        ph = _same_pads(x.shape[1], w.shape[0], stride)
        pw = _same_pads(x.shape[2], w.shape[1], stride)
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
    elif padding != "VALID":
        raise ValueError(f"padding must be VALID or SAME, got {padding!r}")
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1) + params["b"]


def max_pool2d(x: torch.Tensor, window: int = 2,
               stride: int | None = None) -> torch.Tensor:
    """Max pooling over H, W of an NHWC tensor (``"VALID"`` windows)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window,
                     window if stride is None else stride)
    return y.permute(0, 2, 3, 1)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


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


def dropout2d(gen: torch.Generator | None, x: torch.Tensor, rate: float = 0.5,
              deterministic: bool = False) -> torch.Tensor:
    """Channel dropout (``nn.Dropout2d``) on an NHWC tensor: one draw per
    (sample, channel), broadcast over H and W, kept channels scaled by
    ``1 / (1 - rate)``; the identity when ``deterministic`` or ``rate ==
    0``. Draws from ``gen`` as :func:`dropout` does."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    n, _, _, c = x.shape
    mask = torch.rand((n, 1, 1, c), generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
