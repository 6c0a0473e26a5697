"""A counter-based random generator in plain torch, vectorised on the device.

The serving engine keeps one PRNG state per request as uint32[2] *key
data* — the same shape and the same seeding layout as the JAX package's
``jax.random.key_data(jax.random.key(seed))`` (``[seed >> 32, seed &
0xffffffff]``), because the request journal records it in a later slice.
What the key data drives is this module's generator, not ``jax.random``:
the numbers differ from JAX's by design; what the port keeps is the split
discipline (one split per sampled token, none for greedy), so a served
request's sampled stream equals its solo decode.

Every draw is a pure function of (key data, counter) through the murmur3
finaliser, computed on int64 tensors holding 32-bit words (products are
split into 16-bit halves so no int64 product overflows): the same key gives
the same bits on any device, for any batch the key rides in.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_C1, _C2, _C3 = 0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9
#: counters reserved for :func:`split` (draw counters stay far below)
_SPLIT_CTR = 0xFFFF0000


def key_data(seed: int) -> np.ndarray:
    """uint32[2] key data for ``seed`` (the JAX package's layout)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & _M32], np.uint32)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for 32-bit words in int64, without overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def _bits(k0: torch.Tensor, k1: torch.Tensor, ctr) -> torch.Tensor:
    """32 random bits for counter ``ctr`` under key ``(k0, k1)``
    (broadcasting; Python ints give the same bits as int64 tensors)."""
    h = _fmix32(_mul32(k0, _C3) ^ k1)
    h = _fmix32(_mul32(h, _C1) ^ (ctr & _M32))
    return _fmix32((h + _C3) & _M32)


def split(kd: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``kd`` int64 [..., 2] -> ``(next_key, subkey)``, each [..., 2]."""
    ctr = _SPLIT_CTR + torch.arange(4, device=kd.device, dtype=torch.int64)
    words = _bits(kd[..., 0:1], kd[..., 1:2], ctr)     # one pass, 4 words
    return words[..., :2], words[..., 2:]


def gumbel(ks: torch.Tensor, n: int, ctr0: torch.Tensor | None = None
           ) -> torch.Tensor:
    """Standard Gumbel noise [N, n] f32 from subkeys ``ks`` int64 [N, 2]:
    row ``i`` column ``v`` uses counter ``ctr0[i] + v`` (``ctr0`` = 0 by
    default). Uniforms are 24-bit, strictly inside (0, 1)."""
    ctr = torch.arange(n, device=ks.device, dtype=torch.int64)[None, :]
    if ctr0 is not None:
        ctr = ctr + ctr0[:, None]
    b = _bits(ks[:, 0:1], ks[:, 1:2], ctr)
    u = ((b >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def fold_in(seed: int, data: int) -> int:
    """A 63-bit seed for a ``torch.Generator``, derived from ``(seed,
    data)`` alone through the murmur mix (the role of JAX's
    ``fold_in(key(seed), data)``): a training step's dropout generator is
    seeded by ``fold_in(config.seed, step)``, so a resumed or replayed
    step draws the masks the uninterrupted run drew. Python ints, once per
    step on the host."""
    k0, k1 = (int(w) for w in key_data(seed))
    ctr = 2 * (int(data) & 0x7FFFFFFF)
    return (_bits(k0, k1, ctr) << 31) | (_bits(k0, k1, ctr + 1) >> 1)
