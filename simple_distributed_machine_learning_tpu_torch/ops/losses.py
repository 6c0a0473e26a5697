"""Loss ops (port of ``ops/losses.py``): what the serving slice needs."""

from __future__ import annotations

import torch


def log_softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.log_softmax(x, dim=axis)
