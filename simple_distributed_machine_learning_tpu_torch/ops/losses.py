"""Loss ops (port of ``ops/losses.py``): ``log_softmax`` and ``nll_loss``."""

from __future__ import annotations

import torch


def log_softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.log_softmax(x, dim=axis)


def nll_loss(log_probs: torch.Tensor, targets: torch.Tensor,
             reduction: str = "mean") -> torch.Tensor:
    """Negative log likelihood of integer ``targets`` under ``log_probs``
    (``[..., C]``, already log-probabilities; ``targets`` ``[...]``)."""
    losses = -torch.gather(log_probs, -1, targets.long()[..., None])[..., 0]
    if reduction == "mean":
        return losses.mean()
    if reduction == "sum":
        return losses.sum()
    if reduction == "none":
        return losses
    raise ValueError(f"unknown reduction: {reduction!r}")
