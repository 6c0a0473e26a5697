"""The one device rule every entry point of the port follows."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device without CUDA raises — the
    port never carries on silently on the CPU; the CPU path runs only
    when the caller asks for it (``device="cpu"``, as the tests do)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default. "
            "Pass device='cpu' to run the plain-torch versions on the CPU.")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev
