"""Carry stage weights between the JAX package and the port as numpy trees.

The JAX side hands over its stage param trees after
``jax.tree.map(np.asarray, [s.params for s in stages])``: plain dicts and
lists of numpy arrays. Both packages share the layouts and the tree paths
(GPT, MLP, LeNet), so crossing is a copy with no transposes — and this
module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from simple_distributed_machine_learning_tpu_torch._device import (
    resolve_device,
)
from simple_distributed_machine_learning_tpu_torch._tree import (
    to_module,
    to_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models.gpt import GPT


def _to_torch(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree, dtype=np.float32, copy=True))


def _stage_module(tree) -> nn.Module:
    if isinstance(tree, dict) and "blocks" in tree:
        return GPT(_to_torch(tree["blocks"]), _to_torch(tree.get("embed")),
                   _to_torch(tree.get("head")))
    return to_module(tree)


def params_from_numpy(params_list, device=None) -> list[nn.Module]:
    """Per-stage numpy trees -> the port's per-stage parameter modules on
    ``device`` (None = ``"cuda"``), ready to pass as a stage's params, an
    engine's or a decoder's. A GPT stage (a dict with ``"blocks"``)
    becomes a :class:`GPT` keeping exactly the subtrees the JAX stage had
    (``embed`` first, ``head`` last); any other tree (the MLP's layer
    list, LeNet's dicts) its ``_tree`` container."""
    dev = resolve_device(device)
    return [_stage_module(p).to(dev) for p in params_list]


def adapter_from_numpy(adapter: dict, device=None) -> dict:
    """One LoRA adapter's numpy factors (``{"aq", "bq", "av", "bv"}``, the
    JAX ``models/lora.py`` tree after ``np.asarray``) -> f32 tensors on
    ``device`` (None = ``"cuda"``), ready for ``register_adapter``."""
    dev = resolve_device(device)
    return {k: _to_torch(v).to(dev) for k, v in adapter.items()}


def params_to_numpy(params_list) -> list:
    """The inverse: the port's per-stage modules -> numpy trees with the
    JAX stage trees' structure (what ``params_from_numpy`` takes)."""
    return [to_numpy(m) for m in params_list]
