"""Carry GPT weights between the JAX package and the port as numpy trees.

The JAX side hands over its stage param trees after
``jax.tree.map(np.asarray, [s.params for s in stages])``: plain dicts and
lists of numpy arrays. Both packages share the layouts and the tree paths,
so crossing is a copy with no transposes — and this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from simple_distributed_machine_learning_tpu_torch._device import (
    resolve_device,
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


def params_from_numpy(params_list, device=None) -> list[GPT]:
    """Per-stage numpy trees -> the port's per-stage :class:`GPT` modules
    on ``device`` (None = ``"cuda"``), ready to pass as an engine's or a
    decoder's ``params``. Stage ``i`` keeps exactly the subtrees stage
    ``i`` of the JAX build had (``embed`` first, ``head`` last)."""
    dev = resolve_device(device)
    return [GPT(_to_torch(p["blocks"]), _to_torch(p.get("embed")),
                _to_torch(p.get("head"))).to(dev) for p in params_list]


def params_to_numpy(params_list) -> list[dict]:
    """The inverse: the port's per-stage modules -> numpy trees with the
    JAX stage trees' structure (what ``params_from_numpy`` takes)."""
    out = []
    for module in params_list:
        tree: dict = {"blocks": [{} for _ in module["blocks"]]}
        for path, t in module.state_dict().items():
            keys = path.split(".")
            node = tree
            if keys[0] == "blocks":
                node = tree["blocks"][int(keys[1])]
                keys = keys[2:]
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = t.detach().cpu().numpy()
        out.append(tree)
    return out
