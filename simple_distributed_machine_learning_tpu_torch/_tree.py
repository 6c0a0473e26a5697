"""Parameter trees that index like the JAX package's param pytrees.

A JAX stage's params are nested dicts and lists of arrays. The port keeps
the same shapes in ``nn.Module`` containers, so ``.to(device)``,
``deepcopy`` and ``parameters()`` work, while ``params["fc1"]["w"]`` and
``params[0]["b"]`` still index as in JAX: a dict becomes a :class:`Tree`,
a list an ``nn.ModuleList``.

Two leaf orders exist and must not be confused:

- ``module.parameters()`` — registration order; the optimizers' per-tensor
  state follows it (``parallel/pipeline.py::param_leaves``);
- :func:`tree_leaves` — ``jax.tree.flatten``'s order (dict keys sorted,
  lists by index); the packed stage buffer and checkpoints follow it.

They differ for the GPT (``Linear`` registers ``w`` before ``b``), and a
mix-up there swaps same-shaped leaves such as a LayerNorm's ``scale`` and
``bias`` with no shape check to catch it.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


class Tree(nn.Module):
    """A parameter container that indexes like the JAX param dict."""

    def __getitem__(self, key: str):
        if key not in self:
            raise KeyError(key)
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self._parameters or key in self._modules

    def get(self, key: str, default=None):
        return self[key] if key in self else default


class ParamTree(Tree):
    """A :class:`Tree` built from any nested dict of tensors, dicts and
    lists (the MLP's and LeNet's stage trees)."""

    def __init__(self, tree: dict) -> None:
        super().__init__()
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, nn.Parameter(v))
            else:
                self.add_module(k, to_module(v))


def to_module(tree) -> nn.Module:
    """A nested dict/list of tensors (or numpy arrays, copied to f32) ->
    its :class:`ParamTree` / ``nn.ModuleList`` container."""
    if isinstance(tree, dict):
        return ParamTree({k: _as_tensor(v) if _is_leaf(v) else v
                          for k, v in tree.items()})
    if isinstance(tree, (list, tuple)):
        if any(_is_leaf(v) for v in tree):
            raise TypeError("a list of bare tensors has no parameter "
                            "container: wrap each in a dict")
        return nn.ModuleList(to_module(v) for v in tree)
    raise TypeError(f"not a parameter tree: {type(tree).__name__}")


def _is_leaf(v) -> bool:
    return isinstance(v, (torch.Tensor, np.ndarray))


def _as_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(np.array(v, dtype=np.float32, copy=True))


def _children(tree):
    """``(key, child)`` pairs in ``jax.tree.flatten``'s order, or None for
    a leaf."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return None
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree) if tree[k] is not None]
    if isinstance(tree, (list, tuple, nn.ModuleList)):
        return list(enumerate(tree))
    if isinstance(tree, nn.Module):
        named = {**dict(tree._parameters), **dict(tree._modules)}
        return [(k, named[k]) for k in sorted(named) if named[k] is not None]
    raise TypeError(f"not a parameter tree: {type(tree).__name__}")


def tree_leaves(tree) -> list:
    """The leaves of a tree — a container module, or plain dicts and lists
    of tensors or numpy arrays — in ``jax.tree.flatten``'s order."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for _, c in kids for leaf in tree_leaves(c)]


def skeleton(tree):
    """The tree's structure with every leaf replaced by None: plain dicts
    (sorted keys) and lists, the port's stand-in for a JAX treedef."""
    kids = _children(tree)
    if kids is None:
        return None
    if isinstance(tree, (dict, nn.Module)) and not isinstance(
            tree, nn.ModuleList):
        return {k: skeleton(c) for k, c in kids}
    return [skeleton(c) for _, c in kids]


def unflatten(skel, leaves: list):
    """Inverse of :func:`tree_leaves` over a :func:`skeleton`: plain dicts
    and lists holding ``leaves`` in order."""
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        if isinstance(s, dict):
            return {k: build(v) for k, v in s.items()}
        return [build(v) for v in s]

    out = build(skel)
    if next(it, None) is not None:
        raise ValueError("more leaves than the skeleton holds")
    return out


def to_numpy(tree):
    """A container module (or tree of tensors) -> plain dicts and lists of
    numpy arrays with the JAX tree's structure."""
    kids = _children(tree)
    if kids is None:
        return (tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor)
                else np.asarray(tree))
    if isinstance(tree, (dict, nn.Module)) and not isinstance(
            tree, nn.ModuleList):
        return {k: to_numpy(c) for k, c in kids}
    return [to_numpy(c) for _, c in kids]
