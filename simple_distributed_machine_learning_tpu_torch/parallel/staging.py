"""Stage split rule, packed stage buffer and wire codec (port of
``parallel/staging.py``).

The packed buffer is the checkpoint's and the JAX package's parameter
format: each stage's tree flattened in ``jax.tree.flatten`` order (dict
keys sorted, lists by index — :func:`~.._tree.tree_leaves`), cast to f32,
concatenated and zero-padded to the widest stage. A row packed here
unpacks in the JAX package and the other way round. On one card the
optimizer updates the stage modules in place; packing happens only at
checkpoint boundaries.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch

from simple_distributed_machine_learning_tpu_torch._tree import (
    skeleton,
    tree_leaves,
    unflatten,
)


def contiguous_split(units: Sequence[Any], n_stages: int) -> list[list]:
    """Assign ``units`` (layers/blocks) contiguously to ``n_stages`` stages,
    earlier stages taking the remainder — the JAX package's rule, so a
    stage split means the same layers in both packages."""
    n = len(units)
    if n < n_stages:
        raise ValueError(f"{n} layers cannot fill {n_stages} stages")
    per = [n // n_stages + (1 if i < n % n_stages else 0)
           for i in range(n_stages)]
    out, start = [], 0
    for p in per:
        out.append(list(units[start:start + p]))
        start += p
    return out


@dataclasses.dataclass(frozen=True)
class StageMeta:
    """Static description of one stage's packed parameter layout.
    ``treedef`` is the tree's :func:`~.._tree.skeleton` (plain dicts and
    lists with None leaves)."""
    treedef: Any
    shapes: tuple[tuple[int, ...], ...]
    sizes: tuple[int, ...]
    total: int


def stage_meta(params: Any) -> StageMeta:
    """The packed layout of one stage tree (a container module or a tree
    of tensors / numpy arrays)."""
    shapes = tuple(tuple(leaf.shape) for leaf in tree_leaves(params))
    sizes = tuple(math.prod(s) for s in shapes)
    return StageMeta(skeleton(params), shapes, sizes, sum(sizes))


def flatten_row(leaves: Sequence[torch.Tensor], width: int) -> torch.Tensor:
    """Leaves (already in ``jax.tree.flatten`` order) -> one zero-padded
    ``[width]`` f32 row on the CPU."""
    row = torch.zeros(width, dtype=torch.float32)
    off = 0
    for leaf in leaves:
        t = torch.as_tensor(leaf).detach().reshape(-1)
        row[off:off + t.numel()] = t.to(device="cpu", dtype=torch.float32)
        off += t.numel()
    return row


def pack_stage_params(stage_params: Sequence[Any]
                      ) -> tuple[torch.Tensor, list[StageMeta]]:
    """Pack per-stage trees into a ``[n_stages, max_size]`` f32 buffer (on
    the CPU): row s = stage s's leaves in ``jax.tree.flatten`` order,
    zero-padded. Returns the buffer and the metadata that
    :func:`unpack_stage_params` needs."""
    metas = [stage_meta(p) for p in stage_params]
    width = max((m.total for m in metas), default=0)
    rows = [flatten_row(tree_leaves(p), width) for p in stage_params]
    return (torch.stack(rows) if rows
            else torch.zeros((0, 0), dtype=torch.float32)), metas


def unpack_stage_params(row: torch.Tensor, meta: StageMeta) -> Any:
    """Rebuild one stage's tree (plain dicts and lists of views of
    ``row``) from its packed row."""
    leaves, off = [], 0
    for shape, size in zip(meta.shapes, meta.sizes):
        leaves.append(row[off:off + size].reshape(shape))
        off += size
    return unflatten(meta.treedef, leaves)


def wire_encode(x: torch.Tensor, wire_dim: int) -> torch.Tensor:
    """Flatten per-sample features and zero-pad to the pipeline wire width."""
    flat = x.reshape(x.shape[0], -1)
    pad = wire_dim - flat.shape[1]
    if pad < 0:
        raise ValueError(
            f"activation width {flat.shape[1]} exceeds wire_dim {wire_dim}")
    return torch.nn.functional.pad(flat, (0, pad)) if pad else flat


def wire_decode(wire: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """Slice the leading features off the wire and reshape to ``shape``
    (per-sample shape, excluding the batch dim)."""
    size = math.prod(shape)
    return wire[:, :size].reshape((wire.shape[0],) + tuple(shape))
