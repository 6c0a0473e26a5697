"""Optimizers (port of ``train/optimizer.py``: ``sgd``, ``adamw``,
``clip_by_global_norm``).

The update rules are the JAX package's (themselves torch's SGD-with-momentum
and AdamW), written out here rather than taken from ``torch.optim``, so the
two packages apply the same arithmetic in the same order. Where the JAX
update returns new arrays, this one updates the parameter and state tensors
IN PLACE under ``no_grad`` (there is no buffer to donate in eager PyTorch)
and returns them, so a step's call shape is the JAX one:
``params, state = opt.update(grads, state, params)``.

``params`` is anything :func:`~..parallel.pipeline.param_leaves` flattens
(the pipeline's list of stage modules, each on its stage's device);
``grads`` is aligned with those leaves, each on its parameter's device,
and every state tensor lies beside its parameter, so each update runs on
that tensor's own device. ZeRO-1 (:func:`shard_opt_state_zero1`) is the
identity on a one-wide data axis, as the JAX package's is; over a real
data axis each data replica keeps and updates one slice of every stage's
packed vector, and the parameters are gathered over the stage's data
group after the update (:class:`Zero1State`). The JAX package's
``from_optax`` wraps a JAX library and has no port.

State layout (``train/checkpoint.py`` maps it to the JAX package's): a
list holds one tensor per :func:`param_leaves` entry (momentum, Adam
moments); a tuple is structure; an int is a step counter.
"""

from __future__ import annotations

import sys
from typing import Any, Callable, NamedTuple

import torch
from torch import nn

from simple_distributed_machine_learning_tpu_torch.parallel import (
    mesh as mesh_lib,
)
from simple_distributed_machine_learning_tpu_torch.parallel.expert import (
    is_expert_leaf,
)
from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (
    param_leaves,
    param_units,
)
from simple_distributed_machine_learning_tpu_torch.parallel.tensor import (
    Shards,
    is_sharded_leaf,
)


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]  # (grads, state, params) -> (params, state)


def _zeros_like(params) -> list[torch.Tensor]:
    return [torch.zeros_like(p) for p in param_leaves(params)]


def sgd(learning_rate, momentum: float = 0.0) -> Optimizer:
    """torch-semantics SGD(momentum): ``buf = momentum * buf + grad;
    p -= lr * buf``. State = the momentum buffers (``()`` without
    momentum); with a schedule (``step -> lr``) it is ``(count, buffers)``
    and the k-th update runs at ``schedule(k)``."""
    scheduled = callable(learning_rate)

    def init(params):
        buf = () if momentum == 0.0 else _zeros_like(params)
        return (0, buf) if scheduled else buf

    @torch.no_grad()
    def update(grads, state, params):
        if scheduled:
            count, buf = state
            lr = learning_rate(count)
        else:
            buf, lr = state, learning_rate
        leaves = param_leaves(params)
        if momentum == 0.0:
            for p, g in zip(leaves, grads):
                p.sub_(lr * g)
        else:
            for p, b, g in zip(leaves, buf, grads):
                b.mul_(momentum).add_(g)
                p.sub_(lr * b)
        return params, ((count + 1, buf) if scheduled else buf)

    return Optimizer(init, _zero1_aware(update))


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.01) -> Optimizer:
    """torch-semantics AdamW (decoupled weight decay, bias-corrected
    moments). State = ``(step, m, v)``. ``learning_rate``: float or
    schedule; a schedule reads the step counter (the k-th update runs at
    ``schedule(k)``) and scales both the decay and the moment step."""
    scheduled = callable(learning_rate)

    def init(params):
        return (0, _zeros_like(params), _zeros_like(params))

    @torch.no_grad()
    def update(grads, state, params):
        step, m, v = state
        lr = learning_rate(step) if scheduled else learning_rate
        step += 1
        bc1 = 1 - b1 ** step
        bc2 = 1 - b2 ** step
        for p, m_, v_, g in zip(param_leaves(params), m, v, grads):
            m_.mul_(b1).add_((1 - b1) * g)
            v_.mul_(b2).add_((1 - b2) * g * g)
            # decoupled decay first (torch applies p *= 1 - lr*wd before
            # the Adam step), then the bias-corrected moment update
            p.mul_(1 - lr * weight_decay)
            p.sub_(lr * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps))
        return params, (step, m, v)

    return Optimizer(init, _zero1_aware(update))


def global_grad_norm(grads, params) -> torch.Tensor:
    """The global L2 norm of ``grads`` (aligned with ``param_leaves(params)``)
    on the first gradient's device: each module's per-tensor norms in one
    multi-tensor launch, their squares summed in module order. Every
    parameter of the model counts once, whatever the data, model, seq and
    expert widths: an unsharded stage once (the JAX
    ``replication_weights()``' ``1 / replication``), a sharded stage's
    split leaves from every shard and its replicated leaves (norms,
    ``mlp_out.b``, the router, attention, embed, head) from shard 0 only.
    The JAX package counts those replicated leaves once per shard (its
    weight is 1 for a whole sharded row); the port departs there, so that
    ``--tp M --clip-norm`` and ``--ep D --clip-norm`` clip as the dense
    model does (ROADMAP.md, Queue C). Across processes (a ``StageParams``
    on a distributed mesh) each module's sum comes from the process of its
    replica 0 and seq chunk 0 (model and expert coordinate 0 for an
    unsharded stage) and the sums are added over the world."""
    mesh = getattr(params, "mesh", None)
    distributed = mesh is not None and mesh.distributed
    dev = grads[0].device
    units = ([(0, None, params)] if isinstance(params, nn.Module)
             else param_units(params))
    parts, k = [], 0
    for s, m, module in units:
        c = len(param_leaves([module]))
        gs, k = grads[k:k + c], k + c
        expert = m is not None and params[s].axis == mesh_lib.EXPERT_AXIS
        if m:
            # a replicated leaf of shard m > 0 is shard 0's over again
            names = [n.split(".") for n, _ in module.named_parameters()]
            split = is_expert_leaf if expert else is_sharded_leaf
            gs = [g for g, n in zip(gs, names) if split(n)]
        coord = dict(m=0, q=0, e=0)
        if m is not None:
            coord["e" if expert else "m"] = m
        if gs and (not distributed or mesh.owns(0, s, **coord)):
            norms = torch._foreach_norm(gs, 2, dtype=torch.float32)
            parts.append(torch.stack(norms).square().sum().to(dev))
    sq = sum(parts) if parts else torch.zeros((), device=dev)
    if distributed:
        sq = mesh_lib.all_reduce(sq)
    return torch.sqrt(sq)


def clip_by_global_norm(opt: Optimizer, max_norm: float) -> Optimizer:
    """Wrap ``opt`` with torch ``clip_grad_norm_`` semantics: scale every
    gradient by ``min(1, max_norm / (norm + 1e-6))``, ``norm`` the global
    L2 norm over all of them (:func:`global_grad_norm`, summed over the
    processes; the scale sent back to each
    gradient's device), before the inner update. The norm counts every
    parameter once, as ``clip_by_global_norm(..., Pipeline.
    replication_weights())`` of the JAX package intends, except for the
    replicated leaves of a sharded stage, which the JAX norm counts once
    per shard (:func:`global_grad_norm`)."""
    @torch.no_grad()
    def update(grads, state, params):
        norm = global_grad_norm(grads, params)
        scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
        return opt.update([(g * scale.to(g.device)).to(g.dtype)
                           for g in grads], state, params)

    return Optimizer(opt.init, update)


class Zero1State:
    """An optimizer state sharded over the data axis (ZeRO-1; JAX
    ``optimizer.py:161-199``). Each held module's packed vector (stage
    ``s``'s leaves, or shard ``m``'s, in ``jax.tree.flatten`` order:
    ``train/checkpoint.py``'s row ``[s, m]`` or ``[s, :, m]`` of an
    expert-parallel stage) splits into ``n_data``
    chunks of ``P / n_data`` elements, ``P`` the packed width; data
    replica ``d`` keeps the state of chunk ``d``. This process keeps the
    chunks of the replicas it owns the stage of: ``ranges[s] = (lo, hi)``
    (``ranges[(s, m)]`` for shard ``m`` of a sharded stage), contiguous. ``inner`` is the
    inner optimizer's state over those slices (one flat tensor per held
    module where the unsharded state has one per parameter); an update
    runs the inner rule on the slices of the parameters and gradients,
    then gathers the parameters over each stage's data group (a broadcast
    per chunk from its owner), so every replica holds the updated
    parameters — elementwise the same numbers as the replicated
    update."""

    def __init__(self, inner, ranges: dict, order: list, chunk: int,
                 totals: dict, mesh, axes: dict | None = None) -> None:
        self.inner = inner
        self.ranges = ranges
        self.order = order
        self.chunk = chunk
        self.totals = totals
        self.mesh = mesh
        # the mesh axis of each sharded stage's shards (a checkpoint's row)
        self.axes = axes or {}

    def shard(self, per_tensor) -> list[torch.Tensor]:
        """Per-parameter tensors (``param_leaves`` order) -> this process's
        flat slices, one per owned stage."""
        out = []
        for unit, (lo, hi) in self.ranges.items():
            flat = torch.cat([per_tensor[i].reshape(-1)
                              for i in self.order[unit]])
            out.append(flat[lo:hi].clone())
        return out

    def gather(self, shards: list, params) -> None:
        """Write the updated slices back into ``params`` with every other
        replica's: each chunk comes from the process that owns it."""
        leaves = param_leaves(params)
        for (unit, (lo, hi)), mine in zip(self.ranges.items(), shards):
            s = unit if isinstance(unit, int) else unit[0]
            idx = self.order[unit]
            full = torch.cat([leaves[i].detach().reshape(-1) for i in idx])
            group = self.mesh.data_group(s)
            for d in range(self.mesh.n_data):
                a = min(d * self.chunk, self.totals[unit])
                b = min((d + 1) * self.chunk, self.totals[unit])
                if a == b:
                    continue
                if lo <= a and b <= hi:
                    full[a:b] = mine[a - lo:b - lo]
                if group is not None:
                    full[a:b] = mesh_lib.broadcast(
                        full[a:b], self.mesh.owner(d, s), group)
            off = 0
            for i in idx:
                n = leaves[i].numel()
                leaves[i].copy_(full[off:off + n].view_as(leaves[i]))
                off += n


def _zero1_aware(update):
    """An optimizer's update that also takes a :class:`Zero1State`: the
    rule runs on this process's slices, then the parameters are
    gathered."""
    @torch.no_grad()
    def wrapped(grads, state, params):
        if not isinstance(state, Zero1State):
            return update(grads, state, params)
        shards = state.shard(param_leaves(params))
        _, state.inner = update(state.shard(grads), state.inner, shards)
        state.gather(shards, params)
        return params, state

    return wrapped


def shard_opt_state_zero1(state: Any, mesh=None, param_spec=None,
                          params=None) -> Any:
    """ZeRO-1: shard the optimizer state over the data axis. On the
    one-card mesh (``mesh=None``) or a one-wide data axis there is one data
    shard, so the state is returned as it is — what the JAX package does.
    Over ``n_data > 1`` replicas it returns a :class:`Zero1State`:
    ``param_spec`` is the packed layout (a ``Pipeline`` or its ``metas``;
    the JAX argument is the packed buffer's sharding) and ``params`` the
    ``StageParams`` the state belongs to. A packed width not divisible by
    the data axis keeps the state replicated, with the JAX package's
    stderr line per state buffer."""
    if mesh is None or mesh.n_data == 1:
        return state
    from simple_distributed_machine_learning_tpu_torch.train.checkpoint import (  # noqa: E501
        _metas,
        _units,
    )
    D = mesh.n_data
    width = max(m.total for m in _metas(param_spec))

    def n_buffers(st) -> int:
        if isinstance(st, tuple):
            return sum(n_buffers(x) for x in st)
        return isinstance(st, list)

    if width % D:
        for _ in range(n_buffers(state)):
            sys.stderr.write(
                f"zero1: packed param axis {width} not divisible by data "
                f"axis {D} — this state leaf stays REPLICATED (no memory "
                f"saving)\n")
        return state
    leaves = param_leaves(params)
    chunk = width // D
    ranges, totals, order = {}, {}, {}
    for unit, s, _, idx in _units(params):
        order[unit] = idx
        totals[unit] = sum(leaves[i].numel() for i in idx)
        ds = [d for d in range(D) if mesh.owns(d, s)]
        ranges[unit] = (min(ds[0] * chunk, totals[unit]),
                        min((ds[-1] + 1) * chunk, totals[unit]))
    z = Zero1State(None, ranges, order, chunk, totals, mesh,
                   {s: p.axis for s, p in enumerate(params)
                    if isinstance(p, Shards)})

    def shard(st):
        if isinstance(st, tuple):
            return tuple(shard(x) for x in st)
        return z.shard(st) if isinstance(st, list) else st

    z.inner = shard(state)
    return z
