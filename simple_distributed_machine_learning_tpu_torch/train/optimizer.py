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
(the pipeline's list of stage modules); ``grads`` is aligned with those
leaves. ZeRO-1 (:func:`shard_opt_state_zero1`) is the identity on the
one-card mesh, as the JAX package's is on a one-wide data axis; sharding
the state over a real data axis waits for ROADMAP Queue A item 6. The JAX
package's ``from_optax`` wraps a JAX library and has no port.

State layout (``train/checkpoint.py`` maps it to the JAX package's): a
list holds one tensor per :func:`param_leaves` entry (momentum, Adam
moments); a tuple is structure; an int is a step counter.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from simple_distributed_machine_learning_tpu_torch import _roadmap
from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (
    param_leaves,
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

    return Optimizer(init, update)


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

    return Optimizer(init, update)


def clip_by_global_norm(opt: Optimizer, max_norm: float) -> Optimizer:
    """Wrap ``opt`` with torch ``clip_grad_norm_`` semantics: scale every
    gradient by ``min(1, max_norm / (norm + 1e-6))``, ``norm`` the global
    L2 norm over all of them, before the inner update. (The JAX package's
    ``norm_weights``, the replication correction of its packed multi-device
    buffer, waits for the multi-device slice: on one card every parameter
    is stored once.)"""
    @torch.no_grad()
    def update(grads, state, params):
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
        return opt.update([(g * scale).to(g.dtype) for g in grads], state,
                          params)

    return Optimizer(opt.init, update)


def shard_opt_state_zero1(state: Any, mesh=None, param_spec=None) -> Any:
    """ZeRO-1: shard the optimizer state over the data axis. On the
    one-card mesh (``mesh=None``) there is one data shard, so the state is
    returned as it is — what the JAX package does on a one-wide data axis.
    A real data axis is not ported yet."""
    if mesh is None:
        return state
    raise _roadmap.not_ported(f"ZeRO-1 over the mesh {mesh!r}",
                              _roadmap.PARALLEL_AXES)
