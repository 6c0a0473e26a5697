"""MLP as a pipeline of linear(+relu) stages ending in log_softmax (port of
``models/mlp.py``).

Stage trees are lists of ``{"w", "b"}`` layers (``nn.ModuleList`` of
:class:`~.._tree.ParamTree`), split with ``contiguous_split`` exactly as
the JAX builder splits them, so a stage's tree has the JAX stage's
structure and a checkpoint's packed rows cross between the packages.
"""

from __future__ import annotations

from typing import Sequence

from simple_distributed_machine_learning_tpu_torch._device import (
    resolve_device,
)
from simple_distributed_machine_learning_tpu_torch._tree import to_module
from simple_distributed_machine_learning_tpu_torch.ops.layers import (
    init_generator,
    linear,
    linear_init,
    relu,
)
from simple_distributed_machine_learning_tpu_torch.ops.losses import (
    log_softmax,
)
from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (
    Stage,
)
from simple_distributed_machine_learning_tpu_torch.parallel.staging import (
    contiguous_split,
)


def make_mlp_stages(seed, dims: Sequence[int], n_stages: int, device=None
                    ) -> tuple[list[Stage], int, int]:
    """Build an MLP ``dims[0] -> ... -> dims[-1]`` split into ``n_stages``
    on ``device`` (None = ``"cuda"``). Hidden activations are relu, the
    last layer ends in log_softmax. ``seed`` is an int or a CPU
    ``torch.Generator``; weights are drawn on the CPU and moved.

    Returns ``(stages, wire_dim, out_dim)`` like the JAX builder."""
    dev = resolve_device(device)
    n_layers = len(dims) - 1
    if n_layers < n_stages:
        raise ValueError(f"{n_layers} layers cannot fill {n_stages} stages")
    gen = init_generator(seed)
    layers = [linear_init(gen, dims[i], dims[i + 1]) for i in range(n_layers)]
    stages: list[Stage] = []
    start = 0
    for s, params in enumerate(contiguous_split(layers, n_stages)):
        is_last = s == n_stages - 1

        def apply(params, x, key=None, deterministic=True,
                  _n=len(params), _last=is_last):
            h = x
            for i in range(_n):
                h = linear(params[i], h)
                if i < _n - 1 or not _last:
                    h = relu(h)
            return log_softmax(h) if _last else h

        stages.append(Stage(apply=apply, params=to_module(params).to(dev),
                            in_shape=(dims[start],)))
        start += len(params)
    return stages, max(dims), dims[-1]
