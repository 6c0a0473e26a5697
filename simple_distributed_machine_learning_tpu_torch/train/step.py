"""The train and eval steps (port of ``train/step.py``).

PyTorch runs eagerly, so a step is a plain function, not a compiled
program: forward, loss, backward (through the flash kernels' autograd
Function when the model has ``attn_impl="flash"``), then the optimizer's
in-place update. Nothing in a step waits for the device: losses come back
as device tensors, and the caller decides when to read them.

``key`` is the dropout randomness: an int seed, a ``torch.Generator`` on
the pipeline's device, or None (torch's default generator); over several
stages the pipeline seeds each microbatch's stream from it
(``parallel/pipeline.py``). The port's draws differ from ``jax.random``'s
by design; a model without dropout consumes none.
"""

from __future__ import annotations

import torch

from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (
    Pipeline,
    _generator,
)
from simple_distributed_machine_learning_tpu_torch.data.sharding import (
    host_rows,
)
from simple_distributed_machine_learning_tpu_torch.train.optimizer import (
    Optimizer,
    global_grad_norm,
)


def make_train_step(pipe: Pipeline, opt: Optimizer,
                    with_grad_norm: bool = False):
    """Returns ``step(params, opt_state, x, targets, key=None,
    weights=None) -> (params, opt_state, loss)``; ``params`` and the state
    are updated in place and returned. ``with_grad_norm`` adds a fourth
    output: the global L2 norm of the gradients the update consumes, an
    f32 device scalar taken before the update runs (the one extra value
    the numeric-anomaly sentinel, ``resilience/sentinel.py``, watches
    beside the loss), on the loss's device. Across processes the
    gradients are the global ones (``Pipeline.loss_and_grads`` sums them
    over each stage's data group) and the norm counts each stage once
    (``train/optimizer.py::global_grad_norm``)."""

    def step(params, opt_state, x, targets, key=None, weights=None):
        loss, grads = pipe.loss_and_grads(params, x, targets, key,
                                          deterministic=False,
                                          weights=weights)
        if with_grad_norm:
            gnorm = global_grad_norm(grads, params).to(loss.device)
        params, opt_state = opt.update(grads, opt_state, params)
        if with_grad_norm:
            return params, opt_state, loss, gnorm
        return params, opt_state, loss

    return step


def make_scanned_train_step(pipe: Pipeline, opt: Optimizer, unroll: int = 1,
                            pool_steps: int | None = None):
    """Returns ``step(params, opt_state, xs, targets, key=None) -> (params,
    opt_state, losses)``: ``xs``/``targets`` carry a leading ``n_steps``
    axis and the window runs one optimizer step per batch; ``losses`` is
    the f32 tensor of the per-step losses.

    ``pool_steps``: ``xs``/``targets`` are a POOL of ``P`` batches and the
    window runs ``pool_steps`` steps, reading batch ``t % P`` at step
    ``t``. ``unroll`` is the JAX signature's ``lax.scan`` unroll factor,
    taken and ignored: an eager loop has no scan to unroll, and any value
    gives the same steps. One dropout generator serves the whole window, each
    step drawing after the last (over several stages it lies on the host
    and seeds each step's microbatch streams, so drawing needs no device
    sync)."""

    def step(params, opt_state, xs, targets, key=None):
        gen = _generator(key, pipe.device if pipe.n_stages == 1
                         else torch.device("cpu"))
        xs = pipe._on(xs)
        targets = pipe._on(targets, torch.long)
        n_pool = xs.shape[0]
        n_steps = n_pool if pool_steps is None else int(pool_steps)
        losses = []
        for t in range(n_steps):
            loss, grads = pipe.loss_and_grads(params, xs[t % n_pool],
                                              targets[t % n_pool], gen,
                                              deterministic=False)
            params, opt_state = opt.update(grads, opt_state, params)
            losses.append(loss)
        return params, opt_state, torch.stack(losses)

    return step


def make_eval_step(pipe: Pipeline):
    """Returns ``eval_step(params, x, targets, key=None, n_valid=None) ->
    (sum_nll, n_correct)``: dropout off; rows at or past ``n_valid`` of the
    global batch (the zero-padded tail of a ragged last batch) weigh
    nothing. ``x`` is this process's rows (``data/sharding.py::
    host_rows``; the whole batch on one process); both sums are the whole
    batch's, on every process. ``n_correct`` is an exact integer
    count."""

    def step(params, x, targets, key=None, n_valid=None):
        n, mesh = x.shape[0], pipe.mesh
        lo = (0 if mesh is None
              else host_rows(mesh, n * mesh.n_data // len(mesh.replicas))[0])
        mask = (torch.arange(lo, lo + n, device=pipe.out_device)
                < (lo + n if n_valid is None else int(n_valid))).float()
        sum_loss, _, correct = pipe.eval_metrics(params, x, targets, key,
                                                 weights=mask)
        return sum_loss, correct

    return step
