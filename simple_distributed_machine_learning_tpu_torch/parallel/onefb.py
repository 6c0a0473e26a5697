"""1F1B pipeline schedule: alternating forward/backward with O(S) memory
(port of ``parallel/onefb.py``, the stage axis).

GPipe (``Pipeline`` over several stages) differentiates the sum of every
microbatch's loss with autograd, so every microbatch's residuals are
alive when the backward starts: activation memory grows with the batch.
This schedule interleaves instead (PipeDream-flush / Megatron's
non-interleaved 1F1B), in the JAX package's tick order: at tick ``t``
stage ``s``

- runs the BACKWARD of microbatch ``m_b = t - 2(S-1) + s - 1``, whose
  output cotangent arrived from stage ``s + 1`` at the end of the last
  tick, and hands its input cotangent to stage ``s - 1``;
- runs the FORWARD of microbatch ``m_f = t - s`` under ``torch.no_grad``,
  keeping only its input (and its dropout stream's state), and hands its
  output to stage ``s + 1``.

A backward recomputes its stage from the saved input under autograd and
calls ``torch.autograd.grad`` with the arriving cotangent; the parameter
gradients add up per stage. So a stage keeps at most ``2(S - s) - 1 <=
2S - 1`` inputs in flight (the backward's is released before the
forward's is saved), whatever the number of microbatches. One departure
from the JAX program, which recomputes every stage: the last stage's
forward feeds nothing but its own backward one tick later, so it runs
under autograd and keeps that one graph until then instead of running
twice (per step, the last stage's blocks launch the flash forward K1 once
per microbatch, not twice).

The loss normaliser is the whole batch's weight sum, known from the inputs
before the first tick: the last stage seeds each microbatch's backward
with ``1 / den``, so the loss and gradients are GPipe's at any number of
microbatches. Stages hop over ``Tensor.to(device)`` as in GPipe; one
process runs the ticks in order, stage after stage, which is the JAX
``lax.scan``'s arithmetic without its overlap.
"""

from __future__ import annotations

import torch

from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (
    _weighted_nll_sums,
    param_leaves,
)


def onefb_loss_and_grads(pipe, params, x, targets, key=None,
                         deterministic: bool = False, weights=None
                         ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """``(loss, grads)`` of ``pipe`` (a ``Pipeline`` over two or more
    stages) under the 1F1B schedule; ``grads`` in :func:`param_leaves`
    order. The peak of any stage's saved inputs in flight is left in
    ``pipe.onefb_inflight_peak``."""
    S, M = pipe.n_stages, pipe.n_microbatches
    if S < 2:
        raise ValueError("1F1B needs >= 2 pipeline stages")
    xm, tm, wm, den = pipe._microbatches(x, targets, weights)
    den = torch.clamp_min(den, 1e-12)
    seed = pipe._stream_seed(key, deterministic)
    leaves = [param_leaves([p]) for p in params]
    grads: list[list] = [[None] * len(ls) for ls in leaves]
    saved: list[dict] = [{} for _ in range(S)]   # m -> (input, rng state)
    last_graph: dict = {}                        # m -> the last stage's num
    fwd_in: list = [None] * S                    # (input, rng) arriving
    bwd_in: list = [None] * S                    # cotangent arriving
    num = torch.zeros((), dtype=torch.float32, device=pipe.out_device)
    peak = 0
    for t in range(M + 2 * S - 1):
        fwd_out: list = [None] * S
        bwd_out: list = [None] * S
        for s in range(S):
            last = s == S - 1
            m_b = t - 2 * (S - 1) + s - 1
            if 0 <= m_b < M:
                if last:
                    n, h = last_graph.pop(m_b)
                    outs, cots = [n / den], [None]
                else:
                    h, rng = saved[s].pop(m_b)
                    h = h.requires_grad_(s > 0 and h.is_floating_point())
                    y, _ = pipe._stage_call(s, params[s], h, rng,
                                            deterministic)
                    outs, cots = [y], [bwd_in[s]]
                wrt = leaves[s] + ([h] if h.requires_grad else [])
                got = torch.autograd.grad(outs, wrt, cots, allow_unused=True)
                for i, g in enumerate(got[:len(leaves[s])]):
                    if g is not None:
                        grads[s][i] = g if grads[s][i] is None \
                            else grads[s][i] + g
                if s > 0:
                    bwd_out[s - 1] = got[-1].to(pipe.devices[s - 1])
            m_f = t - s
            if 0 <= m_f < M:
                h, rng = ((xm[m_f], pipe._stream_start(seed, m_f)) if s == 0
                          else fwd_in[s])
                if last:
                    # the graph this stage's backward reads next tick
                    h = h.requires_grad_(h.is_floating_point())
                    y, _ = pipe._stage_call(s, params[s], h, rng,
                                            deterministic)
                    n, _, _ = _weighted_nll_sums(y.float(), tm[m_f],
                                                 wm[m_f])
                    num = num + n.detach()
                    last_graph[m_f] = (n, h)
                    continue
                saved[s][m_f] = (h, rng)
                peak = max(peak, len(saved[s]))
                with torch.no_grad():
                    y, rng = pipe._stage_call(s, params[s], h, rng,
                                              deterministic)
                fwd_out[s + 1] = (y.to(pipe.devices[s + 1]), rng)
        fwd_in, bwd_in = fwd_out, bwd_out
    pipe.onefb_inflight_peak = peak
    flat = [g if g is not None else torch.zeros_like(p)
            for gs, ls in zip(grads, leaves) for g, p in zip(gs, ls)]
    return num / den, flat
