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

The loss normaliser is the whole batch's weight sum, summed over the last
stage's data group before the first tick: the last stage seeds each
microbatch's backward with ``1 / den``, so the loss and gradients are
GPipe's at any number of microbatches. A process runs the ticks of each of
its replicas in turn, its own stages in order within a tick, which is the
JAX ``lax.scan``'s arithmetic without its overlap. Stages of one process
hop over ``Tensor.to(device)`` as in GPipe; across processes both rings
cross the wire every tick (``Pipeline._send_act``/``_recv_act`` forward,
``_send_cot``/``_recv_cot`` back): what a stage sends at the end of tick
``t`` its neighbour receives in tick ``t + 1``, so each receive waits only
on an earlier tick and the sends never block.
"""

from __future__ import annotations

import torch

from simple_distributed_machine_learning_tpu_torch.parallel import (
    mesh as mesh_lib,
)
from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (
    _weighted_nll_sums,
    param_leaves,
)


def onefb_loss_and_grads(pipe, params, x, targets, key=None,
                         deterministic: bool = False, weights=None
                         ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """``(loss, grads)`` of ``pipe`` (a ``Pipeline`` over two or more
    stages) under the 1F1B schedule; ``grads`` are the global gradients of
    this process's stages, in :func:`param_leaves` order. The peak of any
    stage's saved inputs in flight is left in ``pipe.onefb_inflight_peak``."""
    if pipe.n_stages < 2:
        raise ValueError("1F1B needs >= 2 pipeline stages")
    reps, b = pipe._replica_batches(x, targets, weights)
    seed = pipe._stream_seed(key, deterministic)
    den = pipe._den(reps)
    nums, grads, pending = [], [], []
    pipe.onefb_inflight_peak = 0
    for d, batch in reps.items():
        num, g = _replica_ticks(pipe, params, d, batch, b, seed,
                                deterministic, den, pending)
        if num is not None:
            nums.append(num)
        grads.append(g)
    mesh_lib.wait_all(pending)
    return pipe._loss(nums, den), pipe._reduce_grads(params, grads)


def _replica_ticks(pipe, params, d, batch, b, seed, deterministic, den,
                   pending):
    """The ticks of replica ``d`` over this process's stages: ``(num,
    grads)`` — the replica's ``sum(w·nll)`` (None without its last stage)
    and its gradients per stage (None for a stage it does not run)."""
    S, M, mesh = pipe.n_stages, pipe.n_microbatches, pipe.mesh
    xm, tm, wm = batch
    stages = mesh.stage_range(d)
    a, z = stages[0], stages[-1]
    den = None if den is None else torch.clamp_min(den, 1e-12)
    p = {s: pipe._replica_params(params, d, s) for s in stages}
    leaves = {s: param_leaves([params[s]]) for s in stages}
    grads = {s: [None] * len(leaves[s]) for s in stages}
    saved: dict = {s: {} for s in stages}        # m -> (input, rng state)
    last_graph: dict = {}                        # m -> the last stage's num
    fwd_in: dict = {}                            # s -> (input, rng) arriving
    bwd_in: dict = {}                            # s -> cotangent arriving
    num = torch.zeros((), dtype=torch.float32, device=mesh.device(d, S - 1))
    for t in range(M + 2 * S - 1):
        fwd_out: dict = {}
        bwd_out: dict = {}
        for s in stages:
            last = s == S - 1
            m_b = t - 2 * (S - 1) + s - 1
            if 0 <= m_b < M:
                if last:
                    n, h = last_graph.pop(m_b)
                    outs, cots = [n / den], [None]
                else:
                    h, rng = saved[s].pop(m_b)
                    h = h.requires_grad_(s > 0 and h.is_floating_point())
                    y, _ = pipe._stage_call(s, p[s], h, rng, deterministic)
                    outs = [y]
                    cots = [bwd_in.pop(s) if s < z
                            else pipe._recv_cot(d, s, y)]
                wrt = leaves[s] + ([h] if h.requires_grad else [])
                got = torch.autograd.grad(outs, wrt, cots, allow_unused=True)
                for i, g in enumerate(got[:len(leaves[s])]):
                    if g is not None:
                        grads[s][i] = g if grads[s][i] is None \
                            else grads[s][i] + g
                if s > 0:
                    gh = got[-1] if got[-1] is not None else \
                        torch.zeros_like(h)
                    if s > a:
                        bwd_out[s - 1] = gh.to(mesh.device(d, s - 1))
                    else:
                        pipe._send_cot(d, s, gh, pending)
            m_f = t - s
            if 0 <= m_f < M:
                if s == 0:
                    h, rng = xm[m_f], pipe._stream_start(
                        seed, d * M + m_f, mesh.device(d, 0))
                elif s > a:
                    h, rng = fwd_in.pop(s)
                else:
                    h, rng = pipe._recv_act(d, s, b, seed is not None)
                if last:
                    # the graph this stage's backward reads next tick
                    h = h.requires_grad_(h.is_floating_point())
                    y, _ = pipe._stage_call(s, p[s], h, rng, deterministic)
                    n, _, _ = _weighted_nll_sums(y.float(), tm[m_f],
                                                 wm[m_f])
                    num = num + n.detach()
                    last_graph[m_f] = (n, h)
                    continue
                saved[s][m_f] = (h, rng)
                pipe.onefb_inflight_peak = max(pipe.onefb_inflight_peak,
                                               len(saved[s]))
                with torch.no_grad():
                    y, rng = pipe._stage_call(s, p[s], h, rng,
                                              deterministic)
                if s < z:
                    fwd_out[s + 1] = (y.to(mesh.device(d, s + 1)), rng)
                else:
                    pipe._send_act(d, s, y, rng, pending)
        fwd_in, bwd_in = fwd_out, bwd_out
    out: list = [None] * S
    for s in stages:
        out[s] = [g if g is not None else torch.zeros_like(t)
                  for g, t in zip(grads[s], leaves[s])]
    return (num if z == S - 1 else None), out
