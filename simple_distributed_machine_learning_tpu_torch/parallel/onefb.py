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
from simple_distributed_machine_learning_tpu_torch.parallel.sequence import (
    SeqShards,
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
    nums, grads, auxes, pending = [], [], [], []
    pipe.onefb_inflight_peak = 0
    for d, batch in reps.items():
        num, g, aux = _replica_ticks(pipe, params, d, batch, b, seed,
                                     deterministic, den, pending)
        if num is not None:
            nums.append(num)
        if aux is not None:
            auxes.append(aux)
        grads.append(g)
    mesh_lib.wait_all(pending)
    return pipe._loss(nums, den, auxes), pipe._reduce_grads(params, grads)


def _tensors(h) -> list:
    return list(h) if isinstance(h, SeqShards) else [h]


def _replica_ticks(pipe, params, d, batch, b, seed, deterministic, den,
                   pending):
    """The ticks of replica ``d`` over this process's stages: ``(num,
    grads, aux)`` — the replica's ``sum(w·nll)`` (None without its last
    stage), its gradients per stage (None for a stage it does not run)
    and its stages' weighted aux terms (None when no stage returns
    one)."""
    S, M, mesh = pipe.n_stages, pipe.n_microbatches, pipe.mesh
    xm, tm, wm = batch
    stages = mesh.stage_range(d)
    a, z = stages[0], stages[-1]
    den = None if den is None else torch.clamp_min(den, 1e-12)
    p = {s: pipe._replica_params(params, d, s) for s in stages}
    leaves = {s: param_leaves([params[s]]) for s in stages}
    grads = {s: [None] * len(leaves[s]) for s in stages}
    saved: dict = {s: {} for s in stages}        # m -> (input, rng state)
    last_graph: dict = {}                        # m -> the last stage's obj
    fwd_in: dict = {}                            # s -> (input, rng) arriving
    bwd_in: dict = {}                            # s -> cotangents arriving
    num = torch.zeros((), dtype=torch.float32, device=mesh.device(d, S - 1))
    aux_sum = None
    scale = pipe._aux_scale

    def weighted(aux):
        return None if aux is None else aux.float() * scale

    for t in range(M + 2 * S - 1):
        fwd_out: dict = {}
        bwd_out: dict = {}
        for s in stages:
            last = s == S - 1
            m_b = t - 2 * (S - 1) + s - 1
            if 0 <= m_b < M:
                if last:
                    obj, h = last_graph.pop(m_b)
                    outs, cots = [obj], [None]
                else:
                    h, rng = saved[s].pop(m_b)
                    for c in _tensors(h):
                        c.requires_grad_(s > 0 and c.is_floating_point())
                    y, _, aux = pipe._stage_call(s, p[s], h, rng,
                                                 deterministic)
                    outs = _tensors(y)
                    qs = (list(y.view.owned) if isinstance(y, SeqShards)
                          else [None])
                    cots = (bwd_in.pop(s) if s < z else
                            [pipe._recv_cot(d, s, c, q)
                             for c, q in zip(outs, qs)])
                    if aux is not None:
                        outs.append(weighted(aux))
                        cots.append(None)
                ins = [c for c in _tensors(h) if c.requires_grad]
                wrt = leaves[s] + ins
                got = torch.autograd.grad(outs, wrt, cots, allow_unused=True)
                for i, g in enumerate(got[:len(leaves[s])]):
                    if g is not None:
                        grads[s][i] = g if grads[s][i] is None \
                            else grads[s][i] + g
                if s > 0:
                    ghs = [g if g is not None else torch.zeros_like(c)
                           for g, c in zip(got[len(leaves[s]):],
                                           _tensors(h))]
                    if s > a:
                        bwd_out[s - 1] = pipe._hop(ghs,
                                                   mesh.device(d, s - 1),
                                                   offset=-1)
                    else:
                        for g, (_, q) in zip(ghs, pipe._inputs(h)):
                            pipe._send_cot(d, s, g, pending, q)
            m_f = t - s
            if 0 <= m_f < M:
                if s == 0:
                    h = pipe._seq_input(d, xm[m_f])
                    rng = pipe._stream_start(seed, d * M + m_f,
                                             mesh.device(d, 0),
                                             pipe._chunks_of(d))
                elif s > a:
                    h, rng = fwd_in.pop(s)
                else:
                    h, rng = pipe._recv_act(d, s, b, seed is not None)
                if last:
                    # the graph this stage's backward reads next tick
                    for c in _tensors(h):
                        c.requires_grad_(c.is_floating_point())
                    y, _, aux = pipe._stage_call(s, p[s], h, rng,
                                                 deterministic)
                    n = 0
                    for c, tt in zip(_tensors(y),
                                     pipe._token_slices(tm[m_f], y)):
                        n = n + _weighted_nll_sums(c.float(), tt,
                                                   wm[m_f])[0]
                    num = num + n.detach()
                    obj = n / den
                    if aux is not None:
                        obj = obj + weighted(aux).to(obj.device)
                        aux_sum = _add(aux_sum, weighted(aux).detach())
                    last_graph[m_f] = (obj, h)
                    continue
                saved[s][m_f] = (h, rng)
                pipe.onefb_inflight_peak = max(pipe.onefb_inflight_peak,
                                               len(saved[s]))
                with torch.no_grad():
                    y, rng, aux = pipe._stage_call(s, p[s], h, rng,
                                                   deterministic)
                if aux is not None:
                    aux_sum = _add(aux_sum, weighted(aux).to(num.device))
                if s < z:
                    fwd_out[s + 1] = (pipe._hop(y, mesh.device(d, s + 1)),
                                      rng)
                else:
                    pipe._send_act(d, s, y, rng, pending)
        fwd_in, bwd_in = fwd_out, bwd_out
    out: list = [None] * S
    for s in stages:
        out[s] = [g if g is not None else torch.zeros_like(t)
                  for g, t in zip(grads[s], leaves[s])]
    return (num if z == S - 1 else None), out, aux_sum


def _add(total, x):
    return x if total is None else total + x.to(total.device)
