"""Expert parallelism: the mixture-of-experts FFN with all-to-all dispatch
(port of ``parallel/expert.py``).

The JAX package's GShard/Switch recipe, as plain torch:

- **routing** is a matmul and a top-k over the experts; dispatch and
  combine are one-hot ``[T, E, C]`` tensors contracted against the
  ``[T, d]`` tokens, so every shape is static;
- **capacity** is ``capacity_factor * k * T / E`` slots per expert (``int``
  truncates, as the JAX ``default_capacity`` does): a token past its
  expert's capacity is dropped (combine weight 0; the caller's residual
  carries it);
- **expert parallelism** shards the expert axis: each of ``D`` expert
  coordinates holds ``E / D`` experts and routes its own token shard. One
  all-to-all ships each expert's capacity buffer to its owner, the owner
  runs its experts on an ``[E/D, D*C, d]`` batch, and a second all-to-all
  ships the results back (``parallel/mesh.py::all_to_all``: a reshuffle
  of the coordinates' buffers in one process, gloo across processes).

Exact routing needs three details of the JAX functions: ``lax.top_k``
breaks ties toward the lower expert index (here a stable descending
sort), the capacity priority is rank-major (every token's first choice
before any second choice, token order within a rank), and ``jax.nn.gelu``
is the tanh form. The router has no bias; the aux loss is ``E * sum(f *
p)``. Dispatch and combine are built in the tokens' dtype (the JAX
one-hots are f32, which promotes a bf16 layer to f32 after the dispatch;
the values are the same in f32).

:func:`moe_apply` is the dense ground truth; :func:`moe_apply_ep`
computes the same function per token shard. Both take tokens with any
leading batch dims (``[..., T, d]``: each leading index routes alone, as
the JAX GPT ``vmap``s its sequences).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from simple_distributed_machine_learning_tpu_torch.ops.layers import (
    init_generator,
    linear_init,
)
from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (
    EXPERT_AXIS,
    AxisView,
    all_to_all,
    axis_mean,
    permute,
)


def moe_init(seed, d_model: int, d_hidden: int, n_experts: int,
             dtype=torch.float32) -> dict:
    """Params for a MoE FFN: ``router`` ``[d, E]`` and ``n_experts``
    two-layer MLPs stacked on a leading ``[E, ...]`` axis (``experts``:
    ``in``/``out`` linears), drawn from ``seed`` (an int or a CPU
    generator): the router, then each expert's two layers in order."""
    gen = init_generator(seed)
    router = 0.02 * torch.randn((d_model, n_experts), generator=gen,
                                dtype=dtype)
    experts = [{"in": linear_init(gen, d_model, d_hidden, dtype),
                "out": linear_init(gen, d_hidden, d_model, dtype)}
               for _ in range(n_experts)]
    stacked = {lay: {k: torch.stack([e[lay][k] for e in experts])
                     for k in ("w", "b")} for lay in ("in", "out")}
    return {"router": router, "experts": stacked}


def n_experts_of(params) -> int:
    return params["router"].shape[-1]


def is_expert_leaf(path) -> bool:
    """True for a leaf of the stacked experts (its path of keys in a
    stage tree): split across the expert axis. Everything else — the
    router, attention, norms, embed, head — is replicated in per-shard
    storage."""
    return "experts" in path


def _route(params, x: torch.Tensor, k: int, capacity: int):
    """Top-k routing of tokens ``x`` ``[..., T, d]``: ``(dispatch
    [..., T, E, C] one-hot, combine [..., T, E, C] gate-weighted, aux
    [...])``. Tokens past an expert's capacity get zero combine weight."""
    T = x.shape[-2]
    E = n_experts_of(params)
    gates = torch.softmax(x @ params["router"], dim=-1)        # [..., T, E]
    # Switch load balancing: E * sum_e f_e * p_e, f_e the fraction of
    # tokens whose top-1 is e (argmax: the first maximum), p_e the mean gate
    f = F.one_hot(gates.argmax(-1), E).float().mean(-2)
    aux = E * (f * gates.mean(-2)).sum(-1)
    # top-k, ties to the lower index (lax.top_k): a stable descending sort
    topk_idx = torch.sort(gates, dim=-1, descending=True,
                          stable=True).indices[..., :k]         # [..., T, k]
    topk_gate = torch.gather(gates, -1, topk_idx)
    topk_gate = topk_gate / torch.clamp_min(
        topk_gate.sum(-1, keepdim=True), 1e-9)
    # each (token, choice)'s slot in its expert's buffer, rank-major: every
    # rank-0 choice first, token order within a rank
    sel = F.one_hot(topk_idx, E)                                # [..., T, k, E]
    lead = sel.shape[:-3]
    sel_flat = sel.transpose(-3, -2).reshape(lead + (k * T, E))
    pos_flat = torch.cumsum(sel_flat, dim=-2) - sel_flat
    pos = pos_flat.reshape(lead + (k, T, E)).transpose(-3, -2)
    in_cap = (pos < capacity) & (sel > 0)
    # one routing rank at a time: peak memory one [..., T, E, C] tensor
    dispatch = x.new_zeros(lead + (T, E, capacity))
    combine = x.new_zeros(lead + (T, E, capacity))
    for j in range(k):
        oh = (in_cap[..., j, :].to(x.dtype)[..., None]
              * F.one_hot(torch.clamp(pos[..., j, :], 0, capacity - 1),
                          capacity).to(x.dtype))
        dispatch = dispatch + oh
        combine = combine + oh * topk_gate[..., j, None, None]
    return dispatch, combine, aux


def _expert_ffn(experts, xs: torch.Tensor) -> torch.Tensor:
    """The batched per-expert MLP: ``[..., E, C, d] -> [..., E, C, d]``,
    one contraction per layer, tanh GELU between."""
    h = torch.einsum("...ecd,edh->...ech", xs, experts["in"]["w"])
    h = F.gelu(h + experts["in"]["b"][:, None, :], approximate="tanh")
    y = torch.einsum("...ech,ehd->...ecd", h, experts["out"]["w"])
    return y + experts["out"]["b"][:, None, :]


def default_capacity(n_tokens: int, n_experts: int, k: int,
                     capacity_factor: float = 1.25) -> int:
    return max(1, int(capacity_factor * k * n_tokens / n_experts))


def moe_apply(params, x: torch.Tensor, k: int = 2,
              capacity: int | None = None):
    """The dense MoE FFN, the EP path's ground truth: ``x`` ``[..., T,
    d]`` -> ``(y [..., T, d], aux [...])``."""
    T = x.shape[-2]
    E = n_experts_of(params)
    capacity = default_capacity(T, E, k) if capacity is None else capacity
    dispatch, combine, aux = _route(params, x, k, capacity)
    expert_in = torch.einsum("...tec,...td->...ecd", dispatch, x)
    expert_out = _expert_ffn(params["experts"], expert_in)
    return torch.einsum("...tec,...ecd->...td", combine, expert_out), aux


def moe_apply_ep(params, xs, k: int = 2, capacity: int | None = None,
                 axis: str = EXPERT_AXIS, overlap: str = "none"):
    """The expert-parallel MoE FFN over this process's expert coordinates.

    ``params`` are their MoE trees in order (``parallel/tensor.py::
    Shards`` with the expert axis's ``view``, or a list: every coordinate
    in this process): each holds the router and the coordinate's ``[E/D,
    ...]`` expert slice. ``xs`` are their token shards (``[..., T_local,
    d]`` each). ``capacity`` is per (expert, source coordinate): each
    expert's whole buffer is ``D * capacity``. Returns ``(ys, aux)``: each
    coordinate's ``y``, and the aux loss averaged over the axis (every
    coordinate sees the global value).

    ``overlap='none'`` is the canonical two all-to-alls: dispatch
    everything, run one batched FFN per coordinate, ship everything
    back. ``overlap='ring'`` is the offset-hop dispatch: each coordinate
    runs its own chunk first, then for ``s = 1 .. D-1`` sends the chunk
    owned by coordinate ``i + s`` forward (``mesh.permute`` by ``s``),
    runs the FFN on the chunk that arrives from ``i - s`` and returns the
    result on the mirrored permute — the same math per capacity slot, the
    FFN batched ``[E/D, C, d]`` per chunk instead of ``[E/D, D*C, d]``."""
    from simple_distributed_machine_learning_tpu_torch.parallel.overlap import (  # noqa: E501
        check_overlap,
    )
    ring = check_overlap(overlap) == "ring"
    view = getattr(params, "view", None) or AxisView.local(axis,
                                                           len(params))
    if view.name != axis or not (len(params) == len(xs)
                                   == len(view.owned)):
        raise ValueError(f"moe_apply_ep over axis {axis!r}: {len(params)} "
                         f"shards and {len(xs)} token shards for the "
                         f"coordinates {list(view.owned)} of "
                         f"{view.name!r}")
    E = n_experts_of(params[0])                       # the global count
    T = xs[0].shape[-2]
    capacity = default_capacity(T, E, k) if capacity is None else capacity
    routed = [_route(p, x, k, capacity) for p, x in zip(params, xs)]
    aux = axis_mean([a for _, _, a in routed], view)
    expert_in = [torch.einsum("...tec,...td->...ecd", dsp, x)
                 for (dsp, _, _), x in zip(routed, xs)]   # [..., E, C, d]
    if ring and view.size > 1:
        expert_out = _ring_dispatch(params, expert_in, view)
    else:
        # each expert's buffer to its owner: split E D ways, concatenate
        # the sources' contributions on the capacity axis -> [..., E/D,
        # D*C, d]
        owned_in = all_to_all(expert_in, view, split_dim=-3, concat_dim=-2)
        owned_out = [_expert_ffn(p["experts"], b)
                     for p, b in zip(params, owned_in)]
        # the inverse exchange: each source its slice back -> [..., E, C,
        # d]
        expert_out = all_to_all(owned_out, view, split_dim=-2,
                                concat_dim=-3)
    ys = [torch.einsum("...tec,...ecd->...td", comb, out)
          for (_, comb, _), out in zip(routed, expert_out)]
    return ys, aux


def _ring_dispatch(params, expert_in, view) -> list:
    """``moe_apply_ep``'s ring schedule: each owned coordinate's ``[...,
    E, C, d]`` buffers -> its ``[..., E, C, d]`` expert outputs, by
    ``D - 1`` offset hops out and their mirrored hops back."""
    D, owned = view.size, list(view.owned)
    e_loc = expert_in[0].shape[-3] // D

    def chunk(t, c):
        return t.narrow(-3, c * e_loc, e_loc)

    # own chunk first: no hop to hide it under
    pieces = [{c: _expert_ffn(p["experts"], chunk(b, c))}
              for p, b, c in zip(params, expert_in, owned)]
    for s in range(1, D):
        # offset s: send the chunk owner i + s takes, run the FFN on the
        # one arriving from i - s, return it on the mirrored permute
        recv = permute([chunk(b, (c + s) % D)
                        for b, c in zip(expert_in, owned)], view, s)
        back = permute([_expert_ffn(p["experts"], r)
                        for p, r in zip(params, recv)], view, -s)
        for k, c in enumerate(owned):
            pieces[k][(c + s) % D] = back[k]
    return [torch.cat([pc[e] for e in range(D)], -3) for pc in pieces]
