"""The overlapped collectives: ring schedules of the model axis's sums and
gathers (port of ``parallel/overlap.py``).

Every monolithic collective of the tensor-parallel hot paths becomes a
ring of hops over the axis, each hop carrying ``1/mp`` of the tensor, with
the matching chunk of the matmul scheduled beside it:

- :func:`allgather_matmul` — ``allgather(x) @ w`` for row-sharded ``x``
  (the column-parallel layer of a scattered Megatron pair);
- :func:`matmul_reducescatter` — ``reduce_scatter(x @ w)`` (the
  row-parallel layer of a scattered pair);
- :func:`ring_psum` — the chunked sum with a replicated result, in place
  of the sum that closes a row-parallel product (a reduce-scatter ring and
  an all-gather ring over the last axis's chunks);
- :func:`ring_all_gather` / :func:`ring_reduce_scatter` — the bare data
  movers.

The port keeps the layout of ``parallel/tensor.py``, where one process
holds several coordinates of the axis: every primitive takes the list of
this process's per-coordinate tensors (in coordinate order) and the
axis's ``mesh.AxisView``, and returns one tensor per owned coordinate. A
hop (``mesh.permute``) within the process is a rotation of the list
(and a ``Tensor.to`` where two coordinates sit on different cards);
across processes it is a host-staged gloo send and receive.

Ring order is the contract. The chunk that ends at coordinate ``c``
starts at ``c + 1`` and visits ``c + 2, ..., c``: a fixed summation order
per chunk, so every coordinate's replica of a replicated result is the
same bits (a gather moves the finished chunks and adds nothing), and on
the CPU the f32 results equal the JAX primitives' bit for bit.

Gradients. Each primitive is a ``torch.autograd.Function`` whose backward
is the mirrored schedule (the reversed ring, ``sign = -1`` below:
coordinate ``j`` sends to ``j - 1``, the JAX ``_bwd_perm``) wherever
its output is sharded: the cotangent of a sharded output is that
coordinate's own. A replicated output follows the port's Megatron
accounting instead (``parallel/tensor.py``): it is one tensor per
process, every process seeds it with the full cotangent, so the
backward of :func:`ring_psum` hands that cotangent to every owned input
(the identity, as ``tensor.model_sum``'s) and that of
:func:`ring_all_gather` hands each owned coordinate its own slice, with no
hop; the summing backward of the JAX ``ring_psum`` lives in
``tensor.grad_sync(..., overlap="ring")``. The gradients are the dense
model's, as the JAX package's are.

With ``mp == 1`` every primitive is the plain local matmul or the
identity. The JAX package hides each hop under a chunk's compute on the
TPU's interconnect; on one card the hops are list rotations and the
schedule only adds launches (``PERF.md``).
"""

from __future__ import annotations

import torch

from simple_distributed_machine_learning_tpu_torch.analysis import (
    trace as _trace,
)
from simple_distributed_machine_learning_tpu_torch.parallel import (
    mesh as mesh_lib,
)
from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (
    _TAG_BWD,
    _TAG_FWD,
    _permute_raw,
    _to,
)

OVERLAP_CHOICES = ("none", "ring")


def check_overlap(overlap: str) -> str:
    if overlap not in OVERLAP_CHOICES:
        raise ValueError(
            f"overlap must be one of {OVERLAP_CHOICES}, got {overlap!r}")
    return overlap


def _row_chunk(x: torch.Tensor, c: int, n: int) -> torch.Tensor:
    """Rows ``[c*n, (c+1)*n)`` of ``x``."""
    return x[c * n:(c + 1) * n]


# ---- the schedules (no autograd: the Functions below wrap them) -------------

def _ring_all_gather_impl(xs, view, sign: int = 1, tag: int = _TAG_FWD):
    """Every coordinate's ``[n, ...]`` chunk in coordinate order, gathered
    in this process by ``mp - 1`` hops; concatenated on the first owned
    coordinate's device."""
    mp, owned = view.size, list(view.owned)
    got = dict(zip(owned, xs))
    have = list(xs)
    for s in range(1, mp):
        have = _permute_raw(have, view, sign, tag)
        # after s hops a coordinate holds the chunk that started s
        # coordinates back around the ring
        for k, c in enumerate(owned):
            got.setdefault((c - sign * s) % mp, have[k])
    dev = xs[0].device
    return torch.cat([_to(got[c], dev) for c in range(mp)])


def _ring_reduce_scatter_impl(xs, view, sign: int = 1,
                              tag: int = _TAG_FWD) -> list:
    """Per-coordinate partials ``[mp*n, ...]`` -> chunk ``c`` of their sum
    on each owned coordinate ``c``. The accumulator of chunk ``c`` starts
    at coordinate ``c + sign`` and adds one partial per hop, ending at
    ``c``: the ring order."""
    mp, owned = view.size, list(view.owned)
    if xs[0].shape[0] % mp:
        raise ValueError(
            f"ring_reduce_scatter: leading axis {xs[0].shape[0]} not "
            f"divisible by axis size {mp}")
    n = xs[0].shape[0] // mp
    acc = [_row_chunk(x, (c - sign) % mp, n) for x, c in zip(xs, owned)]
    for s in range(1, mp):
        acc = _permute_raw(acc, view, sign, tag)
        acc = [a + _row_chunk(x, (c - sign * (s + 1)) % mp, n)
               for a, x, c in zip(acc, xs, owned)]
    return acc


def _ring_psum_impl(xs, view, sign: int = 1, tag: int = _TAG_FWD):
    """The sum over the axis of the owned coordinates' tensors, the same
    bits on every coordinate: a reduce-scatter ring and an all-gather ring
    over the last axis's chunks. A last axis that does not divide by the
    ring size takes the plain sum (local, then over the axis's
    processes)."""
    mp = view.size
    if xs[0].shape[-1] % mp:
        dev = xs[0].device
        z = _to(xs[0], dev)
        for x in xs[1:]:
            z = z + _to(x, dev)
        if view.group is None:
            _trace.note_collective("psum", view.name, mp, list(xs), [z],
                                   site="ring_psum")
            return z
        return mesh_lib.all_reduce(z, view.group, axes=(view.name,))
    xt = [x.movedim(-1, 0) for x in xs]
    acc = _ring_reduce_scatter_impl(xt, view, sign, tag)
    return _ring_all_gather_impl(acc, view, sign, tag).movedim(0, -1)


def _allgather_matmul_impl(xs, ws, view, sign: int = 1,
                           tag: int = _TAG_FWD) -> list:
    """``allgather(x) @ w_c`` on each owned coordinate ``c``: each held
    activation chunk multiplies while the next rides the ring."""
    mp, owned = view.size, list(view.owned)
    outs = [[None] * mp for _ in owned]
    chunk = list(xs)
    for s in range(mp):
        for k, c in enumerate(owned):
            outs[k][(c - sign * s) % mp] = chunk[k] @ ws[k]
        if s + 1 < mp:
            chunk = _permute_raw(chunk, view, sign, tag)
    return [torch.cat(o) for o in outs]


def _matmul_reducescatter_impl(xs, ws, view, sign: int = 1,
                               tag: int = _TAG_FWD) -> list:
    """Chunk ``c`` of ``sum_j x_j @ w_j`` on each owned coordinate ``c``:
    each row chunk's partial product computes while the accumulator of
    the previous one rides the ring."""
    mp, owned = view.size, list(view.owned)
    if xs[0].shape[0] % mp:
        raise ValueError(
            f"matmul_reducescatter: {xs[0].shape[0]} rows not divisible by "
            f"axis size {mp}")
    n = xs[0].shape[0] // mp
    acc = [_row_chunk(x, (c - sign) % mp, n) @ w
           for x, w, c in zip(xs, ws, owned)]
    for s in range(1, mp):
        acc = _permute_raw(acc, view, sign, tag)
        acc = [a + _row_chunk(x, (c - sign * (s + 1)) % mp, n) @ w
               for a, x, w, c in zip(acc, xs, ws, owned)]
    return acc


def _gatherT_matmul_impl(xs, dys, view, sign: int = 1,
                         tag: int = _TAG_FWD) -> list:
    """``allgather(x)^T @ dy_c`` on each owned coordinate without
    materialising the gather: the ``x`` chunks (``[n, d]`` each)
    circulate and each hop accumulates ``x_j^T @ dy_c[rows j]``, rows
    ``[j*n, (j+1)*n)``."""
    mp, owned = view.size, list(view.owned)
    n = xs[0].shape[0]
    acc = [None] * len(owned)
    chunk = list(xs)
    for s in range(mp):
        for k, c in enumerate(owned):
            j = (c - sign * s) % mp
            t = chunk[k].T @ _row_chunk(dys[k], j, n)
            acc[k] = t if acc[k] is None else acc[k] + t
        if s + 1 < mp:
            chunk = _permute_raw(chunk, view, sign, tag)
    return acc


# ---- the differentiable primitives ------------------------------------------

def _check(xs, view, name: str) -> list:
    xs = list(xs)
    if len(xs) != len(view.owned):
        raise ValueError(f"{name}: {len(xs)} tensors for the owned "
                         f"coordinates {list(view.owned)} of {view.name!r}")
    return xs


class _RingAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, view, *xs):
        ctx.view = view
        ctx.devs = [x.device for x in xs]
        ctx.n = xs[0].shape[0]
        return _ring_all_gather_impl(xs, view)

    @staticmethod
    def backward(ctx, g):
        # the replicated output's full cotangent: each owned coordinate
        # its own rows, no hop (Megatron's gather backward)
        n = ctx.n
        return (None,) + tuple(_to(_row_chunk(g, c, n), d)
                               for c, d in zip(ctx.view.owned, ctx.devs))


def ring_all_gather(xs: list, view) -> list:
    """All-gather the owned coordinates' row shards ``[n, ...]`` (shard
    ``c`` = global rows ``[c*n, (c+1)*n)``) into ``[mp*n, ...]`` by
    ``mp - 1`` hops: the same tensor for every owned coordinate. Backward:
    each coordinate's rows of the (replicated) cotangent."""
    xs = _check(xs, view, "ring_all_gather")
    if view.size == 1:
        return xs
    y = _RingAllGather.apply(view, *xs)
    _trace.note_collective("all_gather", view.name, view.size, xs, [y],
                           site="ring_all_gather", summary=True)
    return [y] * len(xs)


class _RingReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, view, *xs):
        ctx.view = view
        ctx.devs = [x.device for x in xs]
        return tuple(_ring_reduce_scatter_impl(xs, view))

    @staticmethod
    def backward(ctx, *gs):
        # y_c = x_j[rows c] summed over j: dx_j = allgather(dy), the
        # mirrored all-gather ring
        full = _ring_all_gather_impl([g.contiguous() for g in gs], ctx.view,
                                     -1, _TAG_BWD)
        return (None,) + tuple(_to(full, d) for d in ctx.devs)


def ring_reduce_scatter(xs: list, view) -> list:
    """Reduce-scatter the owned coordinates' partials ``[mp*n, ...]``:
    coordinate ``c`` gets rows ``[c*n, (c+1)*n)`` of their sum over the
    axis, summed in ring order. Backward: the mirrored all-gather ring."""
    xs = _check(xs, view, "ring_reduce_scatter")
    if view.size == 1:
        return xs
    return list(_RingReduceScatter.apply(view, *xs))


class _RingPsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, view, *xs):
        ctx.devs = [x.device for x in xs]
        return _ring_psum_impl(xs, view)

    @staticmethod
    def backward(ctx, g):
        # Megatron: every process seeds the replicated sum with the full
        # cotangent, which is each summand's (tensor.model_sum's rule)
        return (None,) + tuple(_to(g, d) for d in ctx.devs)


def ring_psum(xs: list, view) -> list:
    """The sum over the axis of the owned coordinates' tensors (one shape),
    for a row-parallel product's close: the same bits on every coordinate,
    in ring order; a last axis that does not divide by ``mp`` takes the
    plain sum. Backward: the identity (module docstring)."""
    xs = _check(xs, view, "ring_psum")
    if view.size == 1:
        return xs
    y = _RingPsum.apply(view, *xs)
    _trace.note_collective("psum", view.name, view.size, xs, [y],
                           site="ring_psum", summary=True)
    return [y] * len(xs)


class _AllGatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, view, n_own, *xws):
        xs, ws = list(xws[:n_own]), list(xws[n_own:])
        ctx.view, ctx.n_own = view, n_own
        ctx.save_for_backward(*xws)
        return tuple(_allgather_matmul_impl(xs, ws, view))

    @staticmethod
    def backward(ctx, *dys):
        view, n_own = ctx.view, ctx.n_own
        saved = ctx.saved_tensors
        xs, ws = list(saved[:n_own]), list(saved[n_own:])
        dys = [d.contiguous() for d in dys]
        # dx_j = sum_c (dy_c @ w_c^T)[rows j]: the mirrored
        # matmul + reduce-scatter
        dx = _matmul_reducescatter_impl(dys, [w.T for w in ws], view, -1,
                                        _TAG_BWD)
        # dw_c = allgather(x)^T @ dy_c, re-circulating the x chunks
        dw = _gatherT_matmul_impl(xs, dys, view, -1, _TAG_BWD)
        return (None, None) + tuple(dx) + tuple(dw)


def allgather_matmul(xs: list, ws: list, view) -> list:
    """``allgather(x) @ w_c`` for each owned coordinate ``c`` (the
    column-parallel collective matmul): ``xs`` the row shards ``[n, d]``,
    ``ws`` the coordinates' weights ``[d, k]`` (column shards), returns
    ``[mp*n, k]`` each. Backward: ``dx`` by the mirrored matmul +
    reduce-scatter, ``dw`` by circulating the saved ``x`` chunks."""
    xs = _check(xs, view, "allgather_matmul")
    ws = list(ws)
    if view.size == 1:
        return [x @ w for x, w in zip(xs, ws)]
    return list(_AllGatherMatmul.apply(view, len(xs), *xs, *ws))


class _MatmulReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, view, n_own, *xws):
        xs, ws = list(xws[:n_own]), list(xws[n_own:])
        ctx.view, ctx.n_own = view, n_own
        ctx.save_for_backward(*xws)
        return tuple(_matmul_reducescatter_impl(xs, ws, view))

    @staticmethod
    def backward(ctx, *dys):
        view, n_own = ctx.view, ctx.n_own
        saved = ctx.saved_tensors
        xs, ws = list(saved[:n_own]), list(saved[n_own:])
        dys = [d.contiguous() for d in dys]
        # d(x_j @ w_j) = allgather(dy): dx_j = allgather(dy) @ w_j^T
        dx = _allgather_matmul_impl(dys, [w.T for w in ws], view, -1,
                                    _TAG_BWD)
        # dw_j = x_j^T @ allgather(dy) = (allgather(dy)^T @ x_j)^T: the dy
        # chunks circulate against x_j's rows
        dw = [t.T for t in _gatherT_matmul_impl(dys, xs, view, -1,
                                                _TAG_BWD)]
        return (None, None) + tuple(dx) + tuple(dw)


def matmul_reducescatter(xs: list, ws: list, view) -> list:
    """``reduce_scatter(x_j @ w_j)`` (the row-parallel collective matmul):
    ``xs`` each coordinate's ``[N, d]`` activations (``N`` divisible by
    ``mp``), ``ws`` its ``[d, k]`` contracting-dim weight shard; coordinate
    ``c`` gets rows ``[c*N/mp, (c+1)*N/mp)`` of the sum, in ring order.
    Backward: ``dx`` by the mirrored all-gather matmul, ``dw`` by
    circulating the ``dy`` chunks against the saved ``x`` rows."""
    xs = _check(xs, view, "matmul_reducescatter")
    ws = list(ws)
    if view.size == 1:
        return [x @ w for x, w in zip(xs, ws)]
    return list(_MatmulReduceScatter.apply(view, len(xs), *xs, *ws))
