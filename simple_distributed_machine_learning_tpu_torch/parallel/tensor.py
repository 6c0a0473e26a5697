"""Tensor (model) parallelism: Megatron-style sharded linear pairs (port of
``parallel/tensor.py``).

A ``model`` mesh axis shards the hidden dimension of a linear pair:

- **column-parallel** first layer: weight ``[d_in, d_hidden/mp]`` per
  shard, its output stays sharded, the nonlinearity applies locally;
- **row-parallel** second layer: weight ``[d_hidden/mp, d_out]`` per
  shard; the partial products are summed over the model coordinates.

A tensor-parallel ``Stage.apply`` receives :class:`Shards`: this
process's shards of the stage, in model order, and the model group their
coordinates share with other processes (None when this process owns the
whole model axis of its replica's stage). The sums over the model
coordinates are a local sum over the process's shards, then, across
processes, the wire's ``all_reduce`` over that group. Every coordinate
then holds the same (replicated) activation.

The gradient accounting is Megatron's, where the JAX package's is
``shard_map``'s: every coordinate seeds its backward with the full loss
cotangent (the JAX transpose splits it ``1/mp`` per replica), so

- the row-parallel sum's backward is the identity (JAX: the ``psum``
  transpose);
- :func:`grad_sync` sits on the replicated input of each column-parallel
  product: identity forward, and a backward that sums the shards' input
  gradients over the model coordinates — a local sum in one process (the
  shards share the input tensor), the wire's ``all_reduce`` across
  processes (JAX's ``grad_sync`` sums the split cotangents of the
  replicated leaves instead);
- replicated leaves (the pair's output bias, a GPT block's norms and
  ``mlp_out.b``, ``embed``, ``head``) are stored per shard, as in the JAX
  buffer, and :func:`tie` hands each local copy the full gradient, so
  the copies train in lockstep, bit for bit.

With ``overlap='ring'`` the sums over the model coordinates run as the
ring schedules of ``parallel/overlap.py``: :func:`tp_pair_apply` closes
with ``ring_psum`` (identity backward, as :func:`model_sum`'s) and
:func:`grad_sync`'s backward across processes is the mirrored ring.

The gradients are the dense model's, as in the JAX package.
"""

from __future__ import annotations

import torch

from simple_distributed_machine_learning_tpu_torch.analysis import (
    trace as _trace,
)
from simple_distributed_machine_learning_tpu_torch.ops.layers import (
    init_generator,
    linear_init,
    relu,
)
from simple_distributed_machine_learning_tpu_torch.parallel import (
    mesh as mesh_lib,
)
from simple_distributed_machine_learning_tpu_torch.parallel.overlap import (
    _TAG_BWD,
    _ring_psum_impl,
    check_overlap,
    ring_psum,
)


class Shards(list):
    """This process's shards of one stage — parameter trees in the order
    of their ``axis`` (``"model"`` for tensor parallelism, ``"expert"``
    for expert parallelism) — and ``group``, the process group of the
    stage's coordinates on that axis across processes (None: all of them
    in this process); ``view`` (``mesh.AxisView``, where the pipeline
    passes it) describes the axis whole. As a ``StageParams`` entry a
    shard another process owns is None."""

    def __init__(self, trees, group=None, axis: str = "model",
                 view=None) -> None:
        super().__init__(trees)
        self.group = group
        self.axis = axis
        self.view = view


class _GradSync(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over ``group``
    (the processes of ``axis``)."""

    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return mesh_lib.all_reduce(ct, ctx.group,
                                   axes=(ctx.axis,)), None, None


class _LocalGradSum(torch.autograd.Function):
    """Identity forward and backward, in a program trace only: the
    backward notes its cotangent as summed over ``axis`` — in one process
    the shards that read the input add their gradients into it (autograd's
    own accumulation), a sum over the axis that moves no bytes."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        ct = ct.view_as(ct)
        _trace.note_replicated(ct, ctx.axis)
        return ct, None


class _GradSyncRing(torch.autograd.Function):
    """Identity forward; the backward sums the processes' cotangents in
    ring order (each enters on its first owned coordinate)."""

    @staticmethod
    def forward(ctx, x, view):
        ctx.view = view
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        ct = ct.contiguous()
        parts = [ct] + [torch.zeros_like(ct)] * (len(ctx.view.owned) - 1)
        return _ring_psum_impl(parts, ctx.view, -1, _TAG_BWD), None


class _ModelSum(torch.autograd.Function):
    """The sum over ``group`` forward; identity backward (every
    coordinate already holds the full cotangent of the replicated sum)."""

    @staticmethod
    def forward(ctx, z, group, axis):
        return mesh_lib.all_reduce(z, group, axes=(axis,))

    @staticmethod
    def backward(ctx, ct):
        return ct, None, None


class _Tie(torch.autograd.Function):
    """Local copies of one replicated leaf: copy 0 forward, the full
    cotangent to every copy backward."""

    @staticmethod
    def forward(ctx, *copies):
        ctx.n_copies = len(copies)
        return copies[0].view_as(copies[0])

    @staticmethod
    def backward(ctx, ct):
        return (ct,) * ctx.n_copies


def grad_sync(x: torch.Tensor, group=None, overlap: str = "none",
              view=None, axis: str = mesh_lib.MODEL_AXIS) -> torch.Tensor:
    """Identity forward; the backward sums ``x``'s gradient over the
    coordinates of ``axis`` (the model axis, or the expert axis of an MoE
    input). In one process (``group`` None) the shards that read ``x``
    already add their gradients into it, so this is the identity (a
    program trace notes that sum); across processes it is the
    ``all_reduce`` over ``group`` or, with ``overlap='ring'``, the chunked
    ring of ``overlap.ring_psum`` over ``view`` (the axis's
    ``mesh.AxisView``) in the mirrored direction: each process enters its
    own gradient, and every process ends with the same bits."""
    check_overlap(overlap)
    if group is None:
        return _LocalGradSum.apply(x, axis) if _trace.active() else x
    if overlap == "ring":
        if view is None:
            raise ValueError("grad_sync(overlap='ring') across processes "
                             "needs the axis view (its ring order)")
        return _GradSyncRing.apply(x, view)
    return _GradSync.apply(x, group, axis)


def model_sum(parts, group=None, axis: str = mesh_lib.MODEL_AXIS,
              size: int | None = None) -> torch.Tensor:
    """The row-parallel products of this process's shards summed over the
    model coordinates: locally, then over ``group`` across processes.
    ``axis``/``size`` name the axis summed over (``size`` its width) for
    a program trace's note."""
    z = parts[0]
    for p in parts[1:]:
        z = z + p
    if group is None:
        _trace.note_collective("psum", axis, size or len(parts), list(parts),
                               [z], site="model_sum")
        return z
    return _ModelSum.apply(z, group, axis)


def tie(copies, axis: str = mesh_lib.MODEL_AXIS) -> torch.Tensor:
    """One replicated leaf from this process's per-shard copies of it on
    ``axis`` (all equal): the first, with every copy receiving the full
    gradient. A program trace notes the result as the same on every
    coordinate of the axis (each shard's copy is seeded with it), so a
    copy used untied still varies there."""
    copies = list(copies)
    if len(copies) == 1 and not _trace.active():
        return copies[0]
    out = _Tie.apply(*copies)
    _trace.note_replicated(out, axis)
    return out


def is_sharded_leaf(path) -> bool:
    """True for a leaf genuinely split across the model axis (its path of
    keys in the shard's tree): the GPT's attention projections,
    ``mlp_in`` and ``mlp_out.w``, the MLP pair's ``w1`` and ``w2.w``.
    Everything else — norms, ``mlp_out.b``/``w2.b``, ``embed``, ``head``
    — is replicated in per-shard storage."""
    keys = set(path)
    if keys & {"attn", "mlp_in", "w1"}:
        return True
    return bool(keys & {"mlp_out", "w2"}) and path[-1] == "w"


def as_shards(params) -> Shards:
    """``params`` as :class:`Shards`: as it is, a list of shard trees, or
    one shard's tree (a one-wide model axis)."""
    if isinstance(params, Shards):
        return params
    if isinstance(params, (list, tuple)):
        return Shards(params)
    return Shards([params])


def tp_pair_init(seed, d_in: int, d_hidden: int, d_out: int,
                 n_shards: int) -> list[dict]:
    """Per-shard params for a column -> row parallel linear pair: shard
    ``i`` holds columns ``[i*h, (i+1)*h)`` of W1 (``h = d_hidden /
    n_shards``) and the matching rows of W2, sliced from ONE dense init
    (``seed``: an int or a CPU generator; the two layers drawn in order),
    so a TP run is the dense run to float tolerance. W2's bias is
    replicated on every shard and added after the sum."""
    if d_hidden % n_shards:
        raise ValueError(f"d_hidden {d_hidden} not divisible by {n_shards}")
    gen = init_generator(seed)
    w1 = linear_init(gen, d_in, d_hidden)
    w2 = linear_init(gen, d_hidden, d_out)
    h = d_hidden // n_shards
    return [{"w1": {"w": w1["w"][:, i * h:(i + 1) * h].clone(),
                    "b": w1["b"][i * h:(i + 1) * h].clone()},
             "w2": {"w": w2["w"][i * h:(i + 1) * h, :].clone(),
                    "b": w2["b"].clone()}}
            for i in range(n_shards)]


def tp_pair_apply(params, x: torch.Tensor, activation=relu, group=None,
                  overlap: str = "none") -> torch.Tensor:
    """Column -> activation -> row parallel pair over this process's
    shards (``params``: :class:`Shards`, whose ``group`` and ``view`` are
    used, a list of shard trees, or one shard): one sum over the model
    coordinates per call — the plain sum (``overlap='none'``) or the ring
    of ``overlap.ring_psum`` — the replicated output bias added after
    it."""
    shards = as_shards(params)
    group = shards.group if group is None else group
    view = _model_view(shards, group)
    xs = grad_sync(x, group, overlap, view)
    parts = [activation(xs @ p["w1"]["w"] + p["w1"]["b"]) @ p["w2"]["w"]
             for p in shards]
    z = (ring_psum(parts, view)[0] if overlap == "ring"
         else model_sum(parts, group))
    return z + tie((p["w2"]["b"] for p in shards), shards.axis)


def _model_view(shards, group):
    """The model axis as ``shards`` see it: their ``view``, or (all of its
    coordinates in this process) a local axis as wide as the shards."""
    view = getattr(shards, "view", None)
    if view is None and group is None:
        view = mesh_lib.AxisView.local(mesh_lib.MODEL_AXIS, len(shards))
    return view


def make_mlp_tp_stages(seed, dims, n_stages: int, n_model: int,
                       overlap: str = "none", device=None):
    """Tensor-parallel MLP pipeline stages: each stage is one column ->
    row parallel pair sharded ``n_model`` ways, so ``dims`` has ``2 *
    n_stages`` layers and every hidden width divides by ``n_model``. The
    pairs are drawn from one seed in stage order and sliced from their
    dense inits. Returns ``(stages, wire_dim, out_dim)`` for a
    ``Pipeline`` on a ``make_mesh(n_stages=..., n_model=...)`` mesh."""
    from simple_distributed_machine_learning_tpu_torch._device import (
        resolve_device,
    )
    from simple_distributed_machine_learning_tpu_torch._tree import (
        to_module,
    )
    from simple_distributed_machine_learning_tpu_torch.ops.losses import (
        log_softmax,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (  # noqa: E501
        Stage,
    )
    check_overlap(overlap)
    dev = resolve_device(device)
    dims = [int(d) for d in dims]
    if len(dims) != 2 * n_stages + 1:
        raise ValueError(
            f"TP stages hold one column->row pair each: need exactly "
            f"{2 * n_stages} layers for {n_stages} stages, got "
            f"{len(dims) - 1}")
    gen = init_generator(seed)
    stages = []
    for s in range(n_stages):
        d_in, d_h, d_out = dims[2 * s], dims[2 * s + 1], dims[2 * s + 2]
        shards = tuple(to_module(t).to(dev) for t in
                       tp_pair_init(gen, d_in, d_h, d_out, n_model))
        is_last = s == n_stages - 1

        def apply(params, x, key=None, deterministic=True, _last=is_last):
            y = tp_pair_apply(params, x, activation=relu, overlap=overlap)
            return log_softmax(y) if _last else relu(y)

        stages.append(Stage(apply=apply, params=shards[0],
                            in_shape=(d_in,), shards=shards))
    # only stage inputs/outputs (even-index dims) cross the wire
    return stages, max(dims[::2]), dims[-1]
