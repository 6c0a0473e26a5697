"""Device mesh and process bootstrap (port of ``parallel/mesh.py``).

The port's mesh has the JAX package's five axes in its order, data,
stage, model, seq and expert: ``n_data x n_stages x n_model x n_seq x
n_expert`` coordinates numbered data-major, as the JAX ``make_mesh`` lays
its device grid out, so coordinate ``(d, s, m, q, e)`` has index
``(((d * n_stages + s) * n_model + m) * n_seq + q) * n_expert + e``. Each
coordinate has a ``torch.device`` (``coord_devices``) where replica ``d``
runs model shard ``m``, sequence chunk ``q`` and expert shard ``e`` of
stage ``s``; a device may stand for several coordinates —
``devices=["cpu"] * 4`` in the CPU tests, ``[cuda:0] * 4`` on one card —
the counterpart of the JAX package's forced host device count.

A run has ``world_size`` processes (``torch.distributed``, gloo); each owns
a contiguous block of ``len(coord_devices) / world_size`` coordinates, so
process ``r`` owns indices ``[r * per, (r + 1) * per)``. One process owns
them all: the one-process pipeline over several stages, with any of the
other axes. The block either holds whole ``(d, s)`` groups (the world size
divides ``n_data * n_stages``) or lies inside one ``(d, s)`` as a box of
its model x seq x expert coordinates: so each replica's owned stages are
one contiguous run, a stage hop crosses at most from one process to the
next, and a process exchanges with the processes of its own first model,
seq and expert coordinates (``m0``, ``q0``, ``e0``). The coordinates of one
``(d, s)`` that a process owns share a device: the model, seq and expert
axes run in one process on one card, their collectives local.

The process groups a run needs are built with the mesh (every process
calls ``make_mesh`` with the same arguments, as every JAX process builds
the same mesh): a data group per stage and model, seq and expert
coordinate (ZeRO-1's gather), a gradient group per stage over the data and
seq axes (the parameters are replicated over both: gradient and loss
sums), one group per ``(d, s)`` and axis over the model, seq and expert
coordinates split over processes (their collectives) and, for the loss
and the metrics, the world. :meth:`Mesh.view` describes one axis as a
process sees it at ``(d, s)`` (:class:`AxisView`), which the collectives
below take.

``make_mesh()`` with one coordinate, one process and no device list stays
``None``, the trivial one-card mesh that ``Pipeline`` takes down its fused
path.

The wire between processes is gloo over the host (``send``/``recv``
below): a tensor on the card is copied to the host, sent, and copied back
onto the receiving coordinate's device — the reference's own RPC wire,
which shipped CPU tensors. Two processes on one card cannot use NCCL. The
axis collectives (:func:`permute` and its one-hop :func:`ring_shift`,
:func:`all_to_all`, :func:`all_gather`) are a shuffle of tensors between the coordinates of
one process and gloo point-to-point or ``all_to_all_single`` across
processes, each differentiable.

Inside a program trace (``analysis/trace.py``, fake tensors) every one of
these sites notes its collective for the linter — the primitive, the
axis, the group's width, the tensors — and the wire moves nothing: a
``recv`` gives zeros of its shape, an ``all_reduce`` or ``broadcast`` a
copy of its input.
"""

from __future__ import annotations

import dataclasses
import math
import os
from datetime import timedelta
from typing import Any, Sequence

import torch

from simple_distributed_machine_learning_tpu_torch._device import (
    resolve_device,
)
from simple_distributed_machine_learning_tpu_torch.analysis import (
    trace as _trace,
)

DATA_AXIS = "data"
STAGE_AXIS = "stage"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
#: the keyword of each inner axis's coordinate in ``owner``/``owns``
_KW = {MODEL_AXIS: "m", SEQ_AXIS: "q", EXPERT_AXIS: "e"}


@dataclasses.dataclass(frozen=True)
class AxisView:
    """One mesh axis as one process sees it at one ``(d, s)``: its
    ``size``, the coordinates this process ``owned`` (contiguous), the
    rank that owns each coordinate (``ranks``, at this process's other
    coordinates) and the process group over those ranks (None when this
    process owns every coordinate: the collectives are then local)."""
    name: str
    size: int
    owned: range
    ranks: tuple[int, ...] = ()
    group: Any = None

    @staticmethod
    def local(name: str, size: int) -> "AxisView":
        """An axis whose every coordinate lives in this process."""
        return AxisView(name, size, range(size), (0,) * size, None)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n_data x n_stages x n_model x n_seq x n_expert`` coordinates,
    ``coord_devices[i]`` the device of coordinate index ``i`` (module
    docstring); this process (``rank`` of ``world_size``) owns a contiguous
    block of them. ``groups`` maps a tuple of ranks to its process group
    (built by :func:`make_mesh` when ``world_size > 1``)."""
    coord_devices: tuple[torch.device, ...]
    n_data: int = 1
    rank: int = 0
    world_size: int = 1
    groups: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)
    n_model: int = 1
    n_seq: int = 1
    n_expert: int = 1

    @property
    def _block(self) -> int:
        """Coordinates of one ``(d, s)``."""
        return self.n_model * self.n_seq * self.n_expert

    @property
    def n_stages(self) -> int:
        return len(self.coord_devices) // (self.n_data * self._block)

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes by name, as a JAX mesh's ``shape``."""
        return {DATA_AXIS: self.n_data, STAGE_AXIS: self.n_stages,
                MODEL_AXIS: self.n_model, SEQ_AXIS: self.n_seq,
                EXPERT_AXIS: self.n_expert}

    @property
    def distributed(self) -> bool:
        return self.world_size > 1

    @property
    def _per(self) -> int:
        return len(self.coord_devices) // self.world_size

    def _index(self, d: int, s: int, m: int = 0, q: int = 0,
               e: int = 0) -> int:
        return (((d * self.n_stages + s) * self.n_model + m) * self.n_seq
                + q) * self.n_expert + e

    def _owner(self, d: int, s: int, m: int = 0, q: int = 0,
               e: int = 0) -> int:
        return self._index(d, s, m, q, e) // self._per

    @property
    def _first(self) -> tuple[int, int, int]:
        """This process's first owned ``(m, q, e)``: zeros when it owns
        whole ``(d, s)`` groups, else where its block starts."""
        if self._per >= self._block:
            return 0, 0, 0
        off = (self.rank * self._per) % self._block
        qe = self.n_seq * self.n_expert
        return off // qe, (off // self.n_expert) % self.n_seq, \
            off % self.n_expert

    @property
    def m0(self) -> int:
        """This process's first owned model coordinate."""
        return self._first[0]

    @property
    def e0(self) -> int:
        """This process's first owned expert coordinate."""
        return self._first[2]

    def _coord(self, m, q, e) -> tuple[int, int, int]:
        m0, q0, e0 = self._first
        return (m0 if m is None else m, q0 if q is None else q,
                e0 if e is None else e)

    def owner(self, d: int, s: int, m: int | None = None,
              q: int | None = None, e: int | None = None) -> int:
        """The rank that owns coordinate ``(d, s, m, q, e)``; an inner
        coordinate None is this process's own first one — ``owner(d, s)``
        is the peer this process exchanges with at ``(d, s)``."""
        return self._owner(d, s, *self._coord(m, q, e))

    def owns(self, d: int, s: int, m: int | None = None,
             q: int | None = None, e: int | None = None) -> bool:
        """Whether this process owns ``(d, s, m, q, e)`` (None: its own
        first inner coordinate)."""
        return self.owner(d, s, m, q, e) == self.rank

    def device(self, d: int, s: int, m: int | None = None,
               q: int | None = None, e: int | None = None) -> torch.device:
        return self.coord_devices[self._index(d, s, *self._coord(m, q, e))]

    def _axis_range(self, d: int, s: int, axis: str) -> range:
        """The coordinates along ``axis`` of ``(d, s)`` this process owns,
        at its first coordinates of the other inner axes (contiguous)."""
        size = self.shape[axis]
        owned = [i for i in range(size)
                 if self.owns(d, s, **{_KW[axis]: i})]
        return range(owned[0], owned[-1] + 1) if owned else range(0)

    def seq_range(self, d: int, s: int) -> range:
        """The seq coordinates of ``(d, s)`` this process owns."""
        return self._axis_range(d, s, SEQ_AXIS)

    def view(self, d: int, s: int, axis: str) -> AxisView:
        """``axis`` (model, seq or expert) at ``(d, s)`` as this process
        sees it."""
        if axis not in _KW:
            raise ValueError(f"unknown mesh axis {axis!r}: the mesh binds "
                             f"{sorted(self.shape)}")
        size = self.shape[axis]
        ranks = tuple(self.owner(d, s, **{_KW[axis]: i}) for i in range(size))
        return AxisView(axis, size, self._axis_range(d, s, axis), ranks,
                        self.groups.get(tuple(sorted(set(ranks)))))

    @property
    def replicas(self) -> list[int]:
        """The replicas this process holds at least one stage of."""
        return [d for d in range(self.n_data)
                if any(self.owns(d, s) for s in range(self.n_stages))]

    def stage_range(self, d: int) -> range:
        """Replica ``d``'s stages that this process owns (contiguous)."""
        owned = [s for s in range(self.n_stages) if self.owns(d, s)]
        return range(owned[0], owned[-1] + 1) if owned else range(0)

    @property
    def stages(self) -> list[int]:
        """The stages this process holds the parameters of."""
        return [s for s in range(self.n_stages)
                if any(self.owns(d, s) for d in range(self.n_data))]

    def _held(self, axis: str) -> range:
        d = self.replicas[0] if self.replicas else 0
        s = self.stage_range(d)[0] if self.stage_range(d) else 0
        return self._axis_range(d, s, axis)

    @property
    def shards(self) -> range:
        """The model shards this process holds of each stage it holds
        (the same for every stage)."""
        return self._held(MODEL_AXIS)

    @property
    def expert_shards(self) -> range:
        """The expert shards this process holds of each stage it holds."""
        return self._held(EXPERT_AXIS)

    @property
    def primary(self) -> bool:
        """Whether this process's coordinates are model and expert
        coordinate 0: the one of their replicas whose values count once
        in a sum over processes."""
        return self.m0 == 0 and self.e0 == 0

    @property
    def devices(self) -> list[torch.device]:
        """Per stage, where this process keeps its parameters: the device
        of its first owned coordinate of the stage (replica 0's for a
        stage it does not own)."""
        out = []
        for s in range(self.n_stages):
            ds = [d for d in range(self.n_data) if self.owns(d, s)] or [0]
            out.append(self.device(ds[0], s))
        return out

    def data_group(self, s: int):
        """The process group of the processes owning stage ``s``'s
        coordinates at this process's inner coordinates (ZeRO-1's data
        shards); None when this process is the only one."""
        return self.groups.get(
            tuple(sorted({self.owner(d, s) for d in range(self.n_data)})))

    def grad_group(self, s: int):
        """The process group over stage ``s``'s data and seq coordinates
        at this process's model and expert coordinates: the parameters
        are replicated over both, so gradients and the loss sum over it;
        None when this process is the only one."""
        return self.groups.get(tuple(sorted(
            {self.owner(d, s, q=q) for d in range(self.n_data)
             for q in range(self.n_seq)})))


def visible_devices() -> list[torch.device]:
    """The cards this process sees (none without CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_initialized() else 1


def check_split(world: int, n_data: int = 1, n_stages: int = 1,
                n_model: int = 1, n_seq: int = 1, n_expert: int = 1) -> None:
    """Raise unless ``world`` processes can split the ``n_data x n_stages
    x n_model x n_seq x n_expert`` mesh (:func:`make_mesh`'s rule), with
    its text — a check that needs no process group."""
    groups = n_data * n_stages
    block = n_model * n_seq * n_expert
    need = groups * block
    dims = f"{n_data}x{n_stages}x{n_model}x{n_seq}x{n_expert}"
    if need % world or (groups % world and world % groups):
        raise ValueError(
            f"{world} processes cannot split a {dims} (data x stage x "
            f"model x seq x expert) mesh: the process count must divide "
            f"{need} and either divide {groups} or be a multiple of it")
    per, qe = need // world, n_seq * n_expert
    if per < block and not (per % qe == 0 if per >= qe else
                            (qe % per == 0 and (per % n_expert == 0
                                                or n_expert % per == 0))):
        raise ValueError(
            f"{world} processes cannot split a {dims} mesh: {per} "
            f"coordinates per process do not form a box of one (data, "
            f"stage)'s {n_model}x{n_seq}x{n_expert} model x seq x expert "
            f"coordinates")


def make_mesh(n_stages: int = 1, n_data: int | None = None,
              n_model: int = 1, n_seq: int = 1, n_expert: int = 1,
              devices: Sequence | None = None) -> Mesh | None:
    """A ``n_data x n_stages x n_model x n_seq x n_expert`` mesh over
    ``devices`` (None = the visible cards), coordinate ``i`` on
    ``devices[i]``; a list may name one device more than once.
    ``n_data=None`` means 1. Across processes (``bootstrap_distributed``
    first) every process passes the same arguments and owns its block of
    coordinates; the world size must divide the coordinate count and
    either divide ``n_data * n_stages`` or be a multiple of it, and a
    block inside one ``(d, s)`` must be a box of its model x seq x expert
    coordinates. One coordinate, one process and no device list give
    ``None``, the trivial mesh."""
    n_data = 1 if n_data is None else n_data
    sizes = {STAGE_AXIS: n_stages, DATA_AXIS: n_data, MODEL_AXIS: n_model,
             SEQ_AXIS: n_seq, EXPERT_AXIS: n_expert}
    bad = {k: v for k, v in sizes.items() if int(v) < 1}
    if bad:
        raise ValueError(f"mesh axes must be >= 1, got {bad}")
    world, rank = process_count(), process_index()
    need = n_data * n_stages * n_model * n_seq * n_expert
    if devices is None and need == 1 and world == 1:
        return None
    check_split(world, n_data, n_stages, n_model, n_seq, n_expert)
    dims = f"{n_data}x{n_stages}x{n_model}x{n_seq}x{n_expert}"
    devs = (visible_devices() if devices is None
            else [resolve_device(d) for d in devices])
    if need > len(devs):
        raise ValueError(f"mesh {dims} needs {need} devices, have "
                         f"{len(devs)}")
    devs = devs[:need]
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"a mesh's devices must be of one type (the "
                         f"dropout stream crosses stages), got {devs}")
    mesh = Mesh(tuple(devs), n_data, rank, world, n_model=n_model,
                n_seq=n_seq, n_expert=n_expert)
    for d in range(n_data):
        for s in range(n_stages):
            mine = {mesh.device(d, s, m, q, e)
                    for m in mesh._axis_range(d, s, MODEL_AXIS)
                    for q in mesh.seq_range(d, s)
                    for e in mesh._axis_range(d, s, EXPERT_AXIS)}
            if len(mine) > 1:
                raise ValueError(
                    f"the model, seq and expert coordinates of replica "
                    f"{d}'s stage {s} that one process owns must share a "
                    f"device (their collectives are local), got "
                    f"{sorted(map(str, mine))}")
    if world > 1:
        # every process builds every group, in one order (new_group is a
        # collective over the world): per stage the data groups and the
        # data x seq gradient groups, per (d, s) one group per inner axis
        dist = torch.distributed
        inner = [(m, q, e) for m in range(n_model) for q in range(n_seq)
                 for e in range(n_expert)]
        sets = [tuple(sorted({mesh._owner(d, s, *c) for d in range(n_data)}))
                for s in range(n_stages) for c in inner]
        sets += [tuple(sorted({mesh._owner(d, s, m, q, e)
                               for d in range(n_data)
                               for q in range(n_seq)}))
                 for s in range(n_stages) for m in range(n_model)
                 for e in range(n_expert)]
        for d in range(n_data):
            for s in range(n_stages):
                for m, q, e in inner:
                    sets += [tuple(sorted({mesh._owner(d, s, i, q, e)
                                           for i in range(n_model)})),
                             tuple(sorted({mesh._owner(d, s, m, i, e)
                                           for i in range(n_seq)})),
                             tuple(sorted({mesh._owner(d, s, m, q, i)
                                           for i in range(n_expert)}))]
        for ranks in sets:
            if len(ranks) > 1 and ranks not in mesh.groups:
                mesh.groups[ranks] = dist.new_group(list(ranks))
    return mesh


def bootstrap_distributed(rank: int, world_size: int, master_addr: str,
                          master_port: str | int,
                          timeout_s: int = 300) -> None:
    """Multi-process rendezvous: the reference's bootstrap (``--rank``,
    ``--world_size``, ``--master_addr``/``--master_port``) onto a gloo
    process group over TCP, with a real timeout where the reference waits
    forever. Nothing to do for one process."""
    if world_size <= 1:
        return
    if master_addr in ("localhost", "127.0.0.1"):
        # every rank on this host: gloo's sockets on the loopback device
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://{master_addr}:{master_port}",
        rank=int(rank), world_size=int(world_size),
        timeout=timedelta(seconds=timeout_s))


# -- the host-staged wire ------------------------------------------------------

#: what this process put on the wire: point-to-point sends and their
#: bytes, the sums (``all_reduce``) and broadcasts and their payload bytes
WIRE = {"sends": 0, "bytes": 0, "sums": 0, "sum_bytes": 0,
        "broadcasts": 0, "broadcast_bytes": 0}


class _Traced:
    """The pending work of a send inside a trace: nothing to wait for."""

    @staticmethod
    def wait() -> None:
        return None


def _group_ranks(group) -> tuple:
    """The ranks of ``group`` (None: the world); () without a process
    group."""
    if not _dist_ready():
        return ()
    if group is None:
        return tuple(range(torch.distributed.get_world_size()))
    return tuple(torch.distributed.get_process_group_ranks(group))


def _dist_ready() -> bool:
    return (torch.distributed.is_available()
            and torch.distributed.is_initialized())


def send(t: torch.Tensor, dst: int, tag: int = 0):
    """Send ``t`` to rank ``dst`` over gloo, staged through the host;
    returns the pending work (its buffer stays alive with it). Inside a
    program trace (``analysis/trace.py``) it only notes the send."""
    if _trace.active():
        _trace.note_collective("send", (), 2, [t], [], site="send",
                               peer=int(dst), tag=int(tag))
        return _Traced, t
    host = t.detach().to("cpu").reshape(-1).contiguous()
    work = torch.distributed.isend(host, dst, tag=tag)
    WIRE["sends"] += 1
    WIRE["bytes"] += host.numel() * host.element_size()
    return work, host


def recv(shape, dtype, src: int, device, tag: int = 0) -> torch.Tensor:
    """Receive a ``shape``/``dtype`` tensor from rank ``src`` onto
    ``device`` (the wire is flat: only the element count must match).
    Inside a program trace it notes the receive and returns zeros."""
    if _trace.active():
        out = torch.zeros(tuple(shape), dtype=dtype, device=device)
        _trace.note_collective("recv", (), 2, [], [out], site="recv",
                               peer=int(src), tag=int(tag))
        return out
    host = torch.empty(math.prod(shape), dtype=dtype)
    torch.distributed.recv(host, src, tag=tag)
    return host.reshape(tuple(shape)).to(device)


def wait_all(pending: list) -> None:
    """Finish this process's pending sends."""
    for work, _ in pending:
        work.wait()
    pending.clear()


def all_reduce(t: torch.Tensor, group=None, axes=()) -> torch.Tensor:
    """Sum ``t`` over ``group`` (None: the world) through the host;
    returns the sum on ``t``'s device. ``axes`` names the mesh axes the
    group spans, for a program trace, where the sum is only noted (its
    result stands in as a copy of ``t``)."""
    if _trace.active():
        out = t.detach().clone()
        ranks = _group_ranks(group)
        _trace.note_collective("psum", axes, max(1, len(ranks)), [t],
                               [out], site="all_reduce", ranks=ranks)
        return out
    host = t.detach().to("cpu").clone()
    torch.distributed.all_reduce(host, group=group)
    WIRE["sums"] += 1
    WIRE["sum_bytes"] += host.numel() * host.element_size()
    return host.to(t.device)


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` of rank ``src`` on every rank of ``group`` (None: the world),
    on ``t``'s device. Inside a program trace it only notes."""
    if _trace.active():
        out = t.detach().clone()
        ranks = _group_ranks(group)
        _trace.note_collective("pbroadcast", (), max(1, len(ranks)), [t],
                               [out], site="broadcast", peer=int(src),
                               ranks=ranks)
        return out
    host = t.detach().to("cpu").clone()
    torch.distributed.broadcast(host, src, group=group)
    WIRE["broadcasts"] += 1
    WIRE["broadcast_bytes"] += host.numel() * host.element_size()
    return host.to(t.device)


class LockstepClock:
    """A clock whose every reading is the reading of the axis's first
    coordinate's process, broadcast over the axis's process group: one
    8-byte broadcast per read. The processes of a serving mesh that spans
    them must make the same admission, preemption and shedding decisions
    on every tick, or they run different collective sequences; their
    own clocks never agree exactly, so they all take one."""

    def __init__(self, clock, view: AxisView) -> None:
        self.clock = clock
        self.view = view
        self.src = view.ranks[0]

    def __call__(self) -> float:
        t = torch.tensor([float(self.clock())], dtype=torch.float64)
        return float(broadcast(t, self.src, self.view.group)[0])


def lockstep_clock(clock, view: AxisView | None):
    """``clock`` read in lockstep over ``view``'s processes
    (:class:`LockstepClock`); ``clock`` itself when the axis lies in this
    process (or there is none), or when it already reads over ``view``."""
    if view is None or view.group is None:
        return clock
    if isinstance(clock, LockstepClock) and clock.view == view:
        return clock
    return LockstepClock(clock, view)


# -- the axis collectives --------------------------------------------------------

# tags of the axis collectives' point-to-point messages: a base plus the
# receiving coordinate, apart from the pipeline's stage hops
# (parallel/pipeline.py uses 1-3)
_TAG_FWD, _TAG_BWD = 1000, 2000


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return t if t.device == dev else t.to(dev)


def _permute_raw(xs, view: AxisView, offset: int, tag: int) -> list:
    """Coordinate ``c``'s new tensor is coordinate ``c - offset``'s (all of
    one shape), each landing on the device of the tensor it replaces;
    the sends are posted before the receives, so no ring deadlocks."""
    n, owned = view.size, list(view.owned)
    devs = [x.device for x in xs]
    if view.group is None:
        out = [_to(xs[(c - offset) % n], devs[c]) for c in range(n)]
        _trace.note_collective("ppermute", view.name, n, list(xs), out,
                               site="permute", offset=offset)
        return out
    me = view.ranks[owned[0]]
    pending = []
    for k, c in enumerate(owned):
        dst = (c + offset) % n
        if view.ranks[dst] != me:
            pending.append(send(xs[k], view.ranks[dst], tag + dst))
    out = []
    for k, c in enumerate(owned):
        src = (c - offset) % n
        if view.ranks[src] == me:
            out.append(_to(xs[owned.index(src)], devs[k]))
        else:
            out.append(recv(xs[k].shape, xs[k].dtype, view.ranks[src],
                            devs[k], tag + c))
    wait_all(pending)
    return out


class _Permute(torch.autograd.Function):
    """The permute across processes; its backward is the inverse one."""

    @staticmethod
    def forward(ctx, view, offset, *xs):
        ctx.view, ctx.offset = view, offset
        return tuple(_permute_raw(xs, view, offset, _TAG_FWD))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None) + tuple(_permute_raw(
            [g.contiguous() for g in gs], ctx.view, -ctx.offset, _TAG_BWD))


def permute(xs: list, view: AxisView, offset: int = 1) -> list:
    """The JAX ``ppermute`` with pairs ``(j, j + offset)``: given the owned
    coordinates' tensors (one shape), each owned coordinate's new tensor
    is the one of coordinate ``c - offset``. Differentiable: within the
    process a rotation of the list, across processes gloo point-to-point
    (the backward the inverse permute)."""
    if view.group is None:
        return _permute_raw(list(xs), view, offset, _TAG_FWD)
    return list(_Permute.apply(view, offset, *xs))


def ring_shift(xs: list, view: AxisView) -> list:
    """One hop around the axis's ring (coordinate ``i`` sends to ``i +
    1``, the JAX ``ppermute`` of ring attention): each owned coordinate's
    new tensor is the one of the coordinate before it."""
    return permute(xs, view, 1)


def _pieces(x: torch.Tensor, n: int, dim: int) -> tuple:
    if x.shape[dim] % n:
        raise ValueError(f"all_to_all: dim {dim} of {tuple(x.shape)} does "
                         f"not split {n} ways")
    return torch.split(x, x.shape[dim] // n, dim)


def _a2a_wire(xs, view: AxisView, split_dim: int, concat_dim: int) -> list:
    """The tiled all-to-all across processes: each process sends each
    peer the pieces of its owned coordinates' tensors that the peer's
    coordinates take, in one ``all_to_all_single`` through the host."""
    n, owned = view.size, list(view.owned)
    peers = sorted(set(view.ranks))
    blocks = [[c for c in range(n) if view.ranks[c] == r] for r in peers]
    pieces = [_pieces(x, n, split_dim) for x in xs]
    if _trace.active():
        # the shapes the exchange gives, from this process's own pieces
        out = [torch.cat([p[j % len(p)] for j in range(n)], concat_dim)
               for p in pieces]
        _trace.note_collective("all_to_all", view.name, n, list(xs), out,
                               site="all_to_all",
                               ranks=tuple(view.ranks))
        return out
    shape = pieces[0][0].shape
    dev, dtype = xs[0].device, xs[0].dtype
    out = torch.cat([pieces[i][j].reshape(-1) for blk in blocks
                     for i in range(len(xs)) for j in blk]).to("cpu")
    got = torch.empty_like(out)
    torch.distributed.all_to_all_single(got, out, group=view.group)
    got = got.to(dev, dtype).split(math.prod(shape))
    # from each peer: its coordinates' pieces for each of ours, in order
    recv = {}
    k = 0
    for blk in blocks:
        for i in blk:
            for j in owned:
                recv[i, j] = got[k].view(shape)
                k += 1
    return [torch.cat([recv[i, j] for i in range(n)], concat_dim)
            for j in owned]


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, view, split_dim, concat_dim, *xs):
        ctx.args = (view, split_dim, concat_dim)
        return tuple(_a2a_wire(xs, view, split_dim, concat_dim))

    @staticmethod
    def backward(ctx, *gs):
        view, split_dim, concat_dim = ctx.args
        return (None, None, None) + tuple(
            _a2a_wire([g.contiguous() for g in gs], view, concat_dim,
                      split_dim))


def all_to_all(xs: list, view: AxisView, split_dim: int,
               concat_dim: int) -> list:
    """The JAX ``lax.all_to_all(..., tiled=True)`` over the axis: given
    the owned coordinates' tensors (one shape), coordinate ``j``'s result
    is piece ``j`` of every coordinate's tensor split ``size`` ways on
    ``split_dim``, concatenated in coordinate order on ``concat_dim``. A
    reshuffle within the process; across processes ``all_to_all_single``
    over gloo, its backward the reverse exchange."""
    n = view.size
    if view.group is None:
        pieces = [_pieces(x, n, split_dim) for x in xs]
        out = [torch.cat([p[j] for p in pieces], concat_dim)
               for j in range(n)]
        _trace.note_collective("all_to_all", view.name, n, list(xs), out,
                               site="all_to_all")
        return out
    return list(_AllToAll.apply(view, split_dim, concat_dim, *xs))


class _AllGather(torch.autograd.Function):
    """Every coordinate's tensor concatenated on ``dim``; the backward
    hands each owned coordinate its own slice of the cotangent (every
    coordinate holds the full cotangent of the replicated result)."""

    @staticmethod
    def forward(ctx, view, dim, *xs):
        ctx.view, ctx.dim = view, dim
        local = torch.cat(xs, dim)
        peers = len(set(view.ranks))
        if _trace.active():
            out = torch.cat([local] * peers, dim)
            _trace.note_collective("all_gather", view.name, view.size,
                                   list(xs), [out], site="all_gather",
                                   ranks=tuple(view.ranks))
            return out
        host = local.detach().to("cpu").contiguous()
        got = [torch.empty_like(host) for _ in range(peers)]
        torch.distributed.all_gather(got, host, group=view.group)
        return torch.cat(got, dim).to(local.device)

    @staticmethod
    def backward(ctx, g):
        view = ctx.view
        parts = torch.split(g, g.shape[ctx.dim] // view.size, ctx.dim)
        return (None, None) + tuple(parts[j] for j in view.owned)


def all_gather(xs: list, view: AxisView, dim: int) -> torch.Tensor:
    """The JAX ``lax.all_gather(..., tiled=True)`` over the axis: every
    coordinate's tensor concatenated in coordinate order on ``dim``, the
    same on every coordinate — a ``cat`` within the process, gloo across
    processes."""
    if view.group is None:
        out = torch.cat(list(xs), dim)
        _trace.note_collective("all_gather", view.name, view.size,
                               list(xs), [out], site="all_gather")
        return out
    return _AllGather.apply(view, dim, *xs)


def axis_mean(parts: list, view: AxisView) -> torch.Tensor:
    """The mean over every coordinate of the axis of one value per owned
    coordinate (the JAX ``lax.pmean``): summed here, over the axis's
    processes (identity backward, as ``tensor.model_sum``), divided by
    the axis size."""
    from simple_distributed_machine_learning_tpu_torch.parallel.tensor import (  # noqa: E501
        model_sum,
    )
    return model_sum(list(parts), view.group, axis=view.name,
                     size=view.size) / view.size
