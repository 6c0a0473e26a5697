"""Device mesh and process bootstrap (port of ``parallel/mesh.py``).

The port's mesh has three axes, data, stage and model, in the JAX axis
order: ``n_data x n_stages x n_model`` coordinates numbered data-major,
as the JAX ``make_mesh`` lays its device grid out, so coordinate ``(d, s,
m)`` has index ``(d * n_stages + s) * n_model + m``. Each coordinate has a
``torch.device`` (``coord_devices``) where replica ``d`` runs model shard
``m`` of stage ``s``; a device may stand for several coordinates —
``devices=["cpu"] * 4`` in the CPU tests, ``[cuda:0] * 4`` on one card —
the counterpart of the JAX package's forced host device count.

A run has ``world_size`` processes (``torch.distributed``, gloo); each owns
a contiguous block of ``n_data * n_stages * n_model / world_size``
coordinates, so process ``r`` owns indices ``[r * per, (r + 1) * per)``.
One process owns them all: the one-process pipeline over several stages,
with a data axis and a model axis. The block either holds whole model
groups (the world size divides ``n_data * n_stages``) or lies inside one
``(d, s)`` (``n_data * n_stages`` divides the world size): so each
replica's owned stages are one contiguous run, a stage hop crosses at most
from one process to the next, and a process exchanges with the processes
of its own model coordinates (``m0``, its first owned one). The model
coordinates of one ``(d, s)`` that a process owns share a device: the
model axis runs in one process on one card, its sums local.

The process groups a run needs are built with the mesh (every process
calls ``make_mesh`` with the same arguments, as every JAX process builds
the same mesh): one data group per stage and model coordinate (the
processes owning ``(., s, m)``: gradient reduction and ZeRO-1's gather),
one model group per ``(d, s)`` split over processes (the tensor-parallel
sums) and, for the loss and the metrics, the world.

``make_mesh()`` with one coordinate, one process and no device list stays
``None``, the trivial one-card mesh that ``Pipeline`` takes down its fused
path. Sequence and expert parallelism wait for ROADMAP Queue A items 6d.2
and 6d.3.

The wire between processes is gloo over the host (``send``/``recv``
below): a tensor on the card is copied to the host, sent, and copied back
onto the receiving coordinate's device — the reference's own RPC wire,
which shipped CPU tensors. Two processes on one card cannot use NCCL.
"""

from __future__ import annotations

import dataclasses
import math
import os
from datetime import timedelta
from typing import Sequence

import torch

from simple_distributed_machine_learning_tpu_torch import _roadmap
from simple_distributed_machine_learning_tpu_torch._device import (
    resolve_device,
)

DATA_AXIS = "data"
STAGE_AXIS = "stage"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n_data x n_stages x n_model`` coordinates, ``coord_devices[(d *
    n_stages + s) * n_model + m]`` the device of replica ``d``'s shard
    ``m`` of stage ``s``; this process (``rank`` of ``world_size``) owns a
    contiguous block of them. ``groups`` maps a tuple of ranks to its
    process group (built by :func:`make_mesh` when ``world_size > 1``)."""
    coord_devices: tuple[torch.device, ...]
    n_data: int = 1
    rank: int = 0
    world_size: int = 1
    groups: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)
    n_model: int = 1

    @property
    def n_stages(self) -> int:
        return len(self.coord_devices) // (self.n_data * self.n_model)

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes by name, as a JAX mesh's ``shape``."""
        return {DATA_AXIS: self.n_data, STAGE_AXIS: self.n_stages,
                MODEL_AXIS: self.n_model, SEQ_AXIS: 1, EXPERT_AXIS: 1}

    @property
    def distributed(self) -> bool:
        return self.world_size > 1

    def _index(self, d: int, s: int, m: int) -> int:
        return (d * self.n_stages + s) * self.n_model + m

    def _owner(self, d: int, s: int, m: int) -> int:
        per = len(self.coord_devices) // self.world_size
        return self._index(d, s, m) // per

    @property
    def m0(self) -> int:
        """This process's first owned model coordinate: 0 when it owns
        whole model groups, else where its block starts."""
        per = len(self.coord_devices) // self.world_size
        return (self.rank * per) % self.n_model if per < self.n_model else 0

    def owner(self, d: int, s: int, m: int | None = None) -> int:
        """The rank that owns coordinate ``(d, s, m)``; ``m`` None: this
        process's own model coordinate ``m0`` — the peer it exchanges
        with at ``(d, s)``."""
        return self._owner(d, s, self.m0 if m is None else m)

    def owns(self, d: int, s: int, m: int | None = None) -> bool:
        """Whether this process owns ``(d, s, m)``; ``m`` None: any model
        coordinate of ``(d, s)``."""
        if m is not None:
            return self._owner(d, s, m) == self.rank
        return self._owner(d, s, self.m0) == self.rank

    def device(self, d: int, s: int, m: int | None = None) -> torch.device:
        return self.coord_devices[self._index(d, s,
                                              self.m0 if m is None else m)]

    def model_range(self, d: int, s: int) -> range:
        """The model coordinates of ``(d, s)`` this process owns
        (contiguous)."""
        owned = [m for m in range(self.n_model) if self.owns(d, s, m)]
        return range(owned[0], owned[-1] + 1) if owned else range(0)

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

    @property
    def shards(self) -> range:
        """The model shards this process holds of each stage it holds
        (the same for every stage)."""
        d = self.replicas[0] if self.replicas else 0
        s = self.stage_range(d)[0] if self.stage_range(d) else 0
        return self.model_range(d, s)

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
        coordinates at this process's model coordinate; None when this
        process is the only one."""
        return self.groups.get(
            tuple(sorted({self.owner(d, s) for d in range(self.n_data)})))

    def model_group(self, d: int, s: int):
        """The process group of the processes sharing ``(d, s)``'s model
        axis; None when one process owns it whole."""
        return self.groups.get(tuple(sorted(
            {self._owner(d, s, m) for m in range(self.n_model)})))


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


def make_mesh(n_stages: int = 1, n_data: int | None = None,
              n_model: int = 1, n_seq: int = 1, n_expert: int = 1,
              devices: Sequence | None = None) -> Mesh | None:
    """A ``n_data x n_stages x n_model`` mesh over ``devices`` (None = the
    visible cards), coordinate ``i`` on ``devices[i]``; a list may name one
    device more than once. ``n_data=None`` means 1. Across processes
    (``bootstrap_distributed`` first) every process passes the same
    arguments and owns its block of coordinates; the world size must
    divide ``n_data * n_stages * n_model`` and either divide ``n_data *
    n_stages`` or be a multiple of it. One coordinate, one process and no
    device list give ``None``, the trivial mesh."""
    n_data = 1 if n_data is None else n_data
    sizes = {STAGE_AXIS: n_stages, DATA_AXIS: n_data, MODEL_AXIS: n_model,
             SEQ_AXIS: n_seq, EXPERT_AXIS: n_expert}
    bad = {k: v for k, v in sizes.items() if int(v) < 1}
    if bad:
        raise ValueError(f"mesh axes must be >= 1, got {bad}")
    if int(n_seq) > 1:
        raise _roadmap.not_ported(f"a mesh with axes {{'seq': {n_seq}}}",
                                  _roadmap.SEQ_PARALLEL)
    if int(n_expert) > 1:
        raise _roadmap.not_ported(
            f"a mesh with axes {{'expert': {n_expert}}}", _roadmap.EXPERTS)
    world, rank = process_count(), process_index()
    groups = n_data * n_stages
    need = groups * n_model
    if devices is None and need == 1 and world == 1:
        return None
    if need % world or (groups % world and world % groups):
        raise ValueError(
            f"{world} processes cannot split a {n_data}x{n_stages}x"
            f"{n_model} (data x stage x model) mesh: the process count "
            f"must divide {need} and either divide {groups} or be a "
            f"multiple of it")
    devs = (visible_devices() if devices is None
            else [resolve_device(d) for d in devices])
    if need > len(devs):
        raise ValueError(f"mesh {n_data}x{n_stages}x{n_model}x1x1 needs "
                         f"{need} devices, have {len(devs)}")
    devs = devs[:need]
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"a mesh's devices must be of one type (the "
                         f"dropout stream crosses stages), got {devs}")
    mesh = Mesh(tuple(devs), n_data, rank, world, n_model=n_model)
    for d in range(n_data):
        for s in range(n_stages):
            mine = {mesh.device(d, s, m) for m in mesh.model_range(d, s)}
            if len(mine) > 1:
                raise ValueError(
                    f"the model coordinates of replica {d}'s stage {s} "
                    f"that one process owns must share a device (their "
                    f"sums are local), got {sorted(map(str, mine))}")
    if world > 1:
        # every process builds every group, in one order (new_group is a
        # collective over the world)
        dist = torch.distributed
        sets = [tuple(sorted({mesh._owner(d, s, m) for d in range(n_data)}))
                for s in range(n_stages) for m in range(n_model)]
        sets += [tuple(sorted({mesh._owner(d, s, m)
                               for m in range(n_model)}))
                 for d in range(n_data) for s in range(n_stages)]
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

#: what this process sent over the wire: sends and bytes
WIRE = {"sends": 0, "bytes": 0}


def send(t: torch.Tensor, dst: int, tag: int = 0):
    """Send ``t`` to rank ``dst`` over gloo, staged through the host;
    returns the pending work (its buffer stays alive with it)."""
    host = t.detach().to("cpu").reshape(-1).contiguous()
    work = torch.distributed.isend(host, dst, tag=tag)
    WIRE["sends"] += 1
    WIRE["bytes"] += host.numel() * host.element_size()
    return work, host


def recv(shape, dtype, src: int, device, tag: int = 0) -> torch.Tensor:
    """Receive a ``shape``/``dtype`` tensor from rank ``src`` onto
    ``device`` (the wire is flat: only the element count must match)."""
    host = torch.empty(math.prod(shape), dtype=dtype)
    torch.distributed.recv(host, src, tag=tag)
    return host.reshape(tuple(shape)).to(device)


def wait_all(pending: list) -> None:
    """Finish this process's pending sends."""
    for work, _ in pending:
        work.wait()
    pending.clear()


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over ``group`` (None: the world) through the host;
    returns the sum on ``t``'s device."""
    host = t.detach().to("cpu").clone()
    torch.distributed.all_reduce(host, group=group)
    return host.to(t.device)


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` of rank ``src`` on every rank of ``group`` (None: the world),
    on ``t``'s device."""
    host = t.detach().to("cpu").clone()
    torch.distributed.broadcast(host, src, group=group)
    return host.to(t.device)
