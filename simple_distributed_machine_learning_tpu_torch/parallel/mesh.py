"""Device mesh and process bootstrap (port of ``parallel/mesh.py``).

The port's mesh has two axes, data and stage: ``n_data x n_stages``
coordinates numbered data-major, as the JAX ``make_mesh`` lays its device
grid out, so coordinate ``(d, s)`` has index ``d * n_stages + s``. Each
coordinate has a ``torch.device`` (``coord_devices``) where replica ``d``
runs stage ``s``; a device may stand for several coordinates —
``devices=["cpu"] * 4`` in the CPU tests, ``[cuda:0] * 4`` on one card —
the counterpart of the JAX package's forced host device count.

A run has ``world_size`` processes (``torch.distributed``, gloo); each owns
a contiguous block of ``n_data * n_stages / world_size`` coordinates, so
process ``r`` owns indices ``[r * per, (r + 1) * per)``. One process owns
them all: the one-process pipeline over several stages, with a data axis.
Ownership being contiguous in data-major order, each replica's owned
stages are one contiguous run, and a stage hop crosses at most from
process ``r`` to ``r + 1``.

The process groups a run needs are built with the mesh (every process
calls ``make_mesh`` with the same arguments, as every JAX process builds
the same mesh): one data group per stage (the processes owning that
stage's coordinates: gradient reduction and ZeRO-1's gather) and, for the
loss and the metrics, the world.

``make_mesh()`` with one stage, one replica, one process and no device list
stays ``None``, the trivial one-card mesh that ``Pipeline`` takes down its
fused path. Tensor, sequence and expert parallelism wait for ROADMAP Queue
A item 6d.

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
    """``n_data x n_stages`` coordinates, ``coord_devices[d * n_stages +
    s]`` the device of replica ``d``'s stage ``s``; this process
    (``rank`` of ``world_size``) owns a contiguous block of them.
    ``groups`` maps a tuple of ranks to its process group (built by
    :func:`make_mesh` when ``world_size > 1``)."""
    coord_devices: tuple[torch.device, ...]
    n_data: int = 1
    rank: int = 0
    world_size: int = 1
    groups: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    @property
    def n_stages(self) -> int:
        return len(self.coord_devices) // self.n_data

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes by name, as a JAX mesh's ``shape``."""
        return {DATA_AXIS: self.n_data, STAGE_AXIS: self.n_stages,
                MODEL_AXIS: 1, SEQ_AXIS: 1, EXPERT_AXIS: 1}

    @property
    def distributed(self) -> bool:
        return self.world_size > 1

    def owner(self, d: int, s: int) -> int:
        """The rank that owns coordinate ``(d, s)``."""
        per = len(self.coord_devices) // self.world_size
        return (d * self.n_stages + s) // per

    def owns(self, d: int, s: int) -> bool:
        return self.owner(d, s) == self.rank

    def device(self, d: int, s: int) -> torch.device:
        return self.coord_devices[d * self.n_stages + s]

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
        coordinates; None when this process is the only one."""
        return self.groups.get(
            tuple(sorted({self.owner(d, s) for d in range(self.n_data)})))


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
    """A ``n_data x n_stages`` mesh over ``devices`` (None = the visible
    cards), coordinate ``i`` on ``devices[i]``; a list may name one device
    more than once. ``n_data=None`` means 1. Across processes
    (``bootstrap_distributed`` first) every process passes the same
    arguments and owns its block of coordinates; the world size must
    divide ``n_data * n_stages``. One coordinate, one process and no
    device list give ``None``, the trivial mesh."""
    n_data = 1 if n_data is None else n_data
    sizes = {STAGE_AXIS: n_stages, DATA_AXIS: n_data, MODEL_AXIS: n_model,
             SEQ_AXIS: n_seq, EXPERT_AXIS: n_expert}
    bad = {k: v for k, v in sizes.items() if int(v) < 1}
    if bad:
        raise ValueError(f"mesh axes must be >= 1, got {bad}")
    wide = {k: v for k, v in sizes.items()
            if k not in (STAGE_AXIS, DATA_AXIS) and int(v) > 1}
    if wide:
        raise _roadmap.not_ported(f"a mesh with axes {wide}",
                                  _roadmap.PARALLEL_AXES)
    world, rank = process_count(), process_index()
    need = n_data * n_stages
    if devices is None and need == 1 and world == 1:
        return None
    if need % world:
        raise ValueError(
            f"{world} processes cannot split a {n_data}x{n_stages} "
            f"(data x stage) mesh: the process count must divide "
            f"{need}")
    devs = (visible_devices() if devices is None
            else [resolve_device(d) for d in devices])
    if need > len(devs):
        raise ValueError(f"mesh {n_data}x{n_stages}x1x1x1 needs {need} "
                         f"devices, have {len(devs)}")
    devs = devs[:need]
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"a mesh's devices must be of one type (the "
                         f"dropout stream crosses stages), got {devs}")
    mesh = Mesh(tuple(devs), n_data, rank, world)
    if world > 1:
        # every process builds every group, in one order (new_group is a
        # collective over the world)
        dist = torch.distributed
        for s in range(n_stages):
            ranks = tuple(sorted({mesh.owner(d, s) for d in range(n_data)}))
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
