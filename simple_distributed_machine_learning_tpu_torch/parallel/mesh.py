"""Device mesh and process bootstrap (port of ``parallel/mesh.py``).

The port's mesh is its stage axis: one ``torch.device`` per pipeline
stage, which ``Pipeline`` places each stage's parameters on
(``parallel/pipeline.py``). One process drives every stage, as one JAX
controller drives its stage mesh. A device may stand for more than one
stage — ``devices=["cpu"] * S`` in the CPU tests, ``[cuda:0] * S`` on one
card — the counterpart of the JAX package's forced host device count.

``make_mesh()`` with one stage and no device list stays ``None``, the
trivial one-card mesh that ``Pipeline`` takes down its fused path. The data
axis, tensor, sequence and expert parallelism, and a multi-process
bootstrap still wait for ROADMAP Queue A items 6c-6e.
"""

from __future__ import annotations

import dataclasses
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
    """The stage axis: ``devices[s]`` holds stage ``s``'s parameters and
    runs its apply. Every other axis is one wide."""
    devices: tuple[torch.device, ...]

    @property
    def n_stages(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes by name, as a JAX mesh's ``shape``."""
        return {DATA_AXIS: 1, STAGE_AXIS: self.n_stages, MODEL_AXIS: 1,
                SEQ_AXIS: 1, EXPERT_AXIS: 1}


def visible_devices() -> list[torch.device]:
    """The cards this process sees (none without CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_stages: int = 1, n_data: int | None = None,
              n_model: int = 1, n_seq: int = 1, n_expert: int = 1,
              devices: Sequence | None = None) -> Mesh | None:
    """A stage mesh over ``devices`` (None = the visible cards), taking the
    first ``n_stages`` of them; a list may name one device more than once.
    One stage and no device list give ``None``, the trivial mesh.
    ``n_data=None`` means 1 (the data axis is not ported)."""
    sizes = {STAGE_AXIS: n_stages, DATA_AXIS: 1 if n_data is None else n_data,
             MODEL_AXIS: n_model, SEQ_AXIS: n_seq, EXPERT_AXIS: n_expert}
    bad = {k: v for k, v in sizes.items() if int(v) < 1}
    if bad:
        raise ValueError(f"mesh axes must be >= 1, got {bad}")
    wide = {k: v for k, v in sizes.items()
            if k != STAGE_AXIS and int(v) > 1}
    if wide:
        raise _roadmap.not_ported(f"a mesh with axes {wide}",
                                  _roadmap.PARALLEL_AXES)
    if devices is None and n_stages == 1:
        return None
    devs = (visible_devices() if devices is None
            else [resolve_device(d) for d in devices])
    if n_stages > len(devs):
        raise ValueError(f"mesh 1x{n_stages}x1x1x1 needs {n_stages} devices, "
                         f"have {len(devs)}")
    devs = devs[:n_stages]
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"a mesh's devices must be of one type (the "
                         f"dropout stream crosses stages), got {devs}")
    return Mesh(tuple(devs))


def bootstrap_distributed(rank: int, world_size: int, master_addr: str,
                          master_port: str | int,
                          timeout_s: int = 300) -> None:
    """Multi-process rendezvous: nothing to do for one process; more
    processes are not ported yet."""
    if world_size <= 1:
        return
    raise _roadmap.not_ported(
        f"a {world_size}-process run (rank {rank}, coordinator "
        f"{master_addr}:{master_port})", _roadmap.PARALLEL_AXES)
