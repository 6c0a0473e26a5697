"""Device mesh and process bootstrap (port of ``parallel/mesh.py``).

The port runs on one card. Its mesh is the trivial one — one device on
every axis — and ``Pipeline`` takes it as ``mesh=None``, the way the JAX
package's ``Pipeline`` takes a one-device mesh down its fused path. A mesh
with any axis wider than one, and a multi-process bootstrap, wait for the
parallel axes (ROADMAP Queue A item 6).
"""

from __future__ import annotations

from simple_distributed_machine_learning_tpu_torch import _roadmap

DATA_AXIS = "data"
STAGE_AXIS = "stage"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"


def make_mesh(n_stages: int = 1, n_data: int | None = None,
              n_model: int = 1, n_seq: int = 1, n_expert: int = 1) -> None:
    """The one-card mesh: ``None``, what ``Pipeline`` takes on one card.
    ``n_data=None`` means 1 here (one device to fill)."""
    sizes = {STAGE_AXIS: n_stages, DATA_AXIS: 1 if n_data is None else n_data,
             MODEL_AXIS: n_model, SEQ_AXIS: n_seq, EXPERT_AXIS: n_expert}
    bad = {k: v for k, v in sizes.items() if int(v) < 1}
    if bad:
        raise ValueError(f"mesh axes must be >= 1, got {bad}")
    wide = {k: v for k, v in sizes.items() if int(v) > 1}
    if wide:
        raise _roadmap.not_ported(f"a mesh with axes {wide}",
                                  _roadmap.PARALLEL_AXES)
    return None


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
