"""Per-host input rows: each process feeds only its data replicas' rows
(port of ``data/sharding.py``).

The reference loads the full dataset on the master and ships every batch
over RPC (``simple_distributed.py:87-95``). Here process ``r`` takes, from
every global batch, only the contiguous rows of the replicas it holds a
stage of — replica ``d`` owns rows ``[d * B / D, (d + 1) * B / D)`` — so
its host memory and host -> device copies scale with ``B / D``, not the
global batch. The port's counterpart of the JAX ``make_global_batch`` is
the local batch itself: ``Pipeline`` takes this process's rows and sums
the weight of the whole batch over the data group before the schedule
starts (``parallel/pipeline.py``).

On one process the rows are the whole batch.
"""

from __future__ import annotations


def host_rows(mesh, batch: int) -> tuple[int, int]:
    """This process's contiguous ``[lo, hi)`` rows of a ``[batch, ...]``
    global batch (``mesh``: a ``parallel.mesh.Mesh`` or None).

    Raises if the rows are not one contiguous range (cannot happen with
    ``make_mesh``'s data-major ownership, which hands each process one
    contiguous block of coordinates — better loud than silently wrong)."""
    if mesh is None:
        return 0, batch
    if batch % mesh.n_data:
        raise ValueError(f"batch {batch} not divisible by the data axis "
                         f"{mesh.n_data}")
    per = batch // mesh.n_data
    slices = sorted((d * per, (d + 1) * per) for d in mesh.replicas)
    lo, hi = slices[0]
    for s_lo, s_hi in slices[1:]:
        if s_lo > hi:
            raise ValueError(
                f"process-addressable rows of a {batch}-row batch are not "
                f"contiguous ({slices}); per-host input sharding needs a "
                f"data-major device order (make_mesh's default)")
        hi = max(hi, s_hi)
    return lo, hi
