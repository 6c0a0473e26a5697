"""Parallelism (port of ``parallel/``): the stage split rule, the packed
stage buffer and wire codec, the one-card mesh, ``Stage`` and the one-card
``Pipeline``."""

from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (  # noqa: F401
    bootstrap_distributed,
    make_mesh,
)
from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (  # noqa: F401
    Pipeline,
    Stage,
    fused_reference,
    param_leaves,
)
from simple_distributed_machine_learning_tpu_torch.parallel.staging import (  # noqa: F401
    StageMeta,
    contiguous_split,
    pack_stage_params,
    unpack_stage_params,
    wire_decode,
    wire_encode,
)
