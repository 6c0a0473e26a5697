"""Parallelism (port of ``parallel/``): the stage split rule, the packed
stage buffer and wire codec, the stage mesh, ``Stage``, the ``Pipeline``
(one fused stage, or GPipe over several) and the 1F1B schedule."""

from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    bootstrap_distributed,
    make_mesh,
)
from simple_distributed_machine_learning_tpu_torch.parallel.onefb import (  # noqa: F401
    onefb_loss_and_grads,
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
