"""Parallelism (port of ``parallel/``): the stage split rule, ``Stage`` and
the one-card ``Pipeline``."""

from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (  # noqa: F401
    Pipeline,
    Stage,
    fused_reference,
    param_leaves,
)
from simple_distributed_machine_learning_tpu_torch.parallel.staging import (  # noqa: F401
    contiguous_split,
)
