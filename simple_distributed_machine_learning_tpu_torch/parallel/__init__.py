"""Parallelism (port of ``parallel/``): the stage split rule and ``Stage``."""

from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (  # noqa: F401
    Stage,
)
from simple_distributed_machine_learning_tpu_torch.parallel.staging import (  # noqa: F401
    contiguous_split,
)
