"""Utilities (port of ``utils/``): the throughput meter."""

from simple_distributed_machine_learning_tpu_torch.utils.metrics import (  # noqa: F401
    Throughput,
)
