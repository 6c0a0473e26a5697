"""Utilities (port of ``utils/``): the throughput meter, and the profiler
hooks on ``torch.profiler`` (``utils/profiler.py``: import it directly)."""

from simple_distributed_machine_learning_tpu_torch.utils.metrics import (  # noqa: F401
    Throughput,
)
