"""Utilities (port of ``utils/``): the throughput meter, the profiler
hooks on ``torch.profiler`` (``utils/profiler.py``) and the dead-peer
watchdog (``utils/failure.py``): import those two directly."""

from simple_distributed_machine_learning_tpu_torch.utils.metrics import (  # noqa: F401
    Throughput,
)
