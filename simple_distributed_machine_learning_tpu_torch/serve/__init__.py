"""Continuous-batching serving on one GPU (port of ``serve/``).

- :mod:`.slots` — :class:`PagedKVPool`: block-table paged K/V pool with
  refcounted blocks, prefix sharing, copy-on-write and reservations;
- :mod:`.request` — :class:`Request`: prompt, per-request sampling, key
  stream, lifecycle timestamps;
- :mod:`.scheduler` — :class:`FCFSScheduler`;
- :mod:`.engine` — :class:`InferenceEngine`: ``submit`` / ``step`` /
  ``drain`` over chunked prefill and one batched decode tick;
- :mod:`.simulator` — seeded open-loop traffic (:func:`simulate`);
- :mod:`.metrics` — :class:`ServeMetrics`: TTFT/TPOT, occupancy, pool
  gauges on the metric registry.

Correctness anchor: with the same seed every request's tokens equal its
solo ``models.make_cached_decoder`` decode.
"""

from simple_distributed_machine_learning_tpu_torch.serve.engine import (  # noqa: F401
    DrainTimeout,
    InferenceEngine,
)
from simple_distributed_machine_learning_tpu_torch.serve.metrics import (  # noqa: F401
    ServeMetrics,
)
from simple_distributed_machine_learning_tpu_torch.serve.request import (  # noqa: F401
    Request,
)
from simple_distributed_machine_learning_tpu_torch.serve.scheduler import (  # noqa: F401
    FCFSScheduler,
)
from simple_distributed_machine_learning_tpu_torch.serve.simulator import (  # noqa: F401
    SimConfig,
    TrafficClass,
    simulate,
)
from simple_distributed_machine_learning_tpu_torch.serve.slots import (  # noqa: F401
    PagedKVPool,
)
