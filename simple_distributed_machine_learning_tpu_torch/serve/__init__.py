"""Continuous-batching serving on one GPU (port of ``serve/``).

- :mod:`.slots` — :class:`PagedKVPool`: block-table paged K/V pool with
  refcounted blocks, prefix sharing, copy-on-write, reservations and the
  host offload tier, and
  :class:`KVCachePool`, the dense slot-row layout;
- :mod:`.request` — :class:`Request`: prompt, per-request sampling, key
  stream, lifecycle timestamps;
- :mod:`.scheduler` — :class:`FCFSScheduler` and
  :class:`PriorityScheduler` (priority classes with preemption);
- :mod:`.engine` — :class:`InferenceEngine`: ``submit`` / ``step`` /
  ``drain`` / ``restore`` over chunked prefill and one batched decode
  tick;
- :mod:`.journal` — :class:`RequestJournal`: the fsync'd write-ahead
  request journal and its crash recovery;
- :mod:`.supervisor` — :class:`ServeSupervisor`: engine rebuild and
  journal recovery on faults, deadlines, :class:`OverloadPolicy`
  shedding, cross-replica adoption, :func:`engine_factory`;
- :mod:`.router` / :mod:`.fleet` — :class:`FleetRouter` and
  :class:`ServeFleet`: N supervised replicas with affinity routing,
  journal-backed migration, disaggregated prefill/decode and
  :class:`AutoscalePolicy` autoscaling;
- :mod:`.tracing` / :mod:`.flight` — :class:`ServeTrace` (per-request
  span timelines) and :class:`FlightRecorder` (per-tick snapshots for
  post-mortem bundles);
- :mod:`.simulator` — seeded open-loop traffic (:func:`simulate`);
- :mod:`.adapters` — :class:`AdapterStore`: the refcounted device bank
  of LoRA adapters multi-tenant serving gathers from;
- :mod:`.metrics` — :class:`ServeMetrics`: TTFT/TPOT, occupancy, pool,
  host-tier, adapter, restart and shed instruments on the metric
  registry.

Correctness anchor: with the same seed every request's tokens equal its
solo ``models.make_cached_decoder`` decode.
"""

from simple_distributed_machine_learning_tpu_torch.serve.adapters import (  # noqa: F401
    AdapterStore,
)
from simple_distributed_machine_learning_tpu_torch.serve.engine import (  # noqa: F401
    DrainTimeout,
    InferenceEngine,
)
from simple_distributed_machine_learning_tpu_torch.serve.fleet import (  # noqa: F401
    AutoscalePolicy,
    ServeFleet,
)
from simple_distributed_machine_learning_tpu_torch.serve.flight import (  # noqa: F401
    FlightRecorder,
)
from simple_distributed_machine_learning_tpu_torch.serve.journal import (  # noqa: F401
    RequestJournal,
)
from simple_distributed_machine_learning_tpu_torch.serve.metrics import (  # noqa: F401
    ServeMetrics,
)
from simple_distributed_machine_learning_tpu_torch.serve.request import (  # noqa: F401
    Request,
)
from simple_distributed_machine_learning_tpu_torch.serve.router import (  # noqa: F401
    FleetRouter,
)
from simple_distributed_machine_learning_tpu_torch.serve.scheduler import (  # noqa: F401
    FCFSScheduler,
    PriorityScheduler,
)
from simple_distributed_machine_learning_tpu_torch.serve.simulator import (  # noqa: F401
    SimConfig,
    TrafficClass,
    simulate,
)
from simple_distributed_machine_learning_tpu_torch.serve.slots import (  # noqa: F401
    KVCachePool,
    PagedKVPool,
)
from simple_distributed_machine_learning_tpu_torch.serve.supervisor import (  # noqa: F401
    OverloadPolicy,
    RestartBudgetExceeded,
    ServeSupervisor,
    engine_factory,
)
from simple_distributed_machine_learning_tpu_torch.serve.tracing import (  # noqa: F401
    ServeTrace,
)
