"""The serving scenario suite: SLO-gated, deterministic load + fault runs.

Port of ``resilience/scenarios.py``: the six one-engine scenarios and the
seven fleet scenarios. A *scenario* bundles one traffic shape (``serve/simulator.py``: arrival
pattern + multi-tenant class mix with per-class TTFT/TPOT SLOs), one
engine configuration (slots, blocks, chunking, scheduler policy, fleet
shape) and optionally one fault schedule (``resilience/faults.py``).
:func:`run_scenario` drives it through the engine, the serve supervisor
or a :class:`~..serve.fleet.ServeFleet` and asserts SLO attainment from the telemetry registry: the
run passes only when every gated class attains its SLOs and every request
is accounted for.

Determinism: scenarios run on a :class:`VirtualClock` — every clock read
advances simulated time by a fixed quantum and ``sleep`` advances it by
the requested amount, so latencies measure *scheduling structure* (ticks
queued, prefill chunks, preemptions, injected stalls), not host or device
speed. The engine, supervisor, metrics and simulator of this package read
the clock at exactly the JAX package's points, so a scenario's counts,
per-class TTFT quantiles and alert ticks equal the JAX package's on any
weights and any device (no traffic class sets an EOS). SLO targets are
virtual milliseconds.

=================== =====================================================
``steady``           single interactive class, homogeneous Poisson, FCFS
``burst-interactive`` bursty arrivals, interactive (priority 2) vs batch
                     (priority 0); priority scheduling with prefill
                     preemption protects interactive TTFT
``multi-tenant``     interactive/standard/batch over a diurnal cycle
``burst-slow-tick``  burst-interactive's load with injected slow-tick
                     stalls
``crash-serve``      steady traffic with an injected ``engine-crash``: the
                     serve supervisor recovers every in-flight request
                     from the journal (gate: all complete AND >= 1
                     restart happened)
``overload-shed``    a sustained burst above capacity with per-class hard
                     deadlines: the supervisor sheds expired and
                     over-budget work so the interactive class keeps its
                     SLO (gate: every request completed or structurally
                     shed)
``fleet-replica-loss`` steady traffic over 3 replicas with a whole replica
                     killed mid-decode: its in-flight requests migrate
                     onto the survivors from its journal alone (gate: all
                     complete AND >= 1 migration happened)
``hot-prefix-skew``  every request shares one 8-token system prefix: the
                     affinity router keeps the prefix's blocks hot on one
                     replica (round-robin, the baseline, re-prefills it)
``fleet-autoscale-diurnal`` a compressed day/night cycle over an
                     autoscaled fleet (min 1, max 3): backlog scales out,
                     the idle trough drains-then-retires
                     (``ServeFleet.replica_log`` is the pinned trajectory)
``disagg-prefill-heavy`` bursty long prompts over 2 prefill + 2 decode
                     replicas: every request hands off at end-of-prefill
                     (gate: all complete AND every request handed off)
``offload-churn``    hot-prefix traffic between prefix-less scans on one
                     replica with a 12-block pool and the host offload
                     tier on: the scans evict the idle system prompt, the
                     eviction demotes it to host RAM, and the next hot
                     arrival's routing-time prefetch uploads it back
                     (gate: all complete AND >= 1 demotion AND >= 1
                     prefetch hit)
``hot-adapter-churn`` two LoRA tenants over 3 replicas with one tenant's
                     weights hot-swapped at tick 6: adapter-affinity
                     routing keeps each tenant where its bank row is
                     resident (gate: all complete AND >= 3 bank uploads)
``handoff-replica-loss`` 1 prefill + 2 decode with a decode replica killed
                     while handoffs are in flight (gate: all complete AND
                     >= 1 handoff AND >= 1 migration)
=================== =====================================================

Adapter weights are seeded per tenant index with the port's own
generator; ``init_lora_adapter`` zeroes B, so a scenario's tenants decode
the base model's tokens and its pins equal the JAX package's.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from simple_distributed_machine_learning_tpu_torch.resilience import faults
from simple_distributed_machine_learning_tpu_torch.serve.fleet import (
    AutoscalePolicy,
    ServeFleet,
)
from simple_distributed_machine_learning_tpu_torch.serve.metrics import (
    ServeMetrics,
)
from simple_distributed_machine_learning_tpu_torch.serve.scheduler import (
    FCFSScheduler,
    PriorityScheduler,
)
from simple_distributed_machine_learning_tpu_torch.serve.simulator import (
    SimConfig,
    TrafficClass,
    simulate,
)
from simple_distributed_machine_learning_tpu_torch.serve.supervisor import (
    OverloadPolicy,
    ServeSupervisor,
    engine_factory,
)


class VirtualClock:
    """Deterministic simulated time: each read costs ``per_call_s``, each
    ``sleep(dt)`` advances ``dt``. Handed to the engine, its metrics, the
    supervisor, the simulator and ``FaultPlan.sleep``, so all timestamps
    share one origin and one cost model."""

    def __init__(self, per_call_s: float = 0.001) -> None:
        if per_call_s <= 0:
            raise ValueError(f"per_call_s must be > 0, got {per_call_s}")
        self.per_call_s = per_call_s
        self._t = 0.0

    def __call__(self) -> float:
        self._t += self.per_call_s
        return self._t

    def sleep(self, dt: float) -> None:
        self._t += max(0.0, float(dt))


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One catalog entry; see the module docstring. ``supervised`` runs go
    through the :class:`ServeSupervisor` (journal, crash recovery,
    deadlines, ``overload`` admission control); ``allow_shed`` counts a
    structurally shed request as accounted for; ``min_restarts`` is the
    chaos gate (a crash scenario whose fault never fired must fail).

    ``replicas > 0`` runs the traffic through a ``ServeFleet`` of that
    many supervised replicas behind ``route``, with ``autoscale`` (an
    :class:`~..serve.fleet.AutoscalePolicy`) and ``prefill_replicas``
    (disaggregation) as options; ``min_migrations`` and ``min_handoffs``
    are the fleet's vacuous-pass gates.

    ``host_cache_blocks``/``prefetch_ticks`` turn on the paged pools' host
    offload tier in every engine the run builds, with ``min_host_demotes``
    and ``min_host_prefetch_hits`` its vacuous-pass gates.
    ``adapter_rank > 0`` builds every engine with an ``AdapterStore`` of
    that rank and registers ``adapters`` (seeded weights per name) on the
    target before traffic; ``adapter_swap_tick`` re-registers
    ``adapters[0]`` with new seeded weights at that target tick (the
    hot-swap under load), and ``min_adapter_swaps`` is the gate."""

    name: str
    description: str
    sim: SimConfig
    n_slots: int = 3
    block_size: int = 8
    n_blocks: int | None = None
    max_len: int | None = None
    prefill_chunk: int | None = None
    scheduler: str = "priority"        # "fcfs" | "priority"
    chaos: str | None = None           # FaultPlan.parse spec, or None
    min_attainment: float = 0.9        # per-SLO pass bar
    supervised: bool = False
    max_restarts: int = 3
    degrade_after: int | None = None
    overload: OverloadPolicy | None = None
    allow_shed: bool = False
    min_restarts: int = 0
    replicas: int = 0
    route: str = "affinity"
    autoscale: AutoscalePolicy | None = None
    min_migrations: int = 0
    prefill_replicas: int = 0
    min_handoffs: int = 0
    host_cache_blocks: int = 0
    prefetch_ticks: int = 1
    min_host_demotes: int = 0
    min_host_prefetch_hits: int = 0
    adapter_rank: int = 0
    adapters: tuple = ()
    adapter_swap_tick: int = 0
    min_adapter_swaps: int = 0

    def __post_init__(self):
        if self.scheduler not in ("fcfs", "priority"):
            raise ValueError(
                f"scheduler must be fcfs|priority, got {self.scheduler!r}")
        if not 0 < self.min_attainment <= 1:
            raise ValueError(f"min_attainment must be in (0, 1], got "
                             f"{self.min_attainment}")
        if self.min_restarts and not self.supervised:
            raise ValueError(
                "min_restarts needs supervised=True (only the supervisor "
                "restarts an engine)")
        if (self.overload is not None or self.allow_shed) \
                and not (self.supervised or self.replicas):
            raise ValueError(
                "overload/allow_shed need supervised=True or a fleet "
                "(admission control and shedding live in the supervisor)")
        if self.replicas:
            if self.supervised:
                raise ValueError(
                    "replicas > 0 already runs every replica through its "
                    "own ServeSupervisor — drop supervised=True")
            from simple_distributed_machine_learning_tpu_torch.serve.router import (  # noqa: E501
                POLICIES,
            )
            if self.route not in POLICIES:
                raise ValueError(f"route must be one of {POLICIES}, got "
                                 f"{self.route!r}")
        elif (self.min_migrations or self.autoscale is not None
              or self.route != "affinity" or self.prefill_replicas
              or self.min_handoffs):
            raise ValueError(
                "route/autoscale/min_migrations/prefill_replicas/"
                "min_handoffs are fleet knobs — set replicas > 0")
        if self.min_handoffs and not self.prefill_replicas:
            raise ValueError(
                "min_handoffs needs prefill_replicas > 0 (only a "
                "disaggregated fleet hands off)")
        if ((self.min_host_demotes or self.min_host_prefetch_hits)
                and not self.host_cache_blocks):
            raise ValueError(
                "min_host_demotes/min_host_prefetch_hits need "
                "host_cache_blocks > 0 (only the host offload tier "
                "demotes and prefetches)")
        if self.adapter_rank:
            if not (self.supervised or self.replicas):
                raise ValueError(
                    "adapter_rank needs supervised=True or a fleet (the "
                    "engine factory builds the AdapterStore)")
            if not self.adapters:
                raise ValueError(
                    "adapter_rank > 0 needs at least one tenant name in "
                    "`adapters`")
        elif (self.adapters or self.adapter_swap_tick
              or self.min_adapter_swaps):
            raise ValueError(
                "adapters/adapter_swap_tick/min_adapter_swaps need "
                "adapter_rank > 0")


# SLO targets are VIRTUAL milliseconds: an engine tick costs a few vms, so
# "TTFT <= 60 vms" reads "first token within tens of ticks of arrival"
_INTERACTIVE = TrafficClass("interactive", weight=0.35, priority=2,
                            ttft_slo_ms=60.0, tpot_slo_ms=40.0,
                            prompt_lens=(4, 6), max_new_tokens=8)
_STANDARD = TrafficClass("standard", weight=0.3, priority=1,
                         ttft_slo_ms=150.0, tpot_slo_ms=60.0,
                         prompt_lens=(8,), max_new_tokens=12)
_BATCH = TrafficClass("batch", weight=0.35, priority=0,
                      prompt_lens=(12,), max_new_tokens=24)

SCENARIOS: dict[str, Scenario] = {s.name: s for s in (
    Scenario(
        name="steady",
        description="single interactive class, homogeneous Poisson, FCFS "
                    "— the unstressed baseline must meet SLOs",
        sim=SimConfig(n_requests=16, rate=12.0, seed=0,
                      classes=(dataclasses.replace(_INTERACTIVE,
                                                   weight=1.0),)),
        n_slots=4, scheduler="fcfs"),
    Scenario(
        name="burst-interactive",
        description="bursty arrivals, interactive vs batch tenants; "
                    "priority scheduling + prefill preemption protect the "
                    "interactive class's TTFT through the spikes",
        sim=SimConfig(n_requests=28, rate=20.0, seed=0, arrival="bursty",
                      burst_factor=6.0, burst_duty=0.2, period_s=1.0,
                      classes=(_INTERACTIVE,
                               dataclasses.replace(_BATCH, weight=0.65))),
        n_slots=3, prefill_chunk=4),
    Scenario(
        name="multi-tenant",
        description="three tenants (interactive/standard/batch) over a "
                    "diurnal rate cycle, priority scheduling",
        sim=SimConfig(n_requests=30, rate=16.0, seed=0, arrival="diurnal",
                      diurnal_amplitude=0.8, period_s=2.0,
                      classes=(_INTERACTIVE, _STANDARD, _BATCH)),
        n_slots=4, prefill_chunk=4),
    Scenario(
        name="burst-slow-tick",
        description="burst-interactive's load with injected slow-tick "
                    "device stalls (deterministic chaos schedule) — SLOs "
                    "must hold through a degraded device",
        sim=SimConfig(n_requests=24, rate=18.0, seed=0, arrival="bursty",
                      burst_factor=6.0, burst_duty=0.2, period_s=1.0,
                      classes=(_INTERACTIVE,
                               dataclasses.replace(_BATCH, weight=0.65))),
        n_slots=3, prefill_chunk=4,
        chaos="slow-tick@serve.tick,dur=0.004,after=5,times=10"),
    Scenario(
        name="crash-serve",
        description="steady interactive traffic with an engine crash "
                    "injected mid-serve: the serve supervisor re-admits "
                    "every in-flight request from the journal bit-exact "
                    "and the SLOs hold through the restart (gate: all "
                    "complete AND >= 1 restart actually happened)",
        sim=SimConfig(n_requests=16, rate=12.0, seed=0,
                      classes=(dataclasses.replace(_INTERACTIVE,
                                                   weight=1.0),)),
        n_slots=4, prefill_chunk=4, scheduler="fcfs",
        supervised=True, chaos="engine-crash@serve.tick=6",
        min_restarts=1),
    Scenario(
        name="overload-shed",
        description="a sustained burst at > 1.5x service capacity with "
                    "per-class hard deadlines: the supervisor sheds "
                    "expired/over-budget work (deadline + queue-depth "
                    "backpressure) so the interactive class keeps "
                    "attaining its SLOs; the no-deadline FCFS baseline "
                    "fails the same gate",
        sim=SimConfig(n_requests=36, rate=40.0, seed=0, arrival="bursty",
                      burst_factor=5.0, burst_duty=0.3, period_s=1.0,
                      classes=(
                          # the hard deadline sits BELOW the SLO target:
                          # anything not started by 75 vms sheds
                          dataclasses.replace(_INTERACTIVE,
                                              ttft_slo_ms=100.0,
                                              ttft_deadline_ms=75.0,
                                              deadline_ms=500.0),
                          dataclasses.replace(_BATCH, weight=0.65,
                                              deadline_ms=1500.0))),
        n_slots=2, prefill_chunk=4,
        supervised=True, allow_shed=True,
        # past 6 queued the supervisor locks best-effort (priority 0)
        # traffic out until the backlog drains to 2
        overload=OverloadPolicy(max_queue_depth=8,
                                degrade_queue_depth=6,
                                recover_queue_depth=2,
                                degraded_priority_floor=0)),
    Scenario(
        name="fleet-replica-loss",
        description="steady interactive traffic over a 3-replica fleet "
                    "with a whole replica killed mid-decode: its in-flight "
                    "requests migrate onto the survivors from its journal "
                    "alone (gate: all complete AND >= 1 migration actually "
                    "happened; per-stream bit-exactness is pinned in "
                    "tests/test_fleet.py)",
        sim=SimConfig(n_requests=16, rate=12.0, seed=0,
                      classes=(dataclasses.replace(_INTERACTIVE,
                                                   weight=1.0),)),
        n_slots=2, prefill_chunk=4, scheduler="fcfs",
        replicas=3, chaos="replica-kill@fleet.tick=5",
        min_migrations=1),
    Scenario(
        name="hot-prefix-skew",
        description="every request shares one 8-token system prefix: the "
                    "prefix-cache-aware router keeps the prefix's blocks "
                    "hot on one replica instead of re-prefilling them on "
                    "all three — tests pin affinity's prefix-hit counters "
                    "strictly above round-robin's on this exact workload",
        sim=SimConfig(n_requests=18, rate=16.0, seed=0,
                      shared_prefix_len=8,
                      classes=(dataclasses.replace(_INTERACTIVE,
                                                   weight=1.0),)),
        n_slots=2, block_size=8, prefill_chunk=4, scheduler="fcfs",
        replicas=3, route="affinity"),
    Scenario(
        name="fleet-autoscale-diurnal",
        description="a compressed day/night arrival cycle over an "
                    "autoscaled fleet (min 1, max 3): sustained backlog "
                    "scales out, the idle trough drains-then-retires; the "
                    "exact virtual-clock replica-count trajectory "
                    "(ServeFleet.replica_log) is pinned in tests",
        # one virtual-clock run walks the whole autoscaler: the first peak
        # scales 1 -> 3, the trough retires back to 1, the second peak
        # scales out again
        sim=SimConfig(n_requests=50, rate=60.0, seed=0, arrival="diurnal",
                      diurnal_amplitude=0.95, period_s=0.6,
                      classes=(dataclasses.replace(
                          _INTERACTIVE, weight=1.0, ttft_slo_ms=None,
                          tpot_slo_ms=None),)),
        n_slots=2, prefill_chunk=4, scheduler="fcfs",
        replicas=1,
        autoscale=AutoscalePolicy(min_replicas=1, max_replicas=3,
                                  scale_out_queue_depth=4,
                                  scale_out_ticks=2,
                                  retire_idle_s=0.08)),
    Scenario(
        name="disagg-prefill-heavy",
        description="bursty long-prompt arrivals whose decodes linger, "
                    "over a 4-replica fleet split 2 prefill + 2 decode: "
                    "new work boards the prefill pool only, every request "
                    "hands off at end-of-prefill by the journal snap/"
                    "adopt move, and lingering decodes clog the DECODE "
                    "pool's slots instead of blocking fresh prefills "
                    "(gate: all complete AND every request actually "
                    "handed off; tests pin disaggregated TTFT p95 "
                    "strictly below the symmetric 4-replica fleet's on "
                    "this exact workload)",
        sim=SimConfig(n_requests=16, rate=14.0, seed=0, arrival="bursty",
                      burst_factor=5.0, burst_duty=0.25, period_s=1.0,
                      classes=(dataclasses.replace(
                          _INTERACTIVE, weight=1.0, prompt_lens=(12, 16),
                          max_new_tokens=24, ttft_slo_ms=400.0,
                          tpot_slo_ms=None),)),
        n_slots=2, prefill_chunk=4, scheduler="fcfs",
        replicas=4, prefill_replicas=2, min_handoffs=16),
    Scenario(
        name="offload-churn",
        description="hot-prefix traffic interleaved with prefix-less "
                    "background scans under block-pool pressure, host "
                    "offload tier on: every scan burst evicts the idle "
                    "system prompt out of the 12-block pool, the LRU "
                    "eviction demotes it to host RAM instead of "
                    "discarding it, and the next hot arrival's "
                    "routing-time prefetch uploads it back ahead of "
                    "admission (gates: all complete AND demotions AND "
                    "prefetch hits actually happened; tests pin device "
                    "prefix-hit blocks strictly above the HBM-only "
                    "fleet's on this exact workload)",
        sim=SimConfig(n_requests=24, rate=4.0, seed=0,
                      shared_prefix_len=8, sampled_fraction=0.0,
                      classes=(
                          # hot tenant: every prompt opens with the shared
                          # system prompt (2 blocks at block_size=4)
                          dataclasses.replace(
                              _INTERACTIVE, weight=1.0, prompt_lens=(4,),
                              max_new_tokens=4, ttft_slo_ms=None,
                              tpot_slo_ms=None),
                          # background scans: no shared prefix, long
                          # prompts — they evict the idle prefix out of
                          # the 12-block pool between hot arrivals
                          TrafficClass(name="scan", weight=1.0,
                                       prompt_lens=(16,),
                                       max_new_tokens=8,
                                       shared_prefix=False))),
        n_slots=2, block_size=4, n_blocks=12, max_len=48, prefill_chunk=4,
        scheduler="fcfs",
        replicas=1, host_cache_blocks=12, prefetch_ticks=1,
        min_host_demotes=1, min_host_prefetch_hits=1),
    Scenario(
        name="hot-adapter-churn",
        description="two LoRA tenants' traffic over a 3-replica fleet "
                    "with one tenant's weights hot-swapped mid-run under "
                    "load: adapter-affinity routing keeps each tenant on "
                    "a replica already holding its bank row (round-robin "
                    "stays adapter-blind and re-uploads per landing), the "
                    "swap lands at a tick boundary without a retrace, and "
                    "the swapped tenant's later requests decode the NEW "
                    "weights (gates: all complete AND >= 3 bank uploads "
                    "actually happened; tests pin affinity's "
                    "adapter-affinity hit counter strictly above "
                    "round-robin's on this exact workload)",
        sim=SimConfig(n_requests=18, rate=16.0, seed=0,
                      classes=(
                          dataclasses.replace(
                              _INTERACTIVE, name="tenant-a", weight=0.5,
                              ttft_slo_ms=None, tpot_slo_ms=None,
                              adapter="tenant-a"),
                          dataclasses.replace(
                              _INTERACTIVE, name="tenant-b", weight=0.5,
                              ttft_slo_ms=None, tpot_slo_ms=None,
                              adapter="tenant-b"))),
        n_slots=2, prefill_chunk=4, scheduler="fcfs",
        replicas=3, route="affinity",
        adapter_rank=2, adapters=("tenant-a", "tenant-b"),
        adapter_swap_tick=6, min_adapter_swaps=3),
    Scenario(
        name="handoff-replica-loss",
        description="disaggregated fleet (1 prefill + 2 decode) with a "
                    "DECODE replica killed while handoffs are in flight: "
                    "handed-off requests re-adopt onto the surviving "
                    "decode replica from the dead one's journal alone, "
                    "and the handoff journal event keeps the prefill "
                    "source from double-serving them (gate: all complete "
                    "AND >= 1 handoff AND >= 1 migration; per-stream "
                    "bit-exactness through the race is pinned in "
                    "tests/test_disagg.py)",
        sim=SimConfig(n_requests=16, rate=12.0, seed=0,
                      classes=(dataclasses.replace(_INTERACTIVE,
                                                   weight=1.0),)),
        n_slots=2, prefill_chunk=4, scheduler="fcfs",
        replicas=3, prefill_replicas=1,
        chaos="replica-kill@fleet.tick=6,rank=1",
        min_handoffs=1, min_migrations=1),
)}

def _register_tenants(target, scenario: Scenario, cfg, device) -> None:
    """Register ``scenario.adapters`` on ``target`` (an engine, supervisor
    or fleet: one call shape), each tenant's weights a pure function of
    its index, and arm the hot-swap: at target tick
    ``adapter_swap_tick``, ``adapters[0]`` is re-registered with new
    seeded weights. Counting ticks reads no clock, so the virtual timeline
    is the same with the swap armed or not."""
    from simple_distributed_machine_learning_tpu_torch.models import lora

    def weights(seed: int) -> dict:
        return lora.init_lora_adapter(torch.Generator().manual_seed(seed),
                                      cfg, scenario.adapter_rank,
                                      device=device)

    for k, name in enumerate(scenario.adapters):
        target.register_adapter(name, weights(1000 + k))
    if not scenario.adapter_swap_tick:
        return
    new_w = weights(424242)
    inner_step = target.step
    n = [0]

    def step():
        n[0] += 1
        if n[0] == scenario.adapter_swap_tick:
            target.register_adapter(scenario.adapters[0], new_w)
        return inner_step()

    target.step = step


def run_scenario(scenario: Scenario | str, stages, cfg, *,
                 outdir: str | None = None, scheduler: str | None = None,
                 virtual: bool = True, per_call_s: float = 0.001,
                 supervised: bool | None = None, trace=None,
                 route: str | None = None,
                 prefill_replicas: int | None = None,
                 host_cache_blocks: int | None = None,
                 device=None, **engine_kw) -> dict:
    """Run one scenario end to end; returns the report with the SLO block.

    ``stages``/``cfg``: a ``make_gpt_stages`` build on ``device`` (None =
    ``"cuda"``; raises without CUDA unless ``"cpu"``). ``scheduler``
    overrides the scenario's policy; ``supervised=False`` on a
    deadline-carrying scenario is the no-deadline baseline; ``route`` and
    ``prefill_replicas`` override a fleet scenario's routing policy and
    disaggregation (``prefill_replicas=0`` is the symmetric baseline), and
    ``host_cache_blocks`` its host tier (``0`` is the HBM-only baseline;
    the report then has no ``host_tier`` block).
    Extra ``engine_kw`` (``attn_kernel``, ``params``, ...) reach every
    engine the run builds. With ``outdir`` the serve record and a ``kind:
    "scenario"`` record land in ``metrics.jsonl`` + ``metrics.prom``, one
    ``kind: "slo_alert"`` record per alert transition after it, the
    journals as ``journal-<name>[-r<idx>].jsonl`` and a post-mortem bundle
    per restart / drain timeout / shed burst.

    ``trace``: ``True`` builds a ``serve/tracing.py::ServeTrace`` (written
    to ``outdir`` as ``serve_trace-<name>.json`` + its timeline when an
    outdir is set), or pass a ready recorder. The report then carries
    ``trace_events`` and the ``attribution`` block; the recorder reads no
    clock, so every virtual-clock number is the same with tracing on or
    off.

    ``report["slo_ok"]`` is True only when every gated class attains every
    target at ``min_attainment`` or better AND every request is accounted
    for — completed, or (``allow_shed``) structurally shed — AND a
    supervised run restarted at least ``min_restarts`` times AND a fleet
    run migrated and handed off at least ``min_migrations`` /
    ``min_handoffs`` times AND a host tier demoted and prefetched at least
    ``min_host_demotes`` / ``min_host_prefetch_hits`` times AND an adapter
    run uploaded at least ``min_adapter_swaps`` bank rows."""
    import tempfile
    import time

    if isinstance(scenario, str):
        if scenario not in SCENARIOS:
            raise ValueError(
                f"unknown scenario {scenario!r}; available: "
                f"{sorted(SCENARIOS)} (see resilience/scenarios.py)")
        scenario = SCENARIOS[scenario]
    clock = VirtualClock(per_call_s) if virtual else time.monotonic
    sleep = clock.sleep if virtual else time.sleep
    policy = scheduler or scenario.scheduler
    sched_cls = PriorityScheduler if policy == "priority" else FCFSScheduler
    sup_flag = scenario.supervised if supervised is None else supervised
    fleet_flag = scenario.replicas > 0
    route_policy = route or scenario.route
    n_prefill = (scenario.prefill_replicas if prefill_replicas is None
                 else prefill_replicas)
    n_host = (scenario.host_cache_blocks if host_cache_blocks is None
              else host_cache_blocks)

    plan = None
    if scenario.chaos:
        plan = faults.install(faults.FaultPlan.parse(scenario.chaos,
                                                     sleep=sleep))
    target = None
    tmpdir = None
    own_trace = trace is True      # built here -> closed here
    try:
        from simple_distributed_machine_learning_tpu_torch.serve.engine import (  # noqa: E501
            InferenceEngine,
        )
        metrics = ServeMetrics(outdir=outdir, clock=clock)
        # the streaming SLO engine, wherever a supervisor or a fleet owns
        # the tick (observation and evaluation read no clock)
        slo_engine = None
        if sup_flag or fleet_flag:
            from simple_distributed_machine_learning_tpu_torch.telemetry.slo import (  # noqa: E501
                SLOEngine,
            )
            slo_engine = SLOEngine.from_classes(
                scenario.sim.classes, registry=metrics.registry)
        if trace is True:
            from simple_distributed_machine_learning_tpu_torch.serve.tracing import (  # noqa: E501
                ServeTrace,
            )
            trace = ServeTrace(outdir=outdir,
                               suffix=f"-{scenario.name}" if outdir else "")
        kw = dict(n_slots=scenario.n_slots, block_size=scenario.block_size,
                  n_blocks=scenario.n_blocks, max_len=scenario.max_len,
                  prefill_chunk=scenario.prefill_chunk,
                  scheduler=sched_cls, metrics=metrics, clock=clock,
                  device=device, **engine_kw)
        if n_host:
            kw["host_cache_blocks"] = n_host
            kw["prefetch_ticks"] = scenario.prefetch_ticks
        if scenario.adapter_rank:
            kw["adapter_rank"] = scenario.adapter_rank
        if trace and not (sup_flag or fleet_flag):
            kw["trace"] = trace
        if fleet_flag:
            if outdir:
                jdir = outdir
            else:
                tmpdir = tempfile.TemporaryDirectory(prefix="sdml-fleet-")
                jdir = tmpdir.name
            target = ServeFleet(
                engine_factory(stages, cfg, **kw), jdir,
                n_replicas=scenario.replicas,
                prefill_replicas=n_prefill, route=route_policy,
                metrics=metrics, clock=clock,
                autoscale=scenario.autoscale,
                max_restarts=scenario.max_restarts,
                degrade_after=scenario.degrade_after,
                overload=scenario.overload,
                trace=trace or None,
                # virtual-clock runs measure scheduling structure, not
                # durability: no fsync per record
                journal_sync=not virtual,
                journal_prefix=f"journal-{scenario.name}-r",
                postmortem_dir=outdir, slo=slo_engine)
        elif sup_flag:
            from simple_distributed_machine_learning_tpu_torch.serve.journal import (  # noqa: E501
                RequestJournal,
            )
            if outdir:
                jpath = os.path.join(outdir,
                                     f"journal-{scenario.name}.jsonl")
                if os.path.exists(jpath):
                    os.unlink(jpath)           # each run journals fresh
            else:
                tmpdir = tempfile.TemporaryDirectory(prefix="sdml-journal-")
                jpath = os.path.join(tmpdir.name, "journal.jsonl")
            target = ServeSupervisor(
                engine_factory(stages, cfg, **kw),
                RequestJournal(jpath, sync=not virtual),
                metrics=metrics, clock=clock,
                max_restarts=scenario.max_restarts,
                degrade_after=scenario.degrade_after,
                overload=scenario.overload, trace=trace or None,
                postmortem_dir=outdir, slo=slo_engine)
        else:
            target = InferenceEngine(stages, cfg, **kw)
        if scenario.adapter_rank:
            _register_tenants(target, scenario, cfg, device)
        report = simulate(target, scenario.sim, sleep=sleep)
    finally:
        if plan is not None:
            faults.uninstall()
        if (sup_flag or fleet_flag) and target is not None:
            target.close()
        if trace and trace is not True:
            # a recorder built here closes its timeline handle; a
            # caller's only flushes (its lifecycle is the caller's)
            trace.close() if own_trace else trace.flush()
        if tmpdir is not None:
            tmpdir.cleanup()

    n = scenario.sim.n_requests
    accounted = report["completed"] + (report["shed"]
                                       if scenario.allow_shed else 0)
    slo: dict = {}
    ok = accounted == n
    if sup_flag:
        report["restarts"] = target.restarts
        report["supervisor_state"] = target.state
        report["postmortem_bundles"] = len(target.postmortems)
        ok &= target.restarts >= scenario.min_restarts
    if fleet_flag:
        report["fleet"] = {
            "replicas": scenario.replicas,
            "route": route_policy,
            "alive": target.n_alive,
            "in_rotation": target.n_in_rotation,
            "replica_losses": target.replica_losses,
            "migrations": target.migrations,
            "affinity_hits": int(metrics.route_affinity_hits.value),
            "scale_outs": int(metrics.fleet_scale_outs.value),
            "retired": int(metrics.fleet_retired.value),
            "replica_log": list(target.replica_log),
        }
        if n_prefill:
            report["fleet"]["prefill_replicas"] = n_prefill
            report["fleet"]["handoffs"] = target.handoffs
            ok &= target.handoffs >= scenario.min_handoffs
        report["restarts"] = sum(
            r.supervisor.restarts for r in target.replicas)
        ok &= target.migrations >= scenario.min_migrations
    if n_host:
        # host-tier outcomes summed over every pool the run built (the
        # replicas share one ServeMetrics, whose counters sum the deltas)
        hc = metrics._host_counters
        report["host_tier"] = {
            "host_cache_blocks": n_host,
            "demotes": int(hc["host_demotes_total"].value),
            "promotes": int(hc["host_promotes_total"].value),
            "prefetch_hits": int(hc["host_prefetch_hits_total"].value),
            "prefetch_misses": int(hc["host_prefetch_misses_total"].value),
            "host_evictions": int(hc["host_evictions_total"].value),
            "transfer_bytes": int(hc["host_transfer_bytes_total"].value),
        }
        ok &= report["host_tier"]["demotes"] >= scenario.min_host_demotes
        ok &= (report["host_tier"]["prefetch_hits"]
               >= scenario.min_host_prefetch_hits)
    if scenario.adapter_rank:
        report["adapters"] = {
            "rank": scenario.adapter_rank,
            "tenants": list(scenario.adapters),
            "resident_bytes": int(metrics.adapter_resident_bytes.value),
            "swaps": int(metrics.adapter_swaps.value),
            "adapter_affinity_hits": int(metrics.route_adapter_hits.value),
        }
        ok &= report["adapters"]["swaps"] >= scenario.min_adapter_swaps
    if trace:
        report["trace_events"] = trace.n_events
        # fold every traced request's timeline into the additive TTFT
        # decomposition (attribute() raises on drift)
        from simple_distributed_machine_learning_tpu_torch.telemetry.attribution import (  # noqa: E501
            attribute,
        )
        report["attribution"] = attribute(trace.rows,
                                          registry=metrics.registry)
    for tc in scenario.sim.classes:
        if tc.ttft_slo_ms is None and tc.tpot_slo_ms is None:
            continue
        att = metrics.attainment(tc.name, ttft_slo_ms=tc.ttft_slo_ms,
                                 tpot_slo_ms=tc.tpot_slo_ms)
        cls_ok = True
        for key in ("ttft_attainment", "tpot_attainment"):
            if key in att:
                cls_ok &= (att[key] is not None
                           and att[key] >= scenario.min_attainment)
        att["ok"] = cls_ok
        slo[tc.name] = att
        ok &= cls_ok
    report["scenario"] = scenario.name
    report["scheduler"] = policy
    report["supervised"] = sup_flag
    report["slo"] = slo
    report["slo_ok"] = ok
    if slo_engine is not None:
        report["slo_alerts"] = slo_engine.summary()
    if plan is not None:
        report["faults"] = plan.stats()
    if outdir:
        from simple_distributed_machine_learning_tpu_torch.telemetry.registry import (  # noqa: E501
            append_jsonl,
        )
        metrics.emit(extra={"scenario": scenario.name, "scheduler": policy,
                            "completed": report["completed"]})
        append_jsonl(os.path.join(outdir, "metrics.jsonl"), {
            "kind": "scenario", "scenario": scenario.name,
            "scheduler": policy, "supervised": sup_flag,
            "completed": report["completed"], "shed": report["shed"],
            "n_requests": report["n_requests"], "slo": slo, "slo_ok": ok,
            **({"restarts": report["restarts"]} if sup_flag else {}),
            **({"fleet": {k: v for k, v in report["fleet"].items()
                          if k != "replica_log"}} if fleet_flag else {}),
            **({"host_tier": report["host_tier"]} if n_host else {}),
            **({"adapters": report["adapters"]}
               if scenario.adapter_rank else {}),
            **({"slo_alerts": {
                "transitions": len(slo_engine.alerts.journal),
                "firing": slo_engine.active_alerts(),
                "states": slo_engine.alerts.states()}}
               if slo_engine is not None else {}),
            **({"attribution": report["attribution"]}
               if "attribution" in report else {}),
            **({"faults_fired": plan.stats()["total_fired"]}
               if plan is not None else {}),
        })
        if slo_engine is not None:
            # one joinable row per alert transition
            for tr in slo_engine.alerts.journal:
                append_jsonl(os.path.join(outdir, "metrics.jsonl"),
                             {"kind": "slo_alert",
                              "scenario": scenario.name, **tr})
    return report
