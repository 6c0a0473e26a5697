"""Serving telemetry on the metric registry (port of ``serve/metrics.py``).

The serving-standard latency split, as registry instruments:

- ``serve_ttft_ms`` (histogram) — time to first token: queue wait + prefill,
  per request. The latency a user perceives before anything streams.
- ``serve_tpot_ms`` (histogram) — time per output token after the first:
  the decode-tick cadence, one observation per generated token.
- ``serve_queue_depth`` / ``serve_slots_active`` / ``serve_slots_total``
  (gauges) and ``serve_slot_occupancy`` (histogram of active/total per
  tick) — how full the continuous batch runs; occupancy is what batched
  decoding converts into aggregate throughput.
- ``serve_requests_submitted_total`` / ``serve_requests_completed_total`` /
  ``serve_tokens_generated_total`` (counters) and ``serve_tokens_per_sec``
  (gauge) — lifetime request/token counters and aggregate throughput over
  the wall-clock window from first submit to last token.

Paged-pool instruments (populated only by ``kv_layout="paged"`` engines —
the engine hands the pool's stats to :meth:`ServeMetrics.on_tick`):

- ``serve_blocks_in_use`` / ``serve_blocks_free`` / ``serve_blocks_cached``
  / ``serve_blocks_total`` (gauges) — block-pool occupancy: live working
  set, allocatable headroom, reclaimable prefix cache;
- ``serve_kv_bytes_resident`` (gauge) — bytes of K/V live requests
  actually pin (the number the paged layout shrinks vs dense rows);
- ``serve_prefix_hit_blocks_total`` / ``serve_cow_copies_total`` /
  ``serve_block_evictions_total`` (counters) — prefix-share hits at
  admission, copy-on-write block copies, LRU cache evictions;
- ``serve_prefill_chunk_ms`` (histogram) — per-chunk prefill latency: the
  quantity chunked prefill bounds so decode ticks stay steady.

Deployment-shape and speculative instruments:

- ``serve_tp`` / ``serve_spec_k`` (gauges) — the deployment shape: tensor-
  parallel width and speculative verify width (0 = plain decode);
- ``serve_attn_kernel_fused`` (gauge, 0/1) — which attention path the
  paged decode/verify ticks run: 0 = gather-then-dense (the parity
  anchor), 1 = the fused paged-attention kernel (one pass over resident
  K/V per tick; ``ops/paged_attention.py``) — dashboards correlate
  per-tick latency shifts with the kernel path in play;
- ``serve_spec_proposed_tokens_total`` / ``serve_spec_accepted_tokens_total``
  / ``serve_spec_rejected_tokens_total`` (counters) and
  ``serve_spec_accept_rate`` (histogram, one observation per speculative
  tick) — how much of the draft's work the target agreed with; accept
  rate is what converts ``spec_k`` into real tokens/tick.

Traffic-class instruments (populated when requests carry ``cls`` — the
scenario suite's per-class SLO accounting, ``resilience/scenarios.py``):

- ``serve_class_ttft_ms{class=...}`` / ``serve_class_tpot_ms{class=...}``
  (histograms) — the per-class latency split SLO attainment is computed
  from (:meth:`ServeMetrics.attainment` via the registry histograms'
  ``fraction_below``);
- ``serve_class_completed_total{class=...}`` and
  ``serve_class_preemptions_total{class=...}`` (counters), plus the global
  ``serve_preemptions_total`` — how often priority scheduling evicted
  best-effort traffic to protect an interactive class.

Crash-restart + overload-control instruments (fed by the serve supervisor,
``serve/supervisor.py``):

- ``serve_restarts_total`` (counter) — engine rebuilds after a recoverable
  failure;
- ``serve_recovered_requests_total`` (counter) — in-flight requests
  re-admitted from the journal across those restarts;
- ``serve_shed_total{reason=deadline|backpressure|class}`` (counter) and
  ``serve_class_shed_total{class=...}`` — structured rejections: expired
  deadlines, queue-depth backpressure, per-class token-bucket/degraded
  lockout;
- ``serve_degraded`` (gauge, 0/1) — whether the supervisor is in a
  degraded mode (fallback engine layout after repeated crashes, or the
  overload best-effort lockout);
- ``serve_journal_bytes`` (gauge) — the request journal's durable size
  (under a fleet: summed over every alive replica's journal).

Fleet instruments (fed by the multi-replica fleet, ``serve/fleet.py``):

- ``serve_fleet_replicas`` (gauge) — alive replicas currently IN ROTATION
  (healthy per the supervisor state machine and past the re-entry
  hysteresis): the capacity the router is actually spreading load over;
- ``serve_fleet_replica_losses_total`` (counter) — whole-replica deaths
  the fleet absorbed (injected ``replica-kill`` faults and replicas whose
  supervisor exhausted its restart budget);
- ``serve_fleet_migrations_total`` (counter) — in-flight requests
  re-admitted onto a SURVIVING replica from a dead replica's journal
  alone (the cross-replica migration path — each one's token stream stays
  bit-exact vs the uninterrupted run);
- ``serve_route_affinity_hits_total`` (counter) — routing decisions that
  landed on a replica already holding the request's prompt prefix in its
  paged pool's registry (the prefix-cache-aware half of the router; the
  hot-prefix-skew scenario pins this strictly above round-robin);
- ``serve_fleet_scale_outs_total`` / ``serve_fleet_retired_total``
  (counters) — autoscaler actions: replicas added on sustained backlog,
  replicas drained-then-retired on sustained idleness;
- ``serve_route_alert_demotions_total`` (counter) — routing decisions
  where the best prefix-affinity candidate was skipped because its
  per-replica SLO burn alert was firing (the alert→router feedback loop;
  the burn-rate / alert instruments themselves are documented alongside
  the SLO engine, ``telemetry/slo.py``, and the TTFT attribution
  histogram alongside ``telemetry/attribution.py``).

Disaggregated-pool instruments (fed by the disaggregated fleet,
``serve/fleet.py``):

- ``serve_fleet_handoffs_total`` (counter) — planned prefill→decode
  migrations: requests moved at end-of-prefill by the same journal
  snap/adopt move failure migration uses, each handed-off token stream
  bit-exact vs the symmetric single-pool run;
- ``serve_pool_replicas{pool=prefill|decode}`` (gauge) — alive replicas
  per role pool: the independently-sized halves of a disaggregated
  fleet;
- ``serve_pool_queue_depth{pool=...}`` / ``serve_pool_slots_active{pool=...}``
  (gauges) — per-pool backlog and occupancy: the imbalance signal the
  disaggregated scenarios pin (prefill-heavy vs decode-heavy mixes).

Host-offload-tier instruments (fed by the paged pool's host tier,
``serve/slots.py``, through ``PagedKVPool.stats()`` every tick):

- ``serve_host_blocks`` / ``serve_host_bytes_resident`` (gauges) —
  host-RAM offload tier occupancy: blocks demoted from device memory
  that live on in host memory, and the bytes they pin there (host blocks
  x the ``kv_block_bytes`` formula);
- ``serve_host_inflight_blocks`` (gauge) — blocks mid host→device
  prefetch upload: claimed on the device, keys not yet registered;
- ``serve_host_demotes_total`` / ``serve_host_promotes_total`` /
  ``serve_host_evictions_total`` (counters) — tier traffic: device
  evictions demoted to host instead of dying, completed uploads that
  re-registered their prefix keys on the device, and host-side LRU drops
  at ``host_cache_blocks`` capacity;
- ``serve_host_prefetch_hits_total`` / ``serve_host_prefetch_misses_total``
  (counters) — routing-time prefetch outcomes: a hit started (or joined)
  the upload of a host-resident prefix, a miss found nothing the device
  registry did not already cover or no free blocks to upload into;
- ``serve_host_transfer_bytes_total`` (counter) — bytes moved across the
  device↔host boundary in either direction (demotes down, promotes up),
  one ``kv_block_bytes`` per block moved.

Multi-tenant adapter instruments (fed by the engine's per-tick
``AdapterStore.stats()``, the router, and completion):

- ``serve_adapter_resident_bytes`` (gauge) — device memory the adapter
  bank pins: the whole static ``[n_rows, L, d, r]`` stacked-A/B
  allocation (``models/lora.py::bank_bytes``);
- ``serve_adapter_swaps_total`` (counter) — adapter bank-row uploads:
  tick-boundary device writes that seated a tenant's weights (a hot-swap
  or a first admission);
- ``serve_route_adapter_affinity_hits_total`` (counter) — routing
  decisions made by adapter residency: the request landed on a replica
  already holding its adapter's current version on the device, skipping
  a bank-row upload (the hot-adapter-churn scenario pins this above
  round-robin);
- ``serve_class_adapter`` (counter, labeled ``class=<adapter name>``) —
  completed requests per TENANT: the per-adapter traffic split the
  telemetry report's tenant block renders.

With a bound :class:`~..telemetry.slo.SLOEngine` (``bind_slo``) every
TTFT/TPOT/shed observation also streams into its windowed series, tagged
with the fleet replica the fleet sets around each replica's step or
submit (``_slo_replica``).

Model-drift instruments (the byte model checked as a runtime invariant,
fed every tick from ``engine.kv_drift``):

- ``serve_kv_bytes_predicted`` (gauge) — the byte model's
  ``predict_kv_bytes_resident`` over the live sequences' written-row
  counts: what the static model says the pool must be pinning;
- ``serve_kv_drift_bytes`` (gauge) — live resident bytes minus the
  prediction: exactly 0 without prefix sharing, ≤ 0 with it (sharing only
  shrinks the truth), > 0 only on a block-accounting leak — the invariant
  the clean-run tests pin at zero.

``emit()`` writes one ``kind: "serve"`` record to ``metrics.jsonl`` and
rewrites ``metrics.prom``, whose ``# HELP`` lines the metric catalog
(``telemetry/catalog.py``) parses from the bullets above.
"""

from __future__ import annotations

import os
import time

from simple_distributed_machine_learning_tpu_torch.telemetry.registry import (
    MetricsRegistry,
    append_jsonl,
)

METRICS_FILE = "metrics.jsonl"
PROM_FILE = "metrics.prom"

# pool lifetime totals -> instrument names (the counters get the deltas)
_POOL_COUNTERS = {
    "prefix_hit_blocks_total": "serve_prefix_hit_blocks_total",
    "cow_copies_total": "serve_cow_copies_total",
    "evictions_total": "serve_block_evictions_total",
}


# host-offload-tier counter keys -> instrument names (same lifetime-total
# to per-tick-delta conversion; in ``stats()`` only when the pool runs a
# host tier)
_HOST_COUNTERS = {
    "host_demotes_total": "serve_host_demotes_total",
    "host_promotes_total": "serve_host_promotes_total",
    "host_evictions_total": "serve_host_evictions_total",
    "host_prefetch_hits_total": "serve_host_prefetch_hits_total",
    "host_prefetch_misses_total": "serve_host_prefetch_misses_total",
    "host_transfer_bytes_total": "serve_host_transfer_bytes_total",
}


class ServeMetrics:
    """One serving run's instruments; see module docstring."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 outdir: str | None = None, clock=time.monotonic) -> None:
        self.registry = registry if registry is not None else MetricsRegistry()
        self.outdir = outdir
        self._clock = clock
        self._t_first_submit: float | None = None
        self._t_last_token: float | None = None
        r = self.registry
        self.queue_depth = r.gauge("serve_queue_depth")
        self.slots_active = r.gauge("serve_slots_active")
        self.slots_total = r.gauge("serve_slots_total")
        self.occupancy = r.histogram("serve_slot_occupancy")
        self.ttft_ms = r.histogram("serve_ttft_ms")
        self.tpot_ms = r.histogram("serve_tpot_ms")
        self.submitted = r.counter("serve_requests_submitted_total")
        self.completed = r.counter("serve_requests_completed_total")
        self.tokens = r.counter("serve_tokens_generated_total")
        self.tokens_per_sec = r.gauge("serve_tokens_per_sec")
        self.blocks_total = r.gauge("serve_blocks_total")
        self.blocks_in_use = r.gauge("serve_blocks_in_use")
        self.blocks_free = r.gauge("serve_blocks_free")
        self.blocks_cached = r.gauge("serve_blocks_cached")
        self.kv_bytes_resident = r.gauge("serve_kv_bytes_resident")
        # model-drift gauges (both layouts; fed per tick by the engine)
        self.kv_bytes_predicted = r.gauge("serve_kv_bytes_predicted")
        self.kv_drift_bytes = r.gauge("serve_kv_drift_bytes")
        self._drift_seen = False
        self.prefill_chunk_ms = r.histogram("serve_prefill_chunk_ms")
        self._pool_counters = {k: r.counter(v)
                               for k, v in _POOL_COUNTERS.items()}
        self._pool_counter_seen = dict.fromkeys(_POOL_COUNTERS, 0)
        self._paged_seen = False
        self.preemptions = r.counter("serve_preemptions_total")
        self.tp_gauge = r.gauge("serve_tp")
        self.spec_k_gauge = r.gauge("serve_spec_k")
        self.attn_kernel_gauge = r.gauge("serve_attn_kernel_fused")
        self._shape_seen = False
        self.spec_proposed = r.counter("serve_spec_proposed_tokens_total")
        self.spec_accepted = r.counter("serve_spec_accepted_tokens_total")
        self.spec_rejected = r.counter("serve_spec_rejected_tokens_total")
        self.spec_accept_rate = r.histogram("serve_spec_accept_rate")
        self._spec_seen = False
        # the supervisor's instruments (the summary's resilience block
        # appears once any of its hooks fires)
        self.restarts_total = r.counter("serve_restarts_total")
        self.recovered_total = r.counter("serve_recovered_requests_total")
        self.degraded_gauge = r.gauge("serve_degraded")
        self.journal_bytes_gauge = r.gauge("serve_journal_bytes")
        self._shed_reasons: dict[str, object] = {}
        self._resilience_seen = False
        # fleet instruments (serve/fleet.py; the summary's fleet block
        # appears once the fleet feeds any of them)
        self.fleet_replicas = r.gauge("serve_fleet_replicas")
        self.fleet_losses = r.counter("serve_fleet_replica_losses_total")
        self.fleet_migrations = r.counter("serve_fleet_migrations_total")
        self.route_affinity_hits = r.counter(
            "serve_route_affinity_hits_total")
        self.fleet_scale_outs = r.counter("serve_fleet_scale_outs_total")
        self.fleet_retired = r.counter("serve_fleet_retired_total")
        self.fleet_handoffs = r.counter("serve_fleet_handoffs_total")
        self.route_alert_demotions = r.counter(
            "serve_route_alert_demotions_total")
        self._fleet_seen = False
        # disaggregated per-pool gauges, labelled by role
        self._pool_gauges: dict[tuple, object] = {}
        self._pool_names: set[str] = set()
        self._pools_seen = False
        # optional streaming SLO engine (telemetry/slo.py), fed every
        # TTFT/TPOT/shed observation once bound, under the replica index
        # the fleet sets around each replica's step/submit (None outside
        # a fleet)
        self.slo = None
        self._slo_replica: int | None = None
        # the host offload tier: gauges set and counters delta-fed from
        # block_stats, as the pool counters are
        self.host_blocks = r.gauge("serve_host_blocks")
        self.host_bytes_resident = r.gauge("serve_host_bytes_resident")
        self.host_inflight = r.gauge("serve_host_inflight_blocks")
        self._host_counters = {k: r.counter(v)
                               for k, v in _HOST_COUNTERS.items()}
        self._host_counter_seen = dict.fromkeys(_HOST_COUNTERS, 0)
        self._host_seen = False
        # multi-tenant adapters: swap accounting is lifetime->delta PER
        # STORE (a fleet's replicas each own a store and share this
        # object; one scalar would ratchet to the max instead of summing)
        self.adapter_resident_bytes = r.gauge(
            "serve_adapter_resident_bytes")
        self.adapter_swaps = r.counter("serve_adapter_swaps_total")
        self.route_adapter_hits = r.counter(
            "serve_route_adapter_affinity_hits_total")
        self._adapter_swaps_seen: dict[int, int] = {}
        self._adapter_seen = False
        self._adapter_names: set[str] = set()
        self._classes: set[str] = set()
        if outdir:
            os.makedirs(outdir, exist_ok=True)

    def _class_hist(self, name: str, cls: str):
        self._classes.add(cls)
        return self.registry.histogram(name, labels={"class": cls})

    def _class_counter(self, name: str, cls: str):
        self._classes.add(cls)
        return self.registry.counter(name, labels={"class": cls})

    # -- event hooks (engine-driven) --------------------------------------

    def on_submit(self) -> None:
        if self._t_first_submit is None:
            self._t_first_submit = self._clock()
        self.submitted.inc()

    def bind_slo(self, slo) -> None:
        """Attach a ``telemetry.slo.SLOEngine``: later latency and shed
        observations stream into its windowed series."""
        self.slo = slo

    def on_first_token(self, ttft_s: float, cls: str | None = None) -> None:
        self.ttft_ms.observe(ttft_s * 1e3)
        if cls is not None:
            self._class_hist("serve_class_ttft_ms", cls).observe(ttft_s * 1e3)
            if self.slo is not None:
                self.slo.observe_ttft(cls, ttft_s * 1e3,
                                      replica=self._slo_replica)
        self._on_any_token()

    def on_token(self, tpot_s: float, cls: str | None = None) -> None:
        self.tpot_ms.observe(tpot_s * 1e3)
        if cls is not None:
            self._class_hist("serve_class_tpot_ms", cls).observe(tpot_s * 1e3)
            if self.slo is not None:
                self.slo.observe_tpot(cls, tpot_s * 1e3,
                                      replica=self._slo_replica)
        self._on_any_token()

    def on_preempt(self, cls: str | None = None) -> None:
        self.preemptions.inc()
        if cls is not None:
            self._class_counter("serve_class_preemptions_total", cls).inc()

    # -- supervisor hooks (crash restart + overload control) ---------------

    def on_restart(self) -> None:
        self._resilience_seen = True
        self.restarts_total.inc()

    def on_recovered(self, n: int) -> None:
        """``n`` in-flight requests re-admitted from the journal."""
        self._resilience_seen = True
        if n:
            self.recovered_total.inc(n)

    def on_shed(self, reason: str, cls: str | None = None) -> None:
        """One structured rejection; ``reason`` is the label value
        (``deadline`` | ``backpressure`` | ``class``)."""
        self._resilience_seen = True
        counter = self._shed_reasons.get(reason)
        if counter is None:
            counter = self._shed_reasons[reason] = self.registry.counter(
                "serve_shed_total", labels={"reason": reason})
        counter.inc()
        if cls is not None:
            self._class_counter("serve_class_shed_total", cls).inc()
            if self.slo is not None:
                self.slo.observe_shed(cls, replica=self._slo_replica)

    def set_degraded(self, degraded) -> None:
        self._resilience_seen = True
        self.degraded_gauge.set(int(bool(degraded)))

    def set_journal_bytes(self, n: int) -> None:
        self._resilience_seen = True
        self.journal_bytes_gauge.set(int(n))

    # -- fleet hooks (serve/fleet.py) ---------------------------------------

    def set_fleet_replicas(self, n: int) -> None:
        """Alive in-rotation replicas after this fleet tick."""
        self._fleet_seen = True
        self.fleet_replicas.set(int(n))

    def on_replica_loss(self) -> None:
        self._fleet_seen = True
        self.fleet_losses.inc()

    def on_fleet_migrated(self, n: int) -> None:
        """``n`` in-flight requests migrated off a dead replica."""
        self._fleet_seen = True
        if n:
            self.fleet_migrations.inc(n)

    def on_affinity_hit(self) -> None:
        self._fleet_seen = True
        self.route_affinity_hits.inc()

    def on_adapter_affinity_hit(self) -> None:
        """The router's decision was made by adapter residency: the
        destination already holds the request's adapter on the device."""
        self._fleet_seen = True
        self._adapter_seen = True
        self.route_adapter_hits.inc()

    def on_alert_demotion(self) -> None:
        """One routing decision skipped the best affinity replica because
        its per-replica burn alert was firing."""
        self._fleet_seen = True
        self.route_alert_demotions.inc()

    def on_scale_out(self) -> None:
        self._fleet_seen = True
        self.fleet_scale_outs.inc()

    def on_retire(self) -> None:
        self._fleet_seen = True
        self.fleet_retired.inc()

    def on_handoff(self, n: int = 1) -> None:
        """``n`` planned prefill→decode handoffs."""
        self._fleet_seen = True
        if n:
            self.fleet_handoffs.inc(n)

    def _pool_gauge(self, name: str, pool: str):
        key = (name, pool)
        g = self._pool_gauges.get(key)
        if g is None:
            g = self._pool_gauges[key] = self.registry.gauge(
                name, labels={"pool": pool})
        return g

    def set_pool_stats(self, pool: str, *, replicas: int,
                       queue_depth: int, slots_active: int) -> None:
        """One role pool's end-of-tick shape (disaggregated fleets only):
        alive replicas, summed queue depth, summed active slots."""
        self._pools_seen = True
        self._pool_names.add(pool)
        self._pool_gauge("serve_pool_replicas", pool).set(int(replicas))
        self._pool_gauge("serve_pool_queue_depth",
                         pool).set(int(queue_depth))
        self._pool_gauge("serve_pool_slots_active",
                         pool).set(int(slots_active))

    def _on_any_token(self) -> None:
        self.tokens.inc()
        self._t_last_token = self._clock()
        span = self.window_s
        if span and span > 0:
            self.tokens_per_sec.set(self.tokens.value / span)

    def on_complete(self, cls: str | None = None,
                    adapter: str | None = None) -> None:
        self.completed.inc()
        if cls is not None:
            self._class_counter("serve_class_completed_total", cls).inc()
        if adapter is not None:
            # the per-tenant split, labelled by adapter name (tenants are
            # not traffic classes)
            self._adapter_seen = True
            self._adapter_names.add(adapter)
            self.registry.counter("serve_class_adapter",
                                  labels={"class": adapter}).inc()

    def on_prefill_chunk(self, chunk_ms: float) -> None:
        """One prefill chunk's wall latency."""
        self.prefill_chunk_ms.observe(chunk_ms)

    def on_spec(self, proposed: int, accepted: int) -> None:
        """One speculative tick's draft tokens: ``proposed`` were verified,
        ``accepted`` survived (the rest were rejected at or after the
        target's first disagreement). The rate histogram gets one
        observation per tick; with draft == target it stays at 1.0."""
        self._spec_seen = True
        rejected = proposed - accepted
        self.spec_proposed.inc(proposed)
        if accepted:
            self.spec_accepted.inc(accepted)
        if rejected:
            self.spec_rejected.inc(rejected)
        self.spec_accept_rate.observe(accepted / proposed)

    def on_tick(self, queue_depth: int, active: int, total: int,
                decode_active: int | None = None,
                block_stats: dict | None = None,
                tp: int | None = None, spec_k: int | None = None,
                kv_predicted: int | None = None,
                kv_drift: int | None = None,
                attn_kernel: str | None = None,
                adapter_stats: dict | None = None) -> None:
        """End-of-tick gauges. ``decode_active`` is the occupancy the
        tick's batched decode ran at (sampled before same-tick
        retirement); ticks without a decode skip the occupancy sample.
        ``block_stats`` is ``PagedKVPool.stats()``; ``tp``/``spec_k`` the
        deployment shape; ``kv_predicted``/``kv_drift`` the engine's
        per-tick model check (``engine.kv_drift``); ``attn_kernel`` its
        attention path; ``adapter_stats`` ``AdapterStore.stats()``."""
        self.queue_depth.set(queue_depth)
        self.slots_active.set(active)
        self.slots_total.set(total)
        if kv_predicted is not None:
            self._drift_seen = True
            self.kv_bytes_predicted.set(kv_predicted)
            self.kv_drift_bytes.set(kv_drift or 0)
        if tp is not None:
            self._shape_seen = True
            self.tp_gauge.set(tp)
            self.spec_k_gauge.set(spec_k or 0)
        if attn_kernel is not None:
            self.attn_kernel_gauge.set(int(attn_kernel == "fused"))
        if adapter_stats is not None:
            self._adapter_seen = True
            self.adapter_resident_bytes.set(adapter_stats["resident_bytes"])
            sid = adapter_stats.get("store", 0)
            delta = (adapter_stats["swaps_total"]
                     - self._adapter_swaps_seen.get(sid, 0))
            if delta > 0:
                self.adapter_swaps.inc(delta)
                self._adapter_swaps_seen[sid] = adapter_stats["swaps_total"]
        occ = active if decode_active is None else decode_active
        if occ and total:
            self.occupancy.observe(occ / total)
        if block_stats is not None:
            self._paged_seen = True
            self.blocks_total.set(block_stats["blocks_total"])
            self.blocks_in_use.set(block_stats["blocks_in_use"])
            self.blocks_free.set(block_stats["blocks_free"])
            self.blocks_cached.set(block_stats["blocks_cached"])
            self.kv_bytes_resident.set(block_stats["kv_bytes_resident"])
            for key, counter in self._pool_counters.items():
                delta = block_stats[key] - self._pool_counter_seen[key]
                if delta > 0:
                    counter.inc(delta)
                    self._pool_counter_seen[key] = block_stats[key]
            if "host_blocks" in block_stats:
                self._host_seen = True
                self.host_blocks.set(block_stats["host_blocks"])
                self.host_bytes_resident.set(
                    block_stats["host_bytes_resident"])
                self.host_inflight.set(block_stats["host_inflight_blocks"])
                for key, counter in self._host_counters.items():
                    delta = block_stats[key] - self._host_counter_seen[key]
                    if delta > 0:
                        counter.inc(delta)
                        self._host_counter_seen[key] = block_stats[key]

    # -- aggregation -------------------------------------------------------

    @property
    def window_s(self) -> float | None:
        """First submit -> last token span (the throughput denominator)."""
        if self._t_first_submit is None or self._t_last_token is None:
            return None
        return self._t_last_token - self._t_first_submit

    def class_summary(self, cls: str) -> dict:
        r3 = (lambda v: None if v is None else round(v, 3))
        ttft = self._class_hist("serve_class_ttft_ms", cls)
        tpot = self._class_hist("serve_class_tpot_ms", cls)
        return {
            "completed": int(self._class_counter(
                "serve_class_completed_total", cls).value),
            "preemptions": int(self._class_counter(
                "serve_class_preemptions_total", cls).value),
            "shed": int(self._class_counter(
                "serve_class_shed_total", cls).value),
            "ttft_ms_p50": r3(ttft.quantile(0.5)),
            "ttft_ms_p95": r3(ttft.quantile(0.95)),
            "tpot_ms_p50": r3(tpot.quantile(0.5)),
            "tpot_ms_p95": r3(tpot.quantile(0.95)),
        }

    def attainment(self, cls: str, ttft_slo_ms: float | None = None,
                   tpot_slo_ms: float | None = None) -> dict:
        """SLO attainment for one class from the registry histograms: the
        weighted fraction of observations within target. None targets are
        skipped; a class with no observations reports None (the scenario
        runner counts that as a failure)."""
        out = dict(self.class_summary(cls))
        if ttft_slo_ms is not None:
            out["ttft_slo_ms"] = ttft_slo_ms
            out["ttft_attainment"] = self._class_hist(
                "serve_class_ttft_ms", cls).fraction_below(ttft_slo_ms)
        if tpot_slo_ms is not None:
            out["tpot_slo_ms"] = tpot_slo_ms
            out["tpot_attainment"] = self._class_hist(
                "serve_class_tpot_ms", cls).fraction_below(tpot_slo_ms)
        return out

    def summary(self) -> dict:
        """The serving record block (the CLI's serve line reads it)."""
        r3 = (lambda v: None if v is None else round(v, 3))
        out = {
            "requests_submitted": int(self.submitted.value),
            "requests_completed": int(self.completed.value),
            "tokens_generated": int(self.tokens.value),
            "tokens_per_sec": round(self.tokens_per_sec.value, 1),
            "ttft_ms_p50": r3(self.ttft_ms.quantile(0.5)),
            "ttft_ms_p95": r3(self.ttft_ms.quantile(0.95)),
            "tpot_ms_p50": r3(self.tpot_ms.quantile(0.5)),
            "tpot_ms_p95": r3(self.tpot_ms.quantile(0.95)),
            "slot_occupancy_mean": r3(self.occupancy.mean),
        }
        if self._shape_seen:
            out["tp"] = int(self.tp_gauge.value)
            out["spec_k"] = int(self.spec_k_gauge.value)
        if self._spec_seen:
            proposed = int(self.spec_proposed.value)
            accepted = int(self.spec_accepted.value)
            out.update({
                "spec_proposed_tokens": proposed,
                "spec_accepted_tokens": accepted,
                "spec_rejected_tokens": int(self.spec_rejected.value),
                "spec_accept_rate": (round(accepted / proposed, 4)
                                     if proposed else None),
            })
        if self.preemptions.value:
            out["preemptions"] = int(self.preemptions.value)
        if self._resilience_seen:
            shed = {reason: int(c.value)
                    for reason, c in sorted(self._shed_reasons.items())
                    if c.value}
            out.update({
                "restarts": int(self.restarts_total.value),
                "recovered_requests": int(self.recovered_total.value),
                "shed_total": sum(shed.values()),
                "shed_by_reason": shed,
                "degraded": int(self.degraded_gauge.value),
                "journal_bytes": int(self.journal_bytes_gauge.value),
            })
        if self._fleet_seen:
            out.update({
                "fleet_replicas": int(self.fleet_replicas.value),
                "fleet_replica_losses": int(self.fleet_losses.value),
                "fleet_migrations": int(self.fleet_migrations.value),
                "route_affinity_hits": int(self.route_affinity_hits.value),
                "fleet_scale_outs": int(self.fleet_scale_outs.value),
                "fleet_retired": int(self.fleet_retired.value),
                "fleet_handoffs": int(self.fleet_handoffs.value),
                "route_alert_demotions": int(
                    self.route_alert_demotions.value),
            })
        if self._pools_seen:
            out["pools"] = {
                pool: {
                    "replicas": int(self._pool_gauge(
                        "serve_pool_replicas", pool).value),
                    "queue_depth": int(self._pool_gauge(
                        "serve_pool_queue_depth", pool).value),
                    "slots_active": int(self._pool_gauge(
                        "serve_pool_slots_active", pool).value),
                } for pool in sorted(self._pool_names)}
        if self._host_seen:
            hc = self._host_counters
            out.update({
                "host_blocks": int(self.host_blocks.value),
                "host_bytes_resident": int(self.host_bytes_resident.value),
                "host_inflight_blocks": int(self.host_inflight.value),
                "host_demotes": int(hc["host_demotes_total"].value),
                "host_promotes": int(hc["host_promotes_total"].value),
                "host_evictions": int(hc["host_evictions_total"].value),
                "host_prefetch_hits": int(
                    hc["host_prefetch_hits_total"].value),
                "host_prefetch_misses": int(
                    hc["host_prefetch_misses_total"].value),
                "host_transfer_bytes": int(
                    hc["host_transfer_bytes_total"].value),
            })
        if self._adapter_seen:
            out.update({
                "adapter_resident_bytes": int(
                    self.adapter_resident_bytes.value),
                "adapter_swaps": int(self.adapter_swaps.value),
                "route_adapter_affinity_hits": int(
                    self.route_adapter_hits.value),
            })
            if self._adapter_names:
                out["per_adapter_completed"] = {
                    a: int(self.registry.counter(
                        "serve_class_adapter", labels={"class": a}).value)
                    for a in sorted(self._adapter_names)}
        if self._drift_seen:
            out["kv_bytes_predicted"] = int(self.kv_bytes_predicted.value)
            out["kv_drift_bytes"] = int(self.kv_drift_bytes.value)
        if self._classes:
            out["per_class"] = {cls: self.class_summary(cls)
                                for cls in sorted(self._classes)}
        if self._paged_seen:
            out.update({
                "blocks_total": int(self.blocks_total.value),
                "blocks_in_use": int(self.blocks_in_use.value),
                "blocks_cached": int(self.blocks_cached.value),
                "kv_bytes_resident": int(self.kv_bytes_resident.value),
                "prefix_hit_blocks": int(
                    self._pool_counters["prefix_hit_blocks_total"].value),
                "cow_copies": int(
                    self._pool_counters["cow_copies_total"].value),
                "block_evictions": int(
                    self._pool_counters["evictions_total"].value),
                "prefill_chunk_ms_p50": r3(
                    self.prefill_chunk_ms.quantile(0.5)),
                "prefill_chunk_ms_p95": r3(
                    self.prefill_chunk_ms.quantile(0.95)),
            })
        return out

    def emit(self, extra: dict | None = None) -> dict | None:
        """Append one ``kind: "serve"`` JSONL record and rewrite the
        Prometheus exposition into ``outdir`` (no-op without one)."""
        if not self.outdir:
            return None
        rec = {"kind": "serve", **self.summary(), **(extra or {})}
        rec = append_jsonl(os.path.join(self.outdir, METRICS_FILE), rec)
        with open(os.path.join(self.outdir, PROM_FILE), "w") as f:
            f.write(self.registry.prometheus_text())
        return rec
