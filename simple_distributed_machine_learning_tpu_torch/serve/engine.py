"""The continuous-batching inference engine: submit / step / drain.

Port of ``serve/engine.py`` on one device. :class:`InferenceEngine`
serves a GPT over a KV pool (``serve/slots.py``) with a pluggable
scheduler (FCFS by default, or the priority scheduler with preemption):

- ``submit(prompt, ...) -> Request`` enqueues one sequence with its own
  sampling params and seeded key stream, and returns the live handle;
- ``step()`` is one tick. Paged layout (the default): admit (board slots,
  match shared prefixes, reserve blocks) -> at most ONE prefill chunk of
  the oldest prefilling request -> ONE batched decode step over every
  decoding slot -> retire. Dense slot rows (``kv_layout="dense"``, the
  serve supervisor's degraded fallback): admit with a whole-prompt
  prefill each -> one batched decode over every slot -> retire;
- ``drain()`` ticks until queue and slots are empty;
- ``restore(request)`` re-admits a journal-recovered request into a
  rebuilt engine (the serve supervisor's recovery path).

Two fault-injection sites (``resilience/faults.py``) sit where the JAX
engine has them: ``serve.admit`` at the top of ``submit`` and
``serve.tick`` at the top of every busy ``step``.

With a draft model (``draft_stages``/``draft_cfg``/``spec_k``) the decode
step is speculative: the draft proposes ``spec_k`` tokens per slot over
its own dense slot pool, the target verifies them in one batched pass
over its pool — paged (``attn_kernel="fused"``: the CUDA kernel K4 with
``spec_k`` queries per slot) or dense slot rows (plain attention) — and
each slot emits 1..``spec_k`` tokens.

Device state is the pool's K/V tensors, updated in place by the decode
programs; positions, last tokens, block tables, key data and the request
lifecycle are host-side numpy assembled into each tick's inputs.

Correctness anchor: a request's tokens equal its solo
``make_cached_decoder`` decode with the same seed — admission order,
co-residents, paged blocks, shared prefixes, chunk boundaries and, for
greedy requests, speculation cannot change anyone's output.

With ``host_cache_blocks > 0`` the paged pool keeps a host offload tier
(``serve/slots.py``): evicted prefix blocks demote to host RAM, an
upload a router started lands at the top of a tick, before admission,
and a request whose prefix is still in flight waits for it (the
``gate`` trace row). With ``adapters=`` (a ``serve/adapters.py::
AdapterStore``) every program takes the adapter bank and a per-slot row
index: ``submit(adapter=)`` decodes a request under a registered LoRA
adapter, the admission gate pins its bank row, and prefix keys are
namespaced per adapter version so tenants never share K/V. A request
without an adapter rides the all-zero row 0 and keeps the stream of an
engine without adapters.

``trace=`` (a ``serve/tracing.py::ServeTrace``) records every request's
lifecycle at the JAX engine's sites, stamped with timestamps the engine
already read (events without a read of their own take :attr:`_now`, the
most recent one); ``flight=`` (a ``serve/flight.py::FlightRecorder``)
snaps the engine once per busy tick. Neither reads a clock, so tracing on
or off leaves every virtual-clock number unchanged.

The JAX engine's other knobs keep their place in the signature and raise
``NotImplementedError`` naming the ROADMAP item that ports them: tensor
parallelism and the lint preflight.

Clock reads sit exactly where the JAX engine's do (submit without an
arrival stamp, cancel, the dense admission's TTFT endpoint or reseat,
each prefill chunk's two, each decode or speculative tick's one): the
scenario suite's virtual clock charges every read, so one extra read
would move every pinned number.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from simple_distributed_machine_learning_tpu_torch import _roadmap
from simple_distributed_machine_learning_tpu_torch._device import (
    resolve_device,
)
from simple_distributed_machine_learning_tpu_torch.models.gpt import (
    _NO_TOP_K,
    _NO_TOP_P,
    _cache_dtype,
    _check_ported,
    _is_quantized_dtype,
    _merged_stage_trees,
    make_paged_block_copy,
    make_paged_decode_step,
    make_paged_prefill_chunk,
    make_paged_spec_tick,
    make_slot_decode_step,
    make_slot_prefill,
    make_slot_spec_tick,
)
from simple_distributed_machine_learning_tpu_torch.ops.random import key_data
from simple_distributed_machine_learning_tpu_torch.resilience.faults import (
    maybe_fire,
)
from simple_distributed_machine_learning_tpu_torch.serve.metrics import (
    ServeMetrics,
)
from simple_distributed_machine_learning_tpu_torch.serve.request import (
    ACTIVE,
    DONE,
    QUEUED,
    SHED,
    Request,
    draft_key_data,
    validate_request,
)
from simple_distributed_machine_learning_tpu_torch.serve.scheduler import (
    FCFSScheduler,
)
from simple_distributed_machine_learning_tpu_torch.serve.slots import (
    KVCachePool,
    PagedKVPool,
)


class DrainTimeout(RuntimeError):
    """``drain(max_ticks=...)`` hit its cap with requests still in flight;
    ``unfinished`` carries their live handles."""

    def __init__(self, max_ticks: int, unfinished: list):
        states = collections.Counter(r.state for r in unfinished)
        super().__init__(
            f"drain exceeded {max_ticks} ticks with {len(unfinished)} "
            f"unfinished request(s) ({dict(states)}) — rids "
            f"{[r.rid for r in unfinished]}")
        self.max_ticks = max_ticks
        self.unfinished = unfinished


def _check_speculative(draft_stages, draft_cfg, spec_k: int) -> None:
    if (draft_stages is None) != (draft_cfg is None):
        raise ValueError(
            "speculative decoding needs BOTH draft_stages and "
            "draft_cfg (the draft build's config)")
    if draft_stages is not None and spec_k < 2:
        raise ValueError(
            f"speculative decoding needs spec_k >= 2 (got {spec_k}); "
            f"spec_k=1 is plain one-token decode — drop the draft")
    if draft_stages is None and spec_k:
        raise ValueError(
            f"spec_k={spec_k} without draft_stages/draft_cfg — the "
            f"draft model is what proposes the speculated tokens")


def _check_layout(kv_layout, attn_kernel, prefill_chunk, n_blocks,
                  host_cache_blocks) -> None:
    """The JAX engine's layout checks, in its order and words."""
    if kv_layout not in ("paged", "dense"):
        raise ValueError(
            f"kv_layout must be 'paged' or 'dense', got {kv_layout!r}")
    if attn_kernel not in ("dense", "fused"):
        raise ValueError(
            f"attn_kernel must be 'dense' (gather-then-dense "
            f"attention) or 'fused' (the CUDA paged-attention "
            f"kernel), got {attn_kernel!r}")
    if attn_kernel == "fused" and kv_layout != "paged":
        raise ValueError(
            "attn_kernel='fused' is the paged pool's kernel (block-"
            "table gather fused with attention); the dense layout has "
            "no block tables — use kv_layout='paged'")
    if prefill_chunk is not None and prefill_chunk < 1:
        raise ValueError(
            f"prefill_chunk must be >= 1 (or None for whole-prompt "
            f"chunks), got {prefill_chunk}")
    if kv_layout == "dense" and (prefill_chunk is not None
                                 or n_blocks is not None):
        raise ValueError(
            "prefill_chunk/n_blocks are paged-pool knobs; the dense "
            "layout prefills whole prompts into fixed rows")
    if kv_layout == "dense" and host_cache_blocks:
        raise ValueError(
            "host_cache_blocks is a paged-pool knob (the host offload "
            "tier demotes evicted prefix BLOCKS); the dense layout has "
            "no blocks to demote — use kv_layout='paged'")


def _reject_unported(lint, mesh, cfg) -> None:
    if mesh is not None or cfg.n_tensor_parallel > 1:
        raise _roadmap.not_ported("tensor-parallel serving (mesh/"
                                  "n_tensor_parallel > 1)",
                                  _roadmap.PARALLEL_AXES)
    if lint:
        raise _roadmap.not_ported("the serve-program lint preflight",
                                  _roadmap.ANALYSIS)


class InferenceEngine:
    """Continuous-batching serving of a single-device GPT build.

    ``stages``/``cfg``: a ``make_gpt_stages`` build; ``params`` overrides
    the stages' weights (e.g. ``interop.params_from_numpy`` of a JAX
    build). ``max_len`` caps each slot's prompt + generation budget
    (default ``cfg.seq_len``); ``cache_dtype`` is the pool's storage dtype
    (None/f32, bf16, int8, ``float8_e4m3fn``, ``float8_e5m2`` — the narrow
    ones store per-row f32 scales beside their blocks).

    ``kv_layout``: ``"paged"`` (the block-table pool) or ``"dense"``
    (one ``max_len`` row per slot; whole-prompt prefill, no prefix
    sharing, f32/bf16 only). ``block_size`` positions per K/V block;
    ``n_blocks`` pool capacity
    (default: ``n_slots * ceil(max_len / block_size)``); ``prefill_chunk``
    prompt positions per prefill chunk (None = the whole remaining prompt);
    ``attn_kernel`` the decode tick's attention: ``"dense"`` (gather, then
    dense masked softmax; the parity anchor) or ``"fused"`` (the CUDA
    paged-attention kernel, ``ops/paged_attention.py``).

    ``draft_stages``/``draft_cfg`` (a smaller ``make_gpt_stages`` build
    of the same vocab) with ``spec_k >= 2`` make the decode step
    speculative on either layout (module docstring); the draft keeps a
    dense slot pool of its own (f32 when ``cache_dtype`` is quantised).

    ``host_cache_blocks > 0`` (paged only) turns on the pool's host
    offload tier, whose uploads land after ``prefetch_ticks`` ticks.
    ``adapters``: an ``AdapterStore`` built for this engine's ``n_slots``
    on its device (module docstring).

    ``scheduler``: an instance over this engine's pool, or a class /
    factory called with the pool (``PriorityScheduler``; the serve
    supervisor's rebuilds pass the class).

    ``device`` (None = ``"cuda"``; raises without CUDA unless ``"cpu"``)
    holds the pools; the params, the draft's too, must already live
    there.
    """

    def __init__(self, stages, cfg, *, params=None, n_slots: int = 4,
                 max_len: int | None = None, cache_dtype=None,
                 kv_layout: str = "paged", block_size: int = 16,
                 n_blocks: int | None = None, prefill_chunk: int | None = None,
                 host_cache_blocks: int = 0, prefetch_ticks: int = 1,
                 attn_kernel: str = "dense",
                 metrics: ServeMetrics | None = None,
                 scheduler: FCFSScheduler | None = None,
                 clock=time.monotonic, lint: bool = False,
                 mesh=None, draft_stages=None, draft_cfg=None,
                 spec_k: int = 0, trace=None, flight=None,
                 adapters=None, device=None) -> None:
        _check_layout(kv_layout, attn_kernel, prefill_chunk, n_blocks,
                      host_cache_blocks)
        _check_speculative(draft_stages, draft_cfg, spec_k)
        _reject_unported(lint, mesh, cfg)
        _check_ported(cfg, "InferenceEngine")
        self.device = resolve_device(device)
        if adapters is not None and adapters.n_rows != n_slots + 1:
            raise ValueError(
                f"AdapterStore has {adapters.n_rows} bank rows but this "
                f"engine needs n_slots + 1 = {n_slots + 1} (base row + one "
                f"per slot — the never-refuse sizing)")
        if adapters is not None and adapters.device.type != self.device.type:
            raise ValueError(
                f"the AdapterStore's bank lives on {adapters.device}, the "
                f"engine on {self.device}")
        self._adapters = adapters
        adp = adapters is not None
        self.cfg = cfg
        self.kv_layout = kv_layout
        self.attn_kernel = attn_kernel
        self.prefill_chunk = prefill_chunk
        self.params = (params if params is not None
                       else [s.params for s in stages])
        self._check_on_device(self.params)
        self.max_len = int(max_len if max_len is not None else cfg.seq_len)
        n_layers = sum(len(p["blocks"]) for p in self.params)
        self._n_layers = n_layers
        # lazy (ServeSpec, predict_fn) of the per-tick KV-drift check
        self._predict = None
        head_dim = cfg.d_model // cfg.n_heads
        if kv_layout == "paged":
            self.pool = PagedKVPool(n_layers, n_slots, cfg.n_heads,
                                    self.max_len, head_dim, cache_dtype,
                                    block_size=block_size,
                                    n_blocks=n_blocks,
                                    host_cache_blocks=host_cache_blocks,
                                    prefetch_ticks=prefetch_ticks,
                                    device=self.device)
            self._chunk_prefill = make_paged_prefill_chunk(
                stages, cfg, self.max_len, block_size, cache_dtype,
                adapters=adp, device=self.device)
            self._decode = make_paged_decode_step(
                stages, cfg, self.max_len, block_size, cache_dtype,
                kernel=attn_kernel, adapters=adp, device=self.device)
            self._copy_block = make_paged_block_copy()
        else:
            self.pool = KVCachePool(n_layers, n_slots, cfg.n_heads,
                                    self.max_len, head_dim, cache_dtype,
                                    device=self.device)
            self._prefill = make_slot_prefill(stages, cfg, self.max_len,
                                              cache_dtype, adapters=adp,
                                              device=self.device)
            self._decode = make_slot_decode_step(
                stages, cfg, self.max_len, cache_dtype, adapters=adp,
                device=self.device)
        self.spec_k = int(spec_k)
        self.speculative = draft_stages is not None
        self.draft_cfg = draft_cfg
        if self.speculative:
            if draft_cfg.vocab != cfg.vocab:
                raise ValueError(
                    f"draft vocab {draft_cfg.vocab} != target vocab "
                    f"{cfg.vocab} — the draft proposes target token ids")
            # the draft pool is dense slot rows (no per-row scales): a
            # quantised target dtype gives the draft an f32 pool
            self._draft_cache_dtype = (None if _is_quantized_dtype(
                cache_dtype) else cache_dtype)
            self._draft_params = [s.params for s in draft_stages]
            self._check_on_device(self._draft_params)
            self._draft_prefill = make_slot_prefill(
                draft_stages, draft_cfg, self.max_len,
                self._draft_cache_dtype, device=self.device)
            self._spec_fused = (
                make_paged_spec_tick(
                    stages, cfg, draft_stages, draft_cfg, self.max_len,
                    block_size, spec_k, cache_dtype, kernel=attn_kernel,
                    adapters=adp, device=self.device)
                if kv_layout == "paged" else
                make_slot_spec_tick(
                    stages, cfg, draft_stages, draft_cfg, self.max_len,
                    spec_k, cache_dtype, adapters=adp, device=self.device))
            self._init_draft_pool(n_slots)
        if scheduler is None:
            scheduler = FCFSScheduler(self.pool)
        elif not isinstance(scheduler, FCFSScheduler) and callable(scheduler):
            # a scheduler class/factory: the pool is engine-built
            scheduler = scheduler(self.pool)
        self.scheduler = scheduler
        self.scheduler.attach(self)
        self.metrics = metrics
        self._clock = clock
        # request tracing and the tick flight recorder: None by default,
        # one `is None` test per site on the hot path
        self.trace = trace
        self.flight = flight
        # the most recent clock reading (stamps events that read no clock)
        self._now = 0.0
        self._next_rid = 0
        # busy ticks so far: the serve.tick fault site's step
        self._tick_count = 0
        self.requests: dict[int, Request] = {}
        # rids admitted but not yet fully prefilled, in admission order
        self._prefilling: collections.deque[int] = collections.deque()
        # per-request last-emit timestamps for TPOT accounting
        self._last_emit: dict[int, float] = {}
        # rids whose current prefetch-gate episode already traced a
        # ``gate`` row (cleared on boarding)
        self._gated: set[int] = set()

    def _check_on_device(self, params) -> None:
        embed = _merged_stage_trees(params)[0]
        if embed is None or embed["tok"].device.type != self.device.type:
            raise ValueError(
                f"the params must live on the engine's device "
                f"{self.device}, got "
                f"{None if embed is None else embed['tok'].device}")

    def _init_draft_pool(self, n_slots: int) -> None:
        """The draft model's K/V buffers: always the dense slot layout (one
        ``max_len`` row per slot), whatever the target's layout — the
        draft is small by design, and a rejected tail's rows are
        overwritten before they can be attended."""
        dcfg = self.draft_cfg
        dL = sum(len(p["blocks"]) for p in self._draft_params)
        shape = (dL, n_slots, dcfg.n_heads, self.max_len,
                 dcfg.d_model // dcfg.n_heads)
        cd = _cache_dtype(self._draft_cache_dtype)
        self._dkc = torch.zeros(shape, dtype=cd, device=self.device)
        self._dvc = torch.zeros(shape, dtype=cd, device=self.device)

    # -- public API --------------------------------------------------------

    @property
    def busy(self) -> bool:
        return bool(self.scheduler.queue_depth or self.pool.n_active)

    def submit(self, prompt, max_new_tokens: int, temperature: float = 0.0,
               top_k: int | None = None, top_p: float | None = None,
               eos_id: int | None = None, seed: int | None = None,
               on_token=None, arrival_time: float | None = None,
               cls: str | None = None, priority: int = 0,
               ttft_deadline_s: float | None = None,
               deadline_s: float | None = None,
               adapter: str | None = None) -> Request:
        """Enqueue one request; returns its live handle immediately.

        ``arrival_time`` backdates ``submit_time`` to when the request
        arrived (the simulator's Poisson stamp), so TTFT absorbs queue
        wait accrued while the engine was inside a tick.
        ``ttft_deadline_s``/``deadline_s`` are stored on the handle; the
        serve supervisor enforces them."""
        # fault-injection site: a crash while the request is being
        # accepted (the supervisor journaled it; recovery re-admits it)
        maybe_fire("serve.admit", step=self._next_rid)
        prompt = np.asarray(prompt, np.int32)
        validate_request(prompt, max_new_tokens, temperature, top_k, top_p,
                         self.cfg.vocab, self.max_len)
        for name, v in (("ttft_deadline_s", ttft_deadline_s),
                        ("deadline_s", deadline_s)):
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be > 0, got {v}")
        self._check_adapter(adapter)
        rid = self._next_rid
        self._next_rid += 1
        seed = rid if seed is None else seed
        r = Request(rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    eos_id=eos_id, seed=seed, on_token=on_token,
                    cls=cls, priority=priority,
                    ttft_deadline_s=ttft_deadline_s, deadline_s=deadline_s,
                    adapter=adapter)
        if self._adapters is not None:
            # the version-qualified prefix namespace (refreshed at the
            # admission gate: the probe and the decode must agree on the
            # adapter version, or a hot-swap could reuse stale K/V)
            r._prefix_ns = self._adapters.namespace_of(adapter)
        # the request's own key stream: the key a solo make_cached_decoder
        # call would be handed, so the streams align
        r.key_data = key_data(seed)
        if self.speculative:
            r.draft_key_data = draft_key_data(seed)
        r.submit_time = (self._clock() if arrival_time is None
                         else arrival_time)
        self._now = max(self._now, r.submit_time)
        self.requests[rid] = r
        self.scheduler.enqueue(r)
        if self.metrics is not None:
            self.metrics.on_submit()
        if self.trace is not None:
            self.trace.on_submit(r, r.submit_time)
        return r

    # -- adapter plumbing --------------------------------------------------

    def register_adapter(self, name: str, weights: dict) -> None:
        """Add or hot-swap a named LoRA adapter (host side; its bank row
        uploads at the next admission that needs it). The same call as
        ``ServeSupervisor.register_adapter`` and
        ``ServeFleet.register_adapter``."""
        if self._adapters is None:
            raise ValueError("this engine was built without an "
                             "AdapterStore — pass adapters= at "
                             "construction")
        self._adapters.register(name, weights)

    def _check_adapter(self, adapter: str | None) -> None:
        if adapter is None:
            return
        if self._adapters is None:
            raise ValueError(
                f"request names adapter {adapter!r} but this engine was "
                f"built without an AdapterStore — pass adapters= at "
                f"construction")
        if not self._adapters.is_registered(adapter):
            raise KeyError(
                f"adapter {adapter!r} is not registered "
                f"(known: {list(self._adapters.names())})")

    def _adapter_board(self, r: Request) -> bool:
        """The scheduler's admission gate: pin the request's bank row
        (uploading it at this tick boundary if needed) and take its ref.
        Never refuses: the bank has one more row than the pool has
        slots, and admission already holds a free slot."""
        if r.adapter is None or self._adapters is None:
            r._adapter_row = 0
            return True
        # a hot-swap between submit and boarding changes the version this
        # admission pins: refresh the namespace (and drop the stale probe
        # memo) before bind_seq probes the registry
        ns = self._adapters.namespace_of(r.adapter)
        if r._prefix_ns != ns:
            r._prefix_ns = ns
            r._prefix_probe = None
        r._adapter_row = self._adapters.retain(r.adapter)
        return True

    def _adapter_release(self, r: Request) -> None:
        if r._adapter_row and self._adapters is not None:
            self._adapters.release(r._adapter_row)
        r._adapter_row = 0

    def _adapter_inputs(self, active: list[int]) -> np.ndarray:
        """Per-slot bank rows for a batched tick (inactive slots gather
        the zero base row, whose delta is exactly 0)."""
        aids = np.zeros(self.pool.n_slots, np.int64)
        for s in active:
            aids[s] = self.requests[self.pool.occupant(s)]._adapter_row
        return aids

    def _bank_args(self, aids) -> tuple:
        """The trailing ``(bank, aids)`` program arguments, empty without
        a store."""
        if self._adapters is None:
            return ()
        return (self._adapters.bank, aids)

    def step(self) -> int:
        """One tick; returns the number of tokens emitted. A true no-op
        returning 0 when idle (idle ticks touch no metrics)."""
        if not self.busy:
            return 0
        # fault-injection site: slow-tick stalls the tick, engine-crash /
        # wedged-device / host-kill raise (no-op without a plan)
        maybe_fire("serve.tick", step=self._tick_count)
        self._tick_count += 1
        if self.kv_layout == "dense":
            emitted = self._admit_dense()
            # the occupancy the batched decode runs at, sampled before
            # same-tick retirement
            decode_active = self.pool.n_active
            emitted += (self._spec_tick(self.pool.active_slots())
                        if self.speculative else self._decode_tick_dense())
        else:
            # host-tier upload progress first: blocks completing this tick
            # register before admission probes the registry, so a request
            # blocked on its own prefetch boards this very tick
            self.pool.advance_transfers()
            if self.trace is not None and self.pool._inflight:
                # one ``gate`` row per episode for a queued request held
                # back by its own in-flight upload (attribution's
                # queue-vs-prefetch split), stamped with the latest read
                for r in self.scheduler.queue:
                    if (r.rid not in self._gated
                            and self.pool.prefetch_blocked(r)):
                        self._gated.add(r.rid)
                        self.trace.on_gate(r, self._now)
            self._admit_paged()
            emitted = self._prefill_tick()
            decoding = self._decoding_slots()
            decode_active = len(decoding)
            emitted += (self._spec_tick(decoding) if self.speculative
                        else self._decode_tick_paged(decoding))
        if self.metrics is not None:
            live, predicted = self.kv_drift()
            self.metrics.on_tick(
                self.scheduler.queue_depth, self.pool.n_active,
                self.pool.n_slots, decode_active=decode_active,
                block_stats=(self.pool.stats()
                             if self.kv_layout == "paged" else None),
                tp=1, spec_k=self.spec_k,
                kv_predicted=predicted, kv_drift=live - predicted,
                attn_kernel=self.attn_kernel,
                adapter_stats=(self._adapters.stats()
                               if self._adapters is not None else None))
        if self.flight is not None:
            self.flight.snap(self, self._tick_count, emitted)
        return emitted

    def kv_drift(self) -> tuple[int, int]:
        """``(live, predicted)`` resident K/V bytes: the pool's
        ``serve_kv_bytes_resident`` gauge next to the byte model's
        ``predict_kv_bytes_resident`` over the live sequences'
        written-row counts (``analysis/programs.py``), the static model
        checked every tick. ``live - predicted`` is the drift gauge:
        exactly 0 without prefix sharing, <= 0 with it (sharing only
        shrinks the truth), > 0 only if the pool leaks blocks the model
        says no live sequence can be pinning. Reads no clock."""
        if self._predict is None:
            from simple_distributed_machine_learning_tpu_torch.analysis.programs import (  # noqa: E501
                engine_spec,
                predict_kv_bytes_resident,
            )
            # the one engine->spec mapping the registry uses too
            self._predict = (engine_spec(self), predict_kv_bytes_resident)
        sspec, predict = self._predict
        rows = []
        if self.kv_layout == "paged":
            for s in self.pool.active_slots():
                r = self.requests[self.pool.occupant(s)]
                n = (r.prefill_pos if r.prefill_pos is not None
                     else int(self.pool.positions[s]))
                if n > 0:
                    rows.append(n)
        return (self.pool.bytes_resident(),
                predict(sspec, rows, n_layers=self._n_layers))

    def preempt(self, rid: int) -> None:
        """Evict an ACTIVE request from its slot: slot and blocks free now,
        the request returns to the queue front with its tokens intact and
        later re-prefills ``resume_seq`` with its key stream untouched."""
        r = self.requests[rid]
        if r.state != ACTIVE or r.slot is None:
            raise ValueError(
                f"request {rid} is not active (state {r.state!r}, slot "
                f"{r.slot!r}) — only active requests preempt")
        if rid in self._prefilling:
            self._prefilling.remove(rid)
        self.pool.unbind_seq(r.slot)
        self.pool.release(r.slot)
        self._adapter_release(r)   # re-acquired (maybe a new row) on boarding
        r.slot = None
        r.prefill_pos = None
        r.state = QUEUED
        r.n_preempted += 1
        self.scheduler.queue.appendleft(r)
        if self.metrics is not None:
            self.metrics.on_preempt(r.cls)
        if self.trace is not None:
            self.trace.on_preempt(r, self._now)

    def cancel(self, rid: int, reason: str = "cancelled") -> Request:
        """Remove a live request now: a queued one leaves the queue, an
        active one frees its slot and blocks (the full budget refund);
        the handle lands in ``SHED`` with ``finish_reason = reason``."""
        r = self.requests[rid]
        if r.state not in (QUEUED, ACTIVE):
            raise ValueError(
                f"request {rid} is {r.state!r} — only queued/active "
                f"requests cancel")
        if r.state == ACTIVE:
            if rid in self._prefilling:
                self._prefilling.remove(rid)
            self.pool.unbind_seq(r.slot)
            self.pool.release(r.slot)
            self._adapter_release(r)
            r.slot = None
            r.prefill_pos = None
        else:
            # identity scan: Request's dataclass __eq__ compares arrays
            for i, q in enumerate(self.scheduler.queue):
                if q is r:
                    del self.scheduler.queue[i]
                    break
            else:               # pragma: no cover - state-machine guard
                raise RuntimeError(
                    f"queued request {rid} missing from the scheduler "
                    f"queue — lifecycle bookkeeping corrupted")
        r.state = SHED
        r.finish_reason = reason
        r.done_time = self._now = self._clock()
        self._last_emit.pop(rid, None)
        if self.trace is not None:
            self.trace.on_shed(r, r.done_time, reason)
        return r

    def restore(self, request: Request) -> Request:
        """Re-admit a journal-recovered request into THIS engine (the
        serve supervisor's rebuild path): the handle keeps its rid,
        emitted tokens and live key stream and re-enters the queue; like
        a preemption victim it re-prefills ``resume_seq`` on boarding
        with the sample and key advance discarded and reseats on its
        stored newest token, so the continued decode equals the
        uninterrupted run's. Callers re-admit in rid order to keep FCFS
        arrival order across the restart."""
        if request.rid in self.requests:
            raise ValueError(f"request {request.rid} already lives in this "
                             f"engine — restore() is for rebuilt engines")
        validate_request(request.prompt, request.max_new_tokens,
                         request.temperature, request.top_k, request.top_p,
                         self.cfg.vocab, self.max_len)
        self._check_adapter(request.adapter)
        request.state = QUEUED
        request.slot = None
        request.prefill_pos = None
        request._adapter_row = 0   # pinned at boarding on THIS engine
        request._prefix_ns = (None if self._adapters is None
                              else self._adapters.namespace_of(
                                  request.adapter))
        request._prefix_probe = None   # probed against THIS pool's registry
        if request.key_data is None:
            # never emitted a token: the stream starts where submit's would
            request.key_data = key_data(request.seed)
        if self.speculative and request.draft_key_data is None:
            request.draft_key_data = draft_key_data(request.seed)
        self.requests[request.rid] = request
        self._next_rid = max(self._next_rid, request.rid + 1)
        self.scheduler.enqueue(request)
        if self.trace is not None:
            self.trace.on_readmit(request, self._now)
        return request

    def drain(self, max_ticks: int | None = None) -> list[Request]:
        """Tick until idle (or ``max_ticks``, then :class:`DrainTimeout`
        carrying the unfinished handles); returns the finished requests."""
        ticks = 0
        while self.busy:
            if max_ticks is not None and ticks >= max_ticks:
                raise DrainTimeout(max_ticks, [
                    r for r in self.requests.values()
                    if r.state in (QUEUED, ACTIVE)])
            self.step()
            ticks += 1
        return [r for r in self.requests.values() if r.state == DONE]

    # -- dense tick internals ---------------------------------------------

    def _admit_dense(self) -> int:
        """Board waiting requests, each with a whole-sequence prefill into
        its slot row (and the draft's, when speculative); the prefill
        samples the first token (TTFT endpoint) unless the request is
        resuming."""
        emitted = 0
        for r in self.scheduler.admit():
            seq = r.resume_seq       # == r.prompt unless resuming
            t0 = int(seq.shape[0])
            kc, vc, tok, kd = self._prefill(
                self.params, self.pool.kc, self.pool.vc, seq[None, :],
                r.slot, r.key_data, r.temperature,
                r.top_k if r.top_k is not None else _NO_TOP_K,
                r.top_p if r.top_p is not None else _NO_TOP_P,
                *self._bank_args(r._adapter_row))
            self.pool.kc, self.pool.vc = kc, vc
            if self.speculative:
                self._draft_prefill_slot(r, seq)
            if r.tokens:
                # resuming: the prefill only rebuilt K/V; its sample and
                # key advance are discarded and decode restarts from the
                # stored newest token. The TPOT base resets to now: the
                # stall is preemption wait, not decode cadence
                self.pool.seat(r.slot, t0, r.tokens[-1])
                now = self._now = self._clock()
                self._last_emit[r.rid] = now
                if self.trace is not None:
                    self.trace.on_admit(r, now, r.slot)
                    self.trace.on_resume(r, now)
                continue
            tok = int(tok)                       # host sync: TTFT endpoint
            r.key_data = kd.cpu().numpy().astype(np.uint32)
            now = self._now = self._clock()
            r.first_token_time = now
            self._last_emit[r.rid] = now
            r.emit(tok)
            emitted += 1
            if self.metrics is not None:
                self.metrics.on_first_token(r.ttft_s, cls=r.cls)
            if self.trace is not None:
                # the whole-prompt prefill: boarding and the TTFT endpoint
                # share this one clock read
                self.trace.on_admit(r, now, r.slot)
                self.trace.on_first_token(r, now)
            reason = r.finished_by(tok)
            if reason is not None:
                self._finish(r, reason, now)
            else:
                self.pool.seat(r.slot, t0, tok)
        return emitted

    def _decode_tick_dense(self) -> int:
        active = self.pool.active_slots()
        if not active:
            return 0
        kd, temps, top_ks, top_ps = self._sampling_inputs(active)
        kc, vc, toks, kd2 = self._decode(
            self.params, self.pool.kc, self.pool.vc,
            self.pool.last_token.copy(), self.pool.positions.copy(),
            kd, temps, top_ks, top_ps,
            *self._bank_args(self._adapter_inputs(active)))
        self.pool.kc, self.pool.vc = kc, vc
        return self._emit_decoded(active, toks, kd2)

    # -- paged tick internals ---------------------------------------------

    def _admit_paged(self) -> None:
        """Board waiting requests (the scheduler's admit loop already bound
        each to its slot and parked its first position to compute in
        ``r.prefill_pos``); no model work here."""
        for r in self.scheduler.admit():
            self._prefilling.append(r.rid)
            self._gated.discard(r.rid)
            if self.trace is not None:
                # boarding reads no clock: stamped with the most recent
                # read (at most a tick stale)
                self.trace.on_admit(r, self._now, r.slot)

    def _prefill_tick(self) -> int:
        """At most ONE prefill chunk per tick, of the oldest prefilling
        request; the final chunk samples its first token (TTFT endpoint)
        and registers its prompt blocks for prefix sharing."""
        if not self._prefilling:
            return 0
        r = self.requests[self._prefilling[0]]
        seq = r.resume_seq           # == r.prompt unless resuming preempted
        plen = int(seq.shape[0])
        p0 = r.prefill_pos
        c = (plen - p0 if self.prefill_chunk is None
             else min(self.prefill_chunk, plen - p0))
        t_start = self._now = self._clock()
        self._ensure_writable_range(r.slot, p0, c)
        kc, vc, tok, kd = self._chunk_prefill(
            self.params, self.pool.kc, self.pool.vc,
            seq[None, p0:p0 + c], p0, self.pool.device_table(r.slot),
            r.key_data, r.temperature,
            r.top_k if r.top_k is not None else _NO_TOP_K,
            r.top_p if r.top_p is not None else _NO_TOP_P,
            *self._bank_args(r._adapter_row))
        self.pool.kc, self.pool.vc = kc, vc
        tok = int(tok)                 # host sync: honest chunk timing
        now = self._now = self._clock()
        if self.metrics is not None:
            self.metrics.on_prefill_chunk((now - t_start) * 1e3)
        if self.trace is not None:
            self.trace.on_prefill_chunk(r, t_start, now, p0, c)
        if p0 + c < plen:
            # mid-prompt chunk: sampled token and key are discarded — the
            # key stream advances once, at the final chunk
            r.prefill_pos = p0 + c
            return 0
        self._prefilling.popleft()
        r.prefill_pos = None
        # publish before any same-tick retirement, so even a 1-token
        # request leaves its prefix reusable
        self.pool.register_prefix(r.slot, seq)
        if self.speculative:
            # the draft prefills the whole sequence at the final target
            # chunk: its pool must cover every prompt position before the
            # first propose, and the draft is cheap by design
            self._draft_prefill_slot(r, seq)
        if r.tokens:
            # resuming after preemption: the chunk only rebuilt K/V; its
            # sample and key are discarded, decode restarts from the stored
            # newest token
            self.pool.seat(r.slot, plen, r.tokens[-1])
            self._last_emit[r.rid] = now
            if self.trace is not None:
                self.trace.on_resume(r, now)
            return 0
        r.key_data = kd.cpu().numpy().astype(np.uint32)
        r.first_token_time = now
        self._last_emit[r.rid] = now
        r.emit(tok)
        if self.metrics is not None:
            self.metrics.on_first_token(r.ttft_s, cls=r.cls)
        if self.trace is not None:
            self.trace.on_first_token(r, now)
        reason = r.finished_by(tok)
        if reason is not None:
            self._finish(r, reason, now)
        else:
            self.pool.seat(r.slot, plen, tok)
        return 1

    def _decoding_slots(self) -> list[int]:
        """Occupied slots whose request finished prefilling."""
        return [s for s in self.pool.active_slots()
                if self.requests[self.pool.occupant(s)].prefill_pos is None]

    def _decode_tick_paged(self, active: list[int]) -> int:
        if not active:
            return 0
        S = self.pool.n_slots
        kd, temps, top_ks, top_ps = self._sampling_inputs(active)
        # non-decoding slots: position 0 + all-trash table, so their
        # garbage write lands in the trash block no table references
        pos = np.zeros(S, np.int32)
        toks = np.zeros(S, np.int32)
        tables = np.full((S, self.pool.blocks_per_seq), PagedKVPool.TRASH,
                         np.int32)
        for s in active:
            # on-demand block allocation as the position advances (and
            # copy-on-write if the write block is still shared)
            self._ensure_writable_range(s, int(self.pool.positions[s]), 1)
            tables[s] = self.pool.device_table(s)
            pos[s] = self.pool.positions[s]
            toks[s] = self.pool.last_token[s]
        kc, vc, toks2, kd2 = self._decode(
            self.params, self.pool.kc, self.pool.vc,
            toks, pos, tables, kd, temps, top_ks, top_ps,
            *self._bank_args(self._adapter_inputs(active)))
        self.pool.kc, self.pool.vc = kc, vc
        return self._emit_decoded(active, toks2, kd2)

    def _ensure_writable_range(self, slot: int, p0: int, n: int) -> None:
        """Allocate / copy-on-write every block covering positions
        ``[p0, p0+n)`` of ``slot``; runs the device copy the pool asks
        for."""
        for p in range(p0, p0 + n):
            cp = self.pool.ensure_writable(slot, p)
            if cp is not None:
                src, dst = cp
                self.pool.kc, self.pool.vc = self._copy_block(
                    self.pool.kc, self.pool.vc, dst, src)

    # -- speculative tick internals ----------------------------------------

    def _draft_prefill_slot(self, r: Request, seq: np.ndarray) -> None:
        """Write the draft model's K/V for ``seq`` into the draft pool's
        slot row. Greedy arguments and a dummy key: the sampled token and
        the key are discarded, so neither of the request's streams moves."""
        self._dkc, self._dvc, _, _ = self._draft_prefill(
            self._draft_params, self._dkc, self._dvc, seq[None, :], r.slot,
            np.zeros(2, np.uint32), 0.0, _NO_TOP_K, _NO_TOP_P)

    def _spec_tick(self, active: list[int]) -> int:
        """One speculative tick over the decoding slots: the draft's
        ``spec_k`` propose steps, then the batched target verify, emitting
        1..``spec_k`` tokens per slot. The proposals stay on the device;
        the host syncs once, at the end. The dense layout passes no block
        tables."""
        if not active:
            return 0
        S, K = self.pool.n_slots, self.spec_k
        kd, temps, top_ks, top_ps = self._sampling_inputs(active)
        toks = np.zeros(S, np.int32)
        pos = np.zeros(S, np.int32)
        valid = np.zeros(S, np.int32)
        dkd = np.zeros((S, 2), np.uint32)
        for s in active:
            r = self.requests[self.pool.occupant(s)]
            toks[s] = self.pool.last_token[s]
            pos[s] = self.pool.positions[s]
            # never speculate past the remaining token budget, so every
            # real K/V write stays inside the slot's reservation
            # (non-decoding slots keep valid 0: all their writes go to
            # the trash block or row)
            valid[s] = min(K, r.max_new_tokens - len(r.tokens))
            dkd[s] = r.draft_key_data
        tables = ()
        if self.kv_layout == "paged":
            tables = np.full((S, self.pool.blocks_per_seq),
                             PagedKVPool.TRASH, np.int32)
            for s in active:
                self._ensure_writable_range(s, int(pos[s]), int(valid[s]))
                tables[s] = self.pool.device_table(s)
            tables = (tables,)
        (self._dkc, self._dvc, self.pool.kc, self.pool.vc, otoks, nacc, kd2,
         dkd2) = self._spec_fused(
            self._draft_params, self._dkc, self._dvc, self.params,
            self.pool.kc, self.pool.vc, toks, pos, valid, *tables, dkd, kd,
            temps, top_ks, top_ps,
            # adapters ride the verify side only: the draft proposes as the
            # base model, and the adapted verify rows decide every emission
            *self._bank_args(self._adapter_inputs(active)))
        return self._emit_spec(active, otoks, nacc, kd2, dkd2, valid)

    def _emit_spec(self, active: list[int], otoks, nacc, kd2, dkd2,
                   valid) -> int:
        """Host tail of a speculative tick: emit each slot's accepted
        tokens in order (truncated at EOS — the later positions' K/V is
        written but overwritten before it can be attended), advance its
        position by the count emitted, and feed the spec counters."""
        otoks = otoks.cpu().numpy()              # host sync: tick endpoint
        nacc = nacc.cpu().numpy()
        kd2 = kd2.cpu().numpy().astype(np.uint32)
        dkd2 = dkd2.cpu().numpy().astype(np.uint32)
        now = self._now = self._clock()
        emitted = proposed = accepted = 0
        for s in active:
            r = self.requests[self.pool.occupant(s)]
            r.key_data = kd2[s]
            r.draft_key_data = dkd2[s]
            n_emit = 0
            finish = None
            for tok in otoks[s, :int(nacc[s])]:  # >= 1: valid[s] >= 1
                n_emit += 1
                r.emit(int(tok))
                finish = r.finished_by(int(tok))
                if finish is not None:
                    break
            dt = now - self._last_emit[r.rid]
            if self.metrics is not None:
                # n_emit tokens in one dt window: spread the interval so
                # the TPOT mean stays the true cadence
                for _ in range(n_emit):
                    self.metrics.on_token(dt / n_emit, cls=r.cls)
            self._last_emit[r.rid] = now
            emitted += n_emit
            slot_proposed = max(int(valid[s]) - 1, 0)
            slot_accepted = max(n_emit - 1, 0)
            proposed += slot_proposed
            accepted += slot_accepted
            if self.trace is not None:
                self.trace.on_tick_tokens(r, now, n_emit,
                                          proposed=slot_proposed,
                                          accepted=slot_accepted)
            if finish is not None:
                self._finish(r, finish, now)
            else:
                self.pool.positions[s] += n_emit
                self.pool.last_token[s] = r.tokens[-1]
        if self.metrics is not None and proposed:
            self.metrics.on_spec(proposed, accepted)
        return emitted

    # -- shared tick tails -------------------------------------------------

    def _sampling_inputs(self, active: list[int]):
        S = self.pool.n_slots
        kd = np.zeros((S, 2), np.uint32)
        temps = np.zeros(S, np.float32)
        top_ks = np.zeros(S, np.int32)
        top_ps = np.full(S, _NO_TOP_P, np.float32)
        for s in active:
            r = self.requests[self.pool.occupant(s)]
            kd[s] = r.key_data
            temps[s] = r.temperature
            top_ks[s] = r.top_k if r.top_k is not None else _NO_TOP_K
            top_ps[s] = r.top_p if r.top_p is not None else _NO_TOP_P
        return kd, temps, top_ks, top_ps

    def _emit_decoded(self, active: list[int], toks, kd2) -> int:
        toks = toks.cpu().numpy()                # host sync: tick endpoint
        kd2 = kd2.cpu().numpy().astype(np.uint32)
        now = self._now = self._clock()
        emitted = 0
        for s in active:
            r = self.requests[self.pool.occupant(s)]
            tok = int(toks[s])
            r.key_data = kd2[s]
            r.emit(tok)
            emitted += 1
            if self.metrics is not None:
                self.metrics.on_token(now - self._last_emit[r.rid],
                                      cls=r.cls)
            if self.trace is not None:
                self.trace.on_tick_tokens(r, now, 1)
            self._last_emit[r.rid] = now
            reason = r.finished_by(tok)
            if reason is not None:
                self._finish(r, reason, now)
            else:
                self.pool.advance(s, tok)
        return emitted

    def _finish(self, r: Request, reason: str, now: float) -> None:
        r.done_time = now
        self._last_emit.pop(r.rid, None)
        if self.trace is not None:
            self.trace.on_finish(r, now, reason)
        if r.state == ACTIVE:
            # unbinds the sequence (decref table blocks, return the unused
            # reservation) before the slot frees
            self.scheduler.retire(r, reason)
        self._adapter_release(r)
        if self.metrics is not None:
            self.metrics.on_complete(cls=r.cls, adapter=r.adapter)
