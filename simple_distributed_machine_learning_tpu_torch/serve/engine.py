"""The continuous-batching inference engine: submit / step / drain.

Port of ``serve/engine.py`` for the paged layout on one device.
:class:`InferenceEngine` serves a GPT over the paged KV pool
(``serve/slots.py``) with the FCFS scheduler:

- ``submit(prompt, ...) -> Request`` enqueues one sequence with its own
  sampling params and seeded key stream, and returns the live handle;
- ``step()`` is one tick: admit (board slots, match shared prefixes,
  reserve blocks) -> at most ONE prefill chunk of the oldest prefilling
  request -> ONE batched decode step over every decoding slot -> retire;
- ``drain()`` ticks until queue and slots are empty.

Device state is the pool's K/V tensors, updated in place by the decode
programs; positions, last tokens, block tables, key data and the request
lifecycle are host-side numpy assembled into each tick's inputs.

Correctness anchor: a request's tokens equal its solo
``make_cached_decoder`` decode with the same seed — admission order,
co-residents, paged blocks, shared prefixes and chunk boundaries cannot
change anyone's output.

The JAX engine's other knobs keep their place in the signature and raise
``NotImplementedError`` naming the ROADMAP item that ports them: the
dense slot layout, speculative decoding, tensor parallelism, adapters,
the host tier, the lint preflight, tracing and the flight recorder.
"""

from __future__ import annotations

import collections
import time

import numpy as np

from simple_distributed_machine_learning_tpu_torch import _roadmap
from simple_distributed_machine_learning_tpu_torch._device import (
    resolve_device,
)
from simple_distributed_machine_learning_tpu_torch.models.gpt import (
    _NO_TOP_K,
    _NO_TOP_P,
    _check_ported,
    _merged_stage_trees,
    make_paged_block_copy,
    make_paged_decode_step,
    make_paged_prefill_chunk,
)
from simple_distributed_machine_learning_tpu_torch.ops.random import key_data
from simple_distributed_machine_learning_tpu_torch.serve.metrics import (
    ServeMetrics,
)
from simple_distributed_machine_learning_tpu_torch.serve.request import (
    ACTIVE,
    DONE,
    QUEUED,
    SHED,
    Request,
    validate_request,
)
from simple_distributed_machine_learning_tpu_torch.serve.scheduler import (
    FCFSScheduler,
)
from simple_distributed_machine_learning_tpu_torch.serve.slots import (
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


def _reject_unported(kv_layout, host_cache_blocks, prefetch_ticks, lint,
                     mesh, cfg, draft_stages, draft_cfg, spec_k, trace,
                     flight, adapters) -> None:
    if kv_layout == "dense":
        raise _roadmap.not_ported("kv_layout='dense'",
                                  _roadmap.SERVE_EXTENSIONS)
    if draft_stages is not None or draft_cfg is not None or spec_k:
        raise _roadmap.not_ported("speculative decoding (draft_stages/"
                                  "spec_k)", _roadmap.SERVE_EXTENSIONS)
    if mesh is not None or cfg.n_tensor_parallel > 1:
        raise _roadmap.not_ported("tensor-parallel serving (mesh/"
                                  "n_tensor_parallel > 1)",
                                  _roadmap.SERVE_EXTENSIONS)
    if adapters is not None:
        raise _roadmap.not_ported("LoRA adapters",
                                  _roadmap.SERVE_EXTENSIONS)
    if host_cache_blocks or prefetch_ticks != 1:
        raise _roadmap.not_ported("the host offload tier "
                                  "(host_cache_blocks/prefetch_ticks)",
                                  _roadmap.SERVE_EXTENSIONS)
    if lint:
        raise _roadmap.not_ported("the serve-program lint preflight",
                                  _roadmap.ANALYSIS)
    if trace is not None or flight is not None:
        raise _roadmap.not_ported("request tracing and the flight recorder",
                                  _roadmap.SERVE_ROBUSTNESS)


class InferenceEngine:
    """Continuous-batching serving over a dense single-device GPT build.

    ``stages``/``cfg``: a ``make_gpt_stages`` build; ``params`` overrides
    the stages' weights (e.g. ``interop.params_from_numpy`` of a JAX
    build). ``max_len`` caps each slot's prompt + generation budget
    (default ``cfg.seq_len``); ``cache_dtype`` is the pool's storage dtype
    (None/f32, bf16, int8, ``float8_e4m3fn``, ``float8_e5m2`` — the narrow
    ones store per-row f32 scales beside their blocks).

    ``block_size`` positions per K/V block; ``n_blocks`` pool capacity
    (default: ``n_slots * ceil(max_len / block_size)``); ``prefill_chunk``
    prompt positions per prefill chunk (None = the whole remaining prompt);
    ``attn_kernel`` the decode tick's attention: ``"dense"`` (gather, then
    dense masked softmax; the parity anchor) or ``"fused"`` (the CUDA
    paged-attention kernel, ``ops/paged_attention.py``).

    ``device`` (None = ``"cuda"``; raises without CUDA unless ``"cpu"``)
    holds the pool; the params must already live there. ``host_cache_blocks``
    and ``prefetch_ticks`` (the host tier's knobs) keep their JAX defaults
    only.
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
        if kv_layout not in ("paged", "dense"):
            raise ValueError(
                f"kv_layout must be 'paged' or 'dense', got {kv_layout!r}")
        if attn_kernel not in ("dense", "fused"):
            raise ValueError(
                f"attn_kernel must be 'dense' (gather-then-dense "
                f"attention) or 'fused' (the CUDA paged-attention "
                f"kernel), got {attn_kernel!r}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1 (or None for whole-prompt "
                f"chunks), got {prefill_chunk}")
        _reject_unported(kv_layout, host_cache_blocks, prefetch_ticks, lint,
                         mesh, cfg, draft_stages, draft_cfg, spec_k, trace,
                         flight, adapters)
        _check_ported(cfg, "InferenceEngine")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.attn_kernel = attn_kernel
        self.prefill_chunk = prefill_chunk
        self.params = (params if params is not None
                       else [s.params for s in stages])
        embed = _merged_stage_trees(self.params)[0]
        if embed is None or embed["tok"].device.type != self.device.type:
            raise ValueError(
                f"the params must live on the engine's device "
                f"{self.device}, got "
                f"{None if embed is None else embed['tok'].device}")
        self.max_len = int(max_len if max_len is not None else cfg.seq_len)
        n_layers = sum(len(p["blocks"]) for p in self.params)
        self.pool = PagedKVPool(n_layers, n_slots, cfg.n_heads, self.max_len,
                                cfg.d_model // cfg.n_heads, cache_dtype,
                                block_size=block_size, n_blocks=n_blocks,
                                device=self.device)
        self._chunk_prefill = make_paged_prefill_chunk(
            stages, cfg, self.max_len, block_size, cache_dtype,
            device=self.device)
        self._decode = make_paged_decode_step(
            stages, cfg, self.max_len, block_size, cache_dtype,
            kernel=attn_kernel, device=self.device)
        self._copy_block = make_paged_block_copy()
        if scheduler is None:
            scheduler = FCFSScheduler(self.pool)
        elif not isinstance(scheduler, FCFSScheduler) and callable(scheduler):
            # a scheduler class/factory: the pool is engine-built
            scheduler = scheduler(self.pool)
        self.scheduler = scheduler
        self.metrics = metrics
        self._clock = clock
        # the most recent clock reading (stamps events that read no clock)
        self._now = 0.0
        self._next_rid = 0
        self.requests: dict[int, Request] = {}
        # rids admitted but not yet fully prefilled, in admission order
        self._prefilling: collections.deque[int] = collections.deque()
        # per-request last-emit timestamps for TPOT accounting
        self._last_emit: dict[int, float] = {}

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
        wait accrued while the engine was inside a tick."""
        if adapter is not None:
            raise _roadmap.not_ported("LoRA adapters",
                                      _roadmap.SERVE_EXTENSIONS)
        prompt = np.asarray(prompt, np.int32)
        validate_request(prompt, max_new_tokens, temperature, top_k, top_p,
                         self.cfg.vocab, self.max_len)
        for name, v in (("ttft_deadline_s", ttft_deadline_s),
                        ("deadline_s", deadline_s)):
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be > 0, got {v}")
        rid = self._next_rid
        self._next_rid += 1
        seed = rid if seed is None else seed
        r = Request(rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    eos_id=eos_id, seed=seed, on_token=on_token,
                    cls=cls, priority=priority,
                    ttft_deadline_s=ttft_deadline_s, deadline_s=deadline_s)
        # the request's own key stream: the key a solo make_cached_decoder
        # call would be handed, so the streams align
        r.key_data = key_data(seed)
        r.submit_time = (self._clock() if arrival_time is None
                         else arrival_time)
        self._now = max(self._now, r.submit_time)
        self.requests[rid] = r
        self.scheduler.enqueue(r)
        if self.metrics is not None:
            self.metrics.on_submit()
        return r

    def step(self) -> int:
        """One tick; returns the number of tokens emitted. A true no-op
        returning 0 when idle (idle ticks touch no metrics)."""
        if not self.busy:
            return 0
        self._admit_paged()
        emitted = self._prefill_tick()
        decoding = self._decoding_slots()
        emitted += self._decode_tick_paged(decoding)
        if self.metrics is not None:
            self.metrics.on_tick(
                self.scheduler.queue_depth, self.pool.n_active,
                self.pool.n_slots, decode_active=len(decoding),
                block_stats=self.pool.stats())
        return emitted

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
        r.slot = None
        r.prefill_pos = None
        r.state = QUEUED
        r.n_preempted += 1
        self.scheduler.queue.appendleft(r)
        if self.metrics is not None:
            self.metrics.on_preempt(r.cls)

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
        return r

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

    # -- paged tick internals ---------------------------------------------

    def _admit_paged(self) -> None:
        """Board waiting requests (the scheduler's admit loop already bound
        each to its slot and parked its first position to compute in
        ``r.prefill_pos``); no model work here."""
        for r in self.scheduler.admit():
            self._prefilling.append(r.rid)

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
            r.top_p if r.top_p is not None else _NO_TOP_P)
        self.pool.kc, self.pool.vc = kc, vc
        tok = int(tok)                 # host sync: honest chunk timing
        now = self._now = self._clock()
        if self.metrics is not None:
            self.metrics.on_prefill_chunk((now - t_start) * 1e3)
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
        if r.tokens:
            # resuming after preemption: the chunk only rebuilt K/V; its
            # sample and key are discarded, decode restarts from the stored
            # newest token
            self.pool.seat(r.slot, plen, r.tokens[-1])
            self._last_emit[r.rid] = now
            return 0
        r.key_data = kd.cpu().numpy().astype(np.uint32)
        r.first_token_time = now
        self._last_emit[r.rid] = now
        r.emit(tok)
        if self.metrics is not None:
            self.metrics.on_first_token(r.ttft_s, cls=r.cls)
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
            toks, pos, tables, kd, temps, top_ks, top_ps)
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
        if r.state == ACTIVE:
            # unbinds the sequence (decref table blocks, return the unused
            # reservation) before the slot frees
            self.scheduler.retire(r, reason)
        if self.metrics is not None:
            self.metrics.on_complete(cls=r.cls)
