"""KV-cache pools: the serving engine's one device-resident state.

Port of ``serve/slots.py``, two layouts with one slot discipline:

- :class:`PagedKVPool` — a global pool of fixed-size K/V *blocks*
  ``[L, n_blocks+1, H, block_size, dh]`` on the device (physical block 0
  is the trash block non-decoding slots write into) and host bookkeeping:
  a per-slot block table mapping logical block ``j`` (positions
  ``[j*bs, (j+1)*bs)``) to a physical block, on-demand allocation as
  positions advance, and copy-on-write prefix sharing — requests with a
  common prompt prefix reference the same physical blocks until they
  diverge, and the first write into a shared block copies it first.
  Non-decoding slots' tick writes go to the trash block (a retired slot's
  stale table may point at blocks a live request reuses).
- :class:`KVCachePool` — the dense slot-row layout ``[L, n_slots, H,
  max_len, dh]``: a slot is one row of every layer's cache, reserved at
  ``max_len`` whatever the sequence uses. The serve supervisor's degraded
  rebuild falls back to it. An idle slot keeps its stale position and the
  batched decode keeps writing garbage there, which is safe: a row at
  index ``p`` becomes visible only at the tick that first reaches ``p``,
  and that tick overwrites it before attending.

With ``tp > 1`` (tensor-parallel serving) either layout holds one pool
per model coordinate this process owns (all ``tp`` in one process, ``tp
/ W`` in each of W processes over a mesh that spans them), each over its
``H/tp`` heads on its device — the JAX package's head-sharded placement —
and every byte figure is per shard: what one coordinate's pool pins,
the same in every process. The block tables, the block copies and the
eviction are shared: a block means the same rows in every shard's pool,
and the processes of one mesh keep equal tables by making the same
decisions each tick.

Invariants raise instead of corrupting a neighbour: no double occupancy,
no double allocation or free, no write into a block another sequence
still references.

Prefix keys carry the request's adapter NAMESPACE (``_ns_of``): K/V
computed under one LoRA adapter is wrong for every other, so tenants
never share blocks; base requests keep the empty namespace.

Host offload tier (paged, ``host_cache_blocks > 0``): LRU eviction of a
cached prefix block demotes its rows to host RAM instead of discarding
them, growing the effective prefix cache past device memory. The router
probes the host registry too (:meth:`PagedKVPool.host_prefix_len`), and
an affinity hit on a host-resident prefix starts an upload
(:meth:`PagedKVPool.prefetch`) that lands after ``prefetch_ticks`` engine
ticks (:meth:`PagedKVPool.advance_transfers`). Safety model, as the JAX
package's: the uploaded keys are registered — visible to admission's
prefix probe — only at completion; ``can_admit`` blocks a request whose
prefix an in-flight upload covers, so no request boards against
half-uploaded blocks; uploads draw only from free or reclaimable blocks,
never below the outstanding reservations; and a key registered on the
device while its upload flew wins (first writer), the upload's block
going back to the free list.

On the card a demoted block is copied, across every layer (``kc[:,
block]``, strided: the layer axis leads), into a pinned host tensor by a
blocking copy — the demotion runs inside a tick's allocation, before
that tick's writes reach the victim block, and the blocking copy waits
for every earlier write to it. An upload is a ``non_blocking`` copy from
the pinned tensor back into ``kc[:, block]``, in stream order before the
next program's reads. Host copies are torch CPU tensors (numpy has no
fp8 types); a quantised pool's narrow data and its f32 scale planes
travel together, and the round trip is bit-exact.
"""

from __future__ import annotations

import collections
import math

import numpy as np
import torch

from simple_distributed_machine_learning_tpu_torch._device import (
    resolve_device,
)


def _bind_seq_of(request) -> np.ndarray:
    """The sequence admission must budget and prefill for: ``resume_seq``
    where the request tracks preemption state, its plain prompt otherwise
    (a duck-typed request driving the pool directly)."""
    seq = getattr(request, "resume_seq", None)
    return request.prompt if seq is None else seq


def _bind_budget_of(request) -> int:
    budget = getattr(request, "resume_max_new", None)
    return request.max_new_tokens if budget is None else budget


def _ns_of(request) -> bytes:
    """The request's prefix-cache NAMESPACE: the engine's version-qualified
    one (``_prefix_ns``, set from ``AdapterStore.namespace_of``; a
    hot-swap changes it, orphaning the old version's keys), else the bare
    adapter name's (a pool driven without the engine's adapter plumbing),
    else the base model's empty one."""
    ns = getattr(request, "_prefix_ns", None)
    if ns is not None:
        return ns
    adapter = getattr(request, "adapter", None)
    if adapter is None:
        return b""
    from simple_distributed_machine_learning_tpu_torch.serve.adapters import (
        adapter_namespace,
    )
    return adapter_namespace(adapter)


def kv_block_bytes(n_layers: int, n_heads: int, block_size: int,
                   head_dim: int, cache_dtype=None) -> int:
    """Bytes one physical K/V block pins across every layer (K and V);
    quantised dtypes add their f32 scale planes (one per position and
    head, for K and for V)."""
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        _cache_dtype,
        _is_quantized_dtype,
    )
    cd = _cache_dtype(cache_dtype)
    n = 2 * n_layers * n_heads * block_size * head_dim * cd.itemsize
    if _is_quantized_dtype(cache_dtype):
        n += 2 * n_layers * n_heads * block_size * 4
    return int(n)


def n_blocks_for_bytes(budget_bytes: int, n_layers: int, n_heads: int,
                       block_size: int, head_dim: int,
                       cache_dtype=None) -> int:
    """Physical blocks a ``budget_bytes`` K/V budget funds."""
    per = kv_block_bytes(n_layers, n_heads, block_size, head_dim,
                         cache_dtype)
    return max(1, budget_bytes // per)


class _SlotPoolBase:
    """Slot occupancy accounting: the free-slot list with invariant guards
    and the per-slot decode state (positions and last tokens — small host
    arrays fed into every tick; the authoritative copy lives here)."""

    def __init__(self, n_slots: int, max_len: int) -> None:
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2 (a prompt token plus a "
                             f"generated one), got {max_len}")
        self.n_slots = n_slots
        self.max_len = max_len
        self.positions = np.zeros(n_slots, np.int32)
        self.last_token = np.zeros(n_slots, np.int32)
        self._occupant: list[int | None] = [None] * n_slots
        self._free: list[int] = list(range(n_slots))[::-1]   # pop() -> slot 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return self.n_slots - len(self._free)

    def active_slots(self) -> list[int]:
        return [s for s, r in enumerate(self._occupant) if r is not None]

    def occupant(self, slot: int) -> int | None:
        return self._occupant[slot]

    def acquire(self, rid: int) -> int:
        """Claim a free slot for request ``rid``; raises when full."""
        if not self._free:
            raise RuntimeError("slot acquire on a full pool — the scheduler "
                               "must check can_admit first")
        slot = self._free.pop()
        if self._occupant[slot] is not None:     # pragma: no cover - guard
            raise RuntimeError(
                f"slot {slot} already occupied by request "
                f"{self._occupant[slot]} — free-list corruption")
        self._occupant[slot] = rid
        return slot

    def release(self, slot: int) -> None:
        if self._occupant[slot] is None:
            raise RuntimeError(f"release of already-free slot {slot}")
        self._occupant[slot] = None
        self._free.append(slot)

    def seat(self, slot: int, prompt_len: int, first_token: int) -> None:
        """Post-prefill seating: next write position ``prompt_len``, pending
        input token the freshly sampled one."""
        if not 0 < prompt_len < self.max_len:
            raise ValueError(f"prompt_len {prompt_len} outside (0, "
                             f"{self.max_len})")
        self.positions[slot] = prompt_len
        self.last_token[slot] = int(first_token)

    def advance(self, slot: int, next_token: int) -> None:
        self.positions[slot] += 1
        self.last_token[slot] = int(next_token)

    # -- layout hooks (scheduler-driven) -----------------------------------

    def bind_seq(self, request) -> int | None:
        """Attach an admitted request's sequence to its slot. The dense
        layout has no sequence state (the row IS the state): None."""
        return None

    def unbind_seq(self, slot: int) -> None:
        """Release the slot's sequence state (dense: nothing)."""

    # -- routing affinity (FleetRouter's signals) ------------------------

    def shared_prefix_len(self, prompt, ns: bytes = b"") -> int:
        """Prompt positions this pool could serve from registered prefix
        blocks in namespace ``ns`` (the router's affinity signal). The
        dense layout shares nothing: 0."""
        return 0

    def host_prefix_len(self, prompt, ns: bytes = b"") -> int:
        """Prompt positions resident in this pool's host offload tier (the
        router's second affinity signal). Pools without one: 0."""
        return 0

    def prefetch_blocked(self, request) -> bool:
        """True while an in-flight host->device upload covers a prefix of
        ``request``'s bind sequence: the one ``can_admit`` failure that
        preemption can never fix. Pools without a host tier: never."""
        return False

    def admit_shortfall(self, request) -> int:
        """Budget units ``request`` is short of admission beyond a free
        slot (dense: the row is the whole budget — 0)."""
        return 0

    def freeable_blocks(self, slot: int) -> int:
        """Budget guaranteed back if ``slot``'s sequence ends now (dense:
        nothing beyond the slot itself — 0)."""
        return 0


def _check_tp(n_heads: int, tp: int) -> int:
    """Pool-side TP validation: the K/V head axis is what tensor-parallel
    serving splits, so ``tp`` must divide ``n_heads``. Byte accounting
    (``bytes_per_block``, ``serve_kv_bytes_resident``) is per shard: what
    one coordinate's pool pins, the number TP exists to shrink."""
    if tp < 1 or n_heads % tp:
        raise ValueError(
            f"tp={tp} must be >= 1 and divide the K/V head axis "
            f"(n_heads={n_heads})")
    return tp


def _shard_devices(device, tp: int, devices) -> list[torch.device]:
    """The device of each owned model coordinate's pool: ``devices`` (one
    per coordinate this process owns: all ``tp``, or a share of them that
    divides ``tp``), else ``device`` for all ``tp``."""
    if devices is None:
        return [resolve_device(device)] * tp
    devices = [resolve_device(d) for d in devices]
    if not devices or tp % len(devices):
        raise ValueError(f"{len(devices)} shard devices for tp={tp}")
    return devices


class KVCachePool(_SlotPoolBase):
    """Dense fixed-capacity slot pool; see module docstring. ``kc``/``vc``
    are f32 or bf16 tensors on ``device`` (None = ``"cuda"``); quantised
    dtypes are paged-only (dense rows hold no scales). With ``tp > 1``
    they are lists, one ``[L, n_slots, H/tp, max_len, dh]`` pool per owned
    model coordinate on its device (``devices``: one per owned coordinate,
    default every coordinate on ``device``)."""

    def __init__(self, n_layers: int, n_slots: int, n_heads: int,
                 max_len: int, head_dim: int, cache_dtype=None,
                 tp: int = 1, device=None, devices=None) -> None:
        super().__init__(n_slots, max_len)
        from simple_distributed_machine_learning_tpu_torch.models.gpt import (
            _cache_dtype,
            _check_cache_quantization,
        )
        _check_cache_quantization(cache_dtype, "KVCachePool", paged=False)
        self.tp = _check_tp(n_heads, tp)
        devs = _shard_devices(device, self.tp, devices)
        self.device = devs[0]
        shape = (n_layers, n_slots, n_heads // self.tp, max_len, head_dim)
        cd = _cache_dtype(cache_dtype)
        self.cache_dtype = cd
        kc = [torch.zeros(shape, dtype=cd, device=d) for d in devs]
        vc = [torch.zeros(shape, dtype=cd, device=d) for d in devs]
        self.kc, self.vc = (kc, vc) if self.tp > 1 else (kc[0], vc[0])
        # per shard, like the paged pool's bytes_per_block; every row is
        # pinned up front: occupancy never changes what a dense pool holds
        self._bytes_total = kv_block_bytes(n_layers, n_heads // self.tp,
                                           max_len, head_dim, cd) * n_slots

    def bytes_resident(self) -> int:
        """The full allocation, regardless of occupancy."""
        return self._bytes_total

    def can_admit(self, request) -> bool:
        """One free slot IS the whole budget."""
        return self.n_free > 0


class PagedKVPool(_SlotPoolBase):
    """Block-table paged K/V pool with prefix sharing; see module docstring.

    A physical block is *free*, *live* (``ref > 0`` request references) or
    *cached* (``ref == 0`` but holding registered prefix content —
    reclaimable, evicted LRU when the free list runs dry).

    Copy-on-write: writers call :meth:`ensure_writable` before landing K/V
    at a position. A block referenced by more than one request is copied
    first (the caller runs the device copy of the returned ``(src, dst)``)
    — unless the writing slot allocated it: sharers trust only rows below
    their registered fill, so the allocator's tail rows land in place.

    Reservations make on-demand allocation safe: admission reserves the
    sequence's worst-case block budget (minus fully-shared blocks, never
    written), every later allocation draws from it, so a decode tick never
    finds the pool empty.

    ``kc``/``vc`` are torch tensors on ``device`` (None = ``"cuda"``), or
    ``models.gpt.QuantKV`` pairs for quantised dtypes; with ``tp > 1``
    lists of them, one ``[L, n_blocks+1, H/tp, bs, dh]`` pool (and its
    scale planes) per owned model coordinate on its device (``devices``),
    all addressed by the one set of block tables.
    ``host_cache_blocks > 0`` turns on the host offload tier of that many
    blocks, whose uploads land ``prefetch_ticks`` ticks after they start
    (module docstring).
    """

    TRASH = 0   # physical block 0: the garbage sink for non-decoding slots

    def __init__(self, n_layers: int, n_slots: int, n_heads: int,
                 max_len: int, head_dim: int, cache_dtype=None,
                 block_size: int = 16, n_blocks: int | None = None,
                 tp: int = 1, host_cache_blocks: int = 0,
                 prefetch_ticks: int = 1, device=None,
                 devices=None) -> None:
        super().__init__(n_slots, max_len)
        self.tp = _check_tp(n_heads, tp)
        if host_cache_blocks < 0:
            raise ValueError(
                f"host_cache_blocks must be >= 0, got {host_cache_blocks}")
        if host_cache_blocks and self.tp > 1:
            raise ValueError(
                "host_cache_blocks with tp > 1 is not supported: demotion "
                "copies device rows to host per pool, and a sharded pool "
                "would demote per-shard fragments the prefetch upload "
                "cannot re-place")
        if prefetch_ticks < 1:
            raise ValueError(
                f"prefetch_ticks must be >= 1, got {prefetch_ticks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        from simple_distributed_machine_learning_tpu_torch.models.gpt import (
            QuantKV,
            _cache_dtype,
            _check_cache_quantization,
            _is_quantized_dtype,
        )
        devs = _shard_devices(device, self.tp, devices)
        self.device = devs[0]
        self.block_size = block_size
        self.blocks_per_seq = math.ceil(max_len / block_size)
        if n_blocks is None:
            n_blocks = n_slots * self.blocks_per_seq
        if n_blocks < self.blocks_per_seq:
            raise ValueError(
                f"n_blocks={n_blocks} cannot hold even one full sequence "
                f"({self.blocks_per_seq} blocks of {block_size} for "
                f"max_len={max_len})")
        self.n_blocks = n_blocks
        _check_cache_quantization(cache_dtype, "PagedKVPool", paged=True)
        cd = _cache_dtype(cache_dtype)
        self.cache_dtype = cd
        self.quantized = _is_quantized_dtype(cache_dtype)
        shape = (n_layers, n_blocks + 1, n_heads // self.tp, block_size,
                 head_dim)

        def buffer(dev):
            if self.quantized:
                return QuantKV(torch.zeros(shape, dtype=cd, device=dev),
                               torch.zeros(shape[:-1], dtype=torch.float32,
                                           device=dev))
            return torch.zeros(shape, dtype=cd, device=dev)

        kc, vc = [buffer(d) for d in devs], [buffer(d) for d in devs]
        self.kc, self.vc = (kc, vc) if self.tp > 1 else (kc[0], vc[0])
        # per shard: what one coordinate's pool pins, and what the byte
        # model's predict_kv_bytes_resident must agree with
        self.bytes_per_block = kv_block_bytes(n_layers, n_heads // self.tp,
                                              block_size, head_dim,
                                              cache_dtype)
        # block bookkeeping (host-side, authoritative)
        self.ref = np.zeros(n_blocks + 1, np.int64)
        self._free_blocks: list[int] = list(range(1, n_blocks + 1))[::-1]
        self._cached: dict[int, set[bytes]] = {}       # block -> prefix keys
        self._prefix: dict[bytes, tuple[int, int]] = {}  # key -> (block, fill)
        # bumped on every _prefix mutation: versions the per-request probe
        # memo in _probe_cached
        self._registry_epoch = 0
        # block -> the slot that allocated it and may still write it in
        # place while sharers hold references (see ensure_writable)
        self._block_writer: dict[int, int] = {}
        self._lru: collections.OrderedDict[int, None] = (
            collections.OrderedDict())                 # reclaimable, LRU order
        self._reserved = 0
        self.tables: list[list[int]] = [[] for _ in range(n_slots)]
        self._resv = np.zeros(n_slots, np.int64)
        # per-slot prefix namespace, set at bind: register_prefix publishes
        # under the scope the slot's probe matched in
        self._slot_ns: list[bytes] = [b""] * n_slots
        # lifetime counters (ServeMetrics reads the deltas)
        self.prefix_hit_blocks_total = 0
        self.cow_copies_total = 0
        self.evictions_total = 0
        # -- host offload tier (module docstring) -------------------------
        self.host_cache_blocks = host_cache_blocks
        self.prefetch_ticks = prefetch_ticks
        # host_id -> {"keys": {key: fill}, "kc": ..., "vc": ...}, kc/vc one
        # block's rows as CPU tensors (pinned on the card), LRU order
        self._host: collections.OrderedDict[int, dict] = (
            collections.OrderedDict())
        self._host_prefix: dict[bytes, tuple[int, int]] = {}
        self._next_host_id = 0
        # in-flight uploads: {"entries": [(key, fill, host kc, host vc)],
        # "blocks": [phys], "ticks_left": int}
        self._inflight: list[dict] = []
        # uploads issued on the card and not yet known complete: (event,
        # their pinned sources). Holding the sources here until the event
        # has passed keeps them alive for the copy even after the host
        # LRU dropped their entry (the caching host allocator also holds
        # a freed pinned block back until its recorded use completes)
        self._landing: list[tuple] = []
        self.host_demotes_total = 0
        self.host_promotes_total = 0
        self.host_evictions_total = 0
        self.host_prefetch_hits_total = 0
        self.host_prefetch_misses_total = 0
        self.host_transfer_bytes_total = 0

    # -- capacity ----------------------------------------------------------

    @property
    def blocks_in_use(self) -> int:
        """Blocks referenced by live requests (cached-only excluded)."""
        return int((self.ref[1:] > 0).sum())

    @property
    def blocks_cached(self) -> int:
        return len(self._lru)

    @property
    def blocks_available(self) -> int:
        """free + reclaimable minus outstanding reservations."""
        return len(self._free_blocks) + len(self._lru) - self._reserved

    def bytes_resident(self) -> int:
        return self.blocks_in_use * self.bytes_per_block

    @staticmethod
    def _rows_needed(prompt_len: int, max_new_tokens: int) -> int:
        # prefill writes [0, prompt_len) and every consumed token one more
        # row; the final emitted token is never consumed
        return prompt_len + max_new_tokens - 1

    def blocks_for(self, rows: int) -> int:
        return math.ceil(rows / self.block_size)

    # -- admission ---------------------------------------------------------

    def can_admit(self, request) -> bool:
        """A free slot AND enough blocks for the request's worst-case
        budget after prefix sharing, AND no in-flight upload covering its
        prefix (:meth:`prefetch_blocked`: it waits the tick or two for
        the registered blocks instead of recomputing, or sharing
        half-uploaded rows)."""
        return (bool(self._free) and self.admit_shortfall(request) == 0
                and not self.prefetch_blocked(request))

    def admit_shortfall(self, request) -> int:
        """Blocks ``request`` is short of admission (0 = fits). Shared
        chain blocks sitting in the reclaimable LRU are counted out of
        availability: sharing revives them."""
        _shared_len, chain = self._probe_cached(request)
        n_shared_full = sum(1 for _, fill in chain if fill == self.block_size)
        n_shared_reclaimable = sum(1 for b, _ in chain if self.ref[b] == 0)
        budget = self.blocks_for(
            self._rows_needed(int(np.asarray(_bind_seq_of(request)).shape[0]),
                              _bind_budget_of(request))) - n_shared_full
        return max(0, budget - (self.blocks_available - n_shared_reclaimable))

    def freeable_blocks(self, slot: int) -> int:
        """Blocks GUARANTEED back into availability if ``slot``'s sequence
        ends now: its unused reservation plus its solely-referenced
        UNCACHED table blocks. Cached blocks are excluded even at ref 1
        (they land on the reclaimable LRU, which ``admit_shortfall``
        already discounts when a probe shares them): may under-report (a
        missed preemption), never over-report (work destroyed for
        nothing)."""
        return int(self._resv[slot]) + sum(
            1 for b in self.tables[slot]
            if self.ref[b] == 1 and not self._cached.get(b))

    def begin_seq(self, slot: int, prompt: np.ndarray,
                  max_new_tokens: int, ns: bytes = b"") -> int:
        """Attach a sequence to an acquired slot: reference the longest
        registered prefix of ``prompt`` (in namespace ``ns``) into the
        slot's table and reserve the worst-case budget for the rest.
        Returns the first position prefill must compute (always <
        ``len(prompt)``: the last prompt position is recomputed, so the
        first token comes from a real forward pass)."""
        if self.tables[slot] or self._resv[slot]:
            raise RuntimeError(
                f"begin_seq on slot {slot} with a live block table or "
                f"reservation — the previous sequence was never ended")
        prompt = np.asarray(prompt)
        self._slot_ns[slot] = ns
        shared_len, chain = self._probe_prefix(prompt, ns)
        for block, _fill in chain:
            self._ref_block(block)
            self.tables[slot].append(block)
        n_shared_full = sum(1 for _, fill in chain if fill == self.block_size)
        budget = self.blocks_for(
            self._rows_needed(int(prompt.shape[0]), max_new_tokens)
        ) - n_shared_full
        if budget > self.blocks_available:
            raise RuntimeError(
                f"begin_seq short of blocks (need {budget}, have "
                f"{self.blocks_available}) — the scheduler must check "
                f"can_admit first")
        self._reserved += budget
        self._resv[slot] = budget
        self.prefix_hit_blocks_total += len(chain)
        return shared_len

    def bind_seq(self, request) -> int:
        """:meth:`begin_seq` on an admitted request's acquired slot, for
        its ``resume_seq`` (the prompt, plus the emitted tokens after a
        preemption) and namespace. Runs inside the scheduler's admission
        loop, so the next admission probe already sees this reservation."""
        return self.begin_seq(request.slot, _bind_seq_of(request),
                              _bind_budget_of(request), ns=_ns_of(request))

    def unbind_seq(self, slot: int) -> None:
        self.end_seq(slot)

    def end_seq(self, slot: int) -> None:
        """Detach the slot's sequence: decref every table block (registered
        ones stay cached, reclaimable) and return the unused reservation
        (the slot frees separately)."""
        for block in self.tables[slot]:
            if self._block_writer.get(block) == slot:
                del self._block_writer[block]
            self._unref_block(block)
        self.tables[slot] = []
        self._slot_ns[slot] = b""
        self._reserved -= int(self._resv[slot])
        self._resv[slot] = 0

    # -- write-path allocation + copy-on-write -----------------------------

    def ensure_writable(self, slot: int, position: int
                        ) -> tuple[int, int] | None:
        """Make ``position``'s block privately writable by ``slot``,
        allocating on demand. Returns ``(src, dst)`` when copy-on-write
        fired — the caller copies the device block first — else None. An
        in-place write drops registered prefixes whose rows it would
        clobber."""
        if not 0 <= position < self.max_len:
            raise ValueError(f"position {position} outside [0, "
                             f"{self.max_len})")
        table = self.tables[slot]
        j = position // self.block_size
        if j > len(table):          # pragma: no cover - guard
            raise RuntimeError(
                f"slot {slot} write at position {position} skips logical "
                f"block {len(table)} — positions must advance contiguously")
        if j == len(table):
            table.append(self._alloc_block(slot))
            return None
        phys = table[j]
        if self.ref[phys] > 1 and self._block_writer.get(phys) != slot:
            dst = self._alloc_block(slot)
            table[j] = dst
            self._unref_block(phys)
            self.cow_copies_total += 1
            return (phys, dst)
        off = position % self.block_size
        for key in list(self._cached.get(phys, ())):
            if self._prefix[key][1] > off:
                self._drop_key(key)
        return None

    def _alloc_block(self, slot: int) -> int:
        if self._resv[slot] <= 0:   # pragma: no cover - guard
            raise RuntimeError(
                f"slot {slot} allocates past its reservation — the "
                f"admission budget was computed wrong")
        if self._free_blocks:
            block = self._free_blocks.pop()
        elif self._lru:
            block = self._evict_lru()
        else:                       # pragma: no cover - guard
            raise RuntimeError(
                "block pool exhausted despite reservation accounting — "
                "free/reserve bookkeeping corrupted")
        if self.ref[block] != 0 or block == self.TRASH:  # pragma: no cover
            raise RuntimeError(f"allocated block {block} with ref "
                               f"{self.ref[block]} — double allocation")
        self.ref[block] = 1
        self._block_writer[block] = slot
        self._resv[slot] -= 1
        self._reserved -= 1
        return block

    def _evict_lru(self) -> int:
        """Reclaim the oldest cached block: with a host tier its rows and
        keys demote to host RAM BEFORE the keys drop, so the prefix
        survives there; then its device keys go."""
        block, _ = self._lru.popitem(last=False)
        if self.host_cache_blocks:
            self._demote(block)
        for key in list(self._cached.get(block, ())):
            del self._prefix[key]
        self._cached.pop(block, None)
        self._registry_epoch += 1
        self.evictions_total += 1
        return block

    def _ref_block(self, block: int) -> None:
        if self.ref[block] == 0:
            self._lru.pop(block, None)     # cached-reclaimable; revived
        self.ref[block] += 1

    def _unref_block(self, block: int) -> None:
        if self.ref[block] <= 0:
            raise RuntimeError(f"unref of unreferenced block {block} — "
                               f"double free")
        self.ref[block] -= 1
        if self.ref[block] == 0:
            self._block_writer.pop(block, None)
            if self._cached.get(block):
                self._lru[block] = None        # reclaimable, newest last
            else:
                self._free_blocks.append(block)

    # -- prefix registry ---------------------------------------------------

    def shared_prefix_len(self, prompt, ns: bytes = b"") -> int:
        """The fleet router's affinity signal: the longest registered
        prefix of ``prompt`` (in positions) this pool holds in namespace
        ``ns``. A pure probe (no referencing, no memo), so the router may
        ask every replica."""
        return self._probe_prefix(np.asarray(prompt, np.int32), ns)[0]

    def _probe_cached(self, request) -> tuple[int, list[tuple[int, int]]]:
        """Probe memoised on the request, keyed by the registry epoch and
        the bind sequence's length (a blocked head-of-line request is
        re-probed every tick)."""
        seq = np.asarray(_bind_seq_of(request))
        key = (self._registry_epoch, int(seq.shape[0]))
        memo = getattr(request, "_prefix_probe", None)
        if memo is not None and memo[0] == key:
            return memo[1], memo[2]
        shared_len, chain = self._probe_prefix(seq, _ns_of(request))
        request._prefix_probe = (key, shared_len, chain)
        return shared_len, chain

    def _walk(self, registry: dict, prompt, ns: bytes
              ) -> tuple[int, list[tuple[bytes, int, int]]]:
        """Longest chain of ``registry`` keys prefixing ``prompt`` within
        namespace ``ns``, block by block (the longest key first in each;
        capped at ``prompt_len - 1``: at least one position is always
        recomputed). Returns ``(shared_len, [(key, fill, registry[key][0]),
        ...])`` without mutating."""
        prompt = np.asarray(prompt, np.int32)
        cap = int(prompt.shape[0]) - 1
        bs = self.block_size
        chain: list[tuple[bytes, int, int]] = []
        shared = 0
        j = 0
        while True:
            hit = None
            for length in range(min(cap, (j + 1) * bs), j * bs, -1):
                key = ns + prompt[:length].tobytes()
                entry = registry.get(key)
                if entry is not None:
                    hit = (key, length - j * bs, entry[0])
                    break
            if hit is None:
                break
            chain.append(hit)
            shared = j * bs + hit[1]
            if hit[1] < bs:         # partial tail ends the chain
                break
            j += 1
        return shared, chain

    def _probe_prefix(self, prompt: np.ndarray, ns: bytes = b""
                      ) -> tuple[int, list[tuple[int, int]]]:
        """The device registry's chain for ``prompt`` in namespace ``ns``:
        ``(shared_len, [(block, fill), ...])``."""
        shared, chain = self._walk(self._prefix, prompt, ns)
        return shared, [(block, fill) for _key, fill, block in chain]

    def register_prefix(self, slot: int, prompt: np.ndarray) -> None:
        """Publish ``slot``'s prefilled prompt blocks: one key per full
        block boundary plus the partial tail, under the slot's bind-time
        namespace. First writer wins."""
        prompt = np.asarray(prompt, np.int32)
        ns = self._slot_ns[slot]
        bs = self.block_size
        table = self.tables[slot]
        plen = int(prompt.shape[0])
        for j in range(self.blocks_for(plen)):
            fill = min(plen - j * bs, bs)
            key = ns + prompt[:j * bs + fill].tobytes()
            if key in self._prefix:
                continue
            block = table[j]
            self._prefix[key] = (block, fill)
            self._cached.setdefault(block, set()).add(key)
            self._registry_epoch += 1

    def _drop_key(self, key: bytes) -> None:
        block, _ = self._prefix.pop(key)
        self._registry_epoch += 1
        keys = self._cached.get(block)
        if keys:
            keys.discard(key)
            if not keys:
                del self._cached[block]
                if self.ref[block] == 0 and block in self._lru:
                    del self._lru[block]
                    self._free_blocks.append(block)

    # -- host offload tier -------------------------------------------------

    def _block_to_host(self, cache, block: int):
        """One physical block's rows, every layer, as CPU tensors (a
        :class:`QuantKV`'s narrow data and f32 scales together). On the
        card: a blocking copy of the strided ``[:, block]`` view into
        pinned memory, which waits for every earlier write to the block."""
        from simple_distributed_machine_learning_tpu_torch.models.gpt import (
            QuantKV,
        )
        if isinstance(cache, QuantKV):
            return QuantKV(self._block_to_host(cache.data, block),
                           self._block_to_host(cache.scale, block))
        rows = cache[:, block]
        host = torch.empty(rows.shape, dtype=rows.dtype,
                           pin_memory=rows.is_cuda)
        host.copy_(rows)
        return host

    def _block_from_host(self, cache, block: int, host) -> None:
        """Write a host copy back into physical ``block`` in place (the
        pair together for a :class:`QuantKV`); ``non_blocking`` from
        pinned memory on the card, in stream order before the next
        program's reads."""
        from simple_distributed_machine_learning_tpu_torch.models.gpt import (
            QuantKV,
        )
        if isinstance(cache, QuantKV):
            self._block_from_host(cache.data, block, host.data)
            self._block_from_host(cache.scale, block, host.scale)
            return
        cache[:, block].copy_(host, non_blocking=host.is_pinned())

    def _demote(self, block: int) -> None:
        """Copy an evicted cached block's rows and its prefix keys into the
        host tier before the device registry forgets them. A key already
        host-resident is re-pointed at the fresh copy (the key IS the
        token prefix, which fully determines the rows); overflow drops the
        LRU host entry (``host_evictions_total``)."""
        keys = {k: self._prefix[k][1] for k in self._cached.get(block, ())}
        if not keys:                # pragma: no cover - LRU blocks are cached
            return
        hid = self._next_host_id
        self._next_host_id += 1
        for key in keys:
            old = self._host_prefix.get(key)
            if old is not None:
                self._drop_host_key(key, old[0])
        self._host[hid] = {"keys": keys,
                           "kc": self._block_to_host(self.kc, block),
                           "vc": self._block_to_host(self.vc, block)}
        for key, fill in keys.items():
            self._host_prefix[key] = (hid, fill)
        self.host_demotes_total += 1
        self.host_transfer_bytes_total += self.bytes_per_block
        while len(self._host) > self.host_cache_blocks:
            ev_id, ev = self._host.popitem(last=False)
            for key in ev["keys"]:
                if self._host_prefix.get(key, (None, 0))[0] == ev_id:
                    del self._host_prefix[key]
            self.host_evictions_total += 1

    def _drop_host_key(self, key: bytes, hid: int) -> None:
        entry = self._host.get(hid)
        if entry is None:           # pragma: no cover - guard
            return
        entry["keys"].pop(key, None)
        if not entry["keys"]:
            del self._host[hid]

    def host_prefix_len(self, prompt, ns: bytes = b"") -> int:
        """The host-tier affinity signal: the longest host-resident prefix
        of ``prompt`` (in positions) in namespace ``ns``. A pure probe."""
        return self._probe_host(np.asarray(prompt, np.int32), ns)[0]

    def _probe_host(self, prompt: np.ndarray, ns: bytes = b""
                    ) -> tuple[int, list[tuple[bytes, int, int]]]:
        """The HOST registry's chain (its keys are demoted device keys,
        namespace included): ``(shared_len, [(key, fill, host_id),
        ...])``."""
        return self._walk(self._host_prefix, prompt, ns)

    def prefetch(self, prompt, ns: bytes = b"") -> bool:
        """Routing-time upload: start moving ``prompt``'s host-resident
        prefix blocks back to the device so they are registered before the
        request boards. True on a HIT (an upload started, or the same keys
        are already in flight); False (a MISS) when the host tier adds
        nothing past the device registry or availability cannot fund the
        upload without touching reservations. Free blocks fund first,
        then reclaimable LRU blocks by the allocator's evict path, with
        demotion. The keys stay invisible until :meth:`advance_transfers`
        completes them."""
        if not self.host_cache_blocks:
            return False
        prompt = np.asarray(prompt, np.int32)
        host_len, chain = self._probe_host(prompt, ns)
        dev_len = self._probe_prefix(prompt, ns)[0]
        chain = [(k, f, hid) for (k, f, hid) in chain
                 if k not in self._prefix]
        if host_len <= dev_len or not chain:
            self.host_prefetch_misses_total += 1
            return False
        inflight_keys = {k for t in self._inflight
                         for (k, _f, _hk, _hv) in t["entries"]}
        fresh = [(k, f, hid) for (k, f, hid) in chain
                 if k not in inflight_keys]
        if not fresh:
            return True             # already on its way; counted at start
        n = len(fresh)
        if n > self.blocks_available:
            self.host_prefetch_misses_total += 1
            return False
        # capture the host tensors BEFORE claiming device blocks: claiming
        # may evict-and-demote LRU victims, and the demotion's host-LRU
        # overflow could drop the very entries this upload reads from
        entries = []
        for key, fill, hid in fresh:
            e = self._host[hid]
            self._host.move_to_end(hid)        # a prefetch touch is a use
            entries.append((key, fill, e["kc"], e["vc"]))
        blocks = []
        for _ in range(n):
            blocks.append(self._free_blocks.pop() if self._free_blocks
                          else self._evict_lru())
        self._inflight.append({"entries": entries, "blocks": blocks,
                               "ticks_left": self.prefetch_ticks})
        self.host_prefetch_hits_total += 1
        return True

    def prefetch_blocked(self, request) -> bool:
        if not self._inflight:
            return False
        seq_b = _ns_of(request) + np.asarray(
            _bind_seq_of(request), np.int32).tobytes()
        for t in self._inflight:
            for key, _f, _hk, _hv in t["entries"]:
                if len(key) < len(seq_b) and seq_b.startswith(key):
                    return True
        return False

    def advance_transfers(self) -> None:
        """One engine tick of upload progress: count every in-flight
        upload down and COMPLETE those reaching zero — the rows land, the
        keys register (epoch bump), the blocks join the reclaimable LRU as
        cached ref-0 blocks, as if a local request had registered them.
        The paged engine calls this at the top of every step, before
        admission, so a request blocked on its upload boards the tick the
        blocks become real. A key registered on the device while the
        upload flew wins, and the upload's block goes back to the free
        list."""
        self._landing = [(ev, src) for ev, src in self._landing
                         if not ev.query()]
        if not self._inflight:
            return
        done = [t for t in self._inflight if t["ticks_left"] <= 1]
        for t in self._inflight:
            t["ticks_left"] -= 1
        self._inflight = [t for t in self._inflight if t["ticks_left"] > 0]
        for t in done:
            blocks = list(t["blocks"])
            sources = []
            for key, fill, hk, hv in t["entries"]:
                block = blocks.pop(0)
                if key in self._prefix:
                    self._free_blocks.append(block)
                    continue
                self._block_from_host(self.kc, block, hk)
                self._block_from_host(self.vc, block, hv)
                sources.append((hk, hv))
                self._prefix[key] = (block, fill)
                self._cached.setdefault(block, set()).add(key)
                self._lru[block] = None        # cached ref-0, reclaimable
                self._registry_epoch += 1
                self.host_promotes_total += 1
                self.host_transfer_bytes_total += self.bytes_per_block
            if sources and self.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record()
                self._landing.append((ev, sources))

    def host_bytes_resident(self) -> int:
        """Bytes the host tier pins in host RAM: host blocks x
        ``bytes_per_block`` (the :func:`kv_block_bytes` formula)."""
        return len(self._host) * self.bytes_per_block

    # -- tick inputs -------------------------------------------------------

    def device_table(self, slot: int) -> np.ndarray:
        """This slot's block table padded to the static width with trash
        entries (masked out by position in the tick)."""
        t = np.full(self.blocks_per_seq, self.TRASH, np.int32)
        table = self.tables[slot]
        t[:len(table)] = table
        return t

    def stats(self) -> dict:
        s = {
            "blocks_total": self.n_blocks,
            "blocks_in_use": self.blocks_in_use,
            "blocks_cached": self.blocks_cached,
            "blocks_free": len(self._free_blocks),
            "kv_bytes_resident": self.bytes_resident(),
            "prefix_hit_blocks_total": self.prefix_hit_blocks_total,
            "cow_copies_total": self.cow_copies_total,
            "evictions_total": self.evictions_total,
        }
        if self.host_cache_blocks:
            s.update({
                "host_blocks": len(self._host),
                "host_bytes_resident": self.host_bytes_resident(),
                "host_inflight_blocks": sum(
                    len(t["blocks"]) for t in self._inflight),
                "host_demotes_total": self.host_demotes_total,
                "host_promotes_total": self.host_promotes_total,
                "host_evictions_total": self.host_evictions_total,
                "host_prefetch_hits_total": self.host_prefetch_hits_total,
                "host_prefetch_misses_total":
                    self.host_prefetch_misses_total,
                "host_transfer_bytes_total": self.host_transfer_bytes_total,
            })
        return s
