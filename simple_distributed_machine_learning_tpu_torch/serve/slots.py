"""KV-cache pools: the serving engine's one device-resident state.

Port of ``serve/slots.py``, two layouts with one slot discipline (the
host offload tier waits for ROADMAP.md, Queue A, item 5.2):

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

Invariants raise instead of corrupting a neighbour: no double occupancy,
no double allocation or free, no write into a block another sequence
still references.
"""

from __future__ import annotations

import collections
import math

import numpy as np
import torch

from simple_distributed_machine_learning_tpu_torch._device import (
    resolve_device,
)


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

    def admit_shortfall(self, request) -> int:
        """Budget units ``request`` is short of admission beyond a free
        slot (dense: the row is the whole budget — 0)."""
        return 0

    def freeable_blocks(self, slot: int) -> int:
        """Budget guaranteed back if ``slot``'s sequence ends now (dense:
        nothing beyond the slot itself — 0)."""
        return 0


class KVCachePool(_SlotPoolBase):
    """Dense fixed-capacity slot pool; see module docstring. ``kc``/``vc``
    are f32 or bf16 tensors on ``device`` (None = ``"cuda"``); quantised
    dtypes are paged-only (dense rows hold no scales)."""

    def __init__(self, n_layers: int, n_slots: int, n_heads: int,
                 max_len: int, head_dim: int, cache_dtype=None,
                 device=None) -> None:
        super().__init__(n_slots, max_len)
        from simple_distributed_machine_learning_tpu_torch.models.gpt import (
            _cache_dtype,
            _check_cache_quantization,
        )
        _check_cache_quantization(cache_dtype, "KVCachePool", paged=False)
        self.device = resolve_device(device)
        shape = (n_layers, n_slots, n_heads, max_len, head_dim)
        cd = _cache_dtype(cache_dtype)
        self.cache_dtype = cd
        self.kc = torch.zeros(shape, dtype=cd, device=self.device)
        self.vc = torch.zeros(shape, dtype=cd, device=self.device)
        # every row is pinned up front: occupancy never changes what a
        # dense pool holds resident
        self._bytes_total = kv_block_bytes(n_layers, n_heads, max_len,
                                           head_dim, cd) * n_slots

    def bytes_resident(self) -> int:
        """The full allocation, regardless of occupancy."""
        return self._bytes_total

    def shared_prefix_len(self, prompt) -> int:
        """The fleet router's affinity signal: dense rows share nothing."""
        return 0

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
    ``models.gpt.QuantKV`` pairs for quantised dtypes.
    """

    TRASH = 0   # physical block 0: the garbage sink for non-decoding slots

    def __init__(self, n_layers: int, n_slots: int, n_heads: int,
                 max_len: int, head_dim: int, cache_dtype=None,
                 block_size: int = 16, n_blocks: int | None = None,
                 device=None) -> None:
        super().__init__(n_slots, max_len)
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        from simple_distributed_machine_learning_tpu_torch.models.gpt import (
            QuantKV,
            _cache_dtype,
            _check_cache_quantization,
            _is_quantized_dtype,
        )
        self.device = resolve_device(device)
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
        shape = (n_layers, n_blocks + 1, n_heads, block_size, head_dim)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        if self.quantized:
            self.kc = QuantKV(zeros(shape, cd), zeros(shape[:-1],
                                                      torch.float32))
            self.vc = QuantKV(zeros(shape, cd), zeros(shape[:-1],
                                                      torch.float32))
        else:
            self.kc = zeros(shape, cd)
            self.vc = zeros(shape, cd)
        self.bytes_per_block = kv_block_bytes(n_layers, n_heads, block_size,
                                              head_dim, cache_dtype)
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
        # lifetime counters (ServeMetrics reads the deltas)
        self.prefix_hit_blocks_total = 0
        self.cow_copies_total = 0
        self.evictions_total = 0

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
        budget after prefix sharing."""
        return bool(self._free) and self.admit_shortfall(request) == 0

    def admit_shortfall(self, request) -> int:
        """Blocks ``request`` is short of admission (0 = fits). Shared
        chain blocks sitting in the reclaimable LRU are counted out of
        availability: sharing revives them."""
        _shared_len, chain = self._probe_cached(request)
        n_shared_full = sum(1 for _, fill in chain if fill == self.block_size)
        n_shared_reclaimable = sum(1 for b, _ in chain if self.ref[b] == 0)
        budget = self.blocks_for(
            self._rows_needed(int(request.resume_seq.shape[0]),
                              request.resume_max_new)) - n_shared_full
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

    def bind_seq(self, request) -> int:
        """Attach an admitted request's sequence to its acquired slot:
        reference the longest registered prefix's blocks of its
        ``resume_seq`` (the prompt, plus the emitted tokens after a
        preemption) and reserve the worst-case budget for the rest.
        Returns the first position prefill must compute (always <
        ``len(resume_seq)``). Runs inside the scheduler's admission loop,
        so the next admission probe already sees this reservation."""
        slot = request.slot
        if self.tables[slot] or self._resv[slot]:
            raise RuntimeError(
                f"bind_seq on slot {slot} with a live block table or "
                f"reservation — the previous sequence was never unbound")
        prompt = np.asarray(request.resume_seq)
        shared_len, chain = self._probe_prefix(prompt)
        for block, _fill in chain:
            self._ref_block(block)
            self.tables[slot].append(block)
        n_shared_full = sum(1 for _, fill in chain if fill == self.block_size)
        budget = self.blocks_for(
            self._rows_needed(int(prompt.shape[0]), request.resume_max_new)
        ) - n_shared_full
        if budget > self.blocks_available:
            raise RuntimeError(
                f"bind_seq short of blocks (need {budget}, have "
                f"{self.blocks_available}) — the scheduler must check "
                f"can_admit first")
        self._reserved += budget
        self._resv[slot] = budget
        self.prefix_hit_blocks_total += len(chain)
        return shared_len

    def unbind_seq(self, slot: int) -> None:
        """Detach the slot's sequence: decref every table block (registered
        ones stay cached, reclaimable) and return the unused reservation
        (the slot frees separately)."""
        for block in self.tables[slot]:
            if self._block_writer.get(block) == slot:
                del self._block_writer[block]
            self._unref_block(block)
        self.tables[slot] = []
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
            block, _ = self._lru.popitem(last=False)   # evict LRU cached
            for key in list(self._cached.get(block, ())):
                del self._prefix[key]
            self._cached.pop(block, None)
            self._registry_epoch += 1
            self.evictions_total += 1
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

    def shared_prefix_len(self, prompt) -> int:
        """The fleet router's affinity signal: the longest registered
        prefix of ``prompt`` (in positions) this pool holds. A pure probe
        (no referencing, no memo), so the router may ask every replica."""
        return self._probe_prefix(np.asarray(prompt, np.int32))[0]

    def _probe_cached(self, request) -> tuple[int, list[tuple[int, int]]]:
        """Probe memoised on the request, keyed by the registry epoch and
        the bind sequence's length (a blocked head-of-line request is
        re-probed every tick)."""
        seq = np.asarray(request.resume_seq)
        key = (self._registry_epoch, int(seq.shape[0]))
        memo = getattr(request, "_prefix_probe", None)
        if memo is not None and memo[0] == key:
            return memo[1], memo[2]
        shared_len, chain = self._probe_prefix(seq)
        request._prefix_probe = (key, shared_len, chain)
        return shared_len, chain

    def _probe_prefix(self, prompt: np.ndarray
                      ) -> tuple[int, list[tuple[int, int]]]:
        """Longest registered chain prefixing ``prompt`` (capped at
        ``prompt_len - 1``: at least one position is always recomputed).
        Returns ``(shared_len, [(block, fill), ...])`` without mutating."""
        prompt = np.asarray(prompt, np.int32)
        cap = int(prompt.shape[0]) - 1
        bs = self.block_size
        chain: list[tuple[int, int]] = []
        shared = 0
        j = 0
        while True:
            hit = None
            for length in range(min(cap, (j + 1) * bs), j * bs, -1):
                entry = self._prefix.get(prompt[:length].tobytes())
                if entry is not None:
                    hit = (entry[0], length - j * bs)
                    break
            if hit is None:
                break
            chain.append(hit)
            shared = j * bs + hit[1]
            if hit[1] < bs:         # partial tail ends the chain
                break
            j += 1
        return shared, chain

    def register_prefix(self, slot: int, prompt: np.ndarray) -> None:
        """Publish ``slot``'s prefilled prompt blocks: one key per full
        block boundary plus the partial tail. First writer wins."""
        prompt = np.asarray(prompt, np.int32)
        bs = self.block_size
        table = self.tables[slot]
        plen = int(prompt.shape[0])
        for j in range(self.blocks_for(plen)):
            fill = min(plen - j * bs, bs)
            key = prompt[:j * bs + fill].tobytes()
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

    # -- tick inputs -------------------------------------------------------

    def device_table(self, slot: int) -> np.ndarray:
        """This slot's block table padded to the static width with trash
        entries (masked out by position in the tick)."""
        t = np.full(self.blocks_per_seq, self.TRASH, np.int32)
        table = self.tables[slot]
        t[:len(table)] = table
        return t

    def stats(self) -> dict:
        return {
            "blocks_total": self.n_blocks,
            "blocks_in_use": self.blocks_in_use,
            "blocks_cached": self.blocks_cached,
            "blocks_free": len(self._free_blocks),
            "kv_bytes_resident": self.bytes_resident(),
            "prefix_hit_blocks_total": self.prefix_hit_blocks_total,
            "cow_copies_total": self.cow_copies_total,
            "evictions_total": self.evictions_total,
        }
