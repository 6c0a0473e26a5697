"""AdapterStore: per-engine residency of named LoRA adapters (port of
``serve/adapters.py``).

Multi-tenant serving keeps ONE copy of the base weights and a small
device-resident BANK of stacked low-rank adapters (``models/lora.py``);
every decode program gathers each slot's A/B rows by a per-slot index,
so one program serves any adapter mix per tick. This module owns the
bookkeeping around that bank:

- **Named adapters, on the host.** :meth:`AdapterStore.register`
  validates shapes and parks the weights in a host dict — no device
  work. The dict is shared with the supervisor's engine factory, so a
  crash-rebuilt engine starts with every registered tenant (residency
  resets; rows upload again as recovered requests re-admit).
- **Tick-boundary uploads only.** The bank is written only from
  :meth:`retain` / :meth:`ensure_resident`, which the engine's admission
  gate calls inside ``step()`` between program calls: one in-place row
  copy per key on the bank's device, in stream order with the ticks
  around it.
- **Refcounted residency that never refuses.** The bank has ``n_slots +
  1`` rows (row 0 the all-zero base row, never evicted). An admitted
  request holds one ref on its row until it finishes, preempts or
  cancels. Admission needs a free slot first, so at most ``n_slots - 1``
  rows are referenced when a request boards: a zero-ref row always
  exists.
- **Version-pinned hot-swap.** Re-registering a live adapter bumps its
  version on the host; in-flight requests keep decoding from the old
  row, while the next admission uploads the new version to another row.
  The old row is reclaimed once its last ref drops.

``resident_bytes`` is the whole static bank (``lora.bank_bytes``) and
``swaps_total`` counts device row uploads.
"""

from __future__ import annotations

import itertools

import torch

from simple_distributed_machine_learning_tpu_torch._device import (
    resolve_device,
)
from simple_distributed_machine_learning_tpu_torch.models import lora
from simple_distributed_machine_learning_tpu_torch.models.gpt import (
    make_adapter_bank_update,
)


def validate_adapter_name(name: str) -> None:
    """Adapter names key the journal and the prefix-cache namespace:
    reject the empty string and NUL (the namespace delimiter)."""
    if not isinstance(name, str) or not name:
        raise ValueError("adapter name must be a non-empty string")
    if "\x00" in name:
        raise ValueError("adapter name must not contain NUL — it "
                         "delimits the prefix-cache namespace")


def adapter_namespace(name: str | None) -> bytes:
    """The prefix-cache key namespace for a request's adapter: tenants
    never share K/V blocks across adapters. ``None`` (base model) maps to
    the EMPTY namespace, so base keys stay those of an engine without
    adapters; a named adapter prefixes ``name + NUL``."""
    return b"" if name is None else name.encode() + b"\x00"


class AdapterStore:
    """Residency manager for one engine's adapter bank on ``device`` (None
    = ``"cuda"``; the engine's device). ``host`` is the shared ``{name:
    adapter weights}`` dict: pass the same dict into every rebuild so
    registered tenants survive crash recovery. Entries already in ``host``
    are validated and served on demand."""

    # per-process store identity: a fleet's replicas share ONE
    # ServeMetrics, and the lifetime->delta swap accounting is kept per
    # store so N stores' counters sum instead of ratcheting to the max
    _ids = itertools.count()

    def __init__(self, cfg, rank: int, n_slots: int, host: dict | None = None,
                 device=None):
        lora._check_rank(cfg.d_model, rank)
        if n_slots < 1:
            raise ValueError("AdapterStore needs at least one slot")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.rank = int(rank)
        self.n_rows = int(n_slots) + 1
        self._host: dict = host if host is not None else {}
        for name, weights in self._host.items():
            validate_adapter_name(name)
            lora.check_adapter_shapes(weights, cfg, rank)
        self.bank = lora.stack_adapters(
            [lora.zero_adapter(cfg, rank, self.device)] * self.n_rows)
        self._upload = make_adapter_bank_update()
        self._ver: dict[str, int] = {}          # name -> host version
        self._rows: list = [None] * self.n_rows  # row -> (name, ver) | None
        self._refs = [0] * self.n_rows           # row -> in-flight requests
        self._latest: dict[str, int] = {}        # name -> row of current ver
        self._swaps = 0                          # lifetime device uploads
        self._sid = next(AdapterStore._ids)

    # -- host side (no device work) ------------------------------------

    def register(self, name: str, weights: dict) -> None:
        """Add or hot-swap a named adapter, host-side only. Registering a
        live name bumps its version: in-flight requests keep the old row,
        the next admission uploads the new weights. The version counts the
        registrations THIS store saw, so the stores of a fleet sharing one
        host dict version alike whatever the registration order."""
        validate_adapter_name(name)
        lora.check_adapter_shapes(weights, self.cfg, self.rank)
        self._host[name] = weights
        self._ver[name] = self._ver.get(name, -1) + 1
        self._latest.pop(name, None)  # any resident row is now stale

    def names(self) -> tuple:
        return tuple(sorted(self._host))

    def is_registered(self, name: str) -> bool:
        return name in self._host

    def is_resident(self, name: str) -> bool:
        """True when the CURRENT version of ``name`` is uploaded — the
        router's adapter-affinity probe."""
        return name in self._latest

    def namespace_of(self, name: str | None) -> bytes:
        """The version-qualified prefix-cache namespace of ``name``'s
        current registration (``None``: the base model's empty one). A
        hot-swap changes it, so the old version's cached K/V is never
        reused."""
        if name is None:
            return b""
        return adapter_namespace(f"{name}@{self._ver.get(name, 0)}")

    def row_of(self, name: str) -> int:
        return self._latest[name]

    # -- device side (tick boundaries only: the engine's admission gate) --

    @torch.no_grad()
    def ensure_resident(self, name: str) -> int:
        """Upload ``name``'s current version if needed; return its row."""
        if name not in self._host:
            raise KeyError(f"adapter {name!r} is not registered")
        row = self._latest.get(name)
        if row is not None:
            return row
        row = self._alloc()
        # in place, in stream order: a tick launched before this copy
        # reads the row's old contents, every later one the new
        self._upload(self.bank, row, self._host[name])
        self._rows[row] = (name, self._ver.get(name, 0))
        self._latest[name] = row
        self._swaps += 1
        return row

    def _alloc(self) -> int:
        """A zero-ref row to overwrite: never row 0; empty rows first,
        then stale versions, then a resident mapping (evicted)."""
        def key(i):
            held = self._rows[i]
            if held is None:
                return 0
            return 1 if self._latest.get(held[0]) != i else 2

        free = [i for i in range(1, self.n_rows) if self._refs[i] == 0]
        if not free:  # pragma: no cover - structurally unreachable
            raise RuntimeError(
                "adapter bank exhausted: every row referenced — admission "
                "gating should have made this impossible")
        row = min(free, key=lambda i: (key(i), i))
        held = self._rows[row]
        if held is not None and self._latest.get(held[0]) == row:
            del self._latest[held[0]]
        self._rows[row] = None
        return row

    def retain(self, name: str) -> int:
        """Admission-gate entry: ensure residency and take a ref; the
        request releases it (by row) when it leaves the engine."""
        row = self.ensure_resident(name)
        self._refs[row] += 1
        return row

    def release(self, row: int) -> None:
        if row <= 0:
            return
        if self._refs[row] <= 0:
            raise RuntimeError(f"adapter bank row {row} released with no "
                               f"outstanding refs")
        self._refs[row] -= 1

    # -- accounting ----------------------------------------------------

    @property
    def resident_bytes(self) -> int:
        """Device bytes the bank pins: the whole static allocation."""
        return lora.bank_bytes(self.n_rows, self.cfg.n_layers,
                               self.cfg.d_model, self.rank)

    @property
    def swaps_total(self) -> int:
        return self._swaps

    def stats(self) -> dict:
        """The metrics hook payload (``on_tick(adapter_stats=...)``);
        ``store`` identifies this store for the per-store swap deltas."""
        return {"resident_bytes": self.resident_bytes,
                "swaps_total": self._swaps,
                "n_resident": len(self._latest),
                "n_rows": self.n_rows,
                "rank": self.rank,
                "store": self._sid}
