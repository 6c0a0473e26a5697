"""The serving request object (port of ``serve/request.py``).

One :class:`Request` is one user sequence moving through the engine:
``QUEUED`` (waiting for a slot) → ``ACTIVE`` (owns a slot, prefilling then
decoding) → ``DONE`` (EOS or ``max_new_tokens``), or → ``SHED`` (cancelled
with a structured reason). Sampling is per request — greedy or
temperature with optional top-k / top-p — from an independent key stream
seeded by ``seed``, so each request's tokens equal its solo decode.

TTFT (queue wait + prefill) and TPOT (decode cadence) are stamped by the
engine on the host clock.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

QUEUED = "queued"
ACTIVE = "active"
DONE = "done"
SHED = "shed"


@dataclasses.dataclass
class Request:
    """One sequence's serving state; constructed via ``engine.submit``."""

    rid: int
    prompt: np.ndarray                  # [T0] int32 tokens
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int | None = None
    top_p: float | None = None
    eos_id: int | None = None
    seed: int = 0
    # streaming: called with (request, token:int) as each token materialises
    on_token: Callable | None = None
    # traffic class (per-class metrics) and scheduling priority
    cls: str | None = None
    priority: int = 0
    # deadlines relative to submit_time: stored here, enforced by the
    # serve supervisor at tick boundaries (``serve/supervisor.py``)
    ttft_deadline_s: float | None = None
    deadline_s: float | None = None
    # the LoRA adapter the request decodes under (journal key ``adp``);
    # None = the base model
    adapter: str | None = None

    # -- lifecycle (engine-owned) -----------------------------------------
    state: str = QUEUED
    slot: int | None = None
    # chunked prefill: next prompt position to compute while admitted but
    # not yet decoding (None once seated)
    prefill_pos: int | None = None
    tokens: list[int] = dataclasses.field(default_factory=list)
    key_data: np.ndarray | None = None  # live PRNG key data (uint32 [2])
    # speculative decoding: the draft model's own key stream (set by the
    # engine when a draft is configured, :func:`draft_key_data`), so
    # sampled proposals never consume the target stream's splits
    draft_key_data: np.ndarray | None = None
    submit_time: float | None = None
    first_token_time: float | None = None
    done_time: float | None = None
    finish_reason: str | None = None    # "eos" | "length" | a shed reason
    # migration cause of the last journal ``snap`` for this request (the
    # record's ``why`` key); None for never-migrated requests
    snap_reason: str | None = None
    # preemption: re-admission recomputes K/V from `resume_seq` without
    # touching the key stream, so the continued decode is unchanged
    n_preempted: int = 0
    # boarding order (set at admission): the priority scheduler's
    # newest-first victim pick
    _board_seq: int = -1
    # the adapter bank row this request holds while it owns a slot (0 =
    # the base row), pinned at boarding by the engine's admission gate
    _adapter_row: int = 0
    # the version-qualified prefix-cache namespace of its adapter
    # (``AdapterStore.namespace_of``); None without an adapter store
    _prefix_ns: bytes | None = None

    @property
    def resume_seq(self) -> np.ndarray:
        """The sequence (re-)admission must have K/V for: the prompt plus,
        after a preemption, every emitted token except the newest."""
        if not self.tokens:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens[:-1], np.int32)])

    @property
    def resume_max_new(self) -> int:
        """Remaining budget paired with :attr:`resume_seq`, so the pool's
        worst-case row bound stays ``prompt_len + max_new_tokens - 1``."""
        return self.max_new_tokens - max(0, len(self.tokens) - 1)

    @property
    def ttft_s(self) -> float | None:
        if self.submit_time is None or self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time

    @property
    def tpot_s(self) -> float | None:
        """Mean time per output token after the first (None for 1-token
        requests)."""
        if (self.first_token_time is None or self.done_time is None
                or len(self.tokens) < 2):
            return None
        return (self.done_time - self.first_token_time) / (len(self.tokens) - 1)

    def emit(self, token: int) -> None:
        self.tokens.append(int(token))
        if self.on_token is not None:
            self.on_token(self, int(token))

    def finished_by(self, token: int) -> str | None:
        """Finish reason if ``token`` (just emitted) terminates the request."""
        if self.eos_id is not None and int(token) == self.eos_id:
            return "eos"
        if len(self.tokens) >= self.max_new_tokens:
            return "length"
        return None


def draft_key_data(seed: int) -> np.ndarray:
    """The draft's key data for a request seeded ``seed``: derived from
    the seed and disjoint from the target's ``key_data(seed)`` stream (the
    JAX engine's ``fold_in(key(seed), 1)``), so greedy streams, which
    consume neither, stay equal to solo decode."""
    from simple_distributed_machine_learning_tpu_torch.ops.random import (
        fold_in,
        key_data,
    )
    return key_data(fold_in(seed, 1))


def validate_request(prompt: np.ndarray, max_new_tokens: int,
                     temperature: float, top_k: int | None,
                     top_p: float | None, vocab: int, max_len: int) -> None:
    """Submit-time validation; sampling args go through the decoders' own
    ``_check_sampling_args``, so a request the engine accepts is one
    ``make_cached_decoder`` accepts."""
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        _check_sampling_args,
    )
    prompt = np.asarray(prompt)
    if prompt.ndim != 1 or prompt.shape[0] < 1:
        raise ValueError(
            f"prompt must be a non-empty 1-D token array, got shape "
            f"{prompt.shape}")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if prompt.shape[0] + max_new_tokens > max_len:
        raise ValueError(
            f"prompt {prompt.shape[0]} + max_new_tokens {max_new_tokens} "
            f"exceeds the pool's sequence budget {max_len}")
    if prompt.min() < 0 or prompt.max() >= vocab:
        raise ValueError(f"prompt tokens outside [0, vocab={vocab})")
    _check_sampling_args(temperature, top_k, top_p, vocab)
