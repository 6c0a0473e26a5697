"""The serving-program registry, the serving byte model and the kernel
half of the registry (port of ``analysis/programs.py``: ROADMAP.md, Queue
A, items 7.3 and 7.4).

**The program registry.** :func:`build_registry` builds every program one
serving deployment runs — the ``models/gpt.py`` builders' programs
(prefill or chunk, decode, CoW copy, the adapter upload, the draft's
propose, the verify, the fused speculative tick) plus the composite ticks
that thread the pool through them as ``serve/engine.py`` does, and the
solo-parity cached decoder — with fake arguments carrying the contracts
the host side (``serve/slots.py``) keeps (``analysis.spec``: tokens,
positions, block tables, adapter rows) and the host ints the port's
programs read (a chunk's start at its contract's worst case).
:func:`lint_serve` traces and lints each (``analysis.analyze``: the
scatter-bounds pass, in-place buffer flow, the kernel nodes' launch
specs), adds the build-memo and retrace-policy checks
(:func:`check_builder_memo`, a retrace finding per unbounded program
shape) and reconciles the K/V bytes the traced K4 nodes derive with the
byte model's rows; :func:`lint_engine` lints a live engine's own programs
(``InferenceEngine(lint=True)``), :func:`default_registry_reports` the
CI sweep (``--serve`` in the analysis CLI). Trace-only: nothing launches.

**The HBM-bytes-per-tick model.** :class:`ServeSpec` describes one
serving deployment statically (layout, block geometry, slots, cache
dtype, speculation, adapters, the host tier). :func:`hbm_tick_costs`
gives the K/V bytes each program of a tick streams, and the ``predict_*``
functions what the pool's gauges must read:

- :func:`predict_kv_bytes_resident` — ``serve_kv_bytes_resident`` for the
  live sequences' written-row counts; the engine checks it every tick
  (``InferenceEngine.kv_drift``, the ``serve_kv_drift_bytes`` gauge);
- :func:`predict_adapter_bytes` — ``serve_adapter_resident_bytes``;
- :func:`predict_host_kv_bytes` / :func:`predict_transfer_bytes` — the
  host tier's ``serve_host_bytes_resident`` and
  ``serve_host_transfer_bytes_total``.

Each bills in the pool's own units (``serve/slots.py::kv_block_bytes``,
``models/lora.py::bank_bytes``), so a clean run's drift is exactly 0.

**The kernel registry.** :func:`kernel_registry_reports` builds the JAX
registry's tiny GPT over the same :class:`ServeSpec` list and, for each
layout that runs the paged-attention kernel K4 (``attn_kernel="fused"``),
drives one engine through a prefill and a decode (or verify) tick under
``kernels.record_launches()``, lints the launches it recorded with the
contracts the registry declares (tables ``[0, n_blocks]``, positions
``[0, NB*bs-1]``), derives their HBM rows (``kernels.kernel_hbm_costs``)
and reconciles them with :func:`hbm_tick_costs` exactly — the
``--serve-kernel`` preflight, on launches that really ran.

``SDML_LINT_INJECT=<tag>`` (environment) appends one seeded ERROR finding
to every registry report — the drill that proves the gate exits nonzero
(never set it in a real launch).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any

from simple_distributed_machine_learning_tpu_torch.analysis.report import (
    Finding,
    HBMCost,
    Report,
    Severity,
)


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """Static description of one serving deployment.

    ``prompt_lens`` declares the deployment's prompt-length buckets;
    ``spec_k``/``draft_cfg`` speculative decoding; ``attn_kernel`` the
    decode/verify attention path: ``"dense"`` (gather, then dense math:
    two passes over resident K/V per tick) or ``"fused"`` (K4's single
    pass). ``host_cache_blocks`` sizes the host offload tier (0 = off),
    whose uploads take ``prefetch_ticks`` ticks; ``n_adapters`` is the
    adapter bank's total row count (the engine's rule is n_slots + 1) and
    ``adapter_rank`` each row's rank (0 = no adapters). Tensor
    parallelism rides in ``cfg.n_tensor_parallel`` (:attr:`tp`)."""
    cfg: Any
    n_slots: int = 4
    max_len: int | None = None          # None -> cfg.seq_len
    kv_layout: str = "paged"
    block_size: int = 16
    n_blocks: int | None = None         # None -> dense-equivalent capacity
    prefill_chunk: int | None = None
    cache_dtype: Any = None
    prompt_lens: tuple | None = None
    spec_k: int = 0                     # 0 -> plain decode (no draft)
    draft_cfg: Any = None
    attn_kernel: str = "dense"
    host_cache_blocks: int = 0
    prefetch_ticks: int = 1
    n_adapters: int = 0
    adapter_rank: int = 0

    @property
    def adapters_on(self) -> bool:
        return self.n_adapters > 0 and self.adapter_rank > 0

    @property
    def tp(self) -> int:
        """Tensor-parallel width — the cfg's own knob."""
        return int(getattr(self.cfg, "n_tensor_parallel", 1))

    @property
    def ml(self) -> int:
        return int(self.max_len if self.max_len is not None
                   else self.cfg.seq_len)

    @property
    def blocks_per_seq(self) -> int:
        return math.ceil(self.ml / self.block_size)

    @property
    def nb(self) -> int:
        """Resolved pool capacity in blocks (the engine's default rule)."""
        if self.n_blocks is not None:
            return int(self.n_blocks)
        return self.n_slots * self.blocks_per_seq

    @property
    def resolved_chunk(self) -> int:
        """The prefill-chunk length a tick runs: the declared chunk, else
        the largest prompt bucket, else 8; clamped to [1, ml-1]."""
        c = self.prefill_chunk
        if c is None:
            c = int(max(self.prompt_lens)) if self.prompt_lens else 8
        return max(1, min(int(c), self.ml - 1))


def cfg_dense(cfg):
    """The single-device twin of a (possibly TP) serving config."""
    if getattr(cfg, "n_tensor_parallel", 1) == 1:
        return cfg
    return dataclasses.replace(cfg, n_tensor_parallel=1)


def degraded_spec(sspec: ServeSpec) -> ServeSpec:
    """The serve supervisor's degraded-fallback deployment for ``sspec``:
    the transform ``serve/supervisor.py::engine_factory`` applies past
    ``degrade_after`` restarts — speculation off, tensor parallelism off,
    dense slot rows, a quantised cache widened to f32; the adapter bank
    survives."""
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        _is_quantized_dtype,
    )
    return ServeSpec(cfg_dense(sspec.cfg), n_slots=sspec.n_slots,
                     max_len=sspec.max_len, kv_layout="dense",
                     cache_dtype=(None
                                  if _is_quantized_dtype(sspec.cache_dtype)
                                  else sspec.cache_dtype),
                     prompt_lens=sspec.prompt_lens,
                     n_adapters=sspec.n_adapters,
                     adapter_rank=sspec.adapter_rank)


# -- the HBM-bytes-per-tick model ------------------------------------------

def hbm_tick_costs(sspec: ServeSpec, n_layers: int | None = None
                   ) -> list[HBMCost]:
    """Static K/V traffic per serve tick. Shapes are static — the batched
    decode reads EVERY slot's full table span every tick regardless of
    occupancy — so the per-tick streams depend on block geometry and slot
    count only; occupancy changes the RESIDENT bytes
    (:func:`predict_kv_bytes_resident`). One position's row (K + V, one
    layer, per shard) is the pool's own ``kv_block_bytes``, so quantised
    caches bill their f32 scale planes too."""
    from simple_distributed_machine_learning_tpu_torch.serve.slots import (
        kv_block_bytes,
    )
    cfg = sspec.cfg
    L = n_layers if n_layers is not None else cfg.n_layers
    H, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    S, ml = sspec.n_slots, sspec.ml
    tp = sspec.tp
    row = kv_block_bytes(1, H // tp, 1, dh, sspec.cache_dtype)
    shard = f" (per {tp}-way shard)" if tp > 1 else ""
    fused = sspec.attn_kernel == "fused"
    out: list[HBMCost] = []
    K = int(sspec.spec_k)
    if sspec.kv_layout == "paged":
        span = sspec.blocks_per_seq * sspec.block_size
        out.append(HBMCost(
            "decode.kv_gather", "paged_decode", S * L * span * row,
            note=f"{S} slots x {L} layers x {span}-row table span{shard}"
                 + (" — the fused kernel's single pass" if fused else "")))
        if not fused:
            # gather-then-dense materializes the gathered span and the
            # attention einsums read it back: a SECOND full pass of
            # resident K/V per tick, which the fused kernel eliminates
            out.append(HBMCost(
                "decode.kv_attn_reread", "paged_decode",
                S * L * span * row,
                note=f"dense-math path rereads the materialized "
                     f"span{shard}; eliminated by kernel='fused'"))
        out.append(HBMCost(
            "decode.kv_scatter", "paged_decode", S * L * row,
            note=f"one position per slot per layer{shard}"))
        c = sspec.resolved_chunk
        out.append(HBMCost(
            "prefill.kv_scatter", "paged_prefill_chunk", c * L * row,
            note=f"{c}-token chunk{shard}"))
        out.append(HBMCost(
            "prefill.kv_gather", "paged_prefill_chunk", L * span * row,
            note=f"the chunk attends the gathered table span{shard}"))
        out.append(HBMCost(
            "cow.block_copy", "paged_block_copy",
            L * sspec.block_size * row,
            note=f"per copy-on-write divergence, all layers{shard}"))
        if sspec.host_cache_blocks:
            # one whole block (all layers, K+V, scale planes) crosses the
            # device<->host boundary per demotion and per promotion
            blk = kv_block_bytes(L, H // tp, sspec.block_size, dh,
                                 sspec.cache_dtype)
            out.append(HBMCost(
                "offload.demote_copy", "host_offload", blk,
                note=f"per HBM->host demotion: the evicted block, all "
                     f"layers{shard} — an eviction that would otherwise "
                     f"discard the prefix"))
            out.append(HBMCost(
                "offload.prefetch_upload", "host_offload", blk,
                note=f"per host->HBM promotion: one async-prefetched "
                     f"block, all layers{shard}, spread over "
                     f"{sspec.prefetch_ticks} tick(s)"))
        if K >= 2:
            out.append(HBMCost(
                "verify.kv_scatter", "paged_verify", S * L * K * row,
                note=f"{K} speculated positions per slot per layer{shard}"))
            out.append(HBMCost(
                "verify.kv_gather", "paged_verify", S * L * span * row,
                note=f"the verify queries attend the table span{shard}"
                     + (" — the fused kernel's single pass" if fused
                        else "")))
            if not fused:
                out.append(HBMCost(
                    "verify.kv_attn_reread", "paged_verify",
                    S * L * span * row,
                    note=f"dense-math path rereads the materialized "
                         f"span{shard}; eliminated by kernel='fused'"))
    else:
        out.append(HBMCost(
            "decode.kv_read", "slot_decode", S * L * ml * row,
            note=f"{S} rows x {L} layers x max_len={ml}{shard}"))
        out.append(HBMCost(
            "decode.kv_scatter", "slot_decode", S * L * row,
            note=f"one position per slot per layer{shard}"))
        if K >= 2:
            out.append(HBMCost(
                "verify.kv_scatter", "slot_verify", S * L * K * row,
                note=f"{K} speculated positions per slot per layer{shard}"))
            out.append(HBMCost(
                "verify.kv_read", "slot_verify", S * L * ml * row,
                note=f"the verify queries read the full rows{shard}"))
    if sspec.adapters_on:
        # each slot gathers its tenant's whole A/B row per decode
        # dispatch, prefill gathers one row, and every hot-swap or first
        # admission writes one row: billed with the resident gauge's own
        # formula (models/lora.py::bank_bytes)
        from simple_distributed_machine_learning_tpu_torch.models import lora
        row_b = lora.bank_bytes(1, L, cfg.d_model, sspec.adapter_rank)
        paged = sspec.kv_layout == "paged"
        out.append(HBMCost(
            "decode.adapter_gather",
            "paged_decode" if paged else "slot_decode", S * row_b,
            note=f"{S} slots x one bank row ({L} layers, 4 low-rank "
                 f"planes, rank {sspec.adapter_rank}) — row 0 (base) "
                 f"gathers the same bytes of zeros"))
        out.append(HBMCost(
            "prefill.adapter_gather",
            "paged_prefill_chunk" if paged else "slot_prefill", row_b,
            note="the boarding request's one bank row"))
        out.append(HBMCost(
            "adapter.bank_upload", "adapter_bank_update", row_b,
            note="per hot-swap / first admission: one donated bank-row "
                 "rewrite (serve_adapter_swaps_total advances by 1)"))
    if K >= 2 and sspec.draft_cfg is not None:
        from simple_distributed_machine_learning_tpu_torch.models.gpt import (
            _is_quantized_dtype,
        )
        dcfg = sspec.draft_cfg
        # the draft pool is dense slot rows; a quantised TARGET dtype
        # gives the draft an f32 pool (the engine's rule)
        draft_cd = (None if _is_quantized_dtype(sspec.cache_dtype)
                    else sspec.cache_dtype)
        drow = kv_block_bytes(1, dcfg.n_heads, 1,
                              dcfg.d_model // dcfg.n_heads, draft_cd)
        dL = dcfg.n_layers
        out.append(HBMCost(
            "propose.kv_read", "slot_propose", K * S * dL * ml * drow,
            note=f"{K} draft steps x {S} rows x {dL} draft layers x "
                 f"max_len={ml} (replicated draft)"))
        out.append(HBMCost(
            "propose.kv_scatter", "slot_propose", K * S * dL * drow,
            note="one position per draft step per slot per draft layer"))
    return out


def predict_kv_bytes_resident(sspec: ServeSpec, rows_per_seq,
                              n_layers: int | None = None) -> int:
    """Model of the pool's ``serve_kv_bytes_resident`` gauge: bytes the
    given live sequences pin, each entry of ``rows_per_seq`` one
    sequence's written-row count (``prompt_len + tokens_emitted - 1``
    once decoding). Assumes no prefix sharing — shared blocks make the
    true gauge strictly smaller, never larger, which makes the runtime
    drift gauge (live − predicted) a leak detector: 0 without sharing,
    ≤ 0 with it, > 0 only if the pool pins blocks no live sequence can
    need. Dense layout: the pool pins every row up front, so the
    prediction is the full allocation. Per shard under TP."""
    from simple_distributed_machine_learning_tpu_torch.serve.slots import (
        kv_block_bytes,
    )
    cfg = sspec.cfg
    L = n_layers if n_layers is not None else cfg.n_layers
    if sspec.kv_layout == "dense":
        per_row = kv_block_bytes(L, cfg.n_heads // sspec.tp, sspec.ml,
                                 cfg.d_model // cfg.n_heads,
                                 sspec.cache_dtype)
        return per_row * sspec.n_slots
    blocks = sum(math.ceil(r / sspec.block_size) for r in rows_per_seq)
    return blocks * _host_block_bytes(sspec, L)


def predict_adapter_bytes(sspec: ServeSpec,
                          n_layers: int | None = None) -> int:
    """Model of the AdapterStore's ``serve_adapter_resident_bytes`` gauge:
    the device bank's whole static allocation, with the store's own
    formula (``models/lora.py::bank_bytes``)."""
    if not sspec.adapters_on:
        return 0
    from simple_distributed_machine_learning_tpu_torch.models import lora
    cfg = sspec.cfg
    L = n_layers if n_layers is not None else cfg.n_layers
    return lora.bank_bytes(sspec.n_adapters, L, cfg.d_model,
                           sspec.adapter_rank)


def _host_block_bytes(sspec: ServeSpec, n_layers: int | None = None) -> int:
    """One paged block's bytes for ``sspec`` — the pool's own
    ``bytes_per_block`` (per shard; quantised scale planes included)."""
    from simple_distributed_machine_learning_tpu_torch.serve.slots import (
        kv_block_bytes,
    )
    cfg = sspec.cfg
    L = n_layers if n_layers is not None else cfg.n_layers
    return kv_block_bytes(L, cfg.n_heads // sspec.tp, sspec.block_size,
                          cfg.d_model // cfg.n_heads, sspec.cache_dtype)


def predict_host_kv_bytes(sspec: ServeSpec, n_host_blocks: int,
                          n_layers: int | None = None) -> int:
    """Model of the pool's ``serve_host_bytes_resident`` gauge: the host
    tier stores whole blocks, so blocks x ``bytes_per_block``."""
    return n_host_blocks * _host_block_bytes(sspec, n_layers)


def predict_transfer_bytes(sspec: ServeSpec, n_blocks: int,
                           n_layers: int | None = None) -> int:
    """Model of the pool's ``serve_host_transfer_bytes_total`` counter:
    every block crossing the device↔host boundary (``host_demotes_total +
    host_promotes_total`` moves) moves exactly ``bytes_per_block``."""
    return n_blocks * _host_block_bytes(sspec, n_layers)


def engine_spec(engine, prompt_lens: tuple | None = None) -> ServeSpec:
    """The :class:`ServeSpec` of a LIVE engine — the one engine->spec
    mapping, shared by the registry and the runtime KV-drift gauge.
    ``prompt_lens`` are the prompt buckets to declare (None: none, as the
    gauge passes)."""
    pool = engine.pool
    paged = engine.kv_layout == "paged"
    adapters = getattr(engine, "_adapters", None)
    return ServeSpec(
        cfg=engine.cfg, n_slots=pool.n_slots, max_len=engine.max_len,
        kv_layout=engine.kv_layout,
        block_size=pool.block_size if paged else 16,
        n_blocks=pool.n_blocks if paged else None,
        prefill_chunk=engine.prefill_chunk,
        # the storage dtype (a quantised pool's narrow one)
        cache_dtype=pool.cache_dtype, prompt_lens=prompt_lens,
        spec_k=engine.spec_k if engine.speculative else 0,
        draft_cfg=engine.draft_cfg,
        attn_kernel=engine.attn_kernel,
        host_cache_blocks=getattr(pool, "host_cache_blocks", 0),
        prefetch_ticks=getattr(pool, "prefetch_ticks", 1),
        n_adapters=0 if adapters is None else adapters.n_rows,
        adapter_rank=0 if adapters is None else adapters.rank)


# -- the kernel registry ----------------------------------------------------

def _injected_findings() -> list[Finding]:
    tag = os.environ.get("SDML_LINT_INJECT")
    if not tag:
        return []
    return [Finding(
        rule=f"injected.{tag}", severity=Severity.ERROR,
        message="seeded ERROR finding injected via SDML_LINT_INJECT — the "
                "gate drill proving --lint preflights actually fail",
        where="SDML_LINT_INJECT", hint="unset SDML_LINT_INJECT")]


def _reconcile_kernel_hbm(kernel_rows: list[HBMCost],
                          model_rows: list[HBMCost],
                          sspec: ServeSpec, n_shards: int | None = None
                          ) -> list[Finding]:
    """Cross-check the K/V stream bytes derived from the recorded launches
    against the tick model's gather rows: the fused kernel's claim — one
    read of resident K/V per tick — is computed from the launches' own
    specs, not asserted. The two agree EXACTLY or the gate fails. A TP
    program launches once per model coordinate this process runs
    (``n_shards``; None: all ``tp``), each on its shard, where the model
    bills one shard: the launches stream ``n_shards`` times its row."""
    if sspec.attn_kernel != "fused":
        return []
    tp = sspec.tp if n_shards is None else n_shards
    derived: dict[str, int] = {}
    for h in kernel_rows:
        if h.op == "kernel.kv_stream":
            derived[h.program] = derived.get(h.program, 0) + h.bytes_per_tick
    model = {(m.program, m.op): m.bytes_per_tick for m in model_rows}
    out: list[Finding] = []
    for prog, op in (("paged_decode", "decode.kv_gather"),
                     ("paged_verify", "verify.kv_gather")):
        want = model.get((prog, op))
        if want is None:
            continue
        want *= tp
        got = derived.get(prog)
        if got is None:
            out.append(Finding(
                rule="kernel-hbm.mismatch", severity=Severity.ERROR,
                message=(f"attn_kernel='fused' but no kernel K/V stream "
                         f"was recorded in {prog} — the registry linted a "
                         f"program that is not running the kernel it "
                         f"claims"),
                where=prog,
                hint="the engine or the registry dropped the fused "
                     "kernel path; rebuild with kernel='fused' plumbed "
                     "through"))
        elif got != want:
            out.append(Finding(
                rule="kernel-hbm.mismatch", severity=Severity.ERROR,
                message=(f"{prog}: the recorded launches stream {got} K/V "
                         f"bytes/tick but the HBM tick model's {op} row "
                         f"says {want // tp}"
                         + (f" per shard ({want} over {tp} shards)"
                            if tp > 1 else "")
                         + " — the fused single-pass claim no longer "
                           "matches the kernel itself"),
                where=prog,
                hint="hbm_tick_costs and the kernel's launch spec are one "
                     "contract: fix whichever drifted"))
    return out


def registry_config():
    """The registry's tiny GPT config and its one-layer draft's."""
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        GPTConfig,
    )
    cfg = GPTConfig(vocab=32, seq_len=24, d_model=16, n_heads=2, n_layers=2)
    return cfg, dataclasses.replace(cfg, n_layers=1)


def registry_specs(cfg, draft_cfg) -> list[ServeSpec]:
    """The JAX registry sweep's deployments (``default_registry_reports``)
    in its order, the degraded fallback of the speculative paged layout
    last."""
    buckets = (4, 8, 12)
    spec_paged = ServeSpec(cfg, n_slots=4, kv_layout="paged", block_size=4,
                           prefill_chunk=3, prompt_lens=buckets, spec_k=4,
                           draft_cfg=draft_cfg, attn_kernel="fused")
    return [
        ServeSpec(cfg, n_slots=4, kv_layout="paged", block_size=4,
                  prefill_chunk=3, prompt_lens=buckets),
        ServeSpec(cfg, n_slots=4, kv_layout="paged", block_size=8,
                  prefill_chunk=None, prompt_lens=buckets),
        ServeSpec(cfg, n_slots=4, kv_layout="paged", block_size=4,
                  prefill_chunk=3, prompt_lens=buckets,
                  cache_dtype="int8", attn_kernel="fused"),
        ServeSpec(cfg, n_slots=4, kv_layout="dense", prompt_lens=buckets),
        ServeSpec(cfg, n_slots=4, kv_layout="paged", block_size=4,
                  prefill_chunk=3, prompt_lens=buckets, n_adapters=5,
                  adapter_rank=2),
        ServeSpec(cfg, n_slots=4, kv_layout="dense", prompt_lens=buckets,
                  n_adapters=5, adapter_rank=2),
        spec_paged,
        ServeSpec(cfg, n_slots=4, kv_layout="dense", prompt_lens=buckets,
                  spec_k=4, draft_cfg=draft_cfg),
        degraded_spec(spec_paged),
    ]


def serve_label(sspec: ServeSpec) -> str:
    """The registry's name for a deployment (the JAX ``lint_serve``
    label)."""
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        _cache_dtype,
        _dtype_name,
    )
    return (f"serve[{sspec.kv_layout} slots={sspec.n_slots} "
            f"max_len={sspec.ml}"
            + (f" block={sspec.block_size} chunk={sspec.prefill_chunk}"
               if sspec.kv_layout == "paged" else "")
            + (" kernel=fused" if sspec.attn_kernel == "fused" else "")
            + (f" cache={_dtype_name(_cache_dtype(sspec.cache_dtype))}"
               if sspec.cache_dtype is not None else "")
            + (f" tp={sspec.tp}" if sspec.tp > 1 else "")
            + (f" spec_k={sspec.spec_k}" if sspec.spec_k else "")
            + (f" adapters={sspec.n_adapters}r{sspec.adapter_rank}"
               if sspec.adapters_on else "") + "]")


def kernel_contracts(sspec: ServeSpec) -> dict:
    """The contracts the registry declares on K4's tables: block-table
    entries within the pool (``[0, n_blocks]``, trash block 0 included),
    query positions within the table span."""
    return dict(tables=(0, sspec.nb),
                qpos=(0, sspec.blocks_per_seq * sspec.block_size - 1))


#: ticks :func:`tick_launches` steps at most before giving up
_MAX_RECORD_TICKS = 32


def tick_launches(engine) -> dict[str, list]:
    """Step ``engine`` (a request already submitted) under
    ``kernels.record_launches()`` until a tick launches the paged kernel,
    at most ``_MAX_RECORD_TICKS`` ticks; returns that tick's launch specs
    under its program's name, ``paged_verify`` for a speculative engine,
    else ``paged_decode``."""
    from simple_distributed_machine_learning_tpu_torch.analysis import (
        kernels,
    )
    prog = "paged_verify" if engine.speculative else "paged_decode"
    for _ in range(_MAX_RECORD_TICKS):
        with kernels.record_launches() as log:
            engine.step()
        if log:
            return {prog: log}
        if not engine.busy:
            break
    return {}


def _fused_engine(stages, sspec: ServeSpec, spec_k: int, draft_stages,
                  device):
    """A fused paged engine of ``sspec`` (speculative at ``spec_k`` >= 2)
    with one request of the smallest prompt bucket submitted; a TP spec
    serves over a one-device model mesh of its width."""
    import numpy as np

    from simple_distributed_machine_learning_tpu_torch._device import (
        resolve_device,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (
        make_mesh,
    )
    from simple_distributed_machine_learning_tpu_torch.serve import (
        InferenceEngine,
    )
    mesh = (make_mesh(1, n_model=sspec.tp,
                      devices=[resolve_device(device)] * sspec.tp)
            if sspec.tp > 1 else None)
    engine = InferenceEngine(
        stages, sspec.cfg, n_slots=sspec.n_slots, max_len=sspec.max_len,
        cache_dtype=sspec.cache_dtype, kv_layout="paged",
        block_size=sspec.block_size, n_blocks=sspec.n_blocks,
        prefill_chunk=sspec.prefill_chunk, attn_kernel="fused",
        draft_stages=draft_stages if spec_k else None,
        draft_cfg=sspec.draft_cfg if spec_k else None, spec_k=spec_k,
        mesh=mesh, device=device)
    plen = min(sspec.prompt_lens or (4,))
    engine.submit(np.arange(plen, dtype=np.int32) % sspec.cfg.vocab,
                  max_new_tokens=spec_k + 2)
    return engine


def kernel_report(stages, sspec: ServeSpec, name: str | None = None,
                  draft_stages=None, device=None) -> Report:
    """One deployment's kernel report: for a fused paged layout, the lint
    of the launches of one prefill + decode tick (and, speculative, of a
    second engine's prefill + verify tick — the JAX registry traces both
    programs) under :func:`kernel_contracts`, their derived HBM rows
    beside :func:`hbm_tick_costs`, and the reconciliation; for any other
    layout the model rows alone."""
    from simple_distributed_machine_learning_tpu_torch.analysis import (
        kernels,
    )
    label = name or serve_label(sspec)
    report = Report(name=label)
    kernel_rows: list[HBMCost] = []
    if sspec.kv_layout == "paged" and sspec.attn_kernel == "fused":
        contracts = kernel_contracts(sspec)
        ks = (0, sspec.spec_k) if sspec.spec_k >= 2 else (0,)
        for k in ks:
            engine = _fused_engine(stages, sspec, k, draft_stages, device)
            for prog, specs in tick_launches(engine).items():
                specs = [s.with_contracts(**contracts) for s in specs]
                for f in (f for s in specs for f in kernels.lint(s)):
                    report.findings.append(dataclasses.replace(
                        f, where=f"{prog}: {f.where}"))
                kernel_rows += kernels.kernel_hbm_costs(specs, program=prog)
    model_rows = hbm_tick_costs(sspec, n_layers=sspec.cfg.n_layers)
    report.hbm.extend(kernel_rows + model_rows)
    report.findings.extend(
        _reconcile_kernel_hbm(kernel_rows, model_rows, sspec))
    report.findings.extend(_injected_findings())
    return report


def kernel_registry_reports(device=None) -> list[Report]:
    """The kernel half of the registry sweep (the JAX
    ``default_registry_reports``): the registry's tiny GPT (seed 0, its
    draft seed 1) on ``device`` (None = ``"cuda"``), one report per
    :func:`registry_specs` deployment — the degraded fallback named as
    the JAX sweep names it. Every report must be kernel-clean and
    ERROR-free for ``--serve-kernel`` to pass."""
    from simple_distributed_machine_learning_tpu_torch._device import (
        resolve_device,
    )
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        make_gpt_stages,
    )
    dev = resolve_device(device)
    cfg, draft_cfg = registry_config()
    stages = make_gpt_stages(0, cfg, 1, device=dev)[0]
    draft_stages = make_gpt_stages(1, draft_cfg, 1, device=dev)[0]
    specs = registry_specs(cfg, draft_cfg)
    spec_paged = specs[6]
    reports = [kernel_report(stages, s, draft_stages=draft_stages,
                             device=dev) for s in specs[:-1]]
    reports.append(kernel_report(
        stages, specs[-1], device=dev,
        name=f"serve[degraded fallback of paged spec_k={spec_paged.spec_k}"
             f": dense slots={spec_paged.n_slots} tp=1 spec_k=0]"))
    return reports


# -- the program registry (the traced serving programs) ---------------------

@dataclasses.dataclass(frozen=True)
class Program:
    """One registry entry: a built (memoized) program plus the arguments —
    fake stand-ins with declared contracts, and the host ints the port's
    programs read — that one serve tick would feed it."""
    name: str
    fn: Any
    args: tuple


def check_builder_memo(name: str, build) -> list[Finding]:
    """The ``_DECODE_BUILD_CACHE`` contract, machine-checked: calling a
    decode-path builder twice with identical static config must return
    the SAME program. A builder that returns fresh objects rebuilds per
    engine and test — the retrace-explosion failure mode at the build
    level."""
    first, second = build(), build()
    if first is second:
        return []
    return [Finding(
        rule="retrace-explosion.unmemoized-builder", severity=Severity.ERROR,
        message=(f"builder '{name}' returned a DIFFERENT program for an "
                 f"identical static config — every engine (and every test) "
                 f"constructing it pays a fresh build"),
        where=name,
        hint="route the build through models.gpt._memo_builder (the "
             "_DECODE_BUILD_CACHE) keyed on the static config")]


def _retrace_finding(name: str, axis: str, sspec: ServeSpec) -> list[Finding]:
    """Flag a builder whose program shape follows an unbounded runtime
    value (a per-prompt-length program) unless the deployment bounds
    it."""
    if sspec.prompt_lens is not None:
        return []
    return [Finding(
        rule="retrace-explosion.unbounded-trace-key",
        severity=Severity.WARNING,
        message=(f"'{name}' runs a differently shaped program per distinct "
                 f"{axis}, and this deployment declares no bound on it — "
                 f"under real traffic every new length is a new program "
                 f"shape (the shape set grows without limit)"),
        where=name,
        hint="bucket prompt lengths (ServeSpec.prompt_lens / the "
             "simulator's buckets) or serve the paged layout with a "
             "prefill_chunk, which bounds prefill shapes to the chunk "
             "size")]


def _fake(shape, dtype, device):
    from simple_distributed_machine_learning_tpu_torch.analysis.trace import (
        fake_mode,
    )
    import torch
    with fake_mode():
        return torch.empty(tuple(shape), dtype=dtype, device=device)


def _pool(shape, cache_dtype, device, tp: int = 1, devices=None):
    """Fake pool buffers: one ``shape`` buffer (its head axis, dim 2, split
    ``tp`` ways per coordinate), a :class:`QuantKV` for a quantised
    dtype."""
    import torch

    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        QuantKV,
        _cache_dtype,
        _is_quantized_dtype,
    )

    def one(dev):
        sh = list(shape)
        sh[2] //= tp
        if _is_quantized_dtype(cache_dtype):
            return QuantKV(_fake(sh, _cache_dtype(cache_dtype), dev),
                           _fake(sh[:-1], torch.float32, dev))
        return _fake(sh, _cache_dtype(cache_dtype), dev)

    if tp == 1:
        return one(device)
    return [one(d) for d in (devices or [device] * tp)]


def build_registry(stages, sspec: ServeSpec, mesh=None, draft_stages=None,
                   params=None, device=None, anchor: bool = True
                   ) -> tuple[list[Program], list[Finding]]:
    """Build every program of ``sspec``'s serve path with its arguments and
    contracts; returns (programs, policy findings) where the findings are
    the retrace/memo checks that are not graph rules.

    With ``sspec.tp > 1`` pass the live ``mesh``: the registry builds the
    TP programs a TP engine runs (head-sharded pools, the packed serving
    weights — ``params`` when given, else :func:`pack_tp_serve_params` of
    the stages). With ``sspec.spec_k >= 2`` pass the ``draft_stages``.
    ``device`` (None = ``"cuda"``) is where the programs are built for.
    ``anchor`` adds the solo-parity cached decoder (a program the tests
    hold every served stream to, which no engine tick runs)."""
    import torch

    from simple_distributed_machine_learning_tpu_torch._device import (
        resolve_device,
    )
    from simple_distributed_machine_learning_tpu_torch.analysis.bounds import (
        spec,
    )
    from simple_distributed_machine_learning_tpu_torch.analysis.trace import (
        abstractify,
    )
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        _is_quantized_dtype,
        make_cached_decoder,
        make_paged_block_copy,
        make_paged_decode_step,
        make_paged_prefill_chunk,
        make_slot_decode_step,
        make_slot_prefill,
        pack_tp_serve_params,
        tp_serve_devices,
        tp_serve_shards,
    )

    dev = resolve_device(device)
    cfg = sspec.cfg
    S, ml, bs = sspec.n_slots, sspec.ml, sspec.block_size
    V, H, L = cfg.vocab, cfg.n_heads, cfg.n_layers
    dh = cfg.d_model // H
    NB = sspec.blocks_per_seq
    n_blocks = sspec.nb
    tp = sspec.tp
    devices = tp_serve_devices(mesh) if tp > 1 else None
    dense_params = [s.params for s in stages]
    if params is None:
        params = (pack_tp_serve_params(dense_params, tp, devices,
                                       tp_serve_shards(mesh))
                  if tp > 1 else dense_params)
    params = abstractify(params)
    i32, i64, f32 = torch.int32, torch.int64, torch.float32

    def f32S():
        return spec((S,), f32)

    kdS = spec((S, 2), i64)
    kd1 = spec((2,), i64)
    toks = spec((S,), i32, 0, V - 1)
    pos = spec((S,), i32, 0, ml - 1)
    top_ks = spec((S,), i32, 0, V)

    programs: list[Program] = []
    findings: list[Finding] = []

    # the cached decoder: the solo-parity anchor, linted at one bucket
    t0 = int(min(sspec.prompt_lens)) if sspec.prompt_lens else min(4, ml - 1)
    t0 = max(1, min(t0, ml - 1))
    n_new = ml - t0
    anchor_cd = None if _is_quantized_dtype(sspec.cache_dtype) \
        else sspec.cache_dtype
    if anchor:
        dcfg_ = cfg_dense(cfg)
        findings += check_builder_memo(
            "make_cached_decoder",
            lambda: make_cached_decoder(stages, dcfg_, t0, n_new,
                                        cache_dtype=anchor_cd, device=dev))
        findings += _retrace_finding("make_cached_decoder",
                                     "(prompt_len, n_new) pair", sspec)
        programs.append(Program(
            "cached_decoder",
            make_cached_decoder(stages, dcfg_, t0, n_new,
                                cache_dtype=anchor_cd, device=dev),
            (abstractify(dense_params), spec((1, t0), i32, 0, V - 1),
             kd1)))

    K = int(sspec.spec_k)
    speculative = K >= 2 and draft_stages is not None
    valid_n = spec((S,), i32, 0, K) if speculative else None
    # the verify programs branch on the host on whether any slot samples:
    # host temperatures with a sampling slot trace the path that runs both
    import numpy as np
    hot = np.ones((S,), np.float32)
    drafts_a = spec((S, K), i32, 0, V - 1) if speculative else None
    qrows_a = spec((S, K, V), f32) if speculative else None

    # the adapter bank (traced data) and its row contracts; a host int
    # picks a one-request program's row
    bank = aids = None
    aid1 = 0
    if sspec.adapters_on:
        from simple_distributed_machine_learning_tpu_torch.models.gpt import (
            make_adapter_bank_update,
        )
        N, r, d = sspec.n_adapters, sspec.adapter_rank, cfg.d_model
        shapes = {"aq": (L, d, r), "bq": (L, r, d), "av": (L, d, r),
                  "bv": (L, r, d)}
        bank = {k: _fake((N,) + v, f32, dev) for k, v in shapes.items()}
        row = {k: _fake(v, f32, dev) for k, v in shapes.items()}
        aid1 = N - 1
        aids = spec((S,), i32, 0, N - 1)
        findings += check_builder_memo("make_adapter_bank_update",
                                       make_adapter_bank_update)
        programs.append(Program("adapter_bank_update",
                                make_adapter_bank_update(),
                                (bank, N - 1, row)))

    def draft_programs():
        """The draft propose program and its pool (dense slot rows
        whatever the target layout — the engine's draft discipline)."""
        from simple_distributed_machine_learning_tpu_torch.models.gpt import (
            make_slot_propose,
        )
        dcfg = sspec.draft_cfg
        dL = sum(len(p["blocks"]) for p in (s.params for s in draft_stages))
        draft_cd = anchor_cd
        dkc = _pool((dL, S, dcfg.n_heads, ml, dcfg.d_model // dcfg.n_heads),
                    draft_cd, dev)
        dvc = _pool((dL, S, dcfg.n_heads, ml, dcfg.d_model // dcfg.n_heads),
                    draft_cd, dev)
        propose = make_slot_propose(draft_stages, dcfg, ml, K, draft_cd,
                                    device=dev)
        memo = check_builder_memo(
            "make_slot_propose",
            lambda: make_slot_propose(draft_stages, dcfg, ml, K, draft_cd,
                                      device=dev))
        dparams = abstractify([s.params for s in draft_stages])
        return propose, (dparams, dkc, dvc, toks, pos, kdS, f32S(), top_ks,
                         f32S()), memo

    adp = sspec.adapters_on
    kw = dict(mesh=mesh, device=dev)
    if sspec.kv_layout == "dense":
        shape = (L, S, H, ml, dh)
        prefill = make_slot_prefill(stages, cfg, ml, sspec.cache_dtype, **kw)
        decode = make_slot_decode_step(stages, cfg, ml, sspec.cache_dtype,
                                       **kw)
        findings += check_builder_memo(
            "make_slot_prefill",
            lambda: make_slot_prefill(stages, cfg, ml, sspec.cache_dtype,
                                      **kw))
        findings += check_builder_memo(
            "make_slot_decode_step",
            lambda: make_slot_decode_step(stages, cfg, ml,
                                          sspec.cache_dtype, **kw))
        findings += _retrace_finding("make_slot_prefill", "prompt length",
                                     sspec)

        def pools():
            return (_pool(shape, sspec.cache_dtype, dev, tp, devices),
                    _pool(shape, sspec.cache_dtype, dev, tp, devices))

        prefill_tail = (spec((1, t0), i32, 0, V - 1), S - 1, kd1,
                        spec((), f32), spec((), i32, 0, V), spec((), f32))
        decode_tail = (toks, pos, kdS, f32S(), top_ks, f32S())
        programs.append(Program("slot_prefill", prefill,
                                (params, *pools(), *prefill_tail)))
        programs.append(Program("slot_decode", decode,
                                (params, *pools(), *decode_tail)))
        if adp:
            akw = dict(kw, adapters=True)
            findings += check_builder_memo(
                "make_slot_prefill[adapters]",
                lambda: make_slot_prefill(stages, cfg, ml,
                                          sspec.cache_dtype, **akw))
            findings += check_builder_memo(
                "make_slot_decode_step[adapters]",
                lambda: make_slot_decode_step(stages, cfg, ml,
                                              sspec.cache_dtype, **akw))
            programs.append(Program(
                "slot_prefill_adapter",
                make_slot_prefill(stages, cfg, ml, sspec.cache_dtype, **akw),
                (params, *pools(), *prefill_tail, bank, aid1)))
            programs.append(Program(
                "slot_decode_adapter",
                make_slot_decode_step(stages, cfg, ml, sspec.cache_dtype,
                                      **akw),
                (params, *pools(), *decode_tail, bank, aids)))

        # the composite tick: prefill -> decode with the pool buffers
        # threaded the way engine.step threads them
        def dense_tick(params, kc, vc, prompt, slot, kd_1, t1, k1, p1,
                       toks, pos, kds, temps, tks, tps):
            kc, vc, tok, kd_1 = prefill(params, kc, vc, prompt, slot, kd_1,
                                        t1, k1, p1)
            kc, vc, toks2, kds2 = decode(params, kc, vc, toks, pos, kds,
                                         temps, tks, tps)
            return kc, vc, tok, toks2, kds2

        programs.append(Program("dense_tick", dense_tick,
                                (params, *pools(), *prefill_tail,
                                 *decode_tail)))

        if speculative:
            from simple_distributed_machine_learning_tpu_torch.models.gpt import (  # noqa: E501
                make_slot_spec_tick,
                make_slot_verify_step,
            )
            propose, propose_args, memo = draft_programs()
            findings += memo
            verify = make_slot_verify_step(stages, cfg, ml, K,
                                           sspec.cache_dtype, **kw)
            findings += check_builder_memo(
                "make_slot_verify_step",
                lambda: make_slot_verify_step(stages, cfg, ml, K,
                                              sspec.cache_dtype, **kw))
            verify_tail = (toks, pos, drafts_a, qrows_a, valid_n, kdS,
                           hot, top_ks, f32S())
            programs.append(Program("slot_propose", propose, propose_args))
            programs.append(Program("slot_verify", verify,
                                    (params, *pools(), *verify_tail)))
            if tp == 1:
                dcfg = sspec.draft_cfg
                spec_tick = make_slot_spec_tick(
                    stages, cfg, draft_stages, dcfg, ml, K,
                    sspec.cache_dtype, device=dev)
                findings += check_builder_memo(
                    "make_slot_spec_tick",
                    lambda: make_slot_spec_tick(stages, cfg, draft_stages,
                                                dcfg, ml, K,
                                                sspec.cache_dtype,
                                                device=dev))
            else:
                def spec_tick(dparams, dkc, dvc, params, kc, vc, toks, pos,
                              valid, dkds, kds, temps, tks, tps):
                    dkc, dvc, drafts, qrows, dkds2 = propose(
                        dparams, dkc, dvc, toks, pos, dkds, temps, tks, tps)
                    kc, vc, toks2, n_acc, kds2 = verify(
                        params, kc, vc, toks, pos, drafts, qrows, valid,
                        kds, temps, tks, tps)
                    return dkc, dvc, kc, vc, toks2, n_acc, kds2, dkds2
            programs.append(Program(
                "dense_spec_tick", spec_tick,
                (*propose_args[:3], params, *pools(), toks, pos, valid_n,
                 kdS, kdS, hot, top_ks, f32S())))
        return programs, findings

    # the paged layout
    shape = (L, n_blocks + 1, H, bs, dh)
    kernel = sspec.attn_kernel
    tables = spec((S, NB), i32, 0, n_blocks)
    table1 = spec((NB,), i32, 0, n_blocks)
    c = sspec.resolved_chunk
    pkw = dict(kw, kernel=kernel)
    chunk = make_paged_prefill_chunk(stages, cfg, ml, bs, sspec.cache_dtype,
                                     **kw)
    decode = make_paged_decode_step(stages, cfg, ml, bs, sspec.cache_dtype,
                                    **pkw)
    copy = make_paged_block_copy()
    findings += check_builder_memo(
        "make_paged_prefill_chunk",
        lambda: make_paged_prefill_chunk(stages, cfg, ml, bs,
                                         sspec.cache_dtype, **kw))
    findings += check_builder_memo(
        "make_paged_decode_step",
        lambda: make_paged_decode_step(stages, cfg, ml, bs,
                                       sspec.cache_dtype, **pkw))
    findings += check_builder_memo("make_paged_block_copy",
                                   make_paged_block_copy)
    if sspec.prefill_chunk is None:
        findings += _retrace_finding("make_paged_prefill_chunk",
                                     "chunk (= whole-prompt) length", sspec)

    def pools():
        return (_pool(shape, sspec.cache_dtype, dev, tp, devices),
                _pool(shape, sspec.cache_dtype, dev, tp, devices))

    # the host ints a tick reads: the chunk's start at its contract's
    # worst case, the copy's block ids at the pool's last block
    chunk_tail = (spec((1, c), i32, 0, V - 1), ml - 1 - c, table1, kd1,
                  spec((), f32), spec((), i32, 0, V), spec((), f32))
    decode_tail = (toks, pos, tables, kdS, f32S(), top_ks, f32S())
    copy_tail = (n_blocks, n_blocks - 1 if n_blocks > 1 else 0)
    programs.append(Program("paged_prefill_chunk", chunk,
                            (params, *pools(), *chunk_tail)))
    programs.append(Program("paged_decode", decode,
                            (params, *pools(), *decode_tail)))
    programs.append(Program("paged_block_copy", copy,
                            (*pools(), *copy_tail)))

    if adp:
        akw, apkw = dict(kw, adapters=True), dict(pkw, adapters=True)
        findings += check_builder_memo(
            "make_paged_prefill_chunk[adapters]",
            lambda: make_paged_prefill_chunk(stages, cfg, ml, bs,
                                             sspec.cache_dtype, **akw))
        findings += check_builder_memo(
            "make_paged_decode_step[adapters]",
            lambda: make_paged_decode_step(stages, cfg, ml, bs,
                                           sspec.cache_dtype, **apkw))
        programs.append(Program(
            "paged_prefill_chunk_adapter",
            make_paged_prefill_chunk(stages, cfg, ml, bs, sspec.cache_dtype,
                                     **akw),
            (params, *pools(), *chunk_tail, bank, aid1)))
        programs.append(Program(
            "paged_decode_adapter",
            make_paged_decode_step(stages, cfg, ml, bs, sspec.cache_dtype,
                                   **apkw),
            (params, *pools(), *decode_tail, bank, aids)))

    # the composite tick: chunk -> CoW copy -> decode, the pool threaded
    # as engine.step/_ensure_writable_range thread it
    def paged_tick(params, kc, vc, tokens, p0, table, kd_1, t1, k1, p1,
                   dst, src, toks, pos, tables, kds, temps, tks, tps):
        kc, vc, tok, kd_1 = chunk(params, kc, vc, tokens, p0, table, kd_1,
                                  t1, k1, p1)
        kc, vc = copy(kc, vc, dst, src)
        kc, vc, toks2, kds2 = decode(params, kc, vc, toks, pos, tables,
                                     kds, temps, tks, tps)
        return kc, vc, tok, toks2, kds2

    programs.append(Program("paged_tick", paged_tick,
                            (params, *pools(), *chunk_tail, *copy_tail,
                             *decode_tail)))

    if speculative:
        from simple_distributed_machine_learning_tpu_torch.models.gpt import (
            make_paged_spec_tick,
            make_paged_verify_step,
        )
        propose, propose_args, memo = draft_programs()
        findings += memo
        verify = make_paged_verify_step(stages, cfg, ml, bs, K,
                                        sspec.cache_dtype, **pkw)
        findings += check_builder_memo(
            "make_paged_verify_step",
            lambda: make_paged_verify_step(stages, cfg, ml, bs, K,
                                           sspec.cache_dtype, **pkw))
        verify_tail = (toks, pos, drafts_a, qrows_a, valid_n, tables, kdS,
                       hot, top_ks, f32S())
        programs.append(Program("paged_propose", propose, propose_args))
        programs.append(Program("paged_verify", verify,
                                (params, *pools(), *verify_tail)))
        if tp == 1:
            dcfg = sspec.draft_cfg
            spec_tick = make_paged_spec_tick(
                stages, cfg, draft_stages, dcfg, ml, bs, K,
                sspec.cache_dtype, kernel=kernel, device=dev)
            findings += check_builder_memo(
                "make_paged_spec_tick",
                lambda: make_paged_spec_tick(stages, cfg, draft_stages,
                                             dcfg, ml, bs, K,
                                             sspec.cache_dtype,
                                             kernel=kernel, device=dev))
        else:
            def spec_tick(dparams, dkc, dvc, params, kc, vc, toks, pos,
                          valid, tables, dkds, kds, temps, tks, tps):
                dkc, dvc, drafts, qrows, dkds2 = propose(
                    dparams, dkc, dvc, toks, pos, dkds, temps, tks, tps)
                kc, vc, toks2, n_acc, kds2 = verify(
                    params, kc, vc, toks, pos, drafts, qrows, valid,
                    tables, kds, temps, tks, tps)
                return dkc, dvc, kc, vc, toks2, n_acc, kds2, dkds2
        programs.append(Program(
            "paged_spec_tick", spec_tick,
            (*propose_args[:3], params, *pools(), toks, pos, valid_n,
             tables, kdS, kdS, hot, top_ks, f32S())))
    return programs, findings


def _signature(obj):
    """A program argument's static description (shapes, dtypes, contracts,
    host values): two programs alike in it trace alike."""
    import torch

    from simple_distributed_machine_learning_tpu_torch.analysis.bounds import (
        ArgSpec,
    )
    if isinstance(obj, ArgSpec):
        return ("spec", obj.shape, str(obj.dtype), obj.lo, obj.hi, obj.vary)
    if isinstance(obj, torch.Tensor):
        return ("t", tuple(obj.shape), str(obj.dtype), str(obj.device))
    if isinstance(obj, torch.nn.Module):
        return ("m",) + tuple(_signature(t) for t in obj.parameters())
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__,) + tuple(_signature(v) for v in obj)
    if isinstance(obj, dict):
        return ("d",) + tuple((k, _signature(v)) for k, v in obj.items())
    return ("v", repr(obj))


def lint_serve(stages, sspec: ServeSpec, name: str | None = None,
               mesh=None, draft_stages=None, params=None,
               device=None, cache: dict | None = None,
               anchor: bool = True) -> Report:
    """Trace and lint every program of one serving deployment; returns a
    single merged :class:`Report` carrying the findings of all rule
    families, the retrace/memo policy checks and the HBM-bytes-per-tick
    table (the byte model's rows, the kernel nodes' derived rows and
    their reconciliation). Pass the live ``mesh`` for a TP deployment and
    the ``draft_stages`` for a speculative one; ``device`` (None =
    ``"cuda"``) is where the programs run. Nothing is launched.
    ``cache`` (a dict shared across calls) reuses the lint of a program
    already traced alike — the registry sweep's one cached decoder."""
    from simple_distributed_machine_learning_tpu_torch.analysis import (
        analyze,
    )
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        tp_serve_shards,
    )
    if sspec.tp > 1 and mesh is None:
        raise ValueError(
            f"lint_serve: sspec.cfg.n_tensor_parallel={sspec.tp} needs the "
            f"deployment's mesh to rebuild the sharded programs")
    if sspec.spec_k >= 2 and draft_stages is None:
        raise ValueError(
            f"lint_serve: sspec.spec_k={sspec.spec_k} needs the "
            f"draft_stages build to trace the propose/verify pair")
    programs, policy = build_registry(stages, sspec, mesh=mesh,
                                      draft_stages=draft_stages,
                                      params=params, device=device,
                                      anchor=anchor)
    n_layers = sum(len(p["blocks"]) for p in (s.params for s in stages))
    label = name or serve_label(sspec)
    report = Report(name=label, findings=list(policy))
    kernel_rows: list[HBMCost] = []
    for prog in programs:
        key = (id(prog.fn), prog.name, id(mesh), _signature(prog.args))
        sub = None if cache is None else cache.get(key)
        if sub is None:
            sub = analyze(prog.fn, *prog.args, mesh=mesh,
                          name=f"{label}:{prog.name}")
            if cache is not None:
                cache[key] = sub
        for f in sub.findings:
            report.findings.append(dataclasses.replace(
                f, where=f"{prog.name}: {f.where}" if f.where
                else prog.name))
        report.costs.extend(sub.costs)
        # the kernel nodes' derived rows (a K4 stream, the rest's io)
        kernel_rows.extend(dataclasses.replace(h, program=prog.name)
                           for h in sub.hbm if h.bytes_per_tick)
    report.hbm.extend(kernel_rows)
    model_rows = hbm_tick_costs(sspec, n_layers=n_layers)
    report.hbm.extend(model_rows)
    report.findings.extend(_reconcile_kernel_hbm(
        kernel_rows, model_rows, sspec,
        len(tp_serve_shards(mesh)) if sspec.tp > 1 else None))
    report.findings.extend(_injected_findings())
    return report


def default_registry_reports(device=None) -> list[Report]:
    """The CI lint gate's serve-program sweep (``--serve`` in the analysis
    CLI): the registry's tiny GPT (seed 0, its draft seed 1) on ``device``
    (None = ``"cuda"``) linted over every :func:`registry_specs`
    deployment, the degraded fallback named as the JAX sweep names it.
    Every report must be ERROR-free for the gate to pass."""
    from simple_distributed_machine_learning_tpu_torch._device import (
        resolve_device,
    )
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        make_gpt_stages,
    )
    dev = resolve_device(device)
    cfg, draft_cfg = registry_config()
    stages = make_gpt_stages(0, cfg, 1, device=dev)[0]
    draft_stages = make_gpt_stages(1, draft_cfg, 1, device=dev)[0]
    specs = registry_specs(cfg, draft_cfg)
    spec_paged = specs[6]
    cache: dict = {}
    reports = [lint_serve(stages, s, device=dev, cache=cache,
                          draft_stages=draft_stages if s.spec_k else None)
               for s in specs[:-1]]
    reports.append(lint_serve(
        stages, specs[-1], device=dev, cache=cache,
        name=f"serve[degraded fallback of paged spec_k={spec_paged.spec_k}"
             f": dense slots={spec_paged.n_slots} tp=1 spec_k=0]"))
    return reports


def lint_engine(engine, prompt_lens: tuple | None = None) -> Report:
    """Preflight a live :class:`~..serve.engine.InferenceEngine`'s EXACT
    programs — its layout, block geometry, chunk size, cache dtype, mesh,
    kernel, draft and weights (``InferenceEngine(lint=True)`` calls this
    at construction). Trace-only: no kernel launches, no buffer is
    allocated. The programs the engine runs, without the solo-parity
    anchor no tick runs (a decode loop unrolled over the whole sequence,
    whose trace costs more than all of them)."""
    sspec = engine_spec(engine, prompt_lens)
    return lint_serve(engine.stages, sspec, mesh=engine.mesh,
                      draft_stages=engine.draft_stages, params=engine.params,
                      device=engine.device, anchor=False)
