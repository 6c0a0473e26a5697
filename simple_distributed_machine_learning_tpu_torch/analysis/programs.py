"""The serving byte model and the kernel half of the serve-program registry
(port of ``analysis/programs.py``: ROADMAP.md, Queue A, item 7.3, and the
kernel linter's part of item 7.4).

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
and reconciles them with :func:`hbm_tick_costs` exactly. The jaxpr
registry (``build_registry``, ``lint_serve``, ``lint_engine`` and the
decode-program memo check) walks traced XLA programs and stays with the
rest of item 7.4.

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


def engine_spec(engine) -> ServeSpec:
    """The :class:`ServeSpec` of a LIVE engine — the one engine->spec
    mapping, shared by the registry and the runtime KV-drift gauge. A
    live engine declares no prompt buckets (``prompt_lens`` None)."""
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
        cache_dtype=pool.cache_dtype,
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
                          sspec: ServeSpec) -> list[Finding]:
    """Cross-check the K/V stream bytes derived from the recorded launches
    against the tick model's gather rows: the fused kernel's claim — one
    read of resident K/V per tick — is computed from the launches' own
    specs, not asserted. The two agree EXACTLY or the gate fails."""
    if sspec.attn_kernel != "fused":
        return []
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
                         f"says {want} — the fused single-pass claim no "
                         f"longer matches the kernel itself"),
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
