#!/usr/bin/env python3
"""Prove that the PyTorch/CUDA port builds, is right, serves and trains on
one GPU.

Run from the root of a checkout, on a machine with one NVIDIA GPU (H100):

    python3 chip_smoke.py

It imports only the port (``simple_distributed_machine_learning_tpu_torch``)
and torch — no JAX — and exits non-zero, printing no result, without CUDA
or without the port beside it. Phases, each fatal on failure:

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions, and
   the build of every kernel from the checkout's sources (one ``nvcc`` per
   source, started together, into the git-ignored ``_build/`` directory),
   with ptxas's registers and spills per kernel (a spill in K4, or in K1
   at a head dim up to 64, fails), and the count of tensor-core (``HMMA``)
   instructions in each kernel's SASS (``cuobjdump``): all 12 bf16 K1-K3
   instantiations must have some, the f32 flash kernels and K4 none;
2. every kernel against its plain PyTorch version on the card, at the
   serving shapes (H = 8, dh = 64, block 16, 8 slots, positions up to
   255), for every cache dtype and K = 1 and 4, within rtol = atol =
   1e-5 (both read the same stored bytes); a narrow pool's answer also
   within ``tests/tolerances.py::attn_tol`` of the unquantised f32
   pool's; then K4's edge cases (``K4_EDGES``: head dims 40, 128, 256,
   phase 8's head dims 16 (blocks of 8) and 32, blocks of 8 and 32, a table longer than the warp count, K = 4 and 8, a
   slot at position 0 beside a trash-routed one, a non-contiguous and a
   misaligned pool view) against the plain version; then K4 with more
   queries per slot than one block takes (K = 9, 12 and 16: two query
   groups in one launch) for every cache dtype, each plan with a slot whose
   later queries are clamped to position 255 (so positions repeat) and one
   whose queries straddle a block boundary. Each serving case is
   timed with CUDA events (one pair around a run of 40 calls, the L2
   flushed before each call, the flushes' own time subtracted; median of 5
   runs) beside its plain version and its bound, and K4 must beat its
   plain version at the f32 K = 1 case; so are the speculative verify's
   cases (f32, 4 slots, K = 4 and K = 16);
   then the flash kernels K1 (forward), K2 (dq) and K3 (dk/dv) against
   their plain versions, f32 and bf16, at the training shape (16, 8, 256,
   64), at a ragged T = 200 and at the tiny row's (32, 4, 64, 32), and in
   bf16 at the edges of the tensor-core K1-K3 (head dims 8, 32, 40 and
   128, T = 1, 65 and 200), within ``FLASH_TOL``, timed the same way
   beside their bounds and the library yardstick
   (``scaled_dot_product_attention``, forward and backward; K1 against
   SDPA's forward and K2 + K3 against SDPA's backward, each on one line);
3. the port's serving path at full width: ``InferenceEngine(attn_kernel=
   "fused")`` serving the ``gpt_serve`` trace (24 requests, Poisson
   32/s, prompts 8/16/32, 24 new tokens) on the 21 M-parameter GPT
   (vocab 8192, seq 256, d 512, 8 heads, 4 layers; random weights from
   seed 0). It must complete 24/24, launch the kernel n_layers times per
   decode tick, and give every greedy stream equal to an ``attn_kernel=
   "dense"`` engine's and to the solo ``make_cached_decoder``'s;
3b. speculative decoding on the same model, block 16, ``attn_kernel=
   "fused"`` (the verify step launches K4 with ``spec_k`` queries per
   slot): (a) draft == target at ``spec_k`` 4, 4 slots, 24 greedy requests
   submitted up front (prompts 8/16/32, 24 new tokens; the JAX package's
   ``bench.py::_measure_spec_vs_plain``) — accept rate exactly 1.0, at
   least 2x a plain engine's tokens per tick on the same workload, every
   stream equal to the plain engine's and the solo decoder's, and K4
   launched exactly ``n_layers`` times per speculative tick; (b) the CLI's
   draft (half the layers, fresh weights from a derived seed) at
   ``spec_k`` 4 on phase 3's trace — 24/24 served, every greedy stream
   equal to phase 3's, its accept rate, TTFT/TPOT, tokens/s and host-clock
   tick beside the plain engine's; (c) draft == target at ``spec_k`` 12,
   K4's two-group path inside the engine — greedy streams equal to plain
   decode's; and the CLI's ``--model gpt --serve-sim 8 --serve-spec-k 4``
   exits 0 with its ``| serve: tp 1, spec_k 4 accept_rate ...`` line;
4. where a decode tick's time goes: a steady window at full occupancy (8
   slots), timed on the host clock, then traced with ``torch.profiler`` —
   the device's busy share and its time by kernel (``PERF.md`` section 5);
5. the port's training path: ``bench.py``'s ``gpt_bf16`` row at full width
   (21 M parameters, batch 16, bf16, AdamW) and its tiny ``gpt`` row (f32,
   SGD), each ``Pipeline`` + ``make_scanned_train_step`` with
   ``attn_impl="flash"`` for 30 steps over a pool of 2 random batches:
   finite losses that fall, K1-K3 launched exactly ``n_layers`` times per
   step, and losses equal to an ``attn_impl="dense"`` run's from the same
   weights within ``flash_vs_dense_rtol`` over 10 steps, while a run with
   a known-wrong attention core (its causal mask one key too wide) falls
   outside that limit;
6. where a full-width flash training step's time goes, under
   ``torch.profiler``; the bf16 K1 must show there by its tensor-core
   kernel's name, ``n_layers`` launches per step;
7. the reference's main path, through the port's CLI and ``Trainer`` on
   the card: LeNet for 2 epochs at the reference's sizing (6000/1000
   synthetic samples, batch 60, SGD lr 0.1 momentum 0.5) with a
   checkpoint directory and ``--metrics-json`` — every console line in
   the reference's formats, 2 schema-2 records, finite losses — and a
   rerun with ``--epochs 3`` that resumes at epoch 3; 20 deterministic
   SGD steps of LeNet on the card within ``rel=1e-4*(i+1)+1e-5`` of the
   port's CPU path from the same weights and batches, while a (C, H, W)
   flatten lands outside; ``mlp2`` (784-512-10) above 50% test accuracy
   after 2 epochs, and 1 + 1 resumed epochs equal to 2 straight, bit for
   bit, for ``mlp2`` and LeNet; ``--model gpt --attn flash --dryrun 5``
   through the CLI with K2 and K3 launched exactly ``n_layers`` times per
   step and K1 also once per layer per eval batch; and the ``lenet``,
   ``mlp2`` and ``mlp4`` rows' step time at batch 60 on the host clock,
   then under ``torch.profiler`` (device busy share, device and host ops
   per step);
8. serving under faults: (a) the six one-engine SLO scenarios (steady,
   burst-interactive, multi-tenant, burst-slow-tick, crash-serve,
   overload-shed) through the port's ``run_scenario`` on the card at the
   virtual clock, attending through K4, on ``SCENARIO_CFG`` (2 stages,
   weights from seed 0): every count, per-class TTFT p95 and the
   overload-shed alert ticks equal ``SCENARIO_PINS``, K4 launched
   ``n_layers`` times per decode call in every tick, and, since the pins
   hold on any weights, every greedy stream (and the crash-serve and
   overload-shed journals, line for line) equal to a second run through
   the plain gather-then-dense path; (b) a wall-clock crash drill at full
   width: phase 3's trace through ``ServeSupervisor(engine_factory(...,
   attn_kernel="fused", n_slots=8, block_size=16))`` with an fsync'd
   journal under ``DRILL_CHAOS`` — 24/24 served through exactly 1
   restart, every greedy stream equal to phase 3's, K4 launched
   ``n_layers`` times per decode call in every tick before and after the
   restart, and the memory allocated after the rebuild within half a pool
   of the figure before the crash; it prints the recovered count, the restart
   cost (the crash to the next emitted token), tokens/s and the tick p50
   against phase 3's and the journal's fsync cost; (c) the same with
   ``degrade_after=1``: the rebuild serves on ``kv_layout="dense"``,
   degraded 1, greedy streams equal to phase 3's; (d) the CLI's
   ``--model gpt --serve-sim 8 --serve-chaos engine-crash@serve.tick=6``
   (its restart line) and ``--scenario crash-serve`` (TTFT p95 23.16
   vms, SLO attained);
9. the traced fleet: (a) the five fleet scenarios (fleet-replica-loss,
   hot-prefix-skew, fleet-autoscale-diurnal, disagg-prefill-heavy,
   handoff-replica-loss) and two variants (hot-prefix-skew under
   round-robin, disagg-prefill-heavy on the symmetric fleet) through the
   port's ``run_scenario`` on ``SCENARIO_CFG`` at the virtual clock,
   attending through K4: every count, TTFT p95, fleet block and replica
   log equal to ``FLEET_PINS``, K4 launched ``n_layers`` times per decode
   call summed over the replicas in every fleet tick, every greedy stream
   equal to a rerun through the dense path, and a third, traced run with
   the same report and ``ATTRIBUTION_PINS`` (trace events, attributed
   requests, the slowest rid's TTFT and its components); (b) phase 3's
   trace through a two-replica ``ServeFleet`` at full width under
   ``FLEET_DRILL_CHAOS`` with fsync'd journals — 24/24 served, 1 loss,
   at least 1 migration, every greedy stream equal to phase 3's, no more
   memory allocated after the loss than before it (the lost pool freed);
   it prints the migration cost (from the start of the tick that fired
   the kill to the next journaled token of a migrated request), tokens/s
   and the fleet tick p50 against phase 3's; (c) the same trace on 1
   prefill + 1 decode replica — 24 handoffs, greedy streams equal to
   phase 3's, TTFT, tokens/s and the journal's host time per handoff;
   (d) phase 3's trace through one engine with a ``ServeTrace``
   and a ``FlightRecorder`` — 24 requests attributed within
   ``DRIFT_TOL_MS`` on the host clock, balanced Chrome spans, greedy
   streams equal to phase 3's, the report CLI exiting 0, and the decode
   tick p50 traced against untraced; (e) the CLI's ``--serve-replicas 2
   --serve-trace --telemetry-dir D``, ``--serve-replicas 2
   --serve-prefill-replicas 1`` and ``--scenario disagg-prefill-heavy``;
10. training that survives faults: (a) phase 7's ``mlp2`` row (batch 60,
   SGD) under the sentinel: ``nan-grad`` detected, rolled back and
   quarantined, its per-step losses and final parameters equal, bit for
   bit, to a clean run that pre-loaded the quarantine journal;
   ``corrupt-batch`` and ``loss-spike`` each caught once; a clean run
   trips nothing; the sentinel's cost per step (sentinel on against off,
   beside phase 7's step) and one rollback's ms; (b) the ``gpt_bf16``
   row (``attn_impl="flash"``) under ``supervise(make_elastic_trainer(...
   ), (1,))`` with a ``CheckpointStore`` and ``ELASTIC_KILL`` mid-epoch —
   exactly 1 restart, resumed at the first epoch's step, K1-K3 launched
   ``n_layers`` times per train step (K1 also per eval batch) in both
   attempts, the epoch losses and final parameters after the restore
   equal to an uninterrupted run's (bit for bit when two clean runs are;
   else within their spread), the memory allocated after the restart
   within an eighth of one trainer's state of the figure before the kill,
   and one more trainer kept alive reading above that limit; it prints
   the restart cost (the kill to the end of the first step after the
   restore), the store's save ms and bytes per generation, and, for the
   same run with ``sentinel=True`` and no fault (nothing tripped, losses
   equal to the clean run's), the sentinel's cost per step beside phase
   5's step; (c) the store on the card: ``ckpt-write-crash@ckpt.write``
   restarts in place and completes; a truncated newest generation is
   skipped with its warning and the previous one restores; (d) the CLI:
   ``--model mlp --sentinel --chaos nan-grad@train.grad=5`` (0 restarts,
   1 anomaly absorbed), ``--model gpt --attn flash --chaos
   host-kill@train.step=6`` (1 restart; its f32 K1-K3 launches are
   checked here and kept out of the ``kernels`` line's bf16 rows),
   ``--chaos host-kill@train.step=999`` (exits naming "never fired"),
   and ``preempt@train.sigterm=6`` then a rerun, ending on the
   parameters of an uninterrupted run bit for bit.

11. the host offload tier and LoRA adapters: (a) offload-churn's shape
   at SERVE_CFG's width (``HOST_CHURN``: a 2-block shared prefix before
   the hot prompts, prefix-less scans, 8 slots, a 16-block pool, a
   24-block host tier, one fleet replica, the virtual clock), with f32
   and int8 storage, each beside the same run without the tier: at least
   one demotion, promotion and prefetch hit, every demoted copy and every
   promoted block byte-equal to the rows they came from, every stream
   equal to the run without the tier, K4 launched ``n_layers`` times per
   decode call; it prints the demote (device -> host) and upload (host
   -> device) ms per block and the tick p50 beside the run without the
   tier and phase 3's; (b) three rank-``ADAPTER_RANK`` tenants and the
   base model on one engine (phase 3b's 24 greedy requests, tenants
   round-robin): base streams equal to an engine without adapters, every
   tenant stream off the base model's and held against an engine on the
   merged weights (teacher-forced log-probs within
   ``ADAPTER_LOGIT_TOL``; tokens equal, or the first disagreeing step's
   top-2 gap under the tolerance, printed and recorded), a hot-swap three
   ticks in taking effect at the next admission only, and the
   speculative verify with adapters (``spec_k`` 4) equal to plain adapter
   decode; it prints the adapter tick's host ms beside the plain tick's;
   (c) the offload-churn and hot-adapter-churn pins (both routing
   policies) on ``SCENARIO_CFG`` through K4, greedy streams equal to a
   dense rerun; (d) the CLI's ``--serve-sim 8 --serve-replicas 1
   --serve-host-blocks 8`` and ``--serve-sim 8 --serve-adapters 2``;
12. the serve-protocol checker, beam search and dense speculation: (a)
   the port's ``python -m ...analysis --serve-protocol`` in this process
   proves the clean model to depth 8 at ``PROTOCOL_PIN`` (982 states,
   2216 transitions) and each seeded-defect config yields its invariant;
   both committed drills (``tests/data/protocol_drills/*.chaos``) replay
   phase 3's trace on a ``ServeFleet`` of 1 prefill + 2 decode replicas
   through K4 — 24/24 served exactly once (each request's streamed
   tokens are its handle's), every greedy stream equal to phase 3's, at
   least one replica loss, K4 ``n_layers`` per decode call; it prints the
   losses, handoffs and fleet tick p50; (b) ``make_beam_decoder`` at
   SERVE_CFG (``BEAM``: 8 prompts of 16 tokens, 24 new, beam 4), without
   and with an EOS id: beam 1 equal to the cached greedy decoder, every
   score within ``BEAM_TOL`` of its row's teacher-forced log-prob and at
   least the greedy score (within ``BEAM_TOL``), tokens equal to the
   CPU's unless the two answers score within ``BEAM_TOL`` on the card
   (the first differing step and the gap printed); host ms per decode at
   beam 1 and 4; (c) ``kv_layout="dense"`` speculation at ``spec_k`` 4
   on phase 3b's cell: draft == target on 3b (a)'s workload (accept rate
   exactly 1.0, streams equal to 3b (a)'s paged speculative and plain
   ones) and the CLI's half-depth draft on phase 3's trace (24/24,
   greedy streams equal to 3b (b)'s and phase 3's), K4 launched 0 times;
   it prints tokens per tick and the host ms per tick beside the paged
   speculative tick's;
13. training telemetry, the profiler and the native loader: (a) the
   LeNet CLI for ``TELEMETRY_EPOCHS`` epochs with ``--telemetry-dir`` at
   ``--telemetry-every`` 1 and 4 — one record per epoch with the JAX
   Trainer's key set (``JAX_EPOCH_KEYS``) plus ``device_memory``, every
   step but the compile window counted steady, ``compile_time_s > 0``, the
   allocator's peak at least its bytes in use (> 0), live tensor bytes at
   least LeNet's parameter bytes, ``feed``/``step``/``eval``/``epoch_end``
   in ``trace.json`` and ``# HELP step_time_ms`` in ``metrics.prom``; it
   prints the record's step p50/p95 at both values beside phase 7's
   host-clock lenet step; (b) phase 7's ``--model gpt --attn flash``
   CLI run in bf16 with ``--telemetry-dir``, ``--profile`` and
   ``--generate 16`` — K1-K3 launched ``n_layers`` times per step (K1
   also per eval batch), the profiler's Chrome trace naming each kernel
   as often as its wrapper launched it, and one ``kind: "decode"``
   record with tokens/s > 0; (c) phase 7's synthetic MNIST written as
   uint8 IDX files (tiled to 60000/10000, so the reference's 1/10 cut
   reads exactly it) and the LeNet CLI from them with ``--shuffle`` —
   the native library built, its codec parsing the 4 files and its
   prefetcher assembling one batch per step, the console in the
   reference's formats; then ``NATIVE_STEPS`` LeNet steps on the card
   from the native prefetcher and from Python ``batches`` (same
   shuffle), with bit-identical losses, and each feed's host ms per
   batch;
14. the kernel linter, F1 and the KV byte model: (a) the grid fixture's
   kernel F1 (``ops/csrc/grid_scratch.cu``) through the analysis CLI's
   ``--fixture`` for the clean, f32, f16 and racing grids, each launching
   F1 once on the card and linting the spec it recorded
   (``kernel-race.parallel-overwrite`` ERROR on the racing one,
   ``kernel-dtype-drift`` WARNING on f16, nothing on f32); then the clean
   f32 and f16 kernels bit-equal to the plain version, the racing one's
   rows 1-3 NaN and every element of its row 0 one cell's ``2·x``, and
   F1 timed as phase 2 times K4 beside its plain version, its byte bound
   and ``torch.mul(x, 2)``, its profiler cross-check in a process of its
   own (all 40 launches seen); (b) ``programs.kernel_report`` on phase 3's
   deployment, f32 and int8, with ``spec_k`` 4 (draft == target): one
   decode and one verify tick's recorded K4 launches lint clean under
   the registry's contracts, and their derived ``kernel.kv_stream`` bytes
   equal the byte model's ``decode.kv_gather`` (33,554,432 at f32) and
   ``verify.kv_gather``; (c) phase 3's trace through a metered engine —
   ``serve_kv_drift_bytes`` 0 on every tick and ``kv_bytes_predicted``
   equal to the pool's ``kv_bytes_resident`` — and again with a
   ``PREFIX_LEN``-token shared prefix, the drift <= 0 on every tick and
   below 0 on some; (d) ``python -m ...analysis --serve-kernel`` exiting
   0, and 1 under ``SDML_LINT_INJECT``, and ``--fixtures`` exiting 0;
15. the reference's own topology, every stage on the one card (the script
   prints the placement): (a) ``bench.py::_configs``'s ``lenet`` (conv |
   fc) at ``--stages 2``, ``mlp4`` at 4 and the tiny ``gpt`` (``--attn
   flash``, batch 32) at 2 with ``--microbatches 4``, through the CLI at
   batch 60 on phase 7's synthetic MNIST, each under GPipe and 1F1B: the
   placement line, the train and eval losses after ``STAGE_CLI_STEPS``
   steps equal to the one-stage run's within ``STAGE_CLI_RTOL``, LeNet's
   ``Test set:`` line, and the tiny gpt's exact K1-K3 launches; (b) the
   ``gpt_bf16`` row at 2 stages and M = 4 under GPipe, 1F1B and GPipe with
   remat: loss and gradients within ``STAGE_BF16_RTOL`` of one stage's,
   exactly ``STAGE_LAUNCHES`` K1/K2/K3 launches per step, GPipe's peak
   activation bytes growing more than ``STAGE_GPIPE_GROWTH``x from M = 4
   to 16 at microbatch 4 and 1F1B's less than ``STAGE_ONEFB_GROWTH``x;
   the host-clock step, launches per step and device busy (a profiled
   window in a process of its own) beside phase 5's one-stage step; (c)
   ``make_pp_decoder`` at phase 3's width over 2 stages, prompt 32, 24
   new, greedy: tokens equal to the one-card ``make_cached_decoder``'s, a
   bf16 cache's beside them, ms per decode; (d) the CLI's ``--model mlp
   --stages 2 --chaos host-kill@train.step=6 --chaos-stages 2,1`` with a
   store: the JAX CLI test's two pinned lines, exit 0, the restart cost.

Before the last line it prints the kernels as one JSON object (times in
ms, measured in this run; ``bound_ms`` computed from this run's inputs);
the last line is ``{"ok": true, "device": {...}}``. Details also go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PORT = "simple_distributed_machine_learning_tpu_torch"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s outside the
# tensor cores (K4's and the f32 flash kernels' products: TF32 is off) and
# dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
# flash kernel shapes [B, H, T, dh]: the gpt_bf16 row (batch 16, 8 heads,
# seq 256, d 512), the same at a ragged T, and the tiny gpt row's f32
# shape (batch 32 as one fused microbatch, 4 heads, seq 64, d 128)
FLASH_SHAPE = (16, 8, 256, 64)
FLASH_RAGGED = (16, 8, 200, 64)
FLASH_TINY_SHAPE = (32, 4, 64, 32)
# bf16 edge shapes of the tensor-core K1-K3 at a small B*H: head dims padded
# to 32 and 128 and one not a multiple of 16 (40), each at T = 1 (one row),
# 65 (one row past a tile) and 200 (a ragged tail); dh 64 at T = 1, 65; and
# dh 8 (padded to 16, the smallest instantiation) at T = 65, 200
FLASH_EDGES = ([(2, 4, t, dh) for dh in (32, 40, 128) for t in (1, 65, 200)]
               + [(2, 4, t, 64) for t in (1, 65)]
               + [(2, 4, t, 8) for t in (65, 200)])
# (rtol, atol) of each flash kernel against its plain version, keyed by
# (dtype, is a row statistic l/m, is a gradient): f32 at 1e-5 (o, l, m) and
# 1e-4 (dq, dk, dv: tests/test_flash_attention.py's gradient tolerance);
# bf16 outputs within 2^-6 = two bf16 ulps at 1.0 (bf16 keeps 8 significant
# bits; the kernel's f32 sums run in another order, and K1 rounds p against
# its running max, the plain version against the final one); l and m stay
# f32 in both dtypes
_BF16_ULP2 = 2.0 ** -6
FLASH_TOL = {("float32", False, False): (1e-5, 1e-5),
             ("float32", True, False): (1e-5, 1e-5),
             ("float32", False, True): (1e-4, 1e-4),
             ("bfloat16", False, False): (_BF16_ULP2, _BF16_ULP2),
             ("bfloat16", True, False): (1e-5, 1e-5),
             ("bfloat16", False, True): (_BF16_ULP2, _BF16_ULP2)}
# (rtol, atol) of the kernel against its plain version: both read the same
# stored bytes and scales, so only f32 summation order differs
SAME_BYTES_TOL = (1e-5, 1e-5)
# tests/tolerances.py::attn_tol's (rtol, atol) per storage dtype: a narrow
# pool's answer against the unquantised f32 pool's
ATTN_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (5e-2, 5e-2),
            "int8": (6e-2, 6e-2), "float8_e4m3fn": (1.5e-1, 1.5e-1),
            "float8_e5m2": (1.5e-1, 1.5e-1)}
# K4 edge cases beside the serving ones: (storage dtype, K, _pool_case
# options), each held against the plain version; every one also has a slot
# at position 0 with a real table entry beside the trash-routed slot
K4_EDGES = [("float32", 1, dict(dh=40)), ("float32", 1, dict(dh=128)),
            # phase 8's shapes: the scenario model (dh 16, blocks of 8)
            # and the CLI's default GPTConfig (dh 32, blocks of 16)
            ("float32", 1, dict(dh=16, bs=8)), ("float32", 1, dict(dh=32)),
            ("float32", 1, dict(dh=256)), ("bfloat16", 1, dict(dh=256)),
            ("int8", 1, dict(dh=40)),
            ("float32", 1, dict(bs=8)),     # 32 blocks: past the warp count
            ("float32", 1, dict(bs=32)), ("float32", 4, dict(bs=8)),
            ("float32", 8, {}), ("int8", 8, dict(dh=128)),
            ("float8_e4m3fn", 4, dict(dh=40, bs=32)),
            ("float32", 1, dict(layout="block-major")),
            ("bfloat16", 4, dict(layout="misaligned"))]
SERVE_CFG = dict(vocab=8192, seq_len=256, d_model=512, n_heads=8, n_layers=4)
SERVE_SLOTS, SERVE_BLOCK = 8, 16
# bench.py's gpt_bf16 and gpt rows (bench.py::_configs), trained on the
# port's main path with attn_impl="flash"; flash_vs_dense_rtol is the limit
# on the largest relative gap between a flash run's and a dense run's
# per-step losses from the same weights and batches. It sits between the
# gap of the sound flash path and that of a known-wrong one (the dense path
# with a causal mask one key too wide, the smallest gap of the wrong paths
# tried), about a factor of 7 from each in bf16; every run measures both
# gaps and fails unless the wrong one exceeds the limit. bf16 differs
# because the dense bf16 path rounds scores and probabilities to bf16
# where the kernels keep them in f32; f32 by summation order only.
TRAIN_ROWS = {
    "gpt_bf16": dict(cfg=dict(vocab=8192, seq_len=256, d_model=512,
                              n_heads=8, n_layers=4),
                     batch=16, n_micro=1, dtype="bfloat16", opt="adamw",
                     flash_vs_dense_rtol=2e-3),
    "gpt": dict(cfg=dict(vocab=128, seq_len=64, d_model=128, n_heads=4,
                         n_layers=2),
                batch=32, n_micro=4, dtype=None, opt="sgd",
                flash_vs_dense_rtol=1e-4),
}
TRAIN_POOL, TRAIN_STEPS, TRAIN_COMPARE_STEPS = 2, 30, 10
SERVE_SIM = dict(n_requests=24, rate=32.0, seed=0, prompt_lens=(8, 16, 32),
                 max_new_tokens=24)
# phase 2's K4 cases beyond one query group (K = 9, 12, 16, every dtype)
# and the speculative verify's timed cases (f32, 4 slots); phase 3b's
# drives: JAX bench.py's SPEC_BENCH_K = 4 on 4 slots, and spec_k 12
K4_MULTI_GROUP = (9, 12, 16)
SPEC_SLOTS, SPEC_K, SPEC_K_WIDE = 4, 4, 12
SPEC_WORKLOAD = dict(n_requests=24, prompt_lens=(8, 16, 32), max_new=24)
# phase 7, the reference's main path: bench.py::_configs's mlp2 and mlp4
# widths (lenet is the reference's own model); the reference's console
# formats (tests/test_trainer.py) and the Trainer's throughput line
MLP2 = [784, 512, 10]
MLP4 = [784, 512, 512, 512, 10]
TRAIN_RE = re.compile(
    r"^Train Epoch: (\d+) \[(\d+)/(\d+) \((\d+)%\)\]\tLoss: (\d+\.\d{6})$")
TEST_RE = re.compile(
    r"^Test set: Average loss: (\d+\.\d{4}), Accuracy: (\d+)/(\d+) "
    r"\((\d+)%\)$")
EPOCH_RE = re.compile(r"^\| epoch (\d+): (\d+\.\d) samples/sec$")
# LeNet steps held against the port's CPU path; steps of each row's timing
# (warm-up, host-clock window, profiled window); GPT steps through the CLI
MAIN_COMPARE_STEPS = 20
MAIN_WARMUP_STEPS, MAIN_TIMED_STEPS, MAIN_PROFILED_STEPS = 20, 300, 20
MAIN_GPT_STEPS = 5
# phase 8: tests/test_scenarios.py's model for the six one-engine scenarios
# at the virtual clock, and their pins — (completed, shed, restarts,
# preemptions, {class: TTFT p95 in virtual ms}) — which hold on any
# weights and any device (the virtual clock charges every clock read and
# no traffic class sets an EOS); the wall-clock drill's fault schedule
SCENARIO_CFG = dict(vocab=32, seq_len=48, d_model=32, n_heads=2, n_layers=2)
SCENARIO_PINS = {
    "steady": (16, 0, None, 0, {"interactive": 14.16}),
    "burst-interactive": (28, 0, None, 3, {"interactive": 22.249,
                                           "batch": 451.418}),
    "multi-tenant": (30, 0, None, 0, {"interactive": 14.312,
                                      "standard": 14.469, "batch": 92.16}),
    "burst-slow-tick": (24, 0, None, 5, {"interactive": 25.484,
                                         "batch": 443.309}),
    "crash-serve": (16, 0, 1, 0, {"interactive": 23.16}),
    "overload-shed": (11, 25, 0, 2, {"interactive": 75.651,
                                     "batch": 351.149}),
}
SCENARIO_ALERTS = {"overload-shed": [
    (37, "inactive", "pending"), (38, "pending", "firing"),
    (49, "firing", "resolved"), (50, "resolved", "inactive")]}
DRILL_CHAOS = "engine-crash@serve.tick=40"
# phase 9: the five fleet scenarios and two variants (hot-prefix-skew
# under round-robin, disagg-prefill-heavy on the symmetric fleet) with
# their pins on the virtual clock — (completed, interactive TTFT p95 vms
# or None, fleet-block fields, prefix-hit blocks or None) — and, traced,
# (trace events, attributed requests, recovered, slowest rid, its TTFT
# vms, its components); the full-width drill's fault schedule
FLEET_PINS = {
    ("fleet-replica-loss", ()): (16, 22.16, dict(
        replicas=3, alive=2, replica_losses=1, migrations=1,
        replica_log=[("loss", 0, 5, 2)]), None),
    ("hot-prefix-skew", ()): (18, 42.62, dict(
        replicas=3, affinity_hits=17, replica_log=[]), 17),
    ("hot-prefix-skew", (("route", "round-robin"),)): (18, None, dict(
        affinity_hits=0, route="round-robin"), 5),
    ("fleet-autoscale-diurnal", ()): (50, None, dict(
        replicas=1, scale_outs=4, retired=2, replica_log=[
            ("scale-out", 1, 30, 2), ("scale-out", 2, 36, 3),
            ("retire", 2, 61, 2), ("retire", 1, 61, 1),
            ("scale-out", 3, 76, 2), ("scale-out", 4, 78, 3)]), None),
    ("disagg-prefill-heavy", ()): (16, 74.719, dict(
        replicas=4, prefill_replicas=2, handoffs=16), None),
    ("disagg-prefill-heavy", (("prefill_replicas", 0),)): (
        16, 206.719, dict(replicas=4), None),
    ("handoff-replica-loss", ()): (16, 25.16, dict(
        replicas=3, prefill_replicas=1, handoffs=16, replica_losses=1,
        migrations=1, replica_log=[("loss", 1, 6, 2)]), None),
}
ATTRIBUTION_PINS = {
    "fleet-replica-loss": (207, 16, 0, 3, 22.16,
                           {"queue": 1.16, "prefill": 21.0}),
    "hot-prefix-skew": (227, 18, 0, 3, 42.62,
                        {"queue": 34.397, "prefill": 8.224}),
    "fleet-autoscale-diurnal": (625, 50, 0, 47, 138.614,
                                {"queue": 112.614, "prefill": 26.0}),
    "disagg-prefill-heavy": (624, 16, 0, 11, 74.719,
                             {"queue": 3.719, "prefill": 71.0}),
    "handoff-replica-loss": (303, 16, 0, 3, 25.16,
                             {"queue": 6.16, "prefill": 19.0}),
}
FLEET_DRILL_CHAOS = "replica-kill@fleet.tick=40"
# phase 10: the mlp2 sentinel drill (2 epochs of SENTINEL_STEPS steps, a
# snapshot every 4 steps; each numeric fault at its step, after the
# detector's 8-step warm-up, and the two that scale the batch up early in
# epoch 1: a model that has learnt the synthetic digits classifies a
# scaled batch with more confidence, so its loss falls instead — at loss
# 0.25 a batch times 1e30 gives loss 0 and gradient 0 — and a poisoned
# update caught only after the next snapshot exhausts the ring), the
# steps of each sentinel-cost
# window, and the gpt_bf16 elastic drill (ELASTIC_EPOCHS epochs of
# ELASTIC_STEPS steps, an eval set of ELASTIC_TEST sequences, killed
# mid-epoch 2)
SENTINEL_STEPS = 30
SENTINEL_FAULTS = {"nan-grad@train.grad=37": ("nan",),
                   "corrupt-batch@data.batch=12": ("nan", "inf"),
                   "loss-spike@train.step=10": ("spike",)}
SENTINEL_TIMED_STEPS = 100
ELASTIC_EPOCHS, ELASTIC_STEPS, ELASTIC_TEST = 3, 4, 32
ELASTIC_KILL = "host-kill@train.step=6"
# phase 11: (a) the offload-churn scenario's shape at SERVE_CFG's width —
# a 2-block shared prefix (32 tokens) before 16-token hot prompts, and
# 64-token scans without it, 24 requests of 24 new tokens on 8 slots of
# blocks of 16, a pool of 16 blocks and a host tier of 24 on the virtual
# clock (so the counts are the same on any weights and device); (b) three
# LoRA tenants of rank 8 beside the base model on phase 3b's workload, A
# drawn by init_lora_adapter and B at ADAPTER_B_STD, held against the
# merged-weights engine: teacher-forced log-probs within
# ADAPTER_LOGIT_TOL, greedy tokens equal unless the top-2 gap at the first
# disagreeing step lies under that tolerance; (c) the two scenarios' pins
# at SCENARIO_CFG
HOST_CHURN = dict(n_requests=24, rate=4.0, prefix=2 * 16, hot_len=16,
                  scan_len=64, max_new=24, n_slots=8, n_blocks=16,
                  max_len=128, host_cache_blocks=24)
ADAPTER_RANK, ADAPTER_B_STD, ADAPTER_LOGIT_TOL = 8, 0.25, 1e-4
ADAPTER_TENANTS = (None, "t0", "t1", "t2")
HOST_ADAPTER_PINS = {
    ("offload-churn", ()): dict(completed=24, prefix_hit_blocks=16,
                                host_tier={
                                    "host_cache_blocks": 12, "demotes": 66,
                                    "promotes": 5, "prefetch_hits": 3,
                                    "prefetch_misses": 0,
                                    "host_evictions": 53,
                                    "transfer_bytes": 145408}),
    ("hot-adapter-churn", ()): dict(completed=18, swaps=3, hits=15),
    ("hot-adapter-churn", (("route", "round-robin"),)): dict(
        completed=18, swaps=7, hits=0),
}
# phase 12: (a) the serve-protocol checker's pinned depth-8 proof of the
# clean model (states, transitions) and its two committed drills, replayed
# on 1 prefill + 2 decode replicas; (b) beam search at SERVE_CFG, scores
# held to the teacher-forced log-probs within BEAM_TOL (relative)
PROTOCOL_PIN = (982, 2216)
PROTOCOL_DRILLS = ("handoff_kill.chaos", "dropped_handoff_double_serve.chaos")
BEAM = dict(n_prompts=8, t0=16, n_new=24, beam_size=4, seed=12)
BEAM_TOL = 1e-4
# where phases 7 and 14 (b)-(d) run: the card ("cpu" only to rehearse
# them without one, where their device checks cannot pass)
# phase 13: the telemetry runs' epochs and --telemetry-every values (100
# batches per epoch, a multiple of each, so every window closes at an
# epoch's end), the in-process native-vs-Python feed steps, and the JAX
# Trainer's epoch-record keys on a one-stage mesh (no ICI probe)
TELEMETRY_EPOCHS, TELEMETRY_EVERY, NATIVE_STEPS = 2, (1, 4), 20
JAX_EPOCH_KEYS = frozenset((
    "accuracy", "bubble_fraction", "compile_time_s", "correct", "epoch",
    "eval_loss", "examples_per_sec", "kind", "live_array_bytes", "n_eval",
    "n_microbatches", "n_stages", "samples_per_sec", "schedule", "schema",
    "step", "step_time_ms_max", "step_time_ms_p50", "step_time_ms_p95",
    "steps", "time", "tokens_per_sec", "train_loss"))
MAIN_DEVICE = "cuda"
# phase 14: the grid fixtures F1 runs through (name, exit code, the rules
# the linter must report), the shared prefix of (c)'s second trace
GRID_FIXTURES = (
    ("kernel_clean_grid", 0, []),
    ("kernel_f32_accumulator", 0, []),
    ("kernel_f16_accumulator", 1,
     ["kernel-dtype-drift.low-precision-scratch"]),
    ("kernel_grid_race", 1, ["kernel-race.parallel-overwrite"]))
PREFIX_LEN = 32
# phase 15: (a) bench.py::_configs's lenet, mlp4 and tiny gpt rows through
# the CLI — (argv, stages, microbatches) — each run's train and eval loss
# after STAGE_CLI_STEPS steps held to the one-stage run's (f32); (b) the
# gpt_bf16 row at 2 stages, M = 4: the schedules, their K1/K2/K3 launches
# per step (K1: GPipe once per layer and microbatch, remat twice — the
# checkpoint's recompute — and 1F1B 1.5 times: the first stage's blocks
# recompute in the backward tick, the last stage keeps its one graph for
# its own backward a tick later instead of running twice), bf16 gaps
# against one stage, the host-clock and profiled windows, and the peak
# activation bytes at microbatch STAGE_MICRO for M = 4 and 16 (GPipe keeps
# every microbatch's residuals, 1F1B at most 2S - 1 inputs); (c)
# pp_decode at SERVE_CFG; (d) the JAX CLI test's stage-ladder drill and its
# two pinned lines (tests/test_cli.py)
STAGE_CLI_STEPS, STAGE_CLI_RTOL = 20, 1e-4
STAGE_CLI_ROWS = {
    "lenet": (["--model", "lenet"], 2, 1),
    "mlp4": (["--model", "mlp", "--mlp-dims",
              ",".join(str(d) for d in MLP4)], 4, 1),
    "gpt": (["--model", "gpt", "--attn", "flash", "--batch-size", "32"], 2,
            4),
}
STAGE_SCHEDULES = {"gpipe": {}, "1f1b": dict(schedule="1f1b"),
                   "gpipe_remat": dict(remat=True)}
STAGE_LAUNCHES = {"gpipe": (16, 16, 16), "1f1b": (24, 16, 16),
                  "gpipe_remat": (32, 16, 16)}
STAGE_BF16_RTOL, STAGE_MICRO = 2e-2, 4
STAGE_GPIPE_GROWTH, STAGE_ONEFB_GROWTH = 2.0, 1.3
STAGE_TIMED_STEPS, STAGE_PROFILED_STEPS = 10, 5
PP_DECODE = dict(t0=32, n_new=24, reps=3)
STAGE_DRILL_PINS = (
    "restored ckpt-00000004.npz (step 4, written at 2 stages, repacked "
    "onto 1); resuming at epoch 2",
    "chaos: completed after 1 restart(s); attempts: 2st/fault(HostLost) "
    "-> 1st/completed")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _timed_run(body, n: int) -> float:
    """Device ms of ``n`` calls of ``body`` between one CUDA event pair.
    The run is enqueued behind a device-side spin, and counts only if the
    host finished enqueueing it before the device reached the start event:
    then no host dispatch time lies inside the pair. Otherwise the spin
    grows and the run shrinks (a full launch queue also blocks the host)."""
    import torch
    spin = 40_000_000                     # clock cycles, ~20 ms
    for _ in range(5):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        for _ in range(n):
            body()
        b.record()
        ahead = not a.query()
        torch.cuda.synchronize()
        if ahead:
            return a.elapsed_time(b) / n
        spin, n = 2 * spin, max(n // 2, 4)
    raise SmokeFailure("the host could not enqueue a timed run before the "
                       "device reached it")


def time_ms(fn, flush, n: int = 40, reps: int = 5) -> float:
    """Device time of one call of ``fn`` meeting a cold L2, as the decode
    tick meets each layer's K/V: runs of ``n`` (flush the L2 with a 64 MB
    write, call ``fn``) less runs of ``n`` flushes alone, each run between
    one event pair; the median of ``reps`` such differences."""
    for _ in range(3):
        fn()

    def both():
        flush.zero_()
        fn()

    return statistics.median(_timed_run(both, n) - _timed_run(flush.zero_, n)
                             for _ in range(reps))


def profiler_tally(fn, flush, name: str, n: int = 40) -> tuple[float, int]:
    """(self device us, launches) of the kernels whose name holds
    ``name`` over ``n`` (flush, ``fn``) calls, as ``torch.profiler``
    records them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key:
            total += float(getattr(e, "self_device_time_total", None)
                           or getattr(e, "self_cuda_time_total", 0))
            count += e.count
    return total, count


def profiled_kernel_ms(fn, flush, name: str, n: int = 40) -> float:
    """Cross-check of :func:`time_ms`: the mean self device time of the
    kernels whose name holds ``name`` over ``n`` (flush, ``fn``) calls,
    as ``torch.profiler`` records them; every launch must be seen."""
    total, count = profiler_tally(fn, flush, name, n)
    check(count == n, f"the profiler saw {count} launches of {name}, "
                      f"expected {n}")
    return total / count / 1e3


# -- phase 1 ------------------------------------------------------------------

def _toolkit_bin() -> str:
    from simple_distributed_machine_learning_tpu_torch.ops._cuda_build import (  # noqa: E501
        nvcc_path,
    )
    return os.path.dirname(nvcc_path())


def _demangled(counts: dict) -> dict:
    """``counts`` keyed by the demangled kernel names, where the toolkit
    has ``cu++filt``."""
    filt = os.path.join(_toolkit_bin(), "cu++filt")
    if counts and os.path.exists(filt):
        dem = subprocess.run([filt], input="\n".join(counts), text=True,
                             capture_output=True, timeout=60)
        if dem.returncode == 0 and len(dem.stdout.splitlines()) == len(counts):
            return dict(zip(dem.stdout.splitlines(), counts.values()))
    return counts


def ptxas_report(log: str) -> dict[str, dict]:
    """Registers and spill bytes of each kernel, from ``nvcc -Xptxas -v``'s
    output: ``{name: {"registers", "spill_stores", "spill_loads"}}``."""
    import re
    out: dict[str, dict] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name is not None:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out[name]["registers"] = int(m.group(1))
    return _demangled(out)


def _no_spill_required(name: str) -> bool:
    """K4 everywhere, and K1 at head dims up to 64: the bf16 tensor-core
    K1 padded to 16, 32 or 64, and the f32 SIMT K1's 4-column variant."""
    import re
    if "paged_attn_kernel" in name:
        return True
    m = re.search(r"flash_fwd_kernel(_bf16_mma)?(?:<(?:\(int\))?|ILi)(\d+)",
                  name)
    if not m:
        return False
    return int(m.group(2)) <= 64 if m.group(1) else int(m.group(2)) == 4


def sass_hmma_counts(lib_path) -> dict[str, int]:
    """Tensor-core (``HMMA``) instructions in each kernel of a built
    library, from ``cuobjdump -sass`` (beside ``nvcc``); names demangled
    with ``cu++filt`` where the toolkit has it."""
    out = subprocess.run([os.path.join(_toolkit_bin(), "cuobjdump"), "-sass",
                          str(lib_path)], capture_output=True, text=True,
                         timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()}")
    counts: dict[str, int] = {}
    name = None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and "HMMA" in line:
            counts[name] += 1
    return _demangled(counts)


def phase_build(record: dict) -> None:
    import torch
    from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (  # noqa: E501
        build_kernel,
    )
    record["card"] = card_line()
    print(f"chip_smoke: card {record['card']}")
    print(f"chip_smoke: python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from simple_distributed_machine_learning_tpu_torch.analysis.fixtures import (  # noqa: E501
        build_kernel as build_grid,
    )
    from simple_distributed_machine_learning_tpu_torch.ops.flash_attention import (  # noqa: E501
        build_kernel as build_flash,
    )
    # one nvcc per source, all started together
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        futures = [pool.submit(build_kernel), pool.submit(build_flash),
                   pool.submit(build_grid)]
        builds = [f.result() for f in futures]
    record["build_s"] = round(time.perf_counter() - t0, 3)
    ptxas: dict[str, dict] = {}
    for built in builds:
        print(f"chip_smoke: built {built.path.name} (nvcc "
              f"{built.build_s:.3f} s)")
        if not built.log:
            print("chip_smoke:   ptxas: no log (the library was built "
                  "earlier in this checkout)")
        ptxas.update(ptxas_report(built.log))
    for name, r in sorted(ptxas.items()):
        print(f"chip_smoke:   ptxas {r.get('registers', -1):4d} registers, "
              f"spill {r.get('spill_stores', -1)}/{r.get('spill_loads', -1)}"
              f" bytes  {name}")
    held = [n for n in ptxas if _no_spill_required(n)]
    # a fresh build reports the 4 K1 variants at dh <= 64 (f32, bf16 16 /
    # 32 / 64) and K4's 18 (5 storage types x K up to 1, 4, 8, and f32 at
    # dh > 128)
    check(not ptxas or len(held) == 4 + 18,
          f"ptxas reported {len(held)} K1/K4 kernels, not 22: {held}")
    spills = [n for n in held if ptxas[n].get("spill_stores", 0)
              or ptxas[n].get("spill_loads", 0)]
    check(not spills, f"K4 or K1 at dh <= 64 spills registers: {spills}")
    record["ptxas"] = ptxas
    print(f"chip_smoke: kernels built in {record['build_s']} s")
    hmma = sass_hmma_counts(builds[1].path)
    k4_hmma = sass_hmma_counts(builds[0].path)
    k4_hmma.update(sass_hmma_counts(builds[2].path))      # and F1
    for name, n in sorted({**hmma, **k4_hmma}.items()):
        print(f"chip_smoke:   SASS HMMA {n:5d}  {name}")
    mma = {n: c for n, c in hmma.items() if "_bf16_mma" in n}
    # the bf16 K1, K2 and K3, each at head dims padded to 16, 32, 64, 128
    check(len(mma) == 12 and all(c > 0 for c in mma.values()),
          f"the bf16 K1-K3 kernels are not all on the tensor cores: {mma}")
    simt = {n: c for n, c in {**hmma, **k4_hmma}.items()
            if "_bf16_mma" not in n and c}
    check(not simt, f"the f32 flash kernels, K4 or F1 use tensor cores: "
                    f"{simt}")
    record["sass_hmma"] = {**hmma, **k4_hmma}


# -- phase 2 ------------------------------------------------------------------

def _pool_case(name: str, K: int, gen, dev, dh: int = 64,
               bs: int = SERVE_BLOCK, layout: str = "layer",
               pos0: bool = False, slots: int = SERVE_SLOTS,
               spec_plan: bool = False):
    """The serving pool's shapes: [L=4, 129 blocks, 8 heads, 16, 64], one
    layer's view handed to the kernel as the engine does; 8 slots with
    ragged tables (trash 0 past each slot's position), one slot routed
    to the trash like a non-decoding slot. The options make K4's edge
    cases: another head dim or block size (8 x 256 / bs + 1 blocks);
    ``layout`` "block-major" (the pool stored [blocks, L, ...], so the
    layer's view strides its block axis past the other layers) or
    "misaligned" (rows of dh + 1, the view starting one element in, too
    narrow an alignment for the vector loads); ``pos0``: slot 1 at
    position 0 with a real table entry; ``slots``: another slot count;
    ``spec_plan``: slot 1 at 256 - K/2, so its later queries are clamped
    to 255 and repeat, and slot 2 four positions before a block boundary,
    so its queries straddle it."""
    import torch
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        _quantize_rows,
    )
    L, H, S = 4, 8, slots
    NB = 256 // bs
    nblk = S * NB + 1
    wide = dh + 1 if layout == "misaligned" else dh
    kc = torch.randn((L, nblk, H, bs, wide), generator=gen)
    vc = torch.randn((L, nblk, H, bs, wide), generator=gen)
    if name in ("int8", "float8_e4m3fn", "float8_e5m2"):
        (kd, ks), (vd, vs) = _quantize_rows(kc, name), _quantize_rows(vc, name)
    else:
        kd, vd = kc.to(getattr(torch, name)), vc.to(getattr(torch, name))
        ks = vs = None
    pos = torch.randint(0, 256, (S,), generator=gen)
    pos[0], pos[S - 1] = 255, 0
    if pos0:
        pos[1] = 0
    if spec_plan:
        pos[1], pos[2] = 256 - K // 2, 5 * bs - 4
    qpos = torch.clamp(pos[:, None] + torch.arange(K)[None, :], max=255)
    perm = torch.randperm(nblk - 1, generator=gen) + 1
    tables = torch.zeros((S, NB), dtype=torch.int32)
    for s in range(S - 1):
        n = int(qpos[s, -1]) // bs + 1
        tables[s, :n] = perm[s * NB:s * NB + n]
    q = torch.randn((S, H, K, dh), generator=gen)
    li = 2

    def layer(t, rows=True):
        """Layer li's view of a pool on the card (``rows``: values, whose
        last axis is sliced to dh on the card, not scales)."""
        if t is None:
            return None
        if layout == "block-major":
            return t.transpose(0, 1).contiguous().to(dev)[:, li]
        t = t.to(dev)[li]
        return t[..., wide - dh:] if rows else t

    return dict(q=q.to(dev), kc=layer(kd), vc=layer(vd),
                tables=tables.to(dev),
                qpos=qpos.to(torch.int32).contiguous().to(dev),
                kscale=layer(ks, False), vscale=layer(vs, False), bs=bs,
                kc32=layer(kc), vc32=layer(vc))


def _against_plain(name: str, c: dict) -> tuple[dict, bool, bool]:
    """K4 on one case against its plain version (``SAME_BYTES_TOL``) and
    against the unquantised f32 pool's answer (``ATTN_TOL``)."""
    import torch
    from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (  # noqa: E501
        paged_attention,
        paged_attention_reference,
    )
    args = (c["q"], c["kc"], c["vc"], c["tables"], c["qpos"])
    kw = dict(block_size=c["bs"], kscale=c["kscale"], vscale=c["vscale"])
    out = paged_attention(*args, **kw)
    torch.cuda.synchronize()
    ref = paged_attention_reference(*args, **kw)
    err = (out - ref).abs()
    rtol, atol = SAME_BYTES_TOL
    ok = bool(torch.isfinite(out).all()) and bool(
        (err <= atol + rtol * ref.abs()).all())
    wide = paged_attention_reference(c["q"], c["kc32"], c["vc32"],
                                     c["tables"], c["qpos"],
                                     block_size=c["bs"])
    werr = (out - wide).abs()
    wrtol, watol = ATTN_TOL[name]
    wide_ok = bool((werr <= watol + wrtol * wide.abs()).all())
    v = dict(dtype=name, K=int(c["q"].shape[2]), dh=int(c["q"].shape[3]),
             bs=c["bs"], max_abs_err=float(err.max()),
             max_rel_err=float((err / ref.abs().clamp_min(1e-6)).max()),
             rtol=rtol, atol=atol, max_abs_err_vs_f32=float(werr.max()),
             rtol_vs_f32=wrtol, atol_vs_f32=watol)
    return v, ok, wide_ok


def _bound(case: dict) -> tuple[float, str]:
    """Least time for this call's work: the larger of (bytes it must move)
    / HBM rate and (f32 operations it must do) / f32 rate. Bytes: the K/V
    rows up to each slot's newest position (and their scales) read once,
    q, tables entries, qpos read once, out written once."""
    S, H, K, dh = case["q"].shape
    qpos = case["qpos"].cpu()
    item = case["kc"].element_size()
    rows = int((qpos[:, -1] + 1).sum())
    n_kb = int(((qpos[:, -1] // case["bs"]) + 1).sum())
    nbytes = 2 * rows * H * dh * item + 4 * S * H * K * dh * 2
    nbytes += 4 * n_kb + 4 * S * K
    if case["kscale"] is not None:
        nbytes += 2 * rows * H * 4
    live = int((qpos + 1).sum())          # (query, key) pairs per head
    flops = 4 * live * H * dh             # q.k and p.v, 2 flops per MAC
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernels(record: dict) -> dict:
    import torch
    from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (  # noqa: E501
        paged_attention,
        paged_attention_reference,
    )
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=dev)
    variants = []
    for name in ATTN_TOL:
        for K in (1, 4):
            c = _pool_case(name, K, gen, dev)
            args = (c["q"], c["kc"], c["vc"], c["tables"], c["qpos"])
            kw = dict(block_size=c["bs"], kscale=c["kscale"],
                      vscale=c["vscale"])

            def kernel():
                return paged_attention(*args, **kw)

            def plain():
                return paged_attention_reference(*args, **kw)

            v, ok, wide_ok = _against_plain(name, c)
            max_abs, max_rel = v["max_abs_err"], v["max_rel_err"]
            rtol, atol = v["rtol"], v["atol"]
            wrtol = v["rtol_vs_f32"]
            bound_ms, bound_by = _bound(c)
            v.update(ms=time_ms(kernel, flush),
                     plain_ms=time_ms(plain, flush), bound_ms=bound_ms,
                     bound_by=bound_by)
            if name == "float32" and K == 1:
                v["profiler_ms"] = profiled_kernel_ms(kernel, flush,
                                                      "paged_attn_kernel")
            variants.append(v)
            xcheck = (f" (profiler {v['profiler_ms']:.4f} ms)"
                      if "profiler_ms" in v else "")
            print(f"chip_smoke: paged_attention {name:>13} K={K}: vs plain "
                  f"max abs {max_abs:.3e} rel {max_rel:.3e} (limits rtol "
                  f"{rtol} atol {atol}) {'ok' if ok else 'FAIL'}; vs the f32 "
                  f"pool max abs {v['max_abs_err_vs_f32']:.3e} (attn_tol "
                  f"{wrtol}) {'ok' if wide_ok else 'FAIL'}; kernel "
                  f"{v['ms']:.4f} ms{xcheck}, plain {v['plain_ms']:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by})")
            check(ok, f"paged_attention {name} K={K} disagrees with its "
                      f"plain version: max abs {max_abs}")
            check(wide_ok, f"paged_attention {name} K={K} is outside "
                           f"attn_tol of the f32 pool's answer: max abs "
                           f"{v['max_abs_err_vs_f32']}")
    main = next(v for v in variants
                if v["dtype"] == "float32" and v["K"] == 1)
    print(f"chip_smoke: paged_attention float32 K=1: kernel "
          f"{main['ms']:.4f} ms against its plain version "
          f"{main['plain_ms']:.4f} ms: {main['plain_ms'] / main['ms']:.2f}x "
          f"faster")
    check(main["ms"] < main["plain_ms"], "K4 is no faster than its plain "
                                         "version at the f32 K = 1 case")
    edges = []
    for name, K, opts in K4_EDGES:
        c = _pool_case(name, K, gen, dev, pos0=True, **opts)
        v, ok, wide_ok = _against_plain(name, c)
        v["case"] = opts
        edges.append(v)
        print(f"chip_smoke: paged_attention edge {name:>13} K={K} {opts}: "
              f"vs plain max abs {v['max_abs_err']:.3e} "
              f"{'ok' if ok else 'FAIL'}; vs the f32 pool max abs "
              f"{v['max_abs_err_vs_f32']:.3e} {'ok' if wide_ok else 'FAIL'}")
        check(ok and wide_ok, f"paged_attention edge case {name} K={K} "
                              f"{opts} disagrees: {v}")
    multi = []
    for name in ATTN_TOL:
        for K in K4_MULTI_GROUP:
            c = _pool_case(name, K, gen, dev, spec_plan=True)
            v, ok, wide_ok = _against_plain(name, c)
            v["case"] = "spec_plan"
            multi.append(v)
            # gated against the plain version only: the plan's early
            # queries attend one or two rows, whose whole rounding error
            # (fp8 e5m2: up to 1/8 of a value) no average dilutes, so the
            # narrow pool's distance from the f32 pool's answer is shown,
            # not held to attn_tol
            print(f"chip_smoke: paged_attention {name:>13} K={K} "
                  f"({-(-K // 8)} query groups, clamped and straddling "
                  f"plans): vs plain max abs {v['max_abs_err']:.3e} "
                  f"{'ok' if ok else 'FAIL'}; vs the f32 pool max abs "
                  f"{v['max_abs_err_vs_f32']:.3e} (attn_tol "
                  f"{v['atol_vs_f32']}: "
                  f"{'within' if wide_ok else 'outside'}, not gated)")
            check(ok, f"paged_attention {name} K={K} (query groups) "
                      f"disagrees with its plain version: {v}")
    spec_timed = []
    for K in (SPEC_K, 16):
        c = _pool_case("float32", K, gen, dev, slots=SPEC_SLOTS)
        args = (c["q"], c["kc"], c["vc"], c["tables"], c["qpos"])
        kw = dict(block_size=c["bs"])
        v, ok, wide_ok = _against_plain("float32", c)
        v["case"] = f"spec verify, {SPEC_SLOTS} slots"
        v["bound_ms"], v["bound_by"] = _bound(c)
        v["ms"] = time_ms(lambda: paged_attention(*args, **kw), flush)
        v["plain_ms"] = time_ms(
            lambda: paged_attention_reference(*args, **kw), flush)
        spec_timed.append(v)
        print(f"chip_smoke: paged_attention spec verify float32 K={K} "
              f"{SPEC_SLOTS} slots: vs plain max abs {v['max_abs_err']:.3e} "
              f"{'ok' if ok else 'FAIL'}; kernel {v['ms']:.4f} ms, plain "
              f"{v['plain_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms "
              f"({v['bound_by']}): {v['ms'] / v['bound_ms']:.1f}x the bound")
        check(ok and wide_ok, f"paged_attention spec verify K={K} "
                              f"disagrees: {v}")
    print("chip_smoke: paged_attention library_ms: none — no single "
          "PyTorch call computes block-table-gathered attention "
          "(scaled_dot_product_attention needs the rows gathered first)")
    record["kernel_variants"] = variants
    record["kernel_edges"] = edges
    record["kernel_multi_group"] = multi
    record["kernel_spec_verify"] = spec_timed
    return variants + edges + multi + spec_timed


def _flash_bound(name: str, shape, dtype) -> tuple[float, str]:
    """Least time for one flash kernel's work at ``shape`` [B, H, T, dh]:
    the larger of (bytes: each [B, H, T, dh] operand read once, each output
    written once, f32 row statistics) / HBM rate and (the causal products'
    operations: 2 per multiply-add over the T(T+1)/2 live pairs per head;
    K1 does q.k and p.v, K2 adds do.v and ds.k, K3 q.k, do.v, p.do and
    ds.q) / the peak rate of the input type (bf16 tensor cores; f32 outside
    them, since TF32 is off)."""
    B, H, T, dh = shape
    e = 2 if dtype == "bfloat16" else 4
    slab, rows = B * H * T * dh * e, B * H * T * 4
    nbytes, products = {
        "flash_forward": (3 * slab + slab + 2 * rows, 2),
        "flash_dq": (4 * slab + 3 * rows + slab, 3),
        "flash_dkv": (4 * slab + 3 * rows + 2 * slab, 4),
    }[name]
    flops = products * 2 * B * H * (T * (T + 1) // 2) * dh
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (BF16_FLOPS if dtype == "bfloat16" else F32_FLOPS)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _flash_inputs(shape, dtype, gen, dev):
    import torch
    q, k, v, do = (torch.randn(shape, generator=gen).to(dev, getattr(
        torch, dtype)) for _ in range(4))
    return q, k, v, do


def _flash_err(out, ref, rtol: float, atol: float) -> tuple[float, bool]:
    import torch
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    ok = bool(torch.isfinite(out).all()) and bool(
        (err <= atol + rtol * ref.abs()).all())
    return float(err.max()), ok


def phase_flash_kernels(record: dict) -> list[dict]:
    """K1, K2 and K3 against their plain versions on the card, for f32 and
    bf16, at the full-width training shape and at a ragged T = 200 (the
    masked tail live), plus the tiny ``gpt`` row's f32 shape and the bf16
    edge shapes ``FLASH_EDGES`` of the tensor-core K1-K3. K2 and K3 are
    fed the plain forward's statistics, so each is held alone. Each kernel
    is timed (as phase 2 times K4) at the shape its bench row gives it,
    beside its plain version, its bound and the library yardstick:
    ``scaled_dot_product_attention`` for K1, and SDPA's backward (forward
    and ``autograd.grad`` less the forward) for K2 + K3 together."""
    import torch
    import torch.nn.functional as F
    from simple_distributed_machine_learning_tpu_torch.ops import (
        flash_attention as fa,
    )
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=dev)
    cases = [("bfloat16", FLASH_SHAPE), ("bfloat16", FLASH_RAGGED),
             ("float32", FLASH_SHAPE), ("float32", FLASH_RAGGED),
             ("float32", FLASH_TINY_SHAPE)]
    cases += [("bfloat16", shape) for shape in FLASH_EDGES]
    timed = {("bfloat16", FLASH_SHAPE), ("float32", FLASH_TINY_SHAPE)}
    out = []
    for dtype, shape in cases:
        q, k, v, do = _flash_inputs(shape, dtype, gen, dev)
        o_ref, l_ref, m_ref = fa.flash_forward_reference(q, k, v)
        linv, delta = fa._backward_stats(o_ref, l_ref, do)
        bwd = (q, k, v, do, m_ref, linv, delta)
        runs = {
            "flash_forward": (lambda: fa.flash_forward(q, k, v),
                              lambda: fa.flash_forward_reference(q, k, v)),
            "flash_dq": (lambda: fa.flash_dq(*bwd),
                         lambda: fa.flash_dq_reference(*bwd)),
            "flash_dkv": (lambda: fa.flash_dkv(*bwd),
                          lambda: fa.flash_dkv_reference(*bwd)),
        }
        lib = {}
        if (dtype, shape) in timed:
            qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(qg, kg, vg,
                                                      is_causal=True)

            def sdpa_fb():
                return torch.autograd.grad(sdpa(), (qg, kg, vg), do)

            fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True), flush)
            lib = {"flash_forward": fwd_ms,
                   "backward": time_ms(sdpa_fb, flush) - fwd_ms}
        for name, (kernel, plain) in runs.items():
            got, ref = kernel(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            parts = {"flash_forward": ("o", "l", "m"), "flash_dq": ("dq",),
                     "flash_dkv": ("dk", "dv")}[name]
            errs, ok = {}, True
            for part, g, r in zip(parts, got, ref):
                rtol, atol = FLASH_TOL[(dtype, part in ("l", "m"),
                                        name != "flash_forward")]
                errs[part], part_ok = _flash_err(g, r, rtol, atol)
                ok = ok and part_ok
            v_ = dict(name=name, dtype=dtype, shape=list(shape),
                      max_abs_err=max(errs.values()), errs=errs)
            line = (f"chip_smoke: {name:13} {dtype:>8} {tuple(shape)}: vs "
                    f"plain max abs " + ", ".join(
                        f"{p} {e:.3e}" for p, e in errs.items())
                    + f" {'ok' if ok else 'FAIL'}")
            if lib:
                v_["ms"] = time_ms(kernel, flush)
                v_["plain_ms"] = time_ms(plain, flush)
                v_["bound_ms"], v_["bound_by"] = _flash_bound(name, shape,
                                                              dtype)
                v_["library_ms"] = lib.get(name, lib["backward"])
                line += (f"; kernel {v_['ms']:.4f} ms, plain "
                         f"{v_['plain_ms']:.4f} ms, bound "
                         f"{v_['bound_ms']:.4f} ms ({v_['bound_by']}), "
                         f"library {v_['library_ms']:.4f} ms")
            print(line)
            check(ok, f"{name} {dtype} {tuple(shape)} disagrees with its "
                      f"plain version: {errs}")
            out.append(v_)
    main = {v["name"]: v for v in out if v["dtype"] == "bfloat16"
            and tuple(v["shape"]) == FLASH_SHAPE}
    fwd = main["flash_forward"]
    print(f"chip_smoke: K1 bf16 {FLASH_SHAPE}: {fwd['ms']:.4f} ms against "
          f"SDPA's forward {fwd['library_ms']:.4f} ms: "
          f"{fwd['ms'] / fwd['library_ms']:.2f}x")
    record["flash_forward_vs_sdpa"] = dict(
        k1_ms=fwd["ms"], sdpa_forward_ms=fwd["library_ms"],
        ratio=fwd["ms"] / fwd["library_ms"])
    bwd_ms = main["flash_dq"]["ms"] + main["flash_dkv"]["ms"]
    sdpa_bwd = main["flash_dq"]["library_ms"]
    print(f"chip_smoke: K2 + K3 bf16 {FLASH_SHAPE}: {bwd_ms:.4f} ms against "
          f"SDPA's backward {sdpa_bwd:.4f} ms: {bwd_ms / sdpa_bwd:.2f}x")
    record["flash_backward_vs_sdpa"] = dict(k2_k3_ms=bwd_ms,
                                            sdpa_backward_ms=sdpa_bwd,
                                            ratio=bwd_ms / sdpa_bwd)
    print("chip_smoke: flash library_ms: K1's is "
          "scaled_dot_product_attention(is_causal=True); K2's and K3's are "
          "both SDPA's whole backward (forward + autograd.grad, less the "
          "forward): one call computes dq, dk and dv together")
    record["flash_variants"] = out
    return out


# -- phase 3 ------------------------------------------------------------------

def _count_decode_calls(engine) -> list[int]:
    """Count the engine's decode (or speculative) program calls from now
    on: one per tick that decodes; the count is the list's one entry."""
    calls = [0]
    attr = "_spec_fused" if engine.speculative else "_decode"
    inner = getattr(engine, attr)

    def counted(*a):
        calls[0] += 1
        return inner(*a)

    setattr(engine, attr, counted)
    return calls


def _decode_calls_of(engine) -> list[int]:
    """``engine``'s decode-call counter (``_count_decode_calls``), put on
    it the first time it is asked for."""
    calls = engine.__dict__.get("_chip_smoke_calls")
    if calls is None:
        calls = engine._chip_smoke_calls = _count_decode_calls(engine)
    return calls


def _engines_of(target) -> list:
    """The engines a tick of ``target`` steps: an engine's own, a
    supervisor's current one, or every alive replica's of a fleet."""
    if hasattr(target, "replicas"):
        return [r.supervisor.engine for r in target.replicas if r.alive]
    return [getattr(target, "engine", target)]


def _record_ticks(target) -> list[dict]:
    """Hook ``target.step`` (an engine, a supervisor or a fleet: the same
    surface, engines rebuilt by a crash or dropped by a replica loss) to
    record one row per tick: its start and host ms, the decode (or
    speculative) program calls summed over the engines it stepped, K4's
    launches in it (one global counter), whether a supervisor restarted or
    a replica was lost in it, and the memory allocated after it. An
    engine built inside a tick (a rebuild, an autoscaled replica) decodes
    from the next one on. ``del target.step`` unhooks it. A row holds no
    reference to an engine, so a crashed or lost one frees at once."""
    import torch
    from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (  # noqa: E501
        paged_attention,
    )
    rows: list[dict] = []
    step = target.step

    def recorded():
        before = [(_decode_calls_of(e), _decode_calls_of(e)[0])
                  for e in _engines_of(target)]
        l0 = paged_attention.launches
        r0 = getattr(target, "restarts", 0)
        x0 = getattr(target, "replica_losses", 0)
        t0 = time.perf_counter()
        out = step()
        ms = (time.perf_counter() - t0) * 1e3
        decode = sum(calls[0] - c0 for calls, c0 in before)
        del before
        rows.append(dict(
            t0=t0, ms=ms, decode=decode,
            launches=paged_attention.launches - l0,
            crashed=getattr(target, "restarts", 0) > r0,
            lost=getattr(target, "replica_losses", 0) > x0,
            mem=torch.cuda.memory_allocated()))
        return out

    target.step = recorded
    return rows


def _warm_engine(stages, cfg, kernel: str, **engine_kw):
    """Phase 3's engine (``engine_kw``: a draft for the speculative one),
    every shape warmed outside the measured trace as bench.py does (one
    small request per prompt-length bucket, plus decode ticks), with
    fresh metrics."""
    import numpy as np
    from simple_distributed_machine_learning_tpu_torch.serve import (
        InferenceEngine,
        ServeMetrics,
    )
    engine = InferenceEngine(stages, cfg, n_slots=SERVE_SLOTS,
                             block_size=SERVE_BLOCK, attn_kernel=kernel,
                             **engine_kw)
    for t0 in SERVE_SIM["prompt_lens"]:
        engine.submit(np.zeros(t0, np.int32), max_new_tokens=2)
    engine.drain()
    engine.metrics = ServeMetrics()
    return engine


def _serve(target) -> dict:
    """Phase 3's trace through ``target`` (``_warm_engine``'s engine, or a
    supervisor) under ``_record_ticks``: the report, the metrics summary,
    the trace's handles, the tick rows, K4's launches, the decode (or
    speculative) calls, and the host-clock ms per tick, mean and
    median."""
    from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (  # noqa: E501
        paged_attention,
    )
    from simple_distributed_machine_learning_tpu_torch.serve import (
        SimConfig,
        simulate,
    )
    first_rid = getattr(target, "engine", target)._next_rid
    rows = _record_ticks(target)
    paged_attention.launches = 0
    try:
        rep = simulate(target, SimConfig(**SERVE_SIM))
    finally:
        del target.step
    ms = [t["ms"] for t in rows]
    return dict(
        report=rep, summary=target.metrics.summary(),
        handles=[target.requests[first_rid + i]
                 for i in range(SERVE_SIM["n_requests"])],
        rows=rows, launches=paged_attention.launches,
        decode=sum(t["decode"] for t in rows),
        tick_ms=sum(ms) / len(ms), tick_ms_p50=statistics.median(ms))


def phase_serve(stages, cfg, record: dict) -> tuple[dict, list]:
    import torch
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        make_cached_decoder,
    )
    from simple_distributed_machine_learning_tpu_torch.ops.random import (
        key_data,
    )
    n_params = sum(p.numel() for p in stages[0].params.parameters())
    run = _serve(_warm_engine(stages, cfg, "fused"))
    rep, s, handles = run["report"], run["summary"], run["handles"]
    launches, ticks = run["launches"], run["decode"]
    print(f"chip_smoke: serve fused: {rep['completed']}/{rep['n_requests']} "
          f"requests, {s['tokens_generated']} tokens, "
          f"{s['tokens_per_sec']} tok/s, ttft p50/p95 {s['ttft_ms_p50']}/"
          f"{s['ttft_ms_p95']} ms, tpot p50/p95 {s['tpot_ms_p50']}/"
          f"{s['tpot_ms_p95']} ms, occupancy {s['slot_occupancy_mean']}, "
          f"{s['prefix_hit_blocks']} prefix hits, {s['cow_copies']} CoW; "
          f"{n_params} params on {torch.cuda.get_device_name(0)}")
    check(rep["completed"] == SERVE_SIM["n_requests"],
          f"only {rep['completed']}/{rep['n_requests']} requests completed")
    print(f"chip_smoke: paged_attention launches {launches} = "
          f"{cfg.n_layers} layers x {ticks} decode ticks: "
          f"{launches == cfg.n_layers * ticks}")
    check(ticks > 0 and launches == cfg.n_layers * ticks,
          f"kernel launches {launches} != {cfg.n_layers} x {ticks} ticks")
    drun = _serve(_warm_engine(stages, cfg, "dense"))
    drep, ds, dhandles = drun["report"], drun["summary"], drun["handles"]
    dlaunches = drun["launches"]
    check(drep["completed"] == SERVE_SIM["n_requests"] and dlaunches == 0,
          "the dense engine did not complete (or launched the kernel)")
    print(f"chip_smoke: serve dense: {ds['tokens_per_sec']} tok/s, tpot "
          f"p50/p95 {ds['tpot_ms_p50']}/{ds['tpot_ms_p95']} ms")
    greedy = [i for i, h in enumerate(handles) if h.temperature == 0.0]
    same_dense = [i for i in greedy
                  if handles[i].tokens == dhandles[i].tokens]
    params = [st.params for st in stages]
    same_solo = []
    for i in greedy:
        h = handles[i]
        t0 = int(h.prompt.shape[0])
        solo = make_cached_decoder(stages, cfg, t0, h.max_new_tokens)(
            params, h.prompt[None], key_data(h.seed))
        if solo[0, t0:].tolist() == h.tokens:
            same_solo.append(i)
    distinct = len({t for i in greedy for t in handles[i].tokens})
    print(f"chip_smoke: greedy streams equal to the dense engine's "
          f"{len(same_dense)}/{len(greedy)}, to the solo decoder's "
          f"{len(same_solo)}/{len(greedy)} ({distinct} distinct tokens)")
    check(len(greedy) >= 2 and len(same_dense) == len(greedy)
          and len(same_solo) == len(greedy),
          "greedy streams through the kernel differ from the dense path's "
          "or the solo decoder's")
    serve = dict(summary=s, dense_summary=ds, launches=launches,
                 decode_ticks=ticks, tick_ms=run["tick_ms"],
                 tick_ms_p50=run["tick_ms_p50"], greedy=len(greedy),
                 greedy_equal_dense=len(same_dense),
                 greedy_equal_solo=len(same_solo), n_params=n_params,
                 wall_s=rep["wall_s"], dense_wall_s=drep["wall_s"])
    record["serve"] = serve
    return serve, handles


def _spec_workload(vocab: int) -> list[dict]:
    """``SPEC_WORKLOAD``'s greedy requests, as the JAX bench makes them."""
    import numpy as np
    rng = np.random.default_rng(0)
    lens = SPEC_WORKLOAD["prompt_lens"]
    return [dict(prompt=rng.integers(0, vocab, lens[i % len(lens)]).astype(
                     np.int32), max_new_tokens=SPEC_WORKLOAD["max_new"])
            for i in range(SPEC_WORKLOAD["n_requests"])]


def _drain_counted(stages, cfg, reqs, kernel: str = "fused",
                   **engine_kw) -> dict:
    """``reqs``, all submitted up front, through a fresh engine (the
    ``kernel`` attention; ``engine_kw`` may pick the dense layout) on
    ``SPEC_SLOTS`` slots after a warm-up request per prompt length; the
    streams, engine ticks, K4 launches, decode or speculative calls, the
    summary and the host-clock seconds of the drain."""
    import numpy as np
    from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (  # noqa: E501
        paged_attention,
    )
    from simple_distributed_machine_learning_tpu_torch.serve import (
        InferenceEngine,
        ServeMetrics,
    )
    engine = InferenceEngine(stages, cfg, n_slots=SPEC_SLOTS,
                             block_size=SERVE_BLOCK, attn_kernel=kernel,
                             **engine_kw)
    for t0 in SPEC_WORKLOAD["prompt_lens"]:
        engine.submit(np.zeros(t0, np.int32), max_new_tokens=2)
    engine.drain()
    engine.metrics = metrics = ServeMetrics()
    calls = _count_decode_calls(engine)
    handles = [engine.submit(**r) for r in reqs]
    paged_attention.launches = 0
    _sync()
    t0 = time.perf_counter()
    ticks = 0
    while engine.busy:
        engine.step()
        ticks += 1
    _sync()
    wall_s = time.perf_counter() - t0
    return dict(streams=[list(h.tokens) for h in handles], ticks=ticks,
                launches=paged_attention.launches, calls=calls[0],
                summary=metrics.summary(), wall_s=wall_s,
                tokens=sum(len(h.tokens) for h in handles))


def phase_spec_serve(stages, cfg, serve: dict, plain_handles: list,
                     record: dict) -> dict:
    """Speculative decoding through the port's engine at full width
    (module docstring, phase 3b): drives (a) accept-all at ``SPEC_K``,
    (b) the CLI's draft on phase 3's trace, (c) accept-all at
    ``SPEC_K_WIDE`` (K4's two query groups), then the CLI itself. K4's
    launch count is set to 0 just before each drive and read just after;
    the kernel runs ``n_layers`` times per speculative tick."""
    import dataclasses

    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        make_cached_decoder,
        make_gpt_stages,
    )
    from simple_distributed_machine_learning_tpu_torch.ops.random import (
        fold_in,
        key_data,
    )
    rec: dict = {}
    record["spec_serve"] = rec
    reqs = _spec_workload(cfg.vocab)
    n_tok = SPEC_WORKLOAD["n_requests"] * SPEC_WORKLOAD["max_new"]

    # (a) accept-all at spec_k 4 against the plain engine
    plain = _drain_counted(stages, cfg, reqs)
    spec = _drain_counted(stages, cfg, reqs, draft_stages=stages,
                          draft_cfg=cfg, spec_k=SPEC_K)
    s = spec["summary"]
    tpt_plain, tpt_spec = n_tok / plain["ticks"], n_tok / spec["ticks"]
    params = [st.params for st in stages]
    solo_equal = 0
    for r, got in zip(reqs, spec["streams"]):
        t0 = int(r["prompt"].shape[0])
        solo = make_cached_decoder(stages, cfg, t0, r["max_new_tokens"])(
            params, r["prompt"][None], key_data(0))
        solo_equal += solo[0, t0:].tolist() == got
    rec["accept_all"] = dict(
        spec_k=SPEC_K, slots=SPEC_SLOTS, ticks_spec=spec["ticks"],
        ticks_plain=plain["ticks"], tokens_per_tick_spec=tpt_spec,
        tokens_per_tick_plain=tpt_plain,
        speedup_vs_plain=tpt_spec / tpt_plain,
        accept_rate=s.get("spec_accept_rate"), launches=spec["launches"],
        spec_ticks=spec["calls"], solo_equal=solo_equal,
        host_tokens_per_s_spec=spec["tokens"] / spec["wall_s"],
        host_tokens_per_s_plain=plain["tokens"] / plain["wall_s"],
        host_tick_ms_spec=spec["wall_s"] * 1e3 / spec["ticks"],
        host_tick_ms_plain=plain["wall_s"] * 1e3 / plain["ticks"],
        streams=spec["streams"], plain_streams=plain["streams"])
    a = rec["accept_all"]
    print(f"chip_smoke: spec (a) accept-all spec_k {SPEC_K}, {SPEC_SLOTS} "
          f"slots, {len(reqs)} greedy requests: accept rate "
          f"{a['accept_rate']}, {spec['ticks']} ticks against plain "
          f"{plain['ticks']}: {tpt_spec:.3f} tokens/tick against "
          f"{tpt_plain:.3f} ({a['speedup_vs_plain']:.2f}x); host clock "
          f"{a['host_tokens_per_s_spec']:.1f} against "
          f"{a['host_tokens_per_s_plain']:.1f} tok/s, tick "
          f"{a['host_tick_ms_spec']:.3f} against {a['host_tick_ms_plain']:.3f}"
          f" ms; K4 launches {spec['launches']} = {cfg.n_layers} x "
          f"{spec['calls']} spec ticks; streams equal to plain "
          f"{sum(x == y for x, y in zip(spec['streams'], plain['streams']))}"
          f"/{len(reqs)}, to solo {solo_equal}/{len(reqs)}")
    check(a["accept_rate"] == 1.0, f"accept-all rate {a['accept_rate']}")
    check(a["speedup_vs_plain"] >= 2.0,
          f"accept-all tokens per tick {tpt_spec} < 2x plain's {tpt_plain}")
    check(spec["streams"] == plain["streams"] and solo_equal == len(reqs),
          "accept-all speculative streams differ from plain or solo decode")
    check(spec["calls"] > 0
          and spec["launches"] == cfg.n_layers * spec["calls"],
          f"K4 launches {spec['launches']} != {cfg.n_layers} x "
          f"{spec['calls']} speculative ticks")

    # (b) the CLI's draft on phase 3's trace
    dcfg = dataclasses.replace(cfg, n_layers=max(1, cfg.n_layers // 2))
    dstages = make_gpt_stages(fold_in(0, 1), dcfg, 1)[0]
    run = _serve(_warm_engine(stages, cfg, "fused", draft_stages=dstages,
                              draft_cfg=dcfg, spec_k=SPEC_K))
    rep, bs_, handles = run["report"], run["summary"], run["handles"]
    launches, calls, tick_ms = run["launches"], run["decode"], run["tick_ms"]
    greedy = [i for i, h in enumerate(handles) if h.temperature == 0.0]
    same = sum(handles[i].tokens == plain_handles[i].tokens for i in greedy)
    ps = serve["summary"]
    rec["cli_draft"] = dict(
        completed=rep["completed"], summary=bs_, launches=launches,
        spec_ticks=calls, tick_ms=tick_ms, plain_tick_ms=serve["tick_ms"],
        greedy=len(greedy), greedy_equal_plain=same,
        streams=[list(h.tokens) for h in handles])
    print(f"chip_smoke: spec (b) draft of {dcfg.n_layers} layers, spec_k "
          f"{SPEC_K}, phase 3's trace: {rep['completed']}/"
          f"{rep['n_requests']}, accept rate {bs_.get('spec_accept_rate')} "
          f"({bs_.get('spec_accepted_tokens')}/"
          f"{bs_.get('spec_proposed_tokens')}), {bs_['tokens_per_sec']} "
          f"tok/s (plain {ps['tokens_per_sec']}), ttft p50/p95 "
          f"{bs_['ttft_ms_p50']}/{bs_['ttft_ms_p95']} ms (plain "
          f"{ps['ttft_ms_p50']}/{ps['ttft_ms_p95']}), tpot p50/p95 "
          f"{bs_['tpot_ms_p50']}/{bs_['tpot_ms_p95']} ms (plain "
          f"{ps['tpot_ms_p50']}/{ps['tpot_ms_p95']}), host-clock tick "
          f"{tick_ms:.3f} ms (plain {serve['tick_ms']:.3f}); K4 launches "
          f"{launches} = {cfg.n_layers} x {calls}; greedy streams equal to "
          f"plain {same}/{len(greedy)}")
    check(rep["completed"] == SERVE_SIM["n_requests"],
          f"spec (b) served {rep['completed']}/{rep['n_requests']}")
    check(len(greedy) >= 2 and same == len(greedy),
          "spec (b): greedy streams differ from the plain engine's")
    check(launches == cfg.n_layers * calls,
          f"spec (b): K4 launches {launches} != {cfg.n_layers} x {calls}")

    # (c) accept-all at spec_k 12: K4 with two query groups per launch
    wide = _drain_counted(stages, cfg, reqs, draft_stages=stages,
                          draft_cfg=cfg, spec_k=SPEC_K_WIDE)
    same = sum(x == y for x, y in zip(wide["streams"], plain["streams"]))
    rec["wide"] = dict(spec_k=SPEC_K_WIDE, ticks=wide["ticks"],
                       launches=wide["launches"], spec_ticks=wide["calls"],
                       accept_rate=wide["summary"].get("spec_accept_rate"),
                       greedy_equal_plain=same)
    print(f"chip_smoke: spec (c) accept-all spec_k {SPEC_K_WIDE}: "
          f"{wide['ticks']} ticks, accept rate "
          f"{rec['wide']['accept_rate']}, K4 launches {wide['launches']} = "
          f"{cfg.n_layers} x {wide['calls']}; streams equal to plain "
          f"{same}/{len(reqs)}")
    check(same == len(reqs), "spec (c): streams differ from plain decode")
    check(wide["calls"] > 0
          and wide["launches"] == cfg.n_layers * wide["calls"],
          f"spec (c): K4 launches {wide['launches']} != {cfg.n_layers} x "
          f"{wide['calls']}")

    # the CLI
    lines = _cli(["--model", "gpt", "--serve-sim", "8", "--serve-spec-k",
                  str(SPEC_K)])
    spec_line = [ln for ln in lines if ln.startswith("| serve: tp 1, spec_k "
                                                     f"{SPEC_K} accept_rate")]
    rec["cli"] = lines
    print(f"chip_smoke: spec CLI --serve-sim 8 --serve-spec-k {SPEC_K}: "
          f"{lines[1] if len(lines) > 1 else lines}; {spec_line}")
    check(len(spec_line) == 1
          and lines[1].startswith("| serve: 8/8 requests completed"),
          f"the CLI's speculative serve run printed {lines}")
    rec["launches"] = spec["launches"] + launches + wide["launches"]
    return rec


def phase_profile(stages, cfg, record: dict, n_ticks: int = 20) -> None:
    """A steady decode window at full occupancy (8 slots,
    32-token prompts): ``n_ticks`` ticks timed on the host clock, then
    ``n_ticks`` more under ``torch.profiler`` for the device's busy share
    and its time by kernel (Chrome trace in ``chiprun_out/``)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from simple_distributed_machine_learning_tpu_torch.serve import (
        InferenceEngine,
    )
    engine = InferenceEngine(stages, cfg, n_slots=SERVE_SLOTS,
                             block_size=SERVE_BLOCK, attn_kernel="fused")
    rng = np.random.default_rng(1)
    for _ in range(SERVE_SLOTS):
        engine.submit(rng.integers(0, cfg.vocab, 32).astype(np.int32),
                      max_new_tokens=2 * n_ticks + 8)
    while engine._prefilling:
        engine.step()
    for _ in range(3):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_ticks):
        engine.step()
    tick_ms = (time.perf_counter() - t0) * 1e3 / n_ticks
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            engine.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    check(len(engine._decoding_slots()) == SERVE_SLOTS,
          "the profiled window did not run at full occupancy")
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = (getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0))
        kernels.append((float(t), e.count, e.key))
    busy_us = sum(t for t, _, _ in kernels)
    check(busy_us > 0, "torch.profiler recorded no device time")
    kernels.sort(reverse=True)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "serve_profile.json"))
    prof_rec = dict(tick_ms=tick_ms, profiled_tick_ms=wall_us / 1e3 / n_ticks,
                    device_busy_share=busy_us / wall_us,
                    kernel_launches_per_tick=sum(c for _, c, _ in kernels)
                    / n_ticks,
                    top=[dict(name=k[:120], us_per_tick=t / n_ticks,
                              calls_per_tick=c / n_ticks)
                         for t, c, k in kernels[:10]])
    record["profile"] = prof_rec
    print(f"chip_smoke: profile: decode tick at 8/8 slots {tick_ms:.3f} ms "
          f"(host clock, unprofiled); under the profiler "
          f"{prof_rec['profiled_tick_ms']:.3f} ms, device busy "
          f"{prof_rec['device_busy_share']:.4f}, "
          f"{prof_rec['kernel_launches_per_tick']:.1f} kernels/tick")
    for k in prof_rec["top"]:
        print(f"chip_smoke:   {k['us_per_tick']:9.2f} us/tick "
              f"{k['calls_per_tick']:6.1f} calls  {k['name']}")


# -- phase 8: serving under faults ---------------------------------------------

def _scenario_run(name: str, stages, cfg, kernel: str, outdir: str,
                  **kw):
    """One scenario through the port's ``run_scenario`` on the card with
    ``attn_kernel=kernel``, ``outdir`` and ``kw`` (``route``,
    ``prefill_replicas``, ``trace``): ``(report, handles, tick rows)``, the
    rows ``_record_ticks``'s over every engine the run builds."""
    from simple_distributed_machine_learning_tpu_torch.resilience import (
        scenarios,
    )
    seen: dict = {}
    inner = scenarios.simulate

    def simulate(target, sim, **kw):
        seen["rows"] = _record_ticks(target)
        try:
            return inner(target, sim, **kw)
        finally:
            del target.step
            seen["handles"] = dict(target.requests)

    scenarios.simulate = simulate
    try:
        r = scenarios.run_scenario(name, stages, cfg, device=MAIN_DEVICE,
                                   attn_kernel=kernel, outdir=outdir, **kw)
    finally:
        scenarios.simulate = inner
    return r, seen["handles"], seen["rows"]


def phase_scenarios(record: dict) -> int:
    """(a) The six one-engine SLO scenarios through the port's
    ``run_scenario`` on the card, at the virtual clock, on
    ``SCENARIO_CFG`` (2 stages, random weights from seed 0), each run
    twice: attending through K4, and through the plain gather-then-dense
    path. The K4 run's counts, per-class TTFT p95 and overload-shed alert
    ticks must equal ``SCENARIO_PINS`` (``journal_bytes`` depends on the
    weights and is only printed), and K4 must launch ``n_layers`` times
    in every tick for each decode call in it. The pins hold on any
    weights, so what K4 computed is held by the dense run instead: the
    same greedy streams, and the same journal line for line. Returns K4's
    launches."""
    import tempfile

    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        GPTConfig,
        make_gpt_stages,
    )
    cfg = GPTConfig(**SCENARIO_CFG)
    stages = make_gpt_stages(0, cfg, 2)[0]
    rec: dict = {}
    record["scenarios"] = rec
    launches = 0
    for name, pin in SCENARIO_PINS.items():
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip-smoke-scen-") as d:
            runs = {k: _scenario_run(name, stages, cfg, k,
                                     os.path.join(d, k))
                    for k in ("fused", "dense")}
            journals = {}
            for k in runs:
                path = os.path.join(d, k, f"journal-{name}.jsonl")
                if os.path.exists(path):
                    with open(path) as f:
                        journals[k] = f.read().splitlines()
        r, handles, rows = runs["fused"]
        _, dhandles, drows = runs["dense"]
        got = (r["completed"], r["shed"], r.get("restarts"),
               r.get("preemptions", 0),
               {c: b["ttft_ms_p95"] for c, b in r["per_class"].items()})
        alerts = [(t["tick"], t["from"], t["to"])
                  for t in r.get("slo_alerts", {}).get("transitions", [])]
        decode = sum(t["decode"] for t in rows)
        k4 = sum(t["launches"] for t in rows)
        bad_ticks = _off_ticks(rows, cfg.n_layers)
        greedy = [rid for rid, h in handles.items() if h.temperature == 0.0]
        same = [rid for rid in greedy if rid in dhandles
                and list(handles[rid].tokens) == list(dhandles[rid].tokens)]
        same_journal = (journals.get("fused") == journals.get("dense")
                        if journals else None)
        launches += k4
        rec[name] = dict(completed=got[0], shed=got[1], restarts=got[2],
                         preemptions=got[3], ttft_p95_vms=got[4],
                         shed_by_reason=r.get("shed_by_reason"),
                         alerts=alerts, slo_ok=r["slo_ok"],
                         journal_bytes=r.get("journal_bytes"),
                         launches=k4, decode_calls=decode,
                         dense_launches=sum(t["launches"] for t in drows),
                         dense_decode_calls=sum(t["decode"] for t in drows),
                         greedy=len(greedy), greedy_equal_dense=len(same),
                         journal_lines=len(journals.get("fused", [])),
                         journal_equal_dense=same_journal,
                         seconds=time.perf_counter() - t0)
        print(f"chip_smoke: scenario {name}: {got[0]} completed, {got[1]} "
              f"shed {r.get('shed_by_reason', {})}, restarts {got[2]}, "
              f"preemptions {got[3]}, ttft p95 {got[4]} vms, alerts "
              f"{alerts}, slo_ok {r['slo_ok']}, journal_bytes "
              f"{r.get('journal_bytes')}; K4 launches {k4} = "
              f"{cfg.n_layers} x {decode} decode calls "
              f"({len(bad_ticks)} ticks off); against the dense run: "
              f"greedy streams {len(same)}/{len(greedy)}, journal "
              f"{rec[name]['journal_lines']} lines equal {same_journal} "
              f"({rec[name]['seconds']:.2f} s)")
        check(got == pin and r["slo_ok"],
              f"scenario {name}: {got} (slo_ok {r['slo_ok']}) != pin {pin}")
        want = SCENARIO_ALERTS.get(name, [])
        check(alerts == want, f"scenario {name}: alerts {alerts} != {want}")
        check(decode > 0 and not bad_ticks,
              f"scenario {name}: K4 launches {k4} over {decode} decode "
              f"calls; ticks {bad_ticks[:8]} launch other than "
              f"{cfg.n_layers} per decode call")
        check(rec[name]["dense_launches"] == 0
              and rec[name]["dense_decode_calls"] > 0,
              f"scenario {name}: the dense run launched K4 "
              f"{rec[name]['dense_launches']} times over "
              f"{rec[name]['dense_decode_calls']} decode calls")
        check(len(greedy) >= 4 and len(same) == len(greedy),
              f"scenario {name}: {len(same)}/{len(greedy)} greedy streams "
              f"through K4 equal the dense run's")
        if name in ("crash-serve", "overload-shed"):
            check(same_journal is True and rec[name]["journal_lines"] > 0,
                  f"scenario {name}: the journal through K4 differs from "
                  f"the dense run's")
    check(rec["overload-shed"]["shed_by_reason"] == {
        "backpressure": 5, "class": 18, "deadline": 2},
        f"overload-shed sheds {rec['overload-shed']['shed_by_reason']}")
    rec["launches"] = launches
    return launches


def _drill(stages, cfg, plain_handles: list, degrade_after=None) -> dict:
    """Phase 3's trace (``_serve``) through ``ServeSupervisor(
    engine_factory(..., attn_kernel="fused"))`` with an fsync'd journal in
    a temporary directory, under ``DRILL_CHAOS``. Adds to ``_serve``'s
    record the crash: the tick rows before and after it, the memory
    allocated around it, the restart cost and the journal's host time per
    append; and how many streams equal phase 3's ``plain_handles``."""
    import tempfile

    from simple_distributed_machine_learning_tpu_torch.resilience import (
        faults,
    )
    from simple_distributed_machine_learning_tpu_torch.serve import (
        ServeMetrics,
        ServeSupervisor,
        engine_factory,
    )
    metrics = ServeMetrics()
    appends: list[float] = []
    token_t: list[float] = []
    with tempfile.TemporaryDirectory(prefix="chip-smoke-journal-") as d:
        sup = ServeSupervisor(
            engine_factory(stages, cfg, attn_kernel="fused",
                           n_slots=SERVE_SLOTS, block_size=SERVE_BLOCK,
                           device="cuda", metrics=metrics),
            os.path.join(d, "journal.jsonl"), metrics=metrics,
            degrade_after=degrade_after)
        check(sup.journal.sync, "the drill's journal must fsync")
        kc = sup.engine.pool.kc
        pool_bytes = 2 * kc.numel() * kc.element_size()
        del kc
        append = sup.journal.append

        def timed_append(ev):
            t0 = time.perf_counter()
            append(ev)
            appends.append(time.perf_counter() - t0)
            if ev["ev"] == "tok":
                token_t.append(time.perf_counter())

        sup.journal.append = timed_append
        faults.install(faults.FaultPlan.parse(DRILL_CHAOS))
        try:
            run = _serve(sup)
        finally:
            faults.uninstall()
            sup.close()
            # the wrapper closes over the supervisor: unhook it, so the
            # supervisor and its engine free once this drill returns
            del sup.journal.append
    rows = run["rows"]
    crash = [i for i, t in enumerate(rows) if t["crashed"]]
    check(len(crash) == 1, f"drill: {len(crash)} crashed ticks, want 1")
    ci = crash[0]
    t_crash = rows[ci]["t0"]
    next_tok = [t for t in token_t if t > t_crash]
    s = run["summary"]
    handles = run["handles"]
    greedy = [i for i, h in enumerate(plain_handles)
              if h.temperature == 0.0]
    return dict(
        completed=run["report"]["completed"], restarts=sup.restarts,
        degraded=s.get("degraded"), layout_after=sup.engine.kv_layout,
        recovered=s.get("recovered_requests"), summary=s,
        launches=run["launches"],
        before=rows[:ci], after=rows[ci + 1:],
        decode_ticks_before=sum(t["decode"] for t in rows[:ci]),
        launches_before=sum(t["launches"] for t in rows[:ci]),
        decode_ticks_after=sum(t["decode"] for t in rows[ci + 1:]),
        launches_after=sum(t["launches"] for t in rows[ci + 1:]),
        crash_tick=ci, pool_bytes=pool_bytes,
        mem_before=rows[ci - 1]["mem"], mem_after=rows[ci]["mem"],
        restart_ms=(next_tok[0] - t_crash) * 1e3 if next_tok else None,
        crash_tick_ms=rows[ci]["ms"], tick_ms_p50=run["tick_ms_p50"],
        journal_records=len(appends),
        journal_append_ms_mean=sum(appends) * 1e3 / len(appends),
        journal_ms_total=sum(appends) * 1e3,
        greedy=len(greedy),
        greedy_equal=sum(handles[i].tokens == plain_handles[i].tokens
                         for i in greedy),
        sampled_equal=sum(handles[i].tokens == plain_handles[i].tokens
                          for i in range(len(handles)) if i not in greedy))


def _off_ticks(rows: list[dict], per_call: int) -> list[int]:
    """The ticks whose K4 launches are not ``per_call`` per decode call."""
    return [i for i, t in enumerate(rows)
            if t["launches"] != per_call * t["decode"]]


def phase_serve_faults(stages, cfg, serve: dict, plain_handles: list,
                       record: dict) -> int:
    """Phase 8 (module docstring): the six scenarios at the virtual clock
    (a), the wall-clock crash drill at full width (b), the degraded
    rebuild (c) and the CLI's chaos and scenario runs (d). Returns K4's
    launches over (a)-(c)."""
    rec: dict = {}
    record["serve_faults"] = rec
    launches = phase_scenarios(record)
    n_layers = cfg.n_layers
    ps = serve["summary"]

    # (b) the crash drill
    b = _drill(stages, cfg, plain_handles)
    rec["drill"] = {k: v for k, v in b.items()
                  if k not in ("summary", "before", "after")}
    bs_ = b["summary"]
    print(f"chip_smoke: drill (b) {DRILL_CHAOS!r} on phase 3's trace: "
          f"{b['completed']}/{SERVE_SIM['n_requests']} served, "
          f"{b['restarts']} restart at tick {b['crash_tick']}, "
          f"{b['recovered']} recovered; restart cost {b['restart_ms']} ms "
          f"(crash tick {b['crash_tick_ms']:.3f} ms); "
          f"{bs_['tokens_per_sec']} tok/s against phase 3's "
          f"{ps['tokens_per_sec']}; tick p50 {b['tick_ms_p50']:.3f} ms "
          f"against {serve['tick_ms_p50']:.3f}; ttft p50/p95 "
          f"{bs_['ttft_ms_p50']}/{bs_['ttft_ms_p95']} ms, tpot p50/p95 "
          f"{bs_['tpot_ms_p50']}/{bs_['tpot_ms_p95']} ms; journal "
          f"{b['journal_records']} fsync'd records, "
          f"{b['journal_append_ms_mean']:.4f} ms each, "
          f"{b['journal_ms_total']:.1f} ms in all; K4 launches "
          f"{b['launches_before']} = {n_layers} x "
          f"{b['decode_ticks_before']} before the crash, "
          f"{b['launches_after']} = {n_layers} x "
          f"{b['decode_ticks_after']} after; memory allocated "
          f"{b['mem_before']} before the crash, {b['mem_after']} after the "
          f"rebuild (pool {b['pool_bytes']}); greedy streams equal to "
          f"phase 3's {b['greedy_equal']}/{b['greedy']} (sampled "
          f"{b['sampled_equal']}/{SERVE_SIM['n_requests'] - b['greedy']})")
    check(b["completed"] == SERVE_SIM["n_requests"] and b["restarts"] == 1
          and b["recovered"] > 0,
          f"drill: {b['completed']} served, {b['restarts']} restarts, "
          f"{b['recovered']} recovered")
    check(b["greedy"] >= 2 and b["greedy_equal"] == b["greedy"],
          "drill: greedy streams differ from phase 3's")
    for side in ("before", "after"):
        off = _off_ticks(b[side], n_layers)
        check(b[f"decode_ticks_{side}"] > 0 and not off,
              f"drill: K4 launches other than {n_layers} per decode call "
              f"in ticks {off[:8]} of the {len(b[side])} {side} the crash")
    check(b["mem_after"] - b["mem_before"] <= b["pool_bytes"] // 2,
          f"drill: {b['mem_after'] - b['mem_before']} more bytes allocated "
          f"after the rebuild: the dead engine's pool "
          f"({b['pool_bytes']}) is still alive")
    check(b["restart_ms"] is not None, "drill: no token after the crash")

    # (c) the degraded rebuild
    c = _drill(stages, cfg, plain_handles, degrade_after=1)
    rec["degraded"] = {k: v for k, v in c.items()
                  if k not in ("summary", "before", "after")}
    print(f"chip_smoke: drill (c) degrade_after=1: "
          f"{c['completed']}/{SERVE_SIM['n_requests']} served, rebuilt "
          f"on kv_layout={c['layout_after']!r}, degraded {c['degraded']}, "
          f"{c['recovered']} recovered, restart cost {c['restart_ms']} ms, "
          f"{c['summary']['tokens_per_sec']} tok/s; K4 launches "
          f"{c['launches_before']} = {n_layers} x "
          f"{c['decode_ticks_before']} before, {c['launches_after']} after "
          f"({c['decode_ticks_after']} dense decode ticks); greedy streams "
          f"equal to phase 3's {c['greedy_equal']}/{c['greedy']}")
    check(c["completed"] == SERVE_SIM["n_requests"] and c["restarts"] == 1
          and c["degraded"] == 1 and c["layout_after"] == "dense",
          f"degraded drill: {c['completed']} served, restarts "
          f"{c['restarts']}, degraded {c['degraded']}, layout "
          f"{c['layout_after']}")
    check(c["greedy_equal"] == c["greedy"],
          "degraded drill: greedy streams differ from phase 3's")
    off = _off_ticks(c["before"], n_layers)
    check(c["decode_ticks_before"] > 0 and not off
          and c["decode_ticks_after"] > 0 and c["launches_after"] == 0,
          f"degraded drill: K4 launches {c['launches_before']} / "
          f"{c['launches_after']}, other than {n_layers} per decode call "
          f"in ticks {off[:8]} before the crash")

    # (d) the CLI
    lines = _cli(["--model", "gpt", "--serve-sim", "8", "--serve-chaos",
                  "engine-crash@serve.tick=6"])
    sup_line = [ln for ln in lines
                if ln.startswith("| serve: supervisor running, 1 restart(s)")]
    print(f"chip_smoke: CLI --serve-sim 8 --serve-chaos "
          f"engine-crash@serve.tick=6: {lines[2:4]}")
    check(len(sup_line) == 1 and any(
        ln.startswith("| serve: 8/8 requests completed") for ln in lines),
        f"the CLI's chaos run printed {lines}")
    scen = _cli(["--scenario", "crash-serve"])
    print(f"chip_smoke: CLI --scenario crash-serve: {scen}")
    check(scen[-1] == "| scenario: SLO ATTAINED"
          and "ttft p95 23.16 vms" in scen[1],
          f"the CLI's crash-serve scenario printed {scen}")
    rec["cli"] = lines + scen
    return launches + b["launches"] + c["launches"]


# -- phase 9: the traced fleet -----------------------------------------------

def _fleet_scenarios(record: dict) -> int:
    """(a) The five fleet scenarios and two variants (``FLEET_PINS``)
    through the port's ``run_scenario`` on the card at the virtual clock,
    on ``SCENARIO_CFG`` (2 stages, random weights from seed 0), each run
    three times: through K4, through the plain gather-then-dense path, and
    through K4 traced. The K4 run's counts, TTFT p95, fleet block and
    replica log must equal the pins, with K4 launched ``n_layers`` times
    per decode call summed over the replicas in every fleet tick; the
    dense run's greedy streams must equal it (the pins hold on any
    weights); the traced run must give the same report and the
    ``ATTRIBUTION_PINS``. Returns K4's launches."""
    import tempfile

    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        GPTConfig,
        make_gpt_stages,
    )
    from simple_distributed_machine_learning_tpu_torch.telemetry.attribution import (  # noqa: E501
        DRIFT_TOL_MS,
    )
    cfg = GPTConfig(**SCENARIO_CFG)
    stages = make_gpt_stages(0, cfg, 2)[0]
    rec: dict = {}
    record["fleet_scenarios"] = rec
    launches = 0
    for (name, over), pin in FLEET_PINS.items():
        kw = dict(over)
        label = name + "".join(f" {k}={v}" for k, v in over)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip-smoke-fleet-") as d:
            runs = {k: _scenario_run(name, stages, cfg, k,
                                     os.path.join(d, k), **kw)
                    for k in ("fused", "dense")}
            traced = _scenario_run(name, stages, cfg, "fused",
                                   os.path.join(d, "traced"), trace=True,
                                   **kw)[0]
        r, handles, rows = runs["fused"]
        _, dhandles, drows = runs["dense"]
        fl = r["fleet"]
        log = [(e["event"], e["replica"], e["tick"], e["alive"])
               for e in fl["replica_log"]]
        got_fleet = {k: (log if k == "replica_log" else fl[k])
                     for k in pin[2]}
        p95 = r["slo"].get("interactive", {}).get("ttft_ms_p95")
        decode = sum(t["decode"] for t in rows)
        k4 = sum(t["launches"] for t in rows)
        bad_ticks = _off_ticks(rows, cfg.n_layers)
        greedy = [rid for rid, h in handles.items() if h.temperature == 0.0]
        same = [rid for rid in greedy if rid in dhandles
                and list(handles[rid].tokens) == list(dhandles[rid].tokens)]
        att = traced["attribution"]
        top = att["top_slow"][0] if att["top_slow"] else {}
        got_att = (traced["trace_events"], att["requests"],
                   att["recovered"], top.get("rid"), top.get("ttft_ms"),
                   top.get("components_ms"))
        launches += k4
        rec[label] = dict(
            completed=r["completed"], ttft_p95_vms=p95, fleet=fl,
            prefix_hit_blocks=r.get("prefix_hit_blocks"),
            slo_ok=r["slo_ok"], launches=k4, decode_calls=decode,
            dense_launches=sum(t["launches"] for t in drows),
            greedy=len(greedy), greedy_equal_dense=len(same),
            traced=dict(events=traced["trace_events"],
                        attribution=att, slo_ok=traced["slo_ok"]),
            seconds=time.perf_counter() - t0)
        print(f"chip_smoke: fleet scenario {label}: {r['completed']} "
              f"completed, ttft p95 {p95} vms, fleet {fl['replicas']} "
              f"replica(s) ({fl['alive']} alive), losses "
              f"{fl['replica_losses']}, migrations {fl['migrations']}, "
              f"affinity hits {fl['affinity_hits']}, prefix hits "
              f"{r.get('prefix_hit_blocks')}, handoffs "
              f"{fl.get('handoffs', '-')}, log {log}, slo_ok {r['slo_ok']}; "
              f"K4 launches {k4} = {cfg.n_layers} x {decode} decode calls "
              f"over the replicas ({len(bad_ticks)} fleet ticks off); "
              f"greedy streams equal to the dense run's "
              f"{len(same)}/{len(greedy)}; traced: {got_att[0]} events, "
              f"{att['requests']} attributed, {att['recovered']} "
              f"recovered, max drift {att['max_abs_drift_ms']} ms, slowest "
              f"rid {got_att[3]} {got_att[4]} vms = {got_att[5]} "
              f"({rec[label]['seconds']:.2f} s)")
        check(r["completed"] == pin[0] and r["shed"] == 0 and r["slo_ok"]
              and (pin[1] is None or p95 == pin[1]) and got_fleet == pin[2]
              and (pin[3] is None or r["prefix_hit_blocks"] == pin[3]),
              f"fleet scenario {label}: completed {r['completed']}, p95 "
              f"{p95}, fleet {got_fleet}, prefix hits "
              f"{r.get('prefix_hit_blocks')}, slo_ok {r['slo_ok']} off "
              f"the pin {pin}")
        check(decode > 0 and not bad_ticks,
              f"fleet scenario {label}: K4 launches {k4} over {decode} "
              f"decode calls; fleet ticks {bad_ticks[:8]} launch other "
              f"than {cfg.n_layers} per decode call")
        check(rec[label]["dense_launches"] == 0,
              f"fleet scenario {label}: the dense run launched K4")
        check(len(greedy) >= 4 and len(same) == len(greedy),
              f"fleet scenario {label}: {len(same)}/{len(greedy)} greedy "
              f"streams through K4 equal the dense run's")
        check(traced["fleet"] == fl and traced["slo"] == r["slo"]
              and traced["completed"] == r["completed"]
              and att["requests"] == r["completed"]
              and att["max_abs_drift_ms"] <= DRIFT_TOL_MS,
              f"fleet scenario {label}: tracing moved the report, or the "
              f"attribution ({att['requests']} requests, drift "
              f"{att['max_abs_drift_ms']} ms) does not hold")
        if not over:
            check(got_att == ATTRIBUTION_PINS[name],
                  f"fleet scenario {name}: trace and attribution {got_att} "
                  f"!= {ATTRIBUTION_PINS[name]}")
    rec["launches"] = launches
    return launches


def _fleet_drill(stages, cfg, plain_handles: list, prefill: int = 0,
                 chaos: str | None = None) -> dict:
    """Phase 3's trace (``_serve``) through a two-replica ``ServeFleet``
    of ``engine_factory(..., attn_kernel="fused", n_slots=SERVE_SLOTS,
    block_size=SERVE_BLOCK)`` with fsync'd journals in a temporary
    directory — disaggregated 1 + 1 with ``prefill=1`` — under ``chaos``.
    Every replica's journal appends are timed, as ``_drill`` times them.
    Adds to ``_serve``'s record the loss (its tick, the memory allocated
    around it, the migrated rids: the adopters' ``snap`` records with
    ``why`` "failure"; and the migration cost: from the start of the tick
    whose top fired the kill to the next journaled token of a migrated
    request, on the host clock), the handoffs and the journal's host time
    per handoff (the destination's fsync'd snap and the source's fsync'd
    tombstone), and how many greedy streams equal phase 3's."""
    import tempfile

    from simple_distributed_machine_learning_tpu_torch.resilience import (
        faults,
    )
    from simple_distributed_machine_learning_tpu_torch.serve import (
        ServeFleet,
        ServeMetrics,
        engine_factory,
    )
    metrics = ServeMetrics()
    # (host-clock end of the append, its seconds, the record)
    appends: list[tuple[float, float, dict]] = []

    def timed(append):
        def timed_append(ev):
            t0 = time.perf_counter()
            append(ev)
            t1 = time.perf_counter()
            appends.append((t1, t1 - t0, ev))
        return timed_append

    with tempfile.TemporaryDirectory(prefix="chip-smoke-fleet-") as d:
        fleet = ServeFleet(
            engine_factory(stages, cfg, attn_kernel="fused",
                           n_slots=SERVE_SLOTS, block_size=SERVE_BLOCK,
                           device="cuda", metrics=metrics),
            d, n_replicas=2, prefill_replicas=prefill, metrics=metrics)
        journals = [r.supervisor.journal for r in fleet.replicas]
        check(all(j.sync for j in journals),
              "the fleet drill's journals must fsync")
        kc = fleet.replicas[0].supervisor.engine.pool.kc
        pool_bytes = 2 * kc.numel() * kc.element_size()
        del kc
        for j in journals:
            j.append = timed(j.append)
        if chaos:
            faults.install(faults.FaultPlan.parse(chaos))
        try:
            run = _serve(fleet)
        finally:
            faults.uninstall()
            fleet.close()
            # the wrappers close over the record list only; unhook them
            for j in journals:
                del j.append
    rows = run["rows"]
    lost = [i for i, t in enumerate(rows) if t["lost"]]
    handoff_s = sum(dt for _, dt, ev in appends
                    if ev["ev"] == "handoff"
                    or (ev["ev"] == "snap" and ev.get("why") == "handoff"))
    out = dict(completed=run["report"]["completed"], summary=run["summary"],
               launches=run["launches"], decode=run["decode"], rows=rows,
               tick_ms_p50=run["tick_ms_p50"], pool_bytes=pool_bytes,
               losses=fleet.replica_losses, migrations=fleet.migrations,
               handoffs=fleet.handoffs, lost_ticks=lost,
               handoff_ms_per_request=(handoff_s * 1e3
                                       / max(fleet.handoffs, 1)))
    if lost:
        li = lost[0]
        t_kill = rows[li]["t0"]
        migrated = {ev["rid"] for t, _, ev in appends
                    if t > t_kill and ev["ev"] == "snap"
                    and ev.get("why") == "failure"}
        nxt = [t for t, _, ev in appends if t > t_kill
               and ev["ev"] == "tok" and ev["rid"] in migrated]
        # rows[i] is fleet tick i + 1
        out.update(loss_tick=li + 1, mem_before=rows[li - 1]["mem"],
                   mem_after=rows[li]["mem"], migrated=sorted(migrated),
                   migration_ms=((nxt[0] - t_kill) * 1e3 if nxt
                                 else None))
    handles = run["handles"]
    greedy = [i for i, h in enumerate(plain_handles)
              if h.temperature == 0.0]
    out.update(greedy=len(greedy), greedy_equal=sum(
        handles[i].tokens == plain_handles[i].tokens for i in greedy))
    return out


def _traced_serve(stages, cfg, outdir: str) -> tuple[dict, dict, object]:
    """Phase 3's trace through a warmed fused engine twice: untraced, then
    with a ``ServeTrace(outdir)`` and a ``FlightRecorder`` attached after
    the warm-up (so only the trace's 24 requests are recorded). Returns
    both runs and the recorder."""
    from simple_distributed_machine_learning_tpu_torch.serve import (
        FlightRecorder,
        ServeTrace,
    )
    plain = _serve(_warm_engine(stages, cfg, "fused"))
    engine = _warm_engine(stages, cfg, "fused")
    trace = ServeTrace(outdir=outdir)
    engine.trace, engine.flight = trace, FlightRecorder()
    try:
        traced = _serve(engine)
    finally:
        trace.close()
    traced["flight_rows"] = engine.flight.ticks_recorded
    return plain, traced, trace


def _span_balance(events: list[dict]) -> tuple[int, int]:
    """(orphan ends, unclosed begins) over a Chrome trace's async spans."""
    open_count: dict = {}
    orphans = 0
    for e in events:
        key = (e.get("cat"), e.get("id"), e["name"])
        if e["ph"] == "b":
            open_count[key] = open_count.get(key, 0) + 1
        elif e["ph"] == "e":
            if open_count.get(key, 0) < 1:
                orphans += 1
            else:
                open_count[key] -= 1
    return orphans, sum(v for v in open_count.values() if v)


def phase_fleet(stages, cfg, serve: dict, plain_handles: list,
                record: dict) -> int:
    """Phase 9 (module docstring): the fleet scenarios at the virtual
    clock, traced and attributed (a), the full-width replica-loss drill
    (b), the disaggregated fleet at full width (c), tracing at full width
    (d) and the CLI's fleet, trace and disaggregated runs (e). Returns
    K4's launches over (a)-(d)."""
    import subprocess
    import tempfile

    from simple_distributed_machine_learning_tpu_torch.telemetry.attribution import (  # noqa: E501
        DRIFT_TOL_MS,
        attribute,
    )
    rec: dict = {}
    record["fleet"] = rec
    launches = _fleet_scenarios(record)
    n_layers = cfg.n_layers
    ps = serve["summary"]
    n = SERVE_SIM["n_requests"]

    # (b) the replica-loss drill
    b = _fleet_drill(stages, cfg, plain_handles, chaos=FLEET_DRILL_CHAOS)
    bs_ = b["summary"]
    rec["drill"] = {k: v for k, v in b.items() if k not in ("summary",
                                                            "rows")}
    rec["drill"]["summary"] = bs_
    print(f"chip_smoke: fleet drill (b) {FLEET_DRILL_CHAOS!r}, 2 replicas, "
          f"phase 3's trace: {b['completed']}/{n} served, {b['losses']} "
          f"loss at tick {b.get('loss_tick')}, {b['migrations']} "
          f"migrated {b.get('migrated')}; migration cost "
          f"{b.get('migration_ms')} ms (from the start of the killing "
          f"tick to the next journaled token of a migrated request); "
          f"{bs_['tokens_per_sec']} tok/s against "
          f"phase 3's {ps['tokens_per_sec']}; fleet tick p50 "
          f"{b['tick_ms_p50']:.3f} ms against phase 3's tick "
          f"{serve['tick_ms_p50']:.3f}; ttft p50/p95 {bs_['ttft_ms_p50']}/"
          f"{bs_['ttft_ms_p95']} ms; memory allocated {b.get('mem_before')} "
          f"before the loss, {b.get('mem_after')} after (pool "
          f"{b['pool_bytes']}); K4 launches {b['launches']} = {n_layers} x "
          f"{b['decode']} decode calls over the replicas; greedy streams "
          f"equal to phase 3's {b['greedy_equal']}/{b['greedy']}")
    check(b["completed"] == n and b["losses"] == 1 and b["migrations"] >= 1,
          f"fleet drill: {b['completed']} served, {b['losses']} losses, "
          f"{b['migrations']} migrations")
    check(b["greedy"] >= 2 and b["greedy_equal"] == b["greedy"],
          "fleet drill: greedy streams differ from phase 3's")
    off = _off_ticks(b["rows"], n_layers)
    check(b["decode"] > 0 and not off,
          f"fleet drill: K4 launches other than {n_layers} per decode call "
          f"in fleet ticks {off[:8]}")
    check(b["mem_after"] <= b["mem_before"],
          f"fleet drill: {b['mem_after'] - b['mem_before']} more bytes "
          f"allocated after the loss: the lost replica's pool is alive")
    check(b["migration_ms"] is not None,
          "fleet drill: no migrated request emitted after the loss")

    # (c) disaggregated, 1 prefill + 1 decode
    c = _fleet_drill(stages, cfg, plain_handles, prefill=1)
    cs = c["summary"]
    rec["disagg"] = {k: v for k, v in c.items() if k not in ("summary",
                                                             "rows")}
    rec["disagg"]["summary"] = cs
    print(f"chip_smoke: disaggregated (c) 1 prefill + 1 decode, phase 3's "
          f"trace: {c['completed']}/{n} served, {c['handoffs']} handoffs, "
          f"{c['handoff_ms_per_request']:.4f} ms of journal host time "
          f"per handoff (fsync'd snap on the destination, fsync'd "
          f"tombstone on the source); ttft "
          f"p50/p95 {cs['ttft_ms_p50']}/{cs['ttft_ms_p95']} ms against "
          f"phase 3's {ps['ttft_ms_p50']}/{ps['ttft_ms_p95']}; "
          f"{cs['tokens_per_sec']} tok/s against {ps['tokens_per_sec']}; "
          f"fleet tick p50 {c['tick_ms_p50']:.3f} ms; K4 launches "
          f"{c['launches']} = {n_layers} x {c['decode']} decode calls; "
          f"greedy streams equal to phase 3's "
          f"{c['greedy_equal']}/{c['greedy']}")
    check(c["completed"] == n and c["handoffs"] == n,
          f"disaggregated: {c['completed']} served, {c['handoffs']} "
          f"handoffs, want {n} each")
    check(c["greedy_equal"] == c["greedy"],
          "disaggregated: greedy streams differ from phase 3's")
    off = _off_ticks(c["rows"], n_layers)
    check(c["decode"] > 0 and not off,
          f"disaggregated: K4 launches other than {n_layers} per decode "
          f"call in fleet ticks {off[:8]}")

    # (d) tracing at full width, on the host clock
    with tempfile.TemporaryDirectory(prefix="chip-smoke-trace-") as d:
        plain, traced, trace = _traced_serve(stages, cfg, d)
        att = attribute(trace.rows)
        with open(os.path.join(d, trace.trace_file)) as f:
            orphans, unclosed = _span_balance(json.load(f)["traceEvents"])
        rep = subprocess.run(
            [sys.executable, "-m", f"{PORT}.telemetry.report", "--dir", d],
            capture_output=True, text=True, timeout=120, cwd=HERE)
    greedy = [i for i, h in enumerate(plain_handles)
              if h.temperature == 0.0]
    same = sum(traced["handles"][i].tokens == plain_handles[i].tokens
               for i in greedy)
    rec["traced"] = dict(
        events=trace.n_events, attributed=att["requests"],
        max_abs_drift_ms=att["max_abs_drift_ms"], by_class=att["by_class"],
        top_slow=att["top_slow"], orphan_ends=orphans, unclosed=unclosed,
        flight_rows=traced["flight_rows"],
        tick_ms_p50=traced["tick_ms_p50"],
        untraced_tick_ms_p50=plain["tick_ms_p50"],
        tick_ms=traced["tick_ms"], untraced_tick_ms=plain["tick_ms"],
        report_rc=rep.returncode, greedy=len(greedy), greedy_equal=same,
        launches=traced["launches"] + plain["launches"])
    print(f"chip_smoke: traced (d) phase 3's trace: {trace.n_events} "
          f"events, {att['requests']} attributed, max drift "
          f"{att['max_abs_drift_ms']} ms on the host clock, slowest "
          + (f"rid {att['top_slow'][0]['rid']} "
             f"{att['top_slow'][0]['ttft_ms']} ms = "
             f"{att['top_slow'][0]['components_ms']}" if att["top_slow"]
             else "-")
          + f"; spans orphan/unclosed {orphans}/{unclosed}; "
          f"{traced['flight_rows']} flight rows; decode tick p50 "
          f"{traced['tick_ms_p50']:.4f} ms traced against "
          f"{plain['tick_ms_p50']:.4f} untraced (mean "
          f"{traced['tick_ms']:.4f} / {plain['tick_ms']:.4f}); report CLI "
          f"rc {rep.returncode}; greedy streams equal to phase 3's "
          f"{same}/{len(greedy)}")
    check(att["requests"] == n and att["max_abs_drift_ms"] <= DRIFT_TOL_MS,
          f"traced: {att['requests']} attributed, drift "
          f"{att['max_abs_drift_ms']} ms")
    check(orphans == 0 and unclosed == 0,
          f"traced: {orphans} orphan ends, {unclosed} unclosed spans")
    check(rep.returncode == 0 and "timeline" in rep.stdout,
          f"the report CLI exited {rep.returncode}: {rep.stderr[-400:]}")
    check(same == len(greedy) and traced["flight_rows"] > 0,
          "traced: greedy streams differ from phase 3's")
    for run in (plain, traced):
        off = _off_ticks(run["rows"], n_layers)
        check(run["decode"] > 0 and not off,
              f"traced: K4 launches other than {n_layers} per decode "
              f"call in ticks {off[:8]}")

    # (e) the CLI
    with tempfile.TemporaryDirectory(prefix="chip-smoke-cli-") as d:
        lines = _cli(["--model", "gpt", "--serve-sim", "8",
                      "--serve-replicas", "2", "--serve-trace",
                      "--telemetry-dir", d])
        files = sorted(os.listdir(d))
    dis = _cli(["--model", "gpt", "--serve-sim", "8", "--serve-replicas",
                "2", "--serve-prefill-replicas", "1"])
    scen = _cli(["--scenario", "disagg-prefill-heavy"])
    print(f"chip_smoke: CLI --serve-sim 8 --serve-replicas 2 --serve-trace: "
          f"{lines[1:]}, files {files}; --serve-prefill-replicas 1: "
          f"{dis[2:]}; --scenario disagg-prefill-heavy: {scen}")
    check(any(ln.startswith("| serve: 8/8 requests completed")
              for ln in lines) and "request_timeline.jsonl" in files
          and "serve_trace.json" in files
          and any(ln.startswith("| serve: trace ") for ln in lines),
          f"the CLI's traced fleet run printed {lines}, wrote {files}")
    check(any(ln.startswith("| serve: disaggregated — 8 prefill->decode")
              for ln in dis),
          f"the CLI's disaggregated run printed {dis}")
    check(scen[-1] == "| scenario: SLO ATTAINED"
          and any("ttft p95 74.719 vms" in ln for ln in scen),
          f"the CLI's disagg-prefill-heavy scenario printed {scen}")
    rec["cli"] = lines + dis + scen
    return (launches + b["launches"] + c["launches"]
            + rec["traced"]["launches"])


# -- phases 5-6: training ------------------------------------------------------

def _flash_counts() -> tuple[int, int, int]:
    from simple_distributed_machine_learning_tpu_torch.ops import (
        flash_attention as fa,
    )
    return (fa.flash_forward.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches)


def _reset_flash_counts() -> None:
    from simple_distributed_machine_learning_tpu_torch.ops import (
        flash_attention as fa,
    )
    fa.flash_forward.launches = fa.flash_dq.launches = 0
    fa.flash_dkv.launches = 0


def _train_setup(row: dict, attn_impl: str):
    """The bench row's model (random weights from seed 0), pipeline,
    optimizer and a pool of 2 random token batches (float ids, as
    ``bench.py::_data_gpt`` makes them)."""
    import torch
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        GPTConfig,
        make_gpt_stages,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        Pipeline,
    )
    from simple_distributed_machine_learning_tpu_torch.train import (
        adamw,
        sgd,
    )
    cfg = GPTConfig(**row["cfg"], attn_impl=attn_impl)
    stages, wire_dim, out_dim = make_gpt_stages(0, cfg, 1)
    pipe = Pipeline(stages, None, wire_dim, out_dim,
                    n_microbatches=row["n_micro"],
                    compute_dtype=row["dtype"] and getattr(torch,
                                                           row["dtype"]))
    opt = (adamw(1e-3) if row["opt"] == "adamw"
           else sgd(0.1, momentum=0.5))
    gen = torch.Generator().manual_seed(1)
    shape = (TRAIN_POOL, row["batch"], cfg.seq_len)
    xs = torch.randint(0, cfg.vocab, shape, generator=gen).float()
    ts = torch.randint(0, cfg.vocab, shape, generator=gen)
    return cfg, pipe, opt, xs.to(pipe.device), ts.to(pipe.device)


def _train_window(pipe, opt, xs, ts, steps: int):
    """``steps`` optimizer steps from fresh weights through
    ``make_scanned_train_step`` over the pool; host-clock seconds to the
    synchronised end, and the per-step losses."""
    import torch
    from simple_distributed_machine_learning_tpu_torch.train import (
        make_scanned_train_step,
    )
    params = pipe.init_params()
    state = opt.init(params)
    step = make_scanned_train_step(pipe, opt, pool_steps=steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, losses = step(params, state, xs, ts, 0)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, losses.cpu().tolist()


def _leaky_core(q, k, v):
    """A known-wrong attention core: the dense one with the causal mask one
    key too wide, so each query also sees its successor."""
    import math

    import torch
    t = q.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    keep = torch.ones((t, t), dtype=torch.bool, device=q.device).tril(1)
    p = torch.softmax(torch.where(keep, s, -math.inf), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def _wrong_attention_window(dpipe, dopt, xs, ts) -> list[float]:
    """The flash-vs-dense gate's negative control: the dense pipeline's
    ``TRAIN_COMPARE_STEPS`` steps with :func:`_leaky_core` in place of the
    model's attention core; the per-step losses."""
    from simple_distributed_machine_learning_tpu_torch.models import (
        gpt as gpt_mod,
    )
    core = gpt_mod.causal_attention_core
    gpt_mod.causal_attention_core = _leaky_core
    try:
        return _train_window(dpipe, dopt, xs, ts, TRAIN_COMPARE_STEPS)[1]
    finally:
        gpt_mod.causal_attention_core = core


def phase_train(name: str, row: dict, record: dict) -> dict:
    """One bench row's training on the port's main path: ``Pipeline`` +
    ``make_scanned_train_step`` with ``attn_impl="flash"`` for
    ``TRAIN_STEPS`` steps (after a 2-step warm-up window), then the same
    weights and batches with ``attn_impl="dense"`` for
    ``TRAIN_COMPARE_STEPS`` steps, and with a known-wrong attention core.
    Checks: finite losses whose last-5 mean is below the first; K1, K2 and
    K3 launched exactly ``n_layers`` times per step each (counts set to 0
    just before the flash run, read just after), and never by the dense
    run; flash and dense losses within the row's limit over the compared
    steps, and the wrong run's losses outside it."""
    import math

    import torch
    cfg, pipe, opt, xs, ts = _train_setup(row, "flash")
    _train_window(pipe, opt, xs, ts, 2)                 # warm-up
    torch.cuda.reset_peak_memory_stats()
    _reset_flash_counts()
    wall_s, losses = _train_window(pipe, opt, xs, ts, TRAIN_STEPS)
    counts = _flash_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    n_params = sum(p.numel() for p in pipe.stages[0].params.parameters())
    step_ms = wall_s * 1e3 / TRAIN_STEPS
    tokens = row["batch"] * cfg.seq_len
    print(f"chip_smoke: train {name} (flash, {row['dtype'] or 'float32'}, "
          f"{row['opt']}, batch {row['batch']}, {n_params} params): "
          f"{TRAIN_STEPS} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"step {step_ms:.3f} ms (host clock), "
          f"{row['batch'] * 1e3 / step_ms:.1f} samples/s, "
          f"{tokens * 1e3 / step_ms:.0f} tokens/s, peak {peak_mb:.0f} MiB")
    check(all(math.isfinite(v) for v in losses),
          f"{name}: non-finite training loss {losses}")
    last5 = sum(losses[-5:]) / 5
    check(last5 < losses[0], f"{name}: the loss did not fall (first "
                             f"{losses[0]}, mean of the last 5 {last5})")
    want = cfg.n_layers * TRAIN_STEPS
    print(f"chip_smoke: {name} launches K1/K2/K3 {counts} = {cfg.n_layers} "
          f"layers x {TRAIN_STEPS} steps: {counts == (want,) * 3}")
    check(counts == (want,) * 3, f"{name}: flash launches {counts} != "
                                 f"{cfg.n_layers} x {TRAIN_STEPS} each")
    _, dpipe, dopt, _, _ = _train_setup(row, "dense")
    _reset_flash_counts()
    _, dlosses = _train_window(dpipe, dopt, xs, ts, TRAIN_COMPARE_STEPS)
    check(_flash_counts() == (0, 0, 0), f"{name}: the dense run launched "
                                        f"a flash kernel")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, dlosses))
    wlosses = _wrong_attention_window(dpipe, dopt, xs, ts)
    wrong = max(abs(a - b) / abs(b) for a, b in zip(wlosses, dlosses))
    limit = row["flash_vs_dense_rtol"]
    print(f"chip_smoke: {name} flash vs dense losses over "
          f"{TRAIN_COMPARE_STEPS} steps: max rel diff {rel:.3e} (limit "
          f"{limit}) {'ok' if rel <= limit else 'FAIL'}; a causal mask one "
          f"key too wide vs dense: {wrong:.3e} "
          f"{'caught' if wrong > limit else 'MISSED'}")
    check(rel <= limit, f"{name}: flash and dense losses differ by {rel} "
                        f"relative (limit {limit})")
    check(wrong > limit, f"{name}: the limit {limit} does not tell a wrong "
                         f"attention path (gap {wrong}) from a sound one")
    out = dict(steps=TRAIN_STEPS, losses=losses,
               dense_losses=dlosses, flash_vs_dense_max_rel=rel,
               wrong_attention_losses=wlosses,
               wrong_vs_dense_max_rel=wrong,
               flash_vs_dense_rtol=limit, step_ms=step_ms,
               samples_per_s=row["batch"] * 1e3 / step_ms,
               tokens_per_s=tokens * 1e3 / step_ms, launches=counts,
               peak_mib=peak_mb, n_params=n_params)
    record.setdefault("train", {})[name] = out
    return out


def phase_train_profile(row: dict, record: dict, n_steps: int = 5) -> None:
    """Where a full-width flash training step's time goes: ``n_steps``
    ``make_train_step`` calls under ``torch.profiler`` after a warm-up —
    the device's busy share, kernel launches per step and device time by
    kernel (Chrome trace in ``chiprun_out/``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from simple_distributed_machine_learning_tpu_torch.train import (
        make_train_step,
    )
    cfg, pipe, opt, xs, ts = _train_setup(row, "flash")
    params = pipe.init_params()
    state = opt.init(params)
    step = make_train_step(pipe, opt)
    for i in range(3):
        params, state, _ = step(params, state, xs[i % TRAIN_POOL],
                                ts[i % TRAIN_POOL])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_steps):
            params, state, _ = step(params, state, xs[i % TRAIN_POOL],
                                    ts[i % TRAIN_POOL])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = (getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0))
        kernels.append((float(t), e.count, e.key))
    busy_us = sum(t for t, _, _ in kernels)
    check(busy_us > 0, "torch.profiler recorded no device time")
    flash = {}                      # K1, K2, K3: (us per step, launches)
    for kern in ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel"):
        hits = [(t, c) for t, c, k in kernels if kern in k]
        check(bool(hits), f"the profiled step shows no {kern}")
        flash[kern] = (sum(t for t, _ in hits) / n_steps,
                       sum(c for _, c in hits) / n_steps)
    # the bf16 K1 runs the tensor-core kernel, once per layer per step
    k1_mma = sum(c for _, c, k in kernels
                 if "flash_fwd_kernel_bf16_mma" in k) / n_steps
    print(f"chip_smoke:   flash_fwd_kernel_bf16_mma launches per step "
          f"{k1_mma:.1f} (n_layers {cfg.n_layers})")
    check(k1_mma == cfg.n_layers, f"the profiled step launched "
                                  f"flash_fwd_kernel_bf16_mma {k1_mma} "
                                  f"times per step, not {cfg.n_layers}")
    kernels.sort(reverse=True)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "train_profile.json"))
    flash_us = sum(t for t, _, k in kernels if "flash_" in k)
    prof_rec = dict(profiled_step_ms=wall_us / 1e3 / n_steps,
                    device_busy_share=busy_us / wall_us,
                    device_ms_per_step=busy_us / 1e3 / n_steps,
                    flash_kernels_ms_per_step=flash_us / 1e3 / n_steps,
                    kernel_launches_per_step=sum(c for _, c, _ in kernels)
                    / n_steps,
                    flash_us_per_step={k: v[0] for k, v in flash.items()},
                    top=[dict(name=k[:120], us_per_step=t / n_steps,
                              calls_per_step=c / n_steps)
                         for t, c, k in kernels[:12]])
    record["train_profile"] = prof_rec
    print(f"chip_smoke: profile: gpt_bf16 flash train step under the "
          f"profiler {prof_rec['profiled_step_ms']:.3f} ms, device busy "
          f"{prof_rec['device_busy_share']:.4f} "
          f"({prof_rec['device_ms_per_step']:.3f} ms/step, flash kernels "
          f"{prof_rec['flash_kernels_ms_per_step']:.3f} ms), "
          f"{prof_rec['kernel_launches_per_step']:.1f} kernels/step")
    print("chip_smoke:   flash kernels per step: " + ", ".join(
        f"{kern} {us:.2f} us ({n:.1f} calls)"
        for kern, (us, n) in flash.items()))
    for k in prof_rec["top"]:
        print(f"chip_smoke:   {k['us_per_step']:9.2f} us/step "
              f"{k['calls_per_step']:6.1f} calls  {k['name']}")


# -- phase 7: the reference's main path ----------------------------------------

def _quiet(fn, *args):
    """``fn(*args)`` with its console captured: ``(result, text)``."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def _cli(argv: list[str]) -> list[str]:
    """``cli.main(argv)`` in this process on ``MAIN_DEVICE``; its console
    lines, blank ones dropped."""
    from simple_distributed_machine_learning_tpu_torch.cli import main as cli
    text = _quiet(cli, ["--rank", "0", "--world_size", "1", "--device",
                        MAIN_DEVICE] + argv)[1]
    return [line for line in text.split("\n") if line]


def _main_rows() -> dict:
    """``bench.py::_configs``'s lenet, mlp2 and mlp4 rows: each builder
    (random weights from seed 0, one stage on the card) and whether its
    input is the image or the flattened image."""
    from simple_distributed_machine_learning_tpu_torch.models import (
        make_lenet_stages,
        make_mlp_stages,
    )
    return {"lenet": (lambda dev: make_lenet_stages(0, 1, dev), False),
            "mlp2": (lambda dev: make_mlp_stages(0, MLP2, 1, dev), True),
            "mlp4": (lambda dev: make_mlp_stages(0, MLP4, 1, dev), True)}


def _row_data(flat: bool):
    """The reference's data as the CLI loads it without MNIST files: the
    synthetic set at 6000/1000 samples."""
    from simple_distributed_machine_learning_tpu_torch.data.mnist import (
        Dataset,
        synthetic_mnist,
    )
    train, test = synthetic_mnist(n_train=6000, n_test=1000)
    if flat:
        train = Dataset(train.x.reshape(len(train.x), -1), train.y)
        test = Dataset(test.x.reshape(len(test.x), -1), test.y)
    return train, test


def _trainer(row: str, device, epochs: int, ckpt_dir: str | None, **kw):
    """A reference-configured ``Trainer`` (batch 60, SGD lr 0.1 momentum
    0.5) on one of ``_main_rows``, ``kw`` more ``TrainConfig`` fields; its
    console goes nowhere."""
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        Pipeline,
    )
    from simple_distributed_machine_learning_tpu_torch.train import (
        TrainConfig,
        Trainer,
    )
    build, flat = _main_rows()[row]
    stages, wire_dim, out_dim = build(device)
    train, test = _row_data(flat)
    cfg = TrainConfig(epochs=epochs, checkpoint_dir=ckpt_dir,
                      print_throughput=False, **kw)
    return Trainer(Pipeline(stages, None, wire_dim, out_dim, device=device),
                   train, test, cfg)


def _sync() -> None:
    import torch
    if MAIN_DEVICE == "cuda":
        torch.cuda.synchronize()


def _resume_gap(row: str, tmp: str) -> tuple[float, int]:
    """Two epochs straight against one epoch, a checkpoint and a resumed
    second epoch, on the card: the largest relative difference of the
    final parameters and momentum (0.0 = bit-exact), and the accuracy of
    the straight run on the 1000 test samples."""
    straight = _trainer(row, MAIN_DEVICE, 2, None)
    _quiet(straight.fit)
    _, correct = _quiet(straight.evaluate)[0]
    ck = os.path.join(tmp, f"{row}_resume")
    _quiet(_trainer(row, MAIN_DEVICE, 1, ck).fit)
    resumed, log = _quiet(_trainer, row, MAIN_DEVICE, 2, ck)
    check("| resumed from" in log and resumed.start_epoch == 2,
          f"{row}: the second trainer did not resume: {log!r}")
    _quiet(resumed.fit)
    gap = 0.0
    pairs = (list(zip(straight.params[0].parameters(),
                      resumed.params[0].parameters()))
             + list(zip(straight.opt_state, resumed.opt_state)))
    for a, b in pairs:
        d = (a - b).abs().max().item()
        gap = max(gap, d / max(a.abs().max().item(), 1e-30))
    return gap, correct


def _lenet_steps(device, batches, conv_apply=None) -> list[float]:
    """``MAIN_COMPARE_STEPS`` deterministic SGD steps (lr 0.1, momentum
    0.5, dropout off) of the fused LeNet from seed 0's weights on
    ``device``; the per-step losses. ``conv_apply`` replaces the conv
    stage (the known-wrong twin)."""
    import dataclasses

    from simple_distributed_machine_learning_tpu_torch.models import lenet
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        Pipeline,
    )
    from simple_distributed_machine_learning_tpu_torch.train import sgd
    stages, wire_dim, out_dim = lenet.make_lenet_stages(0, 1, device)
    if conv_apply is not None:
        def fused(params, x, key=None, deterministic=True):
            h = conv_apply(params["conv"], x, key, deterministic)
            return lenet._fc_apply(params["fc"], h, key, deterministic)
        stages = [dataclasses.replace(stages[0], apply=fused)]
    pipe = Pipeline(stages, None, wire_dim, out_dim, device=device)
    opt = sgd(0.1, 0.5)
    params = pipe.init_params()
    state = opt.init(params)
    losses = []
    for b in batches:
        loss, grads = pipe.loss_and_grads(params, b.x, b.y,
                                          deterministic=True)
        params, state = opt.update(grads, state, params)
        losses.append(float(loss))
    return losses


def _chw_conv_apply(params, x, key=None, deterministic=True):
    """LeNet's conv stage flattened in torch's (C, H, W) order where the
    JAX layout flattens (H, W, C): fc1 reads the wrong features."""
    from simple_distributed_machine_learning_tpu_torch.models import lenet
    h = lenet.relu(lenet.max_pool2d(lenet.conv2d(params["conv1"], x), 2))
    h = lenet.relu(lenet.max_pool2d(lenet.conv2d(params["conv2"], h), 2))
    return h.permute(0, 3, 1, 2).reshape(h.shape[0], lenet.FEATURES)


def _time_row(row: str) -> dict:
    """One row's training step at batch 60 on the card: ``make_train_step``
    (SGD lr 0.1, momentum 0.5) fed one pageable host -> device copy per
    batch as the Trainer feeds it. Host-clock ms per step over
    ``MAIN_TIMED_STEPS`` steps after ``MAIN_WARMUP_STEPS``, ending in a
    synchronise; then ``MAIN_PROFILED_STEPS`` steps under
    ``torch.profiler``: the device's busy share and device ms per step."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from simple_distributed_machine_learning_tpu_torch.data.mnist import (
        batches,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        Pipeline,
    )
    from simple_distributed_machine_learning_tpu_torch.train import (
        make_train_step,
        sgd,
    )
    build, flat = _main_rows()[row]
    stages, wire_dim, out_dim = build(MAIN_DEVICE)
    pipe = Pipeline(stages, None, wire_dim, out_dim, device=MAIN_DEVICE)
    opt = sgd(0.1, 0.5)
    params = pipe.init_params()
    state = opt.init(params)
    step = make_train_step(pipe, opt)
    feed = list(batches(_row_data(flat)[0], 60))
    n_params = sum(p.numel() for p in params[0].parameters())

    def run(i0: int, n: int):
        nonlocal params, state
        for i in range(i0, i0 + n):
            b = feed[i % len(feed)]
            params, state, _ = step(params, state, torch.from_numpy(b.x),
                                    torch.from_numpy(b.y), i)

    run(0, MAIN_WARMUP_STEPS)
    _sync()
    t0 = time.perf_counter()
    run(MAIN_WARMUP_STEPS, MAIN_TIMED_STEPS)
    _sync()
    step_ms = (time.perf_counter() - t0) * 1e3 / MAIN_TIMED_STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(0, MAIN_PROFILED_STEPS)
        _sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, launches, host = 0.0, 0, []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += float(getattr(e, "self_device_time_total", None)
                             or getattr(e, "self_cuda_time_total", 0))
            launches += e.count
        else:
            host.append((float(e.self_cpu_time_total), e.count, e.key))
    check(busy_us > 0, f"{row}: torch.profiler recorded no device time")
    n = MAIN_PROFILED_STEPS
    out = dict(batch=60, n_params=n_params, step_ms=step_ms,
               samples_per_s=60e3 / step_ms,
               profiled_step_ms=wall_us / 1e3 / n,
               device_ms_per_step=busy_us / 1e3 / n,
               device_busy_share=busy_us / wall_us,
               device_ops_per_step=launches / n,
               host_ops_ms_per_step=sum(t for t, _, _ in host) / 1e3 / n)
    check(all(np.isfinite(v) for v in out.values()),
          f"{row}: non-finite timing {out}")
    out["host_top"] = [dict(name=k[:80], us_per_step=t / n,
                            calls_per_step=c / n)
                       for t, c, k in sorted(host, reverse=True)[:8]]
    return out


def phase_main_path(record: dict) -> None:
    """The reference's main path on the card, through the port's CLI and
    Trainer: the LeNet CLI run with checkpoints, metrics and a resume; the
    LeNet trajectory on the card against the port's CPU path, with a
    known-wrong twin outside the limit; ``mlp2`` learning and its resume
    bit-exact; ``gpt --attn flash`` through the CLI with exactly
    ``n_layers`` launches of K1, K2 and K3 per step; and the step times of
    the lenet, mlp2 and mlp4 rows."""
    import math
    import re
    import tempfile

    from simple_distributed_machine_learning_tpu_torch.data.mnist import (
        batches,
    )
    rec: dict = {}
    record["main_path"] = rec
    with tempfile.TemporaryDirectory() as tmp:
        ck, metrics = os.path.join(tmp, "lenet"), os.path.join(tmp, "m.jsonl")
        argv = ["--model", "lenet", "--data-root",
                os.path.join(tmp, "no-mnist"), "--checkpoint-dir", ck,
                "--metrics-json", metrics]
        t0 = time.perf_counter()
        lines = _cli(argv + ["--epochs", "2"])
        cli_s = time.perf_counter() - t0
        bad = [ln for ln in lines if not (TRAIN_RE.match(ln) or
                                          TEST_RE.match(ln) or
                                          EPOCH_RE.match(ln))]
        check(not bad, f"lenet CLI: lines off the reference formats: {bad}")
        losses = [float(TRAIN_RE.match(ln).group(5)) for ln in lines
                  if TRAIN_RE.match(ln)]
        check(len(losses) == 20 and all(math.isfinite(v) for v in losses),
              f"lenet CLI: expected 20 finite loss lines, got {losses}")
        with open(metrics) as f:
            recs = [json.loads(ln) for ln in f]
        check(len(recs) == 2 and all(r["schema"] == 2 for r in recs),
              f"lenet CLI: expected 2 schema-2 records, got {recs}")
        again = _cli(argv + ["--epochs", "3"])
        want = f"| resumed from {ck}/state.npz at epoch 3 (step 200)"
        check(again[0] == want and any(ln.startswith("Train Epoch: 3 [")
                                       for ln in again),
              f"lenet CLI rerun: expected {want!r} then epoch 3, got "
              f"{again[:3]}")
        rec["lenet_cli"] = dict(
            seconds=cli_s, console=lines, resumed=again,
            samples_per_s=[float(EPOCH_RE.match(ln).group(2))
                           for ln in lines if EPOCH_RE.match(ln)],
            accuracy=[r["accuracy"] for r in recs])
        print(f"chip_smoke: main path: lenet CLI 2 epochs in {cli_s:.1f} s, "
              f"losses {losses[0]} -> {losses[-1]}, "
              f"{[ln for ln in lines if EPOCH_RE.match(ln)]}, test "
              f"accuracy {rec['lenet_cli']['accuracy']}; rerun: {again[0]}")

        # the trajectory on the card against the port's CPU path
        feed = list(batches(_row_data(False)[0], 60))[:MAIN_COMPARE_STEPS]
        cpu = _lenet_steps("cpu", feed)
        card = _lenet_steps(MAIN_DEVICE, feed)
        wrong = _lenet_steps(MAIN_DEVICE, feed, _chw_conv_apply)

        def worst(ls):
            return max(abs(a - b) / abs(b) / (1e-4 * (i + 1) + 1e-5)
                       for i, (a, b) in enumerate(zip(ls, cpu)))
        ok, caught = worst(card), worst(wrong)
        rec["lenet_card_vs_cpu"] = dict(cpu=cpu, card=card, wrong=wrong,
                                        worst_share_of_limit=ok,
                                        wrong_share_of_limit=caught)
        print(f"chip_smoke: main path: lenet {MAIN_COMPARE_STEPS} "
              f"deterministic SGD steps, card vs CPU: worst gap "
              f"{ok:.3f} of rel=1e-4*(i+1)+1e-5 "
              f"{'ok' if ok <= 1 else 'FAIL'}; a (C, H, W) flatten: "
              f"{caught:.1f} of it {'caught' if caught > 1 else 'MISSED'}")
        check(ok <= 1, f"lenet on the card left the CPU path's trajectory: "
                       f"{card} vs {cpu}")
        check(caught > 1, "the trajectory limit does not tell a (C, H, W) "
                          "flatten from the sound LeNet")

        # mlp2 learns, and resumes bit-exact; LeNet's resume gap
        for row in ("mlp2", "lenet"):
            gap, correct = _resume_gap(row, tmp)
            rec[f"{row}_resume"] = dict(max_rel_gap=gap, accuracy=correct)
            print(f"chip_smoke: main path: {row} 2 epochs: test accuracy "
                  f"{correct}/1000; 1 + resumed 1 epoch vs 2 straight: max "
                  f"rel gap {gap:.3e} "
                  f"({'bit-exact' if gap == 0 else 'NOT bit-exact'})")
        check(rec["mlp2_resume"]["accuracy"] > 500,
              f"mlp2 did not learn: {rec['mlp2_resume']['accuracy']}/1000")
        check(rec["mlp2_resume"]["max_rel_gap"] == 0.0,
              "mlp2's resumed run is not bit-exact on the card")
        check(rec["lenet_resume"]["max_rel_gap"] == 0.0,
              "lenet's resumed run is not bit-exact on the card")

        # the GPT through the CLI: K2 and K3 run per train step and layer,
        # K1 also per eval batch (the 1000-sequence test set at batch 60)
        _reset_flash_counts()
        glines = _cli(["--model", "gpt", "--attn", "flash", "--dryrun",
                       str(MAIN_GPT_STEPS), "--generate", "8"])
        counts = _flash_counts()
        n_layers = 2
        evals = -(-1000 // 60)
        want3 = (n_layers * (MAIN_GPT_STEPS + evals),
                 n_layers * MAIN_GPT_STEPS, n_layers * MAIN_GPT_STEPS)
        rec["gpt_cli"] = dict(console=glines, launches=counts,
                              expected=want3)
        print(f"chip_smoke: main path: gpt --attn flash --dryrun "
              f"{MAIN_GPT_STEPS} through the CLI: K1/K2/K3 launches "
              f"{counts} = {n_layers} layers x ({MAIN_GPT_STEPS} steps "
              f"[+ {evals} eval batches for K1]): {counts == want3}; "
              f"{[ln for ln in glines if TEST_RE.match(ln)]}")
        check(counts == want3, f"gpt CLI: flash launches {counts} != "
                               f"{want3}")
        check(any(ln.startswith("| sample tokens") for ln in glines),
              "gpt CLI: --generate printed no sample")

    rows = {}
    for row in ("lenet", "mlp2", "mlp4"):
        rows[row] = r = _time_row(row)
        print(f"chip_smoke: main path: {row} ({r['n_params']} params, "
              f"batch 60, SGD): step {r['step_ms']:.4f} ms (host clock, "
              f"{MAIN_TIMED_STEPS} steps), {r['samples_per_s']:.1f} "
              f"samples/s; profiled: {r['profiled_step_ms']:.4f} ms/step, "
              f"device {r['device_ms_per_step']:.4f} ms/step, busy "
              f"{r['device_busy_share']:.4f}, "
              f"{r['device_ops_per_step']:.1f} device ops/step; host ops "
              f"{r['host_ops_ms_per_step']:.4f} ms/step, most: " + ", ".join(
                  f"{h['name']} {h['us_per_step']:.1f} us"
                  for h in r["host_top"][:4]))
    rec["rows"] = rows


# -- phase 10: training that survives faults -----------------------------------

def _mem() -> int:
    import torch
    if MAIN_DEVICE != "cuda":
        return 0
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _under(spec: str | None, fn, *args):
    """``fn(*args)`` quietly with the fault plan ``spec`` installed (None:
    no plan), uninstalled afterwards."""
    from simple_distributed_machine_learning_tpu_torch.resilience import (
        faults,
    )
    if spec:
        faults.install(faults.FaultPlan.parse(spec))
    try:
        return _quiet(fn, *args)[0]
    finally:
        faults.uninstall()


def _same_params(a, b) -> bool:
    import torch
    return all(torch.equal(x, y) for x, y in zip(a[0].parameters(),
                                                 b[0].parameters()))


def _epoch_ms(trainer, epoch: int) -> float:
    t0 = time.perf_counter()
    _quiet(trainer.train_epoch, epoch)          # ends in a synchronise
    return (time.perf_counter() - t0) * 1e3


def _sentinel_mlp2(rec: dict, tmp: str, mlp2_step_ms: float) -> None:
    """Phase 10 (a): the sentinel's pins, cost and rollback on ``mlp2``."""
    import shutil

    import torch
    def trainer(epochs, steps, ckpt=None, sentinel=True):
        return _trainer("mlp2", MAIN_DEVICE, epochs, ckpt, sentinel=sentinel,
                        max_steps_per_epoch=steps)

    out: dict = {}
    rec["mlp2_sentinel"] = out
    for spec, kinds in SENTINEL_FAULTS.items():
        d = os.path.join(tmp, spec.split("@")[0])
        tr = trainer(2, SENTINEL_STEPS, ckpt=d)
        _under(spec, tr.fit)
        s = tr.sentinel
        q = s.journal.records[0] if len(s.journal.records) == 1 else None
        out[spec] = dict(stats=s.stats(), record=q)
        print(f"chip_smoke: sentinel mlp2 {spec}: {s.by_kind}, "
              f"{s.n_rollbacks} rollback(s), quarantined {q}")
        # a loss-spike's own loss may stay under the threshold (the
        # scaled batch is classified with more confidence); the update it
        # drove then spikes the next step's loss, which is caught
        at = int(spec.split("=")[1])
        late = 1 if spec.startswith("loss-spike") else 0
        check(s.n_anomalies == 1 and s.n_rollbacks == 1 and q is not None
              and q["kind"] in kinds and at <= q["step"] <= at + late,
              f"sentinel mlp2 {spec}: expected one {kinds} anomaly rolled "
              f"back at step {at}" + (f" or {at + 1}" if late else "")
              + f", got {s.stats()} {s.journal.records}")
        if not spec.startswith("nan-grad"):
            continue
        clean = os.path.join(tmp, "clean-journal")
        os.makedirs(clean)
        shutil.copy(os.path.join(d, "quarantine.jsonl"), clean)
        ref = trainer(2, SENTINEL_STEPS, ckpt=clean)
        _under(None, ref.fit)
        exact = (s.observed == ref.sentinel.observed
                 and _same_params(tr.params, ref.params))
        out["nan_grad_bit_exact"] = exact
        print(f"chip_smoke: sentinel mlp2: {len(s.observed)} observed "
              f"losses and the final parameters after the rollback vs a "
              f"clean run that pre-loaded the journal: "
              f"{'bit-exact' if exact else 'DIFFER'}")
        check(ref.sentinel.n_anomalies == 0 and exact,
              "sentinel mlp2: the rolled-back run differs from the clean "
              "run with the same quarantine journal")
    # the cost: train_epoch windows with the sentinel off and on, in
    # turns, after one warm-up epoch each; a clean run trips nothing
    on = trainer(3, SENTINEL_TIMED_STEPS)
    off = trainer(3, SENTINEL_TIMED_STEPS, sentinel=False)
    _epoch_ms(on, 1)
    _epoch_ms(off, 1)
    t_off = _epoch_ms(off, 2)
    t_on = _epoch_ms(on, 2)
    t_on += _epoch_ms(on, 3)
    t_off += _epoch_ms(off, 3)
    n = 2 * SENTINEL_TIMED_STEPS
    cost = (t_on - t_off) / n
    check(on.sentinel.n_anomalies == 0 and len(on.sentinel.observed)
          == 3 * SENTINEL_TIMED_STEPS,
          f"sentinel mlp2: a clean run tripped {on.sentinel.stats()}")
    snap = on.sentinel.ring.newest_at_or_before(on._step_count)
    rollback = []
    for _ in range(20):
        _sync()
        t0 = time.perf_counter()
        on._restore_snapshot(snap)
        _sync()
        rollback.append((time.perf_counter() - t0) * 1e3)
    out.update(step_ms_off=t_off / n, step_ms_on=t_on / n,
               cost_ms_per_step=cost, phase7_step_ms=mlp2_step_ms,
               rollback_ms=statistics.median(rollback),
               snapshot_bytes=snap.nbytes, clean_anomalies=0)
    print(f"chip_smoke: sentinel mlp2 cost: {t_on / n:.4f} ms per step on "
          f"against {t_off / n:.4f} off ({cost:+.4f} ms; phase 7's mlp2 "
          f"step {mlp2_step_ms:.4f} ms); one rollback "
          f"{out['rollback_ms']:.4f} ms (median of 20, {snap.nbytes} "
          f"bytes); a clean run of {3 * SENTINEL_TIMED_STEPS} steps "
          f"tripped nothing")
    del on, off, tr, ref
    if MAIN_DEVICE == "cuda":
        torch.cuda.empty_cache()


def _elastic_setup():
    """The gpt_bf16 row for phase 10 (b): its config with
    ``attn_impl="flash"``, random float token ids (seed 3) for
    ``ELASTIC_STEPS`` batches and ``ELASTIC_TEST`` eval sequences, the
    pipeline builder and the ``TrainConfig``."""
    import numpy as np
    import torch

    from simple_distributed_machine_learning_tpu_torch.data.mnist import (
        Dataset,
    )
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        GPTConfig,
        make_gpt_stages,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        Pipeline,
    )
    from simple_distributed_machine_learning_tpu_torch.train import (
        TrainConfig,
    )
    row = TRAIN_ROWS["gpt_bf16"]
    cfg = GPTConfig(**row["cfg"], attn_impl="flash")
    rng = np.random.default_rng(3)
    n_train = ELASTIC_STEPS * row["batch"]
    shape = (n_train + ELASTIC_TEST, cfg.seq_len)
    x = rng.integers(0, cfg.vocab, shape)
    y = rng.integers(0, cfg.vocab, shape)
    train = Dataset(x[:n_train].astype(np.float32), y[:n_train])
    test = Dataset(x[n_train:].astype(np.float32), y[n_train:])

    def build_pipe(n):
        stages, wire_dim, out_dim = make_gpt_stages(0, cfg, n, MAIN_DEVICE)
        return Pipeline(stages, None, wire_dim, out_dim,
                        compute_dtype=getattr(torch, row["dtype"]),
                        device=MAIN_DEVICE)

    config = TrainConfig(epochs=ELASTIC_EPOCHS, batch_size=row["batch"],
                         max_steps_per_epoch=ELASTIC_STEPS,
                         print_throughput=False)
    return cfg, train, test, build_pipe, config


def _watch(trainer, log: list, attempt: int, steps: bool = False):
    """Record a trainer's unrounded epoch losses and train ms (its
    ``train_epoch``), its launches of K1-K3 over ``fit`` and where
    ``fit`` ended, and with ``steps`` the host clock and the allocated
    memory after each synchronised train step. The wrappers hold the
    trainer weakly: a cycle through them would keep a dead attempt's
    tensors alive until the collector ran."""
    import weakref
    cls, me, step_fn = type(trainer), weakref.ref(trainer), trainer._train_step

    def train_epoch(epoch):
        t0 = time.perf_counter()
        loss = cls.train_epoch(me(), epoch)
        log.append(dict(attempt=attempt, epoch=epoch, loss=loss,
                        ms=(time.perf_counter() - t0) * 1e3))
        return loss

    def fit():
        c0 = _flash_counts()
        try:
            cls.fit(me())
            log.append(dict(attempt=attempt, end="done"))
        except Exception as e:
            log.append(dict(attempt=attempt, end=type(e).__name__,
                            t=time.perf_counter()))
            raise
        finally:
            log.append(dict(attempt=attempt, launches=tuple(
                b - a for a, b in zip(c0, _flash_counts()))))

    def step(*args):
        out = step_fn(*args)
        log.append(dict(attempt=attempt, mem=_mem(),
                        t=time.perf_counter()))
        return out

    trainer.train_epoch, trainer.fit = train_epoch, fit
    if steps:
        trainer._train_step = step
    return trainer


def _step_device_ops(pipe, x, y, plain_gather: bool, n: int = 3) -> float:
    """Device ops (kernels and copies, as ``torch.profiler`` records them)
    per ``make_train_step`` step of ``pipe`` on ``x``/``y``; with
    ``plain_gather`` the model's token conversion and gather are the
    unrepaired ``x.long()`` and ``table[ids]``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from simple_distributed_machine_learning_tpu_torch.models import (
        gpt as gpt_mod,
    )
    from simple_distributed_machine_learning_tpu_torch.train import (
        adamw,
        make_train_step,
    )
    saved = gpt_mod.embedding_lookup, gpt_mod.token_ids
    if plain_gather:
        gpt_mod.embedding_lookup = lambda table, ids: table[ids.long()]
        gpt_mod.token_ids = lambda ids: ids.long()
    try:
        params = pipe.init_params()
        opt = adamw(1e-3)
        state = opt.init(params)
        step = make_train_step(pipe, opt)
        step(params, state, x, y, 0)
        _sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(n):
                step(params, state, x, y, i)
            _sync()
    finally:
        gpt_mod.embedding_lookup, gpt_mod.token_ids = saved
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / n


def _elastic_gpt(rec: dict, tmp: str, gpt_step_ms: float) -> tuple:
    """Phase 10 (b): the gpt_bf16 elastic drill; returns its K1-K3
    launches."""
    import torch

    from simple_distributed_machine_learning_tpu_torch.resilience import (
        CheckpointStore,
        make_elastic_trainer,
        supervise,
    )
    from simple_distributed_machine_learning_tpu_torch.train import (
        Trainer,
        adamw,
    )
    import math

    import numpy as np
    cfg, train, test, build_pipe, config = _elastic_setup()
    n_eval = -(-ELASTIC_TEST // TRAIN_ROWS["gpt_bf16"]["batch"])
    out: dict = {}
    rec["gpt_bf16_elastic"] = out

    # the numeric faults' batches on the card: NaN ids gather row 0, ids
    # times 1e30 gather rows of NaN (no out-of-range index reaches the
    # device), and the card keeps working after them
    pipe = build_pipe(1)
    params = pipe.init_params()
    b = TRAIN_ROWS["gpt_bf16"]["batch"]
    x, y = train.x[:b], torch.from_numpy(train.y[:b])
    with torch.no_grad():
        faulted = {name: float(pipe.loss(params, torch.from_numpy(
            x * np.float32(k)), y)) for name, k in
            (("clean", 1), ("nan-grad", float("nan")),
             ("corrupt-batch", 1e30), ("loss-spike", 100))}
    out["faulted_batch_losses"] = faulted
    print(f"chip_smoke: gpt_bf16 losses of the numeric faults' batches on "
          f"the card: {faulted}")
    check(math.isfinite(faulted["clean"])
          and math.isfinite(faulted["nan-grad"])
          and math.isnan(faulted["corrupt-batch"])
          and math.isnan(faulted["loss-spike"]),
          f"gpt_bf16: the numeric faults' batches gave {faulted}; expected "
          f"finite (clean, NaN ids -> id 0) and NaN (ids past the vocab)")
    # the repaired gather's extra launches per train step: the profiler's
    # device ops of one step, with it and with the plain table[ids.long()]
    xd, yd = torch.from_numpy(x).to(MAIN_DEVICE), y.to(MAIN_DEVICE)
    ops = {name: _step_device_ops(pipe, xd, yd, name == "plain")
           for name in ("repaired", "plain")}
    out["device_ops_per_step"] = ops
    print(f"chip_smoke: gpt_bf16 device ops per train step: "
          f"{ops['repaired']:.1f} with the repaired gather, "
          f"{ops['plain']:.1f} with table[ids.long()] "
          f"({ops['repaired'] - ops['plain']:+.1f})")
    check(ops["plain"] > 0, "torch.profiler recorded no device ops in a "
                            "gpt_bf16 train step")
    del pipe, params

    def losses(log, attempt=None):
        return [(e["epoch"], e["loss"]) for e in log if "loss" in e
                and (attempt is None or e["attempt"] == attempt)]

    # two uninterrupted runs: is the card's training deterministic?
    clean = []
    for _ in range(2):
        log: list = []
        tr = _watch(Trainer(build_pipe(1), train, test, config,
                            opt=adamw(1e-3)), log, 0)
        _quiet(tr.fit)
        clean.append((log, [p.detach().clone()
                            for p in tr.params[0].parameters()]))
        del tr
    det = (losses(clean[0][0]) == losses(clean[1][0])
           and all(torch.equal(a, b) for a, b in zip(clean[0][1],
                                                     clean[1][1])))
    spread = max(abs(a - b) / abs(b) for (_, a), (_, b) in
                 zip(losses(clean[0][0]), losses(clean[1][0])))
    out.update(clean_losses=losses(clean[0][0]), clean_bit_equal=det,
               clean_loss_spread=spread)
    print(f"chip_smoke: gpt_bf16 elastic: two uninterrupted runs "
          f"({ELASTIC_EPOCHS} epochs of {ELASTIC_STEPS} steps) "
          f"{'bit-equal' if det else f'differ by {spread:.3e} relative'}")

    # the drill: a host-kill mid-epoch 2 under the supervisor
    store = CheckpointStore(os.path.join(tmp, "gpt_store"), keep=4)
    saves: list = []
    save_fn = store.save

    def timed_save(*a, **kw):
        _sync()
        t0 = time.perf_counter()
        path = save_fn(*a, **kw)
        saves.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                          bytes=os.path.getsize(path)))
        return path

    store.save = timed_save
    log = []
    last: list = []

    def build(n):
        tr = make_elastic_trainer(build_pipe, n, store, train, test, config,
                                  opt_factory=lambda pipe: adamw(1e-3))
        attempt = len([e for e in log if "end" in e]) + 1
        last[:] = [tr]
        return _watch(tr, log, attempt, steps=True)

    _reset_flash_counts()
    report = _under(ELASTIC_KILL, supervise, build, (1,))
    launches = _flash_counts()
    final = last.pop()
    a1, a2 = report["attempts"]
    mem1 = [e["mem"] for e in log if "mem" in e and e["attempt"] == 1]
    mem2 = [e["mem"] for e in log if "mem" in e and e["attempt"] == 2]
    t_kill = next(e["t"] for e in log if e.get("end") == "HostLost")
    t_first = next(e["t"] for e in log if "mem" in e and e["attempt"] == 2)
    state_bytes = 3 * 4 * sum(p.numel()
                              for p in final.params[0].parameters())
    # a dead attempt kept alive holds at least its f32 parameters and
    # AdamW's m and v, state_bytes; a freed one leaves the two readings
    # within a few allocator blocks of each other
    mem_limit = state_bytes // 8
    per = {e["attempt"]: e["launches"] for e in log if "launches" in e}
    kill_step = int(ELASTIC_KILL.split("=")[1])
    steps1, steps2 = kill_step, (ELASTIC_EPOCHS - 1) * ELASTIC_STEPS
    want = {1: (cfg.n_layers * (steps1 + n_eval), cfg.n_layers * steps1,
                cfg.n_layers * steps1),
            2: (cfg.n_layers * (steps2 + (ELASTIC_EPOCHS - 1) * n_eval),
                cfg.n_layers * steps2, cfg.n_layers * steps2)}
    after = losses(log, 2)
    ref = [(e, v) for e, v in losses(clean[0][0]) if e >= 2]
    gap = max(abs(a - b) / abs(b) for (_, a), (_, b) in zip(after, ref))
    same_params = all(torch.equal(a, b) for a, b in
                      zip(final.params[0].parameters(), clean[0][1]))
    out.update(restarts=report["restarts"],
               transitions=report["transitions"],
               resumed_step=a2["resumed_step"],
               start_epoch=a2["start_epoch"], losses_after=after,
               gap_vs_clean=gap, params_equal_clean=same_params,
               launches_per_attempt=per, launches_expected=want,
               mem_before_kill=mem1[-1], mem_after_restart=mem2[0],
               trainer_state_bytes=state_bytes, mem_limit=mem_limit,
               restart_ms=(t_first - t_kill) * 1e3, saves=saves)
    print(f"chip_smoke: gpt_bf16 elastic {ELASTIC_KILL}: "
          f"{report['restarts']} restart(s), {a1['fault']} then resumed at "
          f"step {a2['resumed_step']} epoch {a2['start_epoch']}; restart "
          f"cost {out['restart_ms']:.1f} ms (the kill to the end of the "
          f"first step after the restore, 50 ms of backoff included); "
          f"K1/K2/K3 per attempt {per} (expected {want}); memory "
          f"allocated {mem1[-1]} bytes before the kill, {mem2[0]} after "
          f"the restart (one trainer's state: {state_bytes}); losses after "
          f"the restore {after} vs uninterrupted {ref}: max rel gap "
          f"{gap:.3e}, final parameters "
          f"{'bit-equal' if same_params else 'differ'}; store: "
          + ", ".join(f"{v['ms']:.1f} ms / {v['bytes']} bytes"
                      for v in saves) + " per generation")
    check(report["completed"] and report["restarts"] == 1
          and a1["fault"] == "HostLost" and a2["resumed_step"]
          == ELASTIC_STEPS and a2["start_epoch"] == 2,
          f"gpt_bf16 elastic: expected 1 restart resuming at step "
          f"{ELASTIC_STEPS} epoch 2, got {report}")
    check(per == want, f"gpt_bf16 elastic: flash launches per attempt "
                       f"{per} != {want}")
    check(abs(mem2[0] - mem1[-1]) <= mem_limit,
          f"gpt_bf16 elastic: {mem2[0]} bytes allocated after the restart "
          f"against {mem1[-1]} before the kill (limit {mem_limit}): the "
          f"dead attempt was not freed")
    if det:
        check(after == ref and same_params,
              f"gpt_bf16 elastic: the restored run's losses {after} or "
              f"parameters differ from the uninterrupted run's {ref}, "
              f"which repeats bit for bit")
    else:
        check(gap <= spread, f"gpt_bf16 elastic: the restored run's "
                             f"losses differ by {gap} relative, beyond "
                             f"the {spread} of two clean runs")
    del final, report
    # the gate's control: one more trainer, restored from the same store
    # and kept alive, as a leaked attempt would be
    base = _mem()
    held, _ = _quiet(lambda: make_elastic_trainer(
        build_pipe, 1, store, train, test, config,
        opt_factory=lambda pipe: adamw(1e-3)))
    out["held_trainer_bytes"] = held_bytes = _mem() - base
    del held
    print(f"chip_smoke: gpt_bf16 elastic: one more trainer kept alive "
          f"reads {held_bytes} bytes (the restart gate's limit: "
          f"{mem_limit})")
    check(held_bytes > mem_limit,
          f"gpt_bf16 elastic: a trainer kept alive reads {held_bytes} "
          f"bytes, within the restart gate's limit {mem_limit}: the gate "
          f"cannot see a leaked attempt")

    # the same run with the sentinel on and no fault
    import dataclasses
    slog: list = []
    sstore = CheckpointStore(os.path.join(tmp, "gpt_sentinel"), keep=4)
    sconfig = dataclasses.replace(config, sentinel=True)
    kept: list = []

    def sbuild(n):
        tr = make_elastic_trainer(build_pipe, n, sstore, train, test,
                                  sconfig,
                                  opt_factory=lambda pipe: adamw(1e-3))
        kept.append(tr)
        return _watch(tr, slog, 1)

    _reset_flash_counts()
    sreport = _under(None, supervise, sbuild, (1,))
    launches = tuple(a + b for a, b in zip(launches, _flash_counts()))
    stats = sreport["attempts"][0]["sentinel"]

    def per_step(lg):
        return statistics.mean(e["ms"] for e in lg if "ms" in e
                               and e["epoch"] >= 2) / ELASTIC_STEPS

    on, off = per_step(slog), per_step(clean[0][0])
    same = losses(slog) == losses(clean[0][0])
    out["sentinel"] = dict(stats=stats, step_ms_on=on, step_ms_off=off,
                           cost_ms_per_step=on - off,
                           phase5_step_ms=gpt_step_ms,
                           losses_equal_clean=same)
    print(f"chip_smoke: gpt_bf16 with the sentinel, no fault: "
          f"{stats['anomalies']} anomalies, {sreport['restarts']} restarts, "
          f"losses {'equal to' if same else 'DIFFER from'} the clean run's; "
          f"{on:.3f} ms per step against {off:.3f} without "
          f"({on - off:+.3f} ms; phase 5's step {gpt_step_ms:.3f} ms); ring "
          f"{stats['snapshot_ring_bytes']} bytes")
    check(stats["anomalies"] == 0 and sreport["restarts"] == 0
          and sreport["completed"],
          f"gpt_bf16 with the sentinel tripped on a clean run: {stats}")
    check(same or not det, "gpt_bf16: the sentinel changed the trajectory "
                           "of a run that repeats bit for bit")
    del kept, clean
    return launches


def _store_on_card(rec: dict, tmp: str) -> None:
    """Phase 10 (c): a checkpoint-write crash restarts in place; a
    truncated newest generation is skipped and the previous restores."""
    import contextlib
    import io

    from simple_distributed_machine_learning_tpu_torch.parallel import (
        Pipeline,
    )
    from simple_distributed_machine_learning_tpu_torch.resilience import (
        CheckpointStore,
        make_elastic_trainer,
        supervise,
    )
    from simple_distributed_machine_learning_tpu_torch.train import (
        TrainConfig,
    )
    data = _row_data(True)
    store = CheckpointStore(os.path.join(tmp, "mlp_store"), keep=4)

    def build_pipe(n):
        stages, wire_dim, out_dim = _main_rows()["mlp2"][0](MAIN_DEVICE)
        return Pipeline(stages, None, wire_dim, out_dim, device=MAIN_DEVICE)

    config = TrainConfig(epochs=2, max_steps_per_epoch=10,
                         print_throughput=False)

    def build(n):
        return make_elastic_trainer(build_pipe, n, store, data[0], data[1],
                                    config)

    report = _under("ckpt-write-crash@ckpt.write", supervise, build, (1,))
    steps = [e["step"] for e in store.entries()]
    print(f"chip_smoke: store on the card: ckpt-write-crash@ckpt.write -> "
          f"{report['restarts']} restart(s), attempts "
          f"{[(a['outcome'], a.get('fault')) for a in report['attempts']]}"
          f", generations at steps {steps}")
    check(report["completed"] and report["restarts"] == 1
          and report["attempts"][0]["fault"] == "CheckpointWriteCrash"
          and steps == [10, 20],
          f"store: the write crash did not restart in place: {report}")
    newest = store.latest_valid()["path"]
    with open(newest, "r+b") as f:
        f.truncate(os.path.getsize(newest) // 2)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        tr, _ = _quiet(build, 1)
    print(f"chip_smoke: store on the card: newest generation truncated -> "
          f"restored step {tr._step_count}, epoch {tr.start_epoch}; "
          f"{err.getvalue().strip()!r}")
    check(tr._step_count == 10 and tr.start_epoch == 2
          and "skipping corrupt" in err.getvalue(),
          "store: a truncated newest generation was not skipped")
    rec["store"] = dict(restarts=report["restarts"], generations=steps,
                        truncated_restored_step=tr._step_count,
                        warning=err.getvalue())


def _cli_drills(rec: dict, tmp: str) -> None:
    """Phase 10 (d): the CLI's chaos and sentinel drills. The GPT drill's
    K1-K3 launches (the f32 kernels) are checked and recorded here and
    stay out of the ``kernels`` line's bf16 rows."""
    from simple_distributed_machine_learning_tpu_torch.resilience import (
        faults,
    )
    from simple_distributed_machine_learning_tpu_torch.train import (
        checkpoint,
    )
    out: dict = {}
    rec["cli"] = out
    mlp = ["--model", "mlp", "--epochs", "2", "--max-steps-per-epoch", "10",
           "--data-root", os.path.join(tmp, "no-mnist")]
    lines = _cli(mlp + ["--sentinel", "--chaos", "nan-grad@train.grad=5",
                        "--checkpoint-dir", os.path.join(tmp, "c1")])
    out["sentinel_chaos"] = [ln for ln in lines if ln.startswith("| ")]
    check("| chaos: completed after 0 restart(s); attempts: 1st/completed; "
          "faults fired: 1" in lines
          and "| chaos: sentinel absorbed 1 anomaly (1 rollback(s), 1 "
              "quarantined batch(es))" in lines,
          f"CLI --sentinel --chaos: {out['sentinel_chaos']}")
    _reset_flash_counts()
    glines = _cli(["--model", "gpt", "--attn", "flash", "--epochs", "2",
                   "--max-steps-per-epoch", "4", "--chaos",
                   "host-kill@train.step=6", "--checkpoint-dir",
                   os.path.join(tmp, "c2")])
    counts = _flash_counts()
    evals = -(-1000 // 60)
    want = (2 * (10 + 2 * evals), 2 * 10, 2 * 10)
    out["gpt_chaos"] = [ln for ln in glines if ln.startswith("| ")]
    out["gpt_chaos_launches"] = counts
    check("| chaos: completed after 1 restart(s); attempts: 1st/fault"
          "(HostLost) -> 1st/completed; faults fired: 1" in glines
          and counts == want,
          f"CLI gpt --chaos host-kill: {out['gpt_chaos']}, K1-K3 {counts} "
          f"(expected {want})")
    try:
        _cli(mlp + ["--chaos", "host-kill@train.step=999",
                    "--checkpoint-dir", os.path.join(tmp, "c3")])
        vacuous = None
    except SystemExit as e:
        vacuous = e.code
    out["never_fired"] = vacuous
    check(isinstance(vacuous, str) and "never fired" in vacuous,
          f"CLI --chaos host-kill@train.step=999 exited with {vacuous!r}")
    cut, straight = os.path.join(tmp, "c4"), os.path.join(tmp, "c5")
    plines = _under("preempt@train.sigterm=6", _cli,
                    mlp + ["--checkpoint-dir", cut])
    rlines = _cli(mlp + ["--checkpoint-dir", cut])
    _cli(mlp + ["--checkpoint-dir", straight])
    a = checkpoint.restore_checkpoint(os.path.join(cut, "state.npz"))
    b = checkpoint.restore_checkpoint(os.path.join(straight, "state.npz"))
    exact = (a["step"] == b["step"] == 20
             and (a["params"] == b["params"]).all()
             and all((x == y).all() for x, y in zip(a["opt_state"],
                                                    b["opt_state"])))
    out["preempt"] = dict(stopped=[ln for ln in plines
                                   if ln.startswith("| ")],
                          resumed=rlines[0], bit_exact=bool(exact))
    check(any(ln.startswith("| preempt: graceful stop on preempt notice at "
                            "step 6") for ln in plines)
          and rlines[0].endswith("at epoch 1 (step 6) (batch 6)") and exact,
          f"CLI preempt + rerun: {out['preempt']}")
    print(f"chip_smoke: CLI: {out['sentinel_chaos'][-2:]}; gpt "
          f"{out['gpt_chaos'][-1]!r}, K1/K2/K3 {counts}; host-kill@999 -> "
          f"{vacuous!r}; preempt@train.sigterm=6 then a rerun "
          f"({rlines[0]!r}): final state "
          f"{'bit-exact' if exact else 'DIFFERS'} vs an uninterrupted run")


def phase_resilience(record: dict) -> tuple:
    """Phase 10 (module docstring): training that survives faults. Returns
    the K1-K3 launches of (b)'s gpt_bf16 runs; (d)'s CLI run launches the
    f32 kernels, which it checks and records on its own."""
    import tempfile
    rec: dict = {}
    record["resilience"] = rec
    mlp2_ms = record["main_path"]["rows"]["mlp2"]["step_ms"]
    gpt_ms = record["train"]["gpt_bf16"]["step_ms"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        _sentinel_mlp2(rec, tmp, mlp2_ms)
        launches = _elastic_gpt(rec, tmp, gpt_ms)
        _store_on_card(rec, tmp)
        _cli_drills(rec, tmp)
    rec["seconds"] = time.perf_counter() - t0
    print(f"chip_smoke: phase 10 took {rec['seconds']:.1f} s")
    return launches


# -- phase 11: the host offload tier and LoRA adapters --------------------------

def _cache_leaves(cache) -> list:
    """The stored tensors of a cache (a ``QuantKV``'s data and scales)."""
    return list(cache) if isinstance(cache, tuple) else [cache]


class _TierProbe:
    """While active, times every demotion (device -> host) and upload
    (host -> device) of every pool's host tier, per block, on the host
    clock between two synchronisations, and holds each copy bit-exact: a
    demoted block's host copy against the device rows it was taken from,
    a promoted block's device rows against the host copy. The first
    checks the blocking copy into pinned memory, the second the
    non-blocking one back; together, the round trip."""

    def __enter__(self):
        from simple_distributed_machine_learning_tpu_torch.serve.slots import (  # noqa: E501
            PagedKVPool,
        )
        self.d2h_ms, self.h2d_ms = [], []
        self.checked, self.bad = 0, 0
        self._cls = PagedKVPool
        self._demote = demote = PagedKVPool._demote
        self._advance = advance = PagedKVPool.advance_transfers
        probe = self

        def timed_demote(pool, block):
            before = [x[:, block].clone()
                      for c in (pool.kc, pool.vc) for x in _cache_leaves(c)]
            hid = pool._next_host_id
            _sync()
            t0 = time.perf_counter()
            demote(pool, block)
            _sync()
            probe.d2h_ms.append((time.perf_counter() - t0) * 1e3)
            entry = pool._host.get(hid)
            if entry is not None:
                probe._same(before, [x for c in (entry["kc"], entry["vc"])
                                     for x in _cache_leaves(c)])

        def timed_advance(pool):
            due = [(key, block, hk, hv) for t in pool._inflight
                   if t["ticks_left"] <= 1
                   for (key, _f, hk, hv), block in zip(t["entries"],
                                                       t["blocks"])]
            n0 = pool.host_promotes_total
            _sync()
            t0 = time.perf_counter()
            advance(pool)
            _sync()
            n = pool.host_promotes_total - n0
            if n:
                probe.h2d_ms.append((time.perf_counter() - t0) * 1e3 / n)
            for key, block, hk, hv in due:
                if pool._prefix.get(key, (None,))[0] == block:
                    probe._same([x for c in (hk, hv)
                                 for x in _cache_leaves(c)],
                                [x[:, block] for c in (pool.kc, pool.vc)
                                 for x in _cache_leaves(c)])

        PagedKVPool._demote = timed_demote
        PagedKVPool.advance_transfers = timed_advance
        return self

    def __exit__(self, *exc) -> None:
        self._cls._demote = self._demote
        self._cls.advance_transfers = self._advance

    def _same(self, a: list, b: list) -> None:
        import torch
        self.checked += 1

        def raw(x):
            return x.detach().cpu().contiguous().view(torch.uint8)

        if not all(x.dtype == y.dtype and torch.equal(raw(x), raw(y))
                   for x, y in zip(a, b)):
            self.bad += 1


def _churn_scenario():
    """``HOST_CHURN``: offload-churn's scenario at SERVE_CFG's width."""
    import dataclasses

    from simple_distributed_machine_learning_tpu_torch.resilience.scenarios import (  # noqa: E501
        SCENARIOS,
    )
    from simple_distributed_machine_learning_tpu_torch.serve import (
        SimConfig,
        TrafficClass,
    )
    hc = HOST_CHURN
    sim = SimConfig(
        n_requests=hc["n_requests"], rate=hc["rate"], seed=0,
        shared_prefix_len=hc["prefix"], sampled_fraction=0.0,
        max_new_tokens=hc["max_new"],
        classes=(TrafficClass("hot", weight=1.0,
                              prompt_lens=(hc["hot_len"],)),
                 TrafficClass("scan", weight=1.0,
                              prompt_lens=(hc["scan_len"],),
                              shared_prefix=False)))
    return dataclasses.replace(
        SCENARIOS["offload-churn"], name="offload-churn-full-width",
        sim=sim, n_slots=hc["n_slots"], block_size=SERVE_BLOCK,
        n_blocks=hc["n_blocks"], max_len=hc["max_len"],
        prefill_chunk=SERVE_BLOCK, host_cache_blocks=hc["host_cache_blocks"])


def _host_tier_full_width(stages, cfg, serve: dict, rec: dict) -> int:
    """(a) ``_churn_scenario`` at SERVE_CFG through K4, with f32 and int8
    storage, each with the host tier and without it (the HBM-only run).
    Returns K4's launches."""
    import tempfile
    scen = _churn_scenario()
    launches = 0
    for cd in (None, "int8"):
        runs = {}
        with tempfile.TemporaryDirectory(prefix="chip-smoke-tier-") as d:
            with _TierProbe() as probe:
                runs["tier"] = _scenario_run(scen, stages, cfg, "fused",
                                             os.path.join(d, "tier"),
                                             cache_dtype=cd)
            runs["hbm"] = _scenario_run(scen, stages, cfg, "fused",
                                        os.path.join(d, "hbm"),
                                        cache_dtype=cd, host_cache_blocks=0)
        r, handles, rows = runs["tier"]
        _, hhandles, hrows = runs["hbm"]
        ht = r["host_tier"]
        k4 = sum(t["launches"] for t in rows + hrows)
        decode = sum(t["decode"] for t in rows + hrows)
        bad_ticks = _off_ticks(rows, cfg.n_layers) + _off_ticks(
            hrows, cfg.n_layers)
        same = [rid for rid in handles if rid in hhandles
                and list(handles[rid].tokens) == list(hhandles[rid].tokens)]
        launches += k4
        tick = statistics.median(t["ms"] for t in rows)
        htick = statistics.median(t["ms"] for t in hrows)
        label = cd or "float32"
        rec[label] = dict(
            completed=r["completed"], host_tier=ht,
            prefix_hit_blocks=r.get("prefix_hit_blocks"),
            hbm_prefix_hit_blocks=runs["hbm"][0].get("prefix_hit_blocks"),
            slo_ok=r["slo_ok"], copies_checked=probe.checked,
            copies_bad=probe.bad, d2h_ms=probe.d2h_ms, h2d_ms=probe.h2d_ms,
            d2h_ms_per_block=(statistics.median(probe.d2h_ms)
                              if probe.d2h_ms else None),
            h2d_ms_per_block=(statistics.median(probe.h2d_ms)
                              if probe.h2d_ms else None),
            tick_ms_p50=tick, hbm_tick_ms_p50=htick, launches=k4,
            decode_calls=decode, streams_equal=len(same),
            requests=len(handles))
        print(f"chip_smoke: host tier {label} at full width: "
              f"{r['completed']} completed, {ht}, prefix hits "
              f"{r.get('prefix_hit_blocks')} (HBM-only "
              f"{rec[label]['hbm_prefix_hit_blocks']}); {probe.checked} "
              f"copies byte-checked, {probe.bad} differ; D2H "
              f"{rec[label]['d2h_ms_per_block']} ms per block (median of "
              f"{len(probe.d2h_ms)}), H2D {rec[label]['h2d_ms_per_block']} "
              f"ms per block (median of {len(probe.h2d_ms)}); tick p50 "
              f"{tick:.3f} ms (HBM-only {htick:.3f}, phase 3 "
              f"{serve['tick_ms_p50']:.3f}); streams equal to the HBM-only "
              f"run's {len(same)}/{len(handles)}; K4 launches {k4} = "
              f"{cfg.n_layers} x {decode} decode calls "
              f"({len(bad_ticks)} ticks off)")
        check(r["completed"] == HOST_CHURN["n_requests"] and r["slo_ok"]
              and ht["demotes"] >= 1 and ht["prefetch_hits"] >= 1
              and ht["promotes"] >= 1,
              f"host tier {label}: {r['completed']} completed, {ht}")
        check(probe.bad == 0
              and probe.checked == ht["demotes"] + ht["promotes"],
              f"host tier {label}: {probe.bad} of {probe.checked} copies "
              f"differ ({ht['demotes']} demotes + {ht['promotes']} "
              f"promotes)")
        check(len(same) == len(handles) == HOST_CHURN["n_requests"],
              f"host tier {label}: {len(same)}/{len(handles)} streams "
              f"equal to the HBM-only run's")
        check(decode > 0 and not bad_ticks,
              f"host tier {label}: K4 launches {k4} over {decode} decode "
              f"calls; ticks {bad_ticks[:8]} off")
    return launches


def _adapter_weights(cfg, seed: int) -> dict:
    """One tenant: ``init_lora_adapter``'s A from ``seed``, B drawn at
    ``ADAPTER_B_STD`` so the delta moves the tenant's stream."""
    import torch
    from simple_distributed_machine_learning_tpu_torch.models import lora
    g = torch.Generator().manual_seed(seed)
    w = lora.init_lora_adapter(g, cfg, ADAPTER_RANK, device=MAIN_DEVICE)
    for k in ("bq", "bv"):
        w[k] = (ADAPTER_B_STD * torch.randn(w[k].shape, generator=g)).to(
            MAIN_DEVICE)
    return w


def _adapter_drain(stages, cfg, reqs, tenants=None, swap=None,
                   **engine_kw) -> dict:
    """``reqs`` (submit kwargs, ``adapter`` included) through a fused
    engine on SERVE_SLOTS slots, every prompt length warmed first; with
    ``tenants`` ({name: weights}) an AdapterStore of ``ADAPTER_RANK``.
    ``swap`` = (tick, name, weights) re-registers a tenant after that many
    ticks and submits ``reqs[-1]`` after it. The streams, tick rows and
    summary."""
    import numpy as np
    from simple_distributed_machine_learning_tpu_torch.serve import (
        AdapterStore,
        InferenceEngine,
        ServeMetrics,
    )
    if tenants is not None:
        engine_kw["adapters"] = AdapterStore(cfg, ADAPTER_RANK, SERVE_SLOTS,
                                             device=MAIN_DEVICE)
    engine = InferenceEngine(stages, cfg, n_slots=SERVE_SLOTS,
                             block_size=SERVE_BLOCK, attn_kernel="fused",
                             device=MAIN_DEVICE, **engine_kw)
    for name, w in (tenants or {}).items():
        engine.register_adapter(name, w)
    for t0 in SPEC_WORKLOAD["prompt_lens"]:
        engine.submit(np.zeros(t0, np.int32), max_new_tokens=2)
    engine.drain()
    engine.metrics = ServeMetrics()
    rows = _record_ticks(engine)
    late = reqs[-1:] if swap else []
    handles = [engine.submit(**r) for r in reqs[:len(reqs) - len(late)]]
    ticks = 0
    try:
        while engine.busy:
            if swap and ticks == swap[0]:
                engine.register_adapter(swap[1], swap[2])
                handles += [engine.submit(**r) for r in late]
            engine.step()
            ticks += 1
    finally:
        del engine.step
    return dict(streams=[list(h.tokens) for h in handles], rows=rows,
                summary=engine.metrics.summary(),
                launches=sum(t["launches"] for t in rows),
                decode=sum(t["decode"] for t in rows))


def _teacher_forced(params, cfg, seq, w=None):
    """Log-probs [T, V] of ``seq`` through the model with dense causal
    attention, ``w``'s adapter (unbatched factors per layer) added to q
    and v when given."""
    import torch
    from simple_distributed_machine_learning_tpu_torch.models import gpt
    from simple_distributed_machine_learning_tpu_torch.ops.attention import (
        causal_attention_core,
    )
    from simple_distributed_machine_learning_tpu_torch.ops.layers import (
        embedding_lookup,
    )
    embed, blocks, head = gpt._merged_stage_trees(params)
    ids = torch.as_tensor(seq, device=embed["tok"].device)[None].long()
    with torch.no_grad():
        h = embedding_lookup(embed["tok"], ids) + embed["pos"][:ids.shape[1]]
        for li, bp in enumerate(blocks):
            ab = (None if w is None
                  else tuple(w[k][li] for k in ("aq", "bq", "av", "bv")))
            q, k, v = gpt._dense_qkv(bp, h, cfg.n_heads, ab)
            h = gpt._dense_attn_tail(bp, h, causal_attention_core(q, k, v))
        return gpt._head_logprobs(head, h)[0]


def _against_merged(params, merged, cfg, req, got, want, w) -> dict:
    """A tenant stream ``got`` (the adapter engine's) against ``want``
    (the merged-weights engine's) by the phase's rule: the teacher-forced
    log-probs along ``got`` through the adapter and through the merged
    weights within ``ADAPTER_LOGIT_TOL``; the tokens equal, or the first
    disagreeing step's top-2 gap (merged weights) under the tolerance."""
    import numpy as np
    t0 = len(req["prompt"])
    seq = np.concatenate([req["prompt"], np.asarray(got[:-1], np.int32)])
    lp_a = _teacher_forced(params, cfg, seq, w)[t0 - 1:]
    lp_m = _teacher_forced(merged, cfg, seq)[t0 - 1:]
    err = float((lp_a - lp_m).abs().max())
    first = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
    gap = None
    if first is not None:
        top2 = lp_m[first].topk(2).values
        gap = float(top2[0] - top2[1])
    return dict(max_abs_err=err, first_mismatch=first, top2_gap=gap,
                ok=(err <= ADAPTER_LOGIT_TOL
                    and (first is None or gap < ADAPTER_LOGIT_TOL)))


def _adapters_full_width(stages, cfg, rec: dict) -> int:
    """(b) Three tenants and the base model on one engine at SERVE_CFG
    (phase 3b's 24 greedy requests, tenants round-robin, so every tick
    mixes bank rows). Returns K4's launches."""
    import dataclasses

    from simple_distributed_machine_learning_tpu_torch.models import lora
    reqs = _spec_workload(cfg.vocab)
    for i, r in enumerate(reqs):
        r["adapter"] = ADAPTER_TENANTS[i % len(ADAPTER_TENANTS)]
        r["seed"] = i
    tenants = {name: _adapter_weights(cfg, 100 + k)
               for k, name in enumerate(ADAPTER_TENANTS[1:])}
    params = [s.params for s in stages]
    mixed = _adapter_drain(stages, cfg, reqs, tenants)
    base_reqs = [dict(r, adapter=None) for r in reqs]
    plain = _adapter_drain(stages, cfg, base_reqs)
    base_ids = [i for i, r in enumerate(reqs) if r["adapter"] is None]
    base_same = [i for i in base_ids
                 if mixed["streams"][i] == plain["streams"][i]]
    moved = [i for i, r in enumerate(reqs) if r["adapter"] is not None
             and mixed["streams"][i] != plain["streams"][i]]
    launches = mixed["launches"] + plain["launches"]
    checks, merged_params = {}, {}
    for name, w in tenants.items():
        merged_params[name] = merge = lora.merge_adapter(params, w)
        ids = [i for i, r in enumerate(reqs) if r["adapter"] == name]
        mst = [dataclasses.replace(s, params=p) for s, p in zip(stages,
                                                                merge)]
        solo = _adapter_drain(mst, cfg, [dict(reqs[i], adapter=None)
                                         for i in ids])
        launches += solo["launches"]
        for i, want in zip(ids, solo["streams"]):
            checks[i] = _against_merged(params, merge, cfg, reqs[i],
                                        mixed["streams"][i], want, w)
    allowed = {i: c for i, c in checks.items()
               if c["first_mismatch"] is not None and c["ok"]}
    # the hot-swap: t0's weights change three ticks into the drain; the
    # request submitted after it decodes the new weights, t0's requests
    # already in flight keep the old row
    new_w = _adapter_weights(cfg, 999)
    t0_ids = [i for i, r in enumerate(reqs) if r["adapter"] == "t0"][:3]
    swap_reqs = [reqs[i] for i in t0_ids] + [dict(reqs[1], seed=777)]
    swapped = _adapter_drain(stages, cfg, swap_reqs, tenants,
                             swap=(3, "t0", new_w))
    launches += swapped["launches"]
    new_merge = lora.merge_adapter(params, new_w)
    new_solo = _adapter_drain(
        [dataclasses.replace(s, params=p) for s, p in zip(stages,
                                                          new_merge)],
        cfg, [dict(swap_reqs[-1], adapter=None)])
    launches += new_solo["launches"]
    old_ok = swapped["streams"][:3] == [mixed["streams"][i] for i in t0_ids]
    new_check = _against_merged(params, new_merge, cfg, swap_reqs[-1],
                                swapped["streams"][-1],
                                new_solo["streams"][0], new_w)
    # the speculative verify with adapters: draft == target at SPEC_K
    spec = _adapter_drain(stages, cfg, reqs, tenants, draft_stages=stages,
                          draft_cfg=cfg, spec_k=SPEC_K)
    launches += spec["launches"]
    spec_same = [i for i in range(len(reqs))
                 if spec["streams"][i] == mixed["streams"][i]]
    tick = statistics.median(t["ms"] for t in mixed["rows"])
    ptick = statistics.median(t["ms"] for t in plain["rows"])
    bad = (_off_ticks(mixed["rows"], cfg.n_layers)
           + _off_ticks(plain["rows"], cfg.n_layers))
    spec_bad = _off_ticks(spec["rows"], cfg.n_layers)
    rec.update(
        rank=ADAPTER_RANK, tenants=list(tenants), requests=len(reqs),
        base_equal=len(base_same), base=len(base_ids),
        tenant_streams_moved=len(moved),
        merged_checks={str(i): c for i, c in checks.items()},
        merged_max_abs_err=max(c["max_abs_err"] for c in checks.values()),
        allowed_mismatches={str(i): c for i, c in allowed.items()},
        hot_swap=dict(old_equal=old_ok, new=new_check),
        spec_equal=len(spec_same), spec_launches=spec["launches"],
        spec_decode=spec["decode"], tick_ms_p50=tick, plain_tick_ms_p50=ptick,
        adapter_swaps=mixed["summary"].get("adapter_swaps"),
        resident_bytes=mixed["summary"].get("adapter_resident_bytes"),
        launches=launches)
    print(f"chip_smoke: adapters at full width: rank {ADAPTER_RANK}, "
          f"tenants {list(tenants)} + base over {len(reqs)} requests; base "
          f"streams equal to the adapter-free engine's "
          f"{len(base_same)}/{len(base_ids)}; tenant streams off the base "
          f"{len(moved)}/{len(reqs) - len(base_ids)}; against the merged "
          f"engines: teacher-forced log-probs max abs err "
          f"{rec['merged_max_abs_err']:.3e} (tol {ADAPTER_LOGIT_TOL}), "
          f"{sum(c['first_mismatch'] is None for c in checks.values())}/"
          f"{len(checks)} token-equal, allowed near-ties "
          f"{[(i, c['first_mismatch'], c['top2_gap']) for i, c in allowed.items()]}"  # noqa: E501
          f"; hot-swap: in-flight on the old row {old_ok}, the next "
          f"admission {new_check}; spec_k {SPEC_K} verify equal to plain "
          f"adapter decode {len(spec_same)}/{len(reqs)}; tick p50 "
          f"{tick:.3f} ms with adapters, {ptick:.3f} ms without; "
          f"{rec['adapter_swaps']} bank uploads, "
          f"{rec['resident_bytes']} bank bytes")
    check(len(base_ids) > 0 and len(base_same) == len(base_ids),
          f"adapters: {len(base_same)}/{len(base_ids)} base streams equal "
          f"to the adapter-free engine's")
    check(len(moved) > 0, "adapters: no tenant stream left the base "
                          "model's (a vacuous comparison)")
    check(all(c["ok"] for c in checks.values()),
          f"adapters: tenant streams against the merged engines: "
          f"{[c for c in checks.values() if not c['ok']]}")
    check(old_ok and new_check["ok"],
          f"adapters: hot-swap old rows equal {old_ok}, new {new_check}")
    check(len(spec_same) == len(reqs),
          f"adapters: {len(spec_same)}/{len(reqs)} speculative streams "
          f"equal to plain adapter decode")
    check(mixed["decode"] > 0 and not bad,
          f"adapters: K4 launches other than {cfg.n_layers} per decode "
          f"call in ticks {bad[:8]}")
    check(spec["decode"] > 0 and not spec_bad,
          f"adapters: K4 launches other than {cfg.n_layers} per "
          f"speculative tick in ticks {spec_bad[:8]}")
    return launches


def _host_adapter_scenarios(rec: dict) -> int:
    """(c) offload-churn and hot-adapter-churn (both routing policies) on
    SCENARIO_CFG through K4 at the virtual clock: the pins, K4 launched
    ``n_layers`` times per decode call in every tick, greedy streams equal
    to a rerun through the dense path. Returns K4's launches."""
    import tempfile

    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        GPTConfig,
        make_gpt_stages,
    )
    cfg = GPTConfig(**SCENARIO_CFG)
    stages = make_gpt_stages(0, cfg, 2, MAIN_DEVICE)[0]
    launches = 0
    for (name, over), pin in HOST_ADAPTER_PINS.items():
        kw = dict(over)
        label = name + "".join(f" {k}={v}" for k, v in over)
        with tempfile.TemporaryDirectory(prefix="chip-smoke-ha-") as d:
            runs = {k: _scenario_run(name, stages, cfg, k,
                                     os.path.join(d, k), **kw)
                    for k in ("fused", "dense")}
        r, handles, rows = runs["fused"]
        _, dhandles, drows = runs["dense"]
        k4 = sum(t["launches"] for t in rows)
        decode = sum(t["decode"] for t in rows)
        bad_ticks = _off_ticks(rows, cfg.n_layers)
        greedy = [rid for rid, h in handles.items() if h.temperature == 0.0]
        same = [rid for rid in greedy if rid in dhandles
                and list(handles[rid].tokens) == list(dhandles[rid].tokens)]
        launches += k4
        got = dict(completed=r["completed"])
        if "host_tier" in pin:
            got.update(host_tier=r["host_tier"],
                       prefix_hit_blocks=r.get("prefix_hit_blocks"))
        else:
            got.update(swaps=r["adapters"]["swaps"],
                       hits=r["adapters"]["adapter_affinity_hits"])
        rec[label] = dict(got, slo_ok=r["slo_ok"], launches=k4,
                          decode_calls=decode, greedy=len(greedy),
                          greedy_equal_dense=len(same),
                          dense_launches=sum(t["launches"] for t in drows))
        print(f"chip_smoke: scenario {label}: {got}, slo_ok {r['slo_ok']}; "
              f"K4 launches {k4} = {cfg.n_layers} x {decode} decode calls "
              f"({len(bad_ticks)} ticks off); greedy streams equal to the "
              f"dense run's {len(same)}/{len(greedy)}")
        check(got == pin and r["slo_ok"],
              f"scenario {label}: {got} (slo_ok {r['slo_ok']}) != {pin}")
        check(decode > 0 and not bad_ticks,
              f"scenario {label}: K4 launches {k4} over {decode} decode "
              f"calls; ticks {bad_ticks[:8]} off")
        check(rec[label]["dense_launches"] == 0 and len(greedy) >= 4
              and len(same) == len(greedy),
              f"scenario {label}: {len(same)}/{len(greedy)} greedy streams "
              f"equal to the dense run's")
    return launches


def phase_host_tier_adapters(stages, cfg, serve: dict,
                             record: dict) -> int:
    """Phase 11 (module docstring): the host offload tier and LoRA
    adapters on the card. Returns K4's launches over (a)-(c)."""
    rec: dict = {}
    record["host_tier_adapters"] = rec
    t0 = time.perf_counter()
    launches = _host_tier_full_width(stages, cfg, serve,
                                     rec.setdefault("host_tier", {}))
    launches += _adapters_full_width(stages, cfg,
                                     rec.setdefault("adapters", {}))
    launches += _host_adapter_scenarios(rec.setdefault("scenarios", {}))
    # (d) the CLI
    tier = _cli(["--model", "gpt", "--serve-sim", "8", "--serve-replicas",
                 "1", "--serve-host-blocks", "8"])
    adp = _cli(["--model", "gpt", "--serve-sim", "8", "--serve-adapters",
                "2"])
    print(f"chip_smoke: CLI --serve-sim 8 --serve-replicas 1 "
          f"--serve-host-blocks 8: {[ln for ln in tier if 'host' in ln]}; "
          f"--serve-adapters 2: {[ln for ln in adp if 'adapter' in ln]}")
    check(any(ln.startswith("| serve: 8/8 requests completed")
              for ln in tier)
          and any(ln.startswith("| serve: host tier ") for ln in tier),
          f"the CLI's host-tier run printed {tier}")
    check(any(ln.startswith("| serve: 8/8 requests completed")
              for ln in adp)
          and any(ln.startswith("| serve: adapters — ") for ln in adp),
          f"the CLI's adapter run printed {adp}")
    rec["cli"] = tier + adp
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t0
    print(f"chip_smoke: phase 11 took {rec['seconds']:.1f} s")
    return launches


# -- phase 12: the protocol checker, beam search, dense speculation ----------

def _protocol_proof(rec: dict) -> None:
    """(a) The port's ``--serve-protocol`` in this process: depth 8 proves
    the clean model at ``PROTOCOL_PIN``; each seeded defect yields its
    invariant."""
    from simple_distributed_machine_learning_tpu_torch.analysis import (
        protocol,
    )
    from simple_distributed_machine_learning_tpu_torch.analysis.__main__ import (  # noqa: E501
        main as analysis_main,
    )
    t0 = time.perf_counter()
    rc, text = _quiet(analysis_main, ["--serve-protocol"])
    ms = (time.perf_counter() - t0) * 1e3
    verdict = next((ln for ln in text.splitlines()
                    if ln.startswith("verdict: ")), "")
    print(f"chip_smoke: protocol --serve-protocol rc {rc} in {ms:.1f} ms: "
          f"{verdict}")
    check(rc == 0 and verdict.startswith("verdict: proved to depth 8")
          and f"({PROTOCOL_PIN[0]} states, {PROTOCOL_PIN[1]} transitions"
          in verdict, f"--serve-protocol: rc {rc}, {text!r}")
    flagged = {}
    for cfg, inv in ((protocol.DROPPED_TOMBSTONE, "double-serve"),
                     (protocol.LEGACY_ORDER, "lost-request"),
                     (protocol.SKIPPED_REFUND, "refcount"),
                     (protocol.UNGATED_BOARDING, "boarding-gate")):
        rules = sorted(f.rule for f in protocol.check_protocol(cfg).findings)
        flagged[inv] = rules
        check(f"protocol.{inv}" in rules,
              f"the {inv} defect config flagged {rules}")
    print(f"chip_smoke: protocol defect configs flagged {flagged}")
    rec.update(rc=rc, ms=ms, verdict=verdict, defects=flagged)


def _protocol_drill(stages, cfg, plain_handles: list, drill: str) -> dict:
    """(a) One committed drill (``tests/data/protocol_drills/``) over phase
    3's trace on a ``ServeFleet`` of 1 prefill + 2 decode replicas of
    ``engine_factory(..., attn_kernel="fused")``: every request's streamed
    tokens (its ``on_token`` callbacks) must be its handle's — served
    exactly once — and every greedy stream phase 3's."""
    import tempfile

    from simple_distributed_machine_learning_tpu_torch.analysis.protocol import (  # noqa: E501
        load_drill,
    )
    from simple_distributed_machine_learning_tpu_torch.resilience import (
        faults,
    )
    from simple_distributed_machine_learning_tpu_torch.serve import (
        ServeFleet,
        ServeMetrics,
        engine_factory,
    )
    from simple_distributed_machine_learning_tpu_torch.serve.request import (
        DONE,
    )
    plan = load_drill(os.path.join(HERE, "tests", "data", "protocol_drills",
                                   drill))
    check(plan is not None, f"{drill} holds no schedule")
    metrics = ServeMetrics()
    streamed: dict[int, list] = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-protocol-") as d:
        fleet = ServeFleet(
            engine_factory(stages, cfg, attn_kernel="fused",
                           n_slots=SERVE_SLOTS, block_size=SERVE_BLOCK,
                           device="cuda", metrics=metrics),
            d, n_replicas=3, prefill_replicas=1, metrics=metrics)
        submit = fleet.submit

        def streaming(*a, **kw):
            box: list = []
            kw["on_token"] = lambda req, tok: box.append(int(tok))
            h = submit(*a, **kw)
            streamed[h.rid] = box
            return h

        fleet.submit = streaming
        faults.install(faults.FaultPlan.parse(plan))
        try:
            run = _serve(fleet)
        finally:
            faults.uninstall()
            fleet.close()
            del fleet.submit
    handles = run["handles"]
    once = sum(h.state == DONE and streamed[h.rid] == list(h.tokens)
               for h in handles)
    greedy = [i for i, h in enumerate(plain_handles)
              if h.temperature == 0.0]
    same = sum(handles[i].tokens == plain_handles[i].tokens for i in greedy)
    return dict(plan=plan, completed=run["report"]["completed"],
                exactly_once=once, losses=fleet.replica_losses,
                handoffs=fleet.handoffs, migrations=fleet.migrations,
                tick_ms_p50=run["tick_ms_p50"], launches=run["launches"],
                decode=run["decode"], greedy=len(greedy),
                greedy_equal=same)


def _profiled(fn) -> dict:
    """``fn()`` once under ``torch.profiler``: its host ms (ending in a
    synchronisation), the device's busy share and the kernel launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, launches = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += float(getattr(e, "self_device_time_total", None)
                             or getattr(e, "self_cuda_time_total", 0))
            launches += e.count
    check(busy_us > 0, "torch.profiler recorded no device time")
    return dict(profiled_ms=wall_us / 1e3, device_busy_share=busy_us
                / wall_us, launches=launches)


def _spec_steady(stages, cfg, layout: str, n_ticks: int = 10) -> dict:
    """A steady speculative window (draft == target, ``SPEC_K``) at full
    occupancy (``SPEC_SLOTS`` slots, 32-token prompts, no admissions):
    ``n_ticks`` ticks on the host clock, then ``n_ticks`` under the
    profiler (launches and device busy share per tick), over ``layout``
    (``"paged"`` through K4, ``"dense"`` through plain attention)."""
    import numpy as np

    from simple_distributed_machine_learning_tpu_torch.serve import (
        InferenceEngine,
    )
    engine = InferenceEngine(
        stages, cfg, n_slots=SPEC_SLOTS, block_size=SERVE_BLOCK,
        kv_layout=layout, attn_kernel="fused" if layout == "paged"
        else "dense", draft_stages=stages, draft_cfg=cfg, spec_k=SPEC_K)
    rng = np.random.default_rng(1)
    for _ in range(SPEC_SLOTS):
        engine.submit(rng.integers(0, cfg.vocab, 32).astype(np.int32),
                      max_new_tokens=SPEC_K * (2 * n_ticks + 3 + SPEC_SLOTS)
                      + 8)
    while engine._prefilling or len(engine._decoding_slots()) < SPEC_SLOTS:
        engine.step()
    for _ in range(3):
        engine.step()
    _sync()
    t0 = time.perf_counter()
    for _ in range(n_ticks):
        engine.step()
    _sync()
    tick_ms = (time.perf_counter() - t0) * 1e3 / n_ticks
    prof = _profiled(lambda: [engine.step() for _ in range(n_ticks)])
    check(len(engine._decoding_slots()) == SPEC_SLOTS,
          f"the {layout} speculative window did not run at full occupancy")
    return dict(tick_ms=tick_ms,
                profiled_tick_ms=prof["profiled_ms"] / n_ticks,
                device_busy_share=prof["device_busy_share"],
                launches_per_tick=prof["launches"] / n_ticks)


def _beam_score(params, cfg, row, eos_id) -> float:
    """The teacher-forced log-prob of a beam row's generated tokens on the
    card, through its first ``eos_id`` (the eos padding scores 0)."""
    import torch
    t0 = BEAM["t0"]
    lp = _teacher_forced(params, cfg, row)
    gen = row[t0:].tolist()
    end = (t0 + gen.index(eos_id) + 1 if eos_id is not None
           and eos_id in gen else len(row))
    pos = torch.arange(t0 - 1, end - 1, device=lp.device)
    nxt = torch.as_tensor(row[t0:end], device=lp.device).long()
    return float(lp[pos, nxt].sum())


def _beam_full_width(stages, cfg, rec: dict) -> None:
    """(b) ``make_beam_decoder`` at SERVE_CFG (``BEAM``), without and with
    an EOS id (one the no-EOS beam run emits mid-stream): ``beam_size=1``
    equals the card's cached greedy decoder; every score equals its row's
    teacher-forced log-prob within ``BEAM_TOL``; every beam score is at
    least the greedy one (within ``BEAM_TOL``); the card's tokens equal
    the CPU's, or the two answers score within ``BEAM_TOL`` of each other
    on the card (a near-tie in the beam's ranking; the first differing
    step and the score gap printed)."""
    import copy

    import numpy as np
    from simple_distributed_machine_learning_tpu_torch.models import (
        make_beam_decoder,
    )
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        make_cached_decoder,
    )
    params = [st.params for st in stages]
    cpu_params = [copy.deepcopy(p).to("cpu") for p in params]
    t0, n_new, K = BEAM["t0"], BEAM["n_new"], BEAM["beam_size"]
    prompts = np.random.default_rng(BEAM["seed"]).integers(
        0, cfg.vocab, (BEAM["n_prompts"], t0)).astype(np.int32)

    def decode(k, eos_id, device, ps):
        return make_beam_decoder(stages, cfg, t0, n_new, k, eos_id=eos_id,
                                 device=device)(ps, prompts)

    def host_ms(k):
        ms = []
        for _ in range(3):
            _sync()
            a = time.perf_counter()
            decode(k, None, "cuda", params)
            _sync()
            ms.append((time.perf_counter() - a) * 1e3)
        return statistics.median(ms)

    greedy = make_cached_decoder(stages, cfg, t0, n_new)(params, prompts)
    g_toks, g_scores = decode(1, None, "cuda", params)
    check(bool((g_toks == greedy).all()),
          "beam_size=1 differs from the cached greedy decoder")
    base_toks, _ = decode(K, None, "cuda", params)
    runs = {}
    for eos_id in (None, int(base_toks[0, t0 + n_new // 2])):
        toks, scores = decode(K, eos_id, "cuda", params)
        ctoks, cscores = decode(K, eos_id, "cpu", cpu_params)
        toks, scores = toks.cpu().numpy(), scores.cpu().numpy()
        ctoks, cscores = ctoks.numpy(), cscores.numpy()
        tf = [_beam_score(params, cfg, row, eos_id) for row in toks]
        score_err = max(abs(float(s) - t) / abs(t)
                        for s, t in zip(scores, tf))
        check(score_err <= BEAM_TOL,
              f"beam scores {scores} against teacher-forced {tf}")
        if eos_id is None:
            worst = min(float(s) - float(g) + BEAM_TOL * abs(float(g))
                        for s, g in zip(scores, g_scores.cpu().numpy()))
            check(worst >= 0.0, f"a beam score under the greedy one: "
                                f"{scores} against {g_scores}")
        ties = []
        for b in range(len(prompts)):
            if (toks[b] == ctoks[b]).all():
                continue
            first = int(np.nonzero(toks[b] != ctoks[b])[0][0]) - t0
            gap = abs(tf[b] - _beam_score(params, cfg, ctoks[b], eos_id))
            ties.append(dict(row=b, first_step=first, score_gap=gap))
            check(gap <= BEAM_TOL * abs(tf[b]),
                  f"beam row {b}: card and CPU tokens differ at step "
                  f"{first}, scores {gap} apart")
        runs["eos" if eos_id is not None else "no_eos"] = dict(
            eos_id=eos_id, scores=scores.tolist(), score_rel_err=score_err,
            cpu_max_rel_gap=float(np.max(np.abs(scores - cscores)
                                         / np.abs(cscores))),
            rows_equal_cpu=len(prompts) - len(ties), near_ties=ties,
            eos_rows=int(sum(eos_id in r[t0:] for r in toks.tolist()))
            if eos_id is not None else 0)
    ms1, msk = host_ms(1), host_ms(K)
    prof1 = _profiled(lambda: decode(1, None, "cuda", params))
    profk = _profiled(lambda: decode(K, None, "cuda", params))
    rec.update(runs, host_ms_beam1=ms1, host_ms_beam=msk, beam_size=K,
               profile_beam1=prof1, profile_beam=profk,
               greedy_scores=g_scores.cpu().tolist())
    for name, r in runs.items():
        print(f"chip_smoke: beam (b) {name} (eos {r['eos_id']}, "
              f"{r['eos_rows']} rows end in it): {BEAM['n_prompts']} "
              f"prompts x {t0} tokens, {n_new} new, beam {K}: scores "
              f"within {r['score_rel_err']:.2e} of the teacher-forced "
              f"log-probs, {r['cpu_max_rel_gap']:.2e} of the CPU's; rows "
              f"equal to the CPU's {r['rows_equal_cpu']}/{len(prompts)}, "
              f"near-ties {r['near_ties']}")
    print(f"chip_smoke: beam (b) host ms per decode: beam 1 {ms1:.3f}, "
          f"beam {K} {msk:.3f}; beam 1 == cached greedy decoder; profiled: "
          f"{prof1['launches']} / {profk['launches']} launches, device "
          f"busy {prof1['device_busy_share']:.4f} / "
          f"{profk['device_busy_share']:.4f}")


def _dense_spec(stages, cfg, serve: dict, plain_handles: list,
                spec: dict, rec: dict) -> None:
    """(c) Speculation over ``kv_layout="dense"`` at phase 3b's cell: (i)
    draft == target at ``SPEC_K`` on phase 3b (a)'s workload — accept
    rate exactly 1.0, streams equal to 3b (a)'s paged speculative and
    plain ones; (ii) the CLI's half-depth draft on phase 3's trace —
    24/24 served, greedy streams equal to 3b (b)'s and phase 3's. K4
    launches 0 in both (the dense rows use plain attention)."""
    import dataclasses

    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        make_gpt_stages,
    )
    from simple_distributed_machine_learning_tpu_torch.ops.random import (
        fold_in,
    )
    reqs = _spec_workload(cfg.vocab)
    n_tok = SPEC_WORKLOAD["n_requests"] * SPEC_WORKLOAD["max_new"]
    a = spec["accept_all"]
    run = _drain_counted(stages, cfg, reqs, kernel="dense",
                         kv_layout="dense", draft_stages=stages,
                         draft_cfg=cfg, spec_k=SPEC_K)
    rate = run["summary"].get("spec_accept_rate")
    rec["accept_all"] = dict(
        ticks=run["ticks"], spec_ticks=run["calls"], accept_rate=rate,
        tokens_per_tick=n_tok / run["ticks"],
        host_tick_ms=run["wall_s"] * 1e3 / run["ticks"],
        launches=run["launches"],
        equal_paged=sum(x == y for x, y in zip(run["streams"],
                                                a["streams"])),
        equal_plain=sum(x == y for x, y in zip(run["streams"],
                                                a["plain_streams"])))
    r = rec["accept_all"]
    print(f"chip_smoke: dense spec (c) accept-all spec_k {SPEC_K}, "
          f"{SPEC_SLOTS} slots: accept rate {rate}, {run['ticks']} ticks, "
          f"{r['tokens_per_tick']:.3f} tokens/tick (paged "
          f"{a['tokens_per_tick_spec']:.3f}), host tick "
          f"{r['host_tick_ms']:.3f} ms (paged {a['host_tick_ms_spec']:.3f}"
          f"); K4 launches {run['launches']}; streams equal to paged spec "
          f"{r['equal_paged']}/{len(reqs)}, to plain {r['equal_plain']}/"
          f"{len(reqs)}")
    check(rate == 1.0, f"dense accept-all rate {rate}")
    check(r["equal_paged"] == len(reqs) == r["equal_plain"],
          "dense speculative streams differ from the paged or plain ones")
    check(run["calls"] > 0 and run["launches"] == 0,
          f"dense spec: {run['calls']} spec ticks, K4 launches "
          f"{run['launches']} (must be 0)")
    steady = {lay: _spec_steady(stages, cfg, lay)
              for lay in ("dense", "paged")}
    rec["steady"] = steady
    dn, pg = steady["dense"], steady["paged"]
    print(f"chip_smoke: dense spec (c) steady tick at {SPEC_SLOTS}/"
          f"{SPEC_SLOTS} slots, draft == target: {dn['tick_ms']:.3f} ms "
          f"host (paged {pg['tick_ms']:.3f}); profiled "
          f"{dn['profiled_tick_ms']:.3f} / {pg['profiled_tick_ms']:.3f} ms,"
          f" {dn['launches_per_tick']:.1f} / {pg['launches_per_tick']:.1f} "
          f"launches per tick, device busy {dn['device_busy_share']:.4f} / "
          f"{pg['device_busy_share']:.4f}")

    dcfg = dataclasses.replace(cfg, n_layers=max(1, cfg.n_layers // 2))
    dstages = make_gpt_stages(fold_in(0, 1), dcfg, 1)[0]
    trace = _serve(_warm_engine(stages, cfg, "dense", kv_layout="dense",
                                draft_stages=dstages, draft_cfg=dcfg,
                                spec_k=SPEC_K))
    b = spec["cli_draft"]
    handles, s = trace["handles"], trace["summary"]
    greedy = [i for i, h in enumerate(plain_handles)
              if h.temperature == 0.0]
    rec["cli_draft"] = dict(
        completed=trace["report"]["completed"], summary=s,
        launches=trace["launches"], spec_ticks=trace["decode"],
        tick_ms=trace["tick_ms"], tick_ms_p50=trace["tick_ms_p50"],
        greedy=len(greedy),
        equal_plain=sum(handles[i].tokens == plain_handles[i].tokens
                        for i in greedy),
        equal_paged=sum(handles[i].tokens == b["streams"][i]
                        for i in greedy))
    c = rec["cli_draft"]
    print(f"chip_smoke: dense spec (c) draft of {dcfg.n_layers} layers, "
          f"spec_k {SPEC_K}, phase 3's trace: {c['completed']}/"
          f"{SERVE_SIM['n_requests']}, accept rate "
          f"{s.get('spec_accept_rate')} (paged "
          f"{b['summary'].get('spec_accept_rate')}), {s['tokens_per_sec']} "
          f"tok/s (paged {b['summary']['tokens_per_sec']}), host tick "
          f"{c['tick_ms']:.3f} ms (paged {b['tick_ms']:.3f}, plain "
          f"{serve['tick_ms']:.3f}); K4 launches {c['launches']}; greedy "
          f"streams equal to phase 3's {c['equal_plain']}/{len(greedy)}, to "
          f"paged spec {c['equal_paged']}/{len(greedy)}")
    check(c["completed"] == SERVE_SIM["n_requests"],
          f"dense spec (ii) served {c['completed']}")
    check(c["equal_plain"] == len(greedy) == c["equal_paged"],
          "dense spec (ii): greedy streams differ from phase 3's or 3b's")
    check(c["spec_ticks"] > 0 and c["launches"] == 0,
          f"dense spec (ii): K4 launches {c['launches']} (must be 0)")


def phase_protocol_beam_dense(stages, cfg, serve: dict, plain_handles: list,
                              spec: dict, record: dict) -> int:
    """Phase 12 (module docstring): the serve-protocol checker and its
    drills on the fleet, beam search, and speculation over dense rows.
    Returns K4's launches over (a)'s fleet drills."""
    rec: dict = {}
    record["protocol_beam_dense"] = rec
    t0 = time.perf_counter()
    _protocol_proof(rec.setdefault("protocol", {}))
    launches = 0
    for drill in PROTOCOL_DRILLS:
        d = _protocol_drill(stages, cfg, plain_handles, drill)
        rec.setdefault("drills", {})[drill] = d
        launches += d["launches"]
        print(f"chip_smoke: protocol drill (a) {drill} ({d['plan']}) on 1 "
              f"prefill + 2 decode, phase 3's trace: {d['completed']}/"
              f"{SERVE_SIM['n_requests']} served, exactly once "
              f"{d['exactly_once']}, {d['losses']} loss(es), "
              f"{d['handoffs']} handoff(s), {d['migrations']} "
              f"migration(s); fleet tick p50 {d['tick_ms_p50']:.3f} ms "
              f"(phase 3's {serve['tick_ms_p50']:.3f}); K4 launches "
              f"{d['launches']} = {cfg.n_layers} x {d['decode']}; greedy "
              f"streams equal to phase 3's {d['greedy_equal']}/"
              f"{d['greedy']}")
        check(d["completed"] == d["exactly_once"]
              == SERVE_SIM["n_requests"],
              f"drill {drill}: {d['completed']} completed, "
              f"{d['exactly_once']} exactly once")
        check(d["greedy_equal"] == d["greedy"] >= 2,
              f"drill {drill}: greedy streams differ from phase 3's")
        check(d["losses"] >= 1 and d["launches"] == cfg.n_layers
              * d["decode"], f"drill {drill}: {d['losses']} losses, K4 "
              f"{d['launches']} != {cfg.n_layers} x {d['decode']}")
    _beam_full_width(stages, cfg, rec.setdefault("beam", {}))
    _dense_spec(stages, cfg, serve, plain_handles, spec,
                rec.setdefault("dense_spec", {}))
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t0
    print(f"chip_smoke: phase 12 took {rec['seconds']:.1f} s")
    return launches


# -- phase 13: training telemetry, the profiler and the native loader ---------

def _idx_file(path: str, arr) -> None:
    """``arr`` (uint8) as an IDX file (big-endian dims, magic 0x08)."""
    import struct
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim)
                + struct.pack(">" + "I" * arr.ndim, *arr.shape)
                + arr.tobytes())


def _jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(ln) for ln in f]


def _telemetry_lenet(tmp: str, every: int, rec: dict) -> None:
    """(a): the LeNet CLI for ``TELEMETRY_EPOCHS`` epochs with
    ``--telemetry-dir`` at ``--telemetry-every every``; its records, trace
    and exposition gated."""
    d = os.path.join(tmp, f"tele_every{every}")
    lines = _cli(["--model", "lenet", "--data-root",
                  os.path.join(tmp, "no-mnist"), "--epochs",
                  str(TELEMETRY_EPOCHS), "--telemetry-dir", d,
                  "--telemetry-every", str(every)])
    bad = [ln for ln in lines if not (TRAIN_RE.match(ln) or TEST_RE.match(ln)
                                      or EPOCH_RE.match(ln))]
    check(not bad, f"telemetry lenet CLI: lines off the reference formats: "
                   f"{bad}")
    recs = _jsonl(os.path.join(d, "metrics.jsonl"))
    per_epoch = 6000 // 60
    want_steps = [e * per_epoch - 1 for e in range(1, TELEMETRY_EPOCHS + 1)]
    check([r["epoch"] for r in recs] == list(range(1, TELEMETRY_EPOCHS + 1)),
          f"every={every}: expected one record per epoch, got {recs}")
    lenet_bytes = 21_840 * 4
    for r in recs:
        check(set(r) == JAX_EPOCH_KEYS | {"device_memory"},
              f"every={every}: record keys {sorted(r)} are not the JAX "
              f"record's plus device_memory: {sorted(set(r) ^ JAX_EPOCH_KEYS)}")
        mem = r["device_memory"].get("0", {})
        check(mem.get("peak_bytes_in_use", 0) >= mem.get("bytes_in_use", 0)
              > 0, f"every={every}: device_memory {r['device_memory']}")
        check(r["live_array_bytes"] >= lenet_bytes,
              f"every={every}: live_array_bytes {r['live_array_bytes']} < "
              f"LeNet's {lenet_bytes} parameter bytes")
        check(r["compile_time_s"] > 0 and 0 < r["step_time_ms_p50"]
              <= r["step_time_ms_p95"] <= r["step_time_ms_max"],
              f"every={every}: timings {r}")
    check([r["steps"] for r in recs] == want_steps,
          f"every={every}: steady steps {[r['steps'] for r in recs]} != "
          f"{want_steps} (every step but the compile window)")
    with open(os.path.join(d, "trace.json")) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    check({"feed", "step", "eval", "epoch_end"} <= names,
          f"every={every}: trace.json names {sorted(names)}")
    with open(os.path.join(d, "metrics.prom")) as f:
        check("# HELP step_time_ms " in f.read(),
              f"every={every}: metrics.prom has no # HELP step_time_ms")
    rec[f"every_{every}"] = dict(
        records=recs, console=[ln for ln in lines if EPOCH_RE.match(ln)])


def _kernel_events(trace_dir: str) -> dict[str, int]:
    """Kernel launches by name in the one ``*.pt.trace.json`` that
    ``--profile`` wrote into ``trace_dir``."""
    files = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    check(len(files) == 1, f"--profile wrote {files} into {trace_dir}")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    counts: dict[str, int] = {}
    for e in events:
        if e.get("cat") == "kernel":
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    return counts


def _telemetry_gpt(tmp: str, rec: dict) -> tuple[int, int, int]:
    """(b): ``gpt --attn flash --bf16`` through the CLI with the telemetry,
    ``--profile`` and ``--generate``; the K1-K3 launches."""
    d, prof = os.path.join(tmp, "tele_gpt"), os.path.join(tmp, "prof_gpt")
    _reset_flash_counts()
    lines = _cli(["--model", "gpt", "--attn", "flash", "--bf16", "--dryrun",
                  str(MAIN_GPT_STEPS), "--generate", "16", "--telemetry-dir",
                  d, "--profile", prof])
    counts = _flash_counts()
    n_layers, evals = 2, -(-1000 // 60)
    want = (n_layers * (MAIN_GPT_STEPS + evals), n_layers * MAIN_GPT_STEPS,
            n_layers * MAIN_GPT_STEPS)
    check(counts == want, f"telemetry gpt CLI: flash launches {counts} != "
                          f"{want}")
    kernels = _kernel_events(prof)
    traced = tuple(sum(n for k, n in kernels.items() if kern in k)
                   for kern in ("flash_fwd_kernel", "flash_dq_kernel",
                                "flash_dkv_kernel"))
    check(traced == counts, f"the --profile trace names K1-K3 {traced} "
                            f"times, the wrappers launched {counts}: "
                            f"{sorted(k for k in kernels if 'flash' in k)}")
    recs = _jsonl(os.path.join(d, "metrics.jsonl"))
    check([r["kind"] for r in recs] == ["epoch", "decode"],
          f"telemetry gpt CLI: records {[r['kind'] for r in recs]}")
    check(recs[1]["n_new"] == 16 and recs[1]["tokens_per_sec"] > 0,
          f"telemetry gpt CLI: decode record {recs[1]}")
    check(set(recs[0]) == JAX_EPOCH_KEYS | {"device_memory"}
          and recs[0]["tokens_per_sec"] > 0,
          f"telemetry gpt CLI: epoch record {recs[0]}")
    check(any(ln.startswith("| sample tokens") for ln in lines),
          "telemetry gpt CLI: --generate printed no sample")
    rec["gpt"] = dict(launches=counts, traced=traced, epoch=recs[0],
                      decode=recs[1], kernels_traced=sorted(
                          k for k in kernels if "flash" in k))
    return counts


def _native_feed(tmp: str, rec: dict) -> None:
    """(c): phase 7's synthetic MNIST as IDX files, tiled to the full
    60000/10000 so the reference's 1/10 cut reads exactly it; the LeNet
    CLI from them with --shuffle; then LeNet's steps from either feed."""
    import itertools

    import numpy as np

    from simple_distributed_machine_learning_tpu_torch.data import (
        mnist,
        native_loader,
    )
    check(native_loader.available(),
          f"the native loader did not build: {native_loader.build_error()}")
    root = os.path.join(tmp, "mnist")
    os.makedirs(root)
    train, test = _row_data(False)
    for split, ds in (("train", train), ("t10k", test)):
        px = np.rint(ds.x[..., 0] * 255).astype(np.uint8)
        _idx_file(os.path.join(root, f"{split}-images-idx3-ubyte"),
                  np.tile(px, (10, 1, 1)))
        _idx_file(os.path.join(root, f"{split}-labels-idx1-ubyte"),
                  np.tile(ds.y.astype(np.uint8), 10))
    files0 = native_loader.idx_read_native.files
    batches0 = native_loader.NativePrefetcher.batches
    t0 = time.perf_counter()
    lines = _cli(["--model", "lenet", "--data-root", root, "--shuffle",
                  "--epochs", "1"])
    cli_s = time.perf_counter() - t0
    files = native_loader.idx_read_native.files - files0
    made = native_loader.NativePrefetcher.batches - batches0
    bad = [ln for ln in lines if not (TRAIN_RE.match(ln) or TEST_RE.match(ln)
                                      or EPOCH_RE.match(ln))]
    steps = 6000 // 60
    check(not bad and sum(bool(TRAIN_RE.match(ln)) for ln in lines) == 10,
          f"native lenet CLI: console {lines}")
    check(files == 4, f"the native codec parsed {files} files, not 4")
    check(made == steps, f"the native prefetcher assembled {made} batches "
                         f"for {steps} steps")
    # the same 20 shuffled batches from either feed, through LeNet on the
    # card: the losses must be bit-identical
    ds, _ = mnist.load_mnist(root)
    seed = 0 * 100003 + 1                         # the Trainer's epoch 1
    feeds, host_ms = {}, {}
    for name, make in (("native", mnist.prefetch_batches),
                       ("python", mnist.batches)):
        t0 = time.perf_counter()
        feeds[name] = list(itertools.islice(
            make(ds, 60, shuffle_seed=seed), NATIVE_STEPS))
        host_ms[name] = (time.perf_counter() - t0) * 1e3 / NATIVE_STEPS
    losses = {name: _lenet_steps(MAIN_DEVICE, feed)
              for name, feed in feeds.items()}
    same = losses["native"] == losses["python"]
    rec["native"] = dict(cli_s=cli_s, console=lines, files=files,
                         batches=made, losses=losses, host_ms=host_ms,
                         bit_identical=same)
    print(f"chip_smoke: native loader: the LeNet CLI from IDX files "
          f"(--shuffle, 1 epoch) in {cli_s:.1f} s, {files} files parsed by "
          f"the codec, {made} batches assembled for {steps} steps; "
          f"{NATIVE_STEPS} LeNet steps on the card, native feed vs Python "
          f"feed: losses bit-identical {same} ({losses['native'][0]} -> "
          f"{losses['native'][-1]}); host ms per batch: native "
          f"{host_ms['native']:.4f}, Python {host_ms['python']:.4f}")
    check(same, f"the native feed's losses {losses['native']} differ from "
                f"the Python feed's {losses['python']}")


def phase_telemetry_native(record: dict) -> tuple[int, int, int]:
    """Phase 13 (module docstring): the training telemetry session, the
    profiler and the native loader on the reference's main path. Returns
    (b)'s K1-K3 launches."""
    import tempfile
    rec: dict = {}
    record["telemetry_native"] = rec
    t0 = time.perf_counter()
    lenet_ms = record["main_path"]["rows"]["lenet"]["step_ms"]
    with tempfile.TemporaryDirectory() as tmp:
        for every in TELEMETRY_EVERY:
            _telemetry_lenet(tmp, every, rec)
        print(f"chip_smoke: telemetry (a): lenet CLI, {TELEMETRY_EPOCHS} "
              f"epochs, step ms p50/p95/max from the telemetry record: "
              + "; ".join(
                  f"every {e}: " + ", ".join(
                      f"epoch {r['epoch']} {r['step_time_ms_p50']}/"
                      f"{r['step_time_ms_p95']}/{r['step_time_ms_max']} "
                      f"({r['steps']} steps, compile "
                      f"{r['compile_time_s']} s)"
                      for r in rec[f"every_{e}"]["records"])
                  for e in TELEMETRY_EVERY)
              + f"; phase 7's lenet step (host clock, no fences) "
                f"{lenet_ms:.4f} ms")
        last = rec[f"every_{TELEMETRY_EVERY[0]}"]["records"][-1]
        print(f"chip_smoke: telemetry (a): device memory "
              f"{last['device_memory']}, live tensor bytes "
              f"{last['live_array_bytes']}")
        counts = _telemetry_gpt(tmp, rec)
        g = rec["gpt"]
        print(f"chip_smoke: telemetry (b): gpt --attn flash --bf16 "
              f"--dryrun {MAIN_GPT_STEPS} --profile: K1/K2/K3 launches "
              f"{counts}, the same in the profiler trace "
              f"{g['kernels_traced']}; decode record: "
              f"{g['decode']['tokens_per_sec']} tokens/s, p50 "
              f"{g['decode']['step_time_ms_p50']} ms")
        print(f"chip_smoke: telemetry (b): epoch record {json.dumps(g['epoch'])}")
        _native_feed(tmp, rec)
    rec["seconds"] = time.perf_counter() - t0
    print(f"chip_smoke: phase 13 took {rec['seconds']:.1f} s")
    return counts


# -- phase 14: the kernel linter, F1 and the KV byte model ------------------

def _grid_on_card(rec: dict) -> dict:
    """(a) F1 through ``--fixture`` (the launches counted), then against
    its plain version, the linter's verdicts, and its times. Returns F1's
    row of the kernels line."""
    import torch
    from simple_distributed_machine_learning_tpu_torch.analysis import (
        kernels,
    )
    from simple_distributed_machine_learning_tpu_torch.analysis.__main__ import (  # noqa: E501
        main as analysis_main,
    )
    from simple_distributed_machine_learning_tpu_torch.analysis.fixtures import (  # noqa: E501
        grid_input,
        grid_scratch,
        grid_scratch_reference,
        grid_scratch_spec,
        launch,
    )
    grid_scratch.launches = 0
    for name, want_rc, want_rules in GRID_FIXTURES:
        rc, text = _quiet(analysis_main, ["--fixture", name])
        rules = sorted(set(re.findall(r"\] (kernel-[a-z.-]+):", text)))
        print(f"chip_smoke: lint (a) --fixture {name}: rc {rc}, {rules}")
        check(rc == want_rc and rules == want_rules,
              f"--fixture {name}: rc {rc}, {text!r}")
    launches = grid_scratch.launches
    check(launches == len(GRID_FIXTURES),
          f"F1 launched {launches} times by the {len(GRID_FIXTURES)} "
          f"grid fixtures")
    x = grid_input("cuda")
    errs = []
    for scratch in (torch.float32, torch.float16):
        got = grid_scratch(x, racing=False, scratch_dtype=scratch)
        want = grid_scratch_reference(x, racing=False,
                                      scratch_dtype=scratch)
        torch.cuda.synchronize()
        errs.append(float((got - want).abs().max()))
        check(torch.equal(got, want), f"F1 ({scratch}) differs from its "
                                      f"plain version: {errs[-1]}")
    race = grid_scratch(x, racing=True)
    torch.cuda.synchronize()
    winners = (race[0][None] == 2 * x)              # [cells, cols]
    check(bool(torch.isnan(race[1:]).all()) and bool(winners.any(0).all()),
          "the racing F1 wrote outside row 0, or a row-0 element is no "
          "cell's 2x")
    cells = sorted({int(winners[:, c].nonzero()[0, 0])
                    for c in range(x.shape[1])})
    print(f"chip_smoke: lint (a) F1 on the card: clean f32/f16 bit-equal "
          f"to the plain version; racing: rows 1-3 NaN, row 0 written by "
          f"cell(s) {cells} (one cell won the whole row: "
          f"{len(cells) == 1})")
    verdicts = {}
    for label, spec in (
            ("race", grid_scratch_spec(*x.shape, racing=True)),
            ("f16", grid_scratch_spec(*x.shape, racing=False,
                                      scratch_dtype=torch.float16)),
            ("f32", grid_scratch_spec(*x.shape, racing=False))):
        verdicts[label] = [f"{f.rule} {f.severity}"
                           for f in kernels.lint(spec)]
    check(verdicts == {
        "race": ["kernel-race.parallel-overwrite ERROR"],
        "f16": ["kernel-dtype-drift.low-precision-scratch WARNING"],
        "f32": []}, f"the linter on F1's specs: {verdicts}")
    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32,
                        device="cuda")
    out = torch.full_like(x, float("nan"))
    out_row = torch.arange(x.shape[0], dtype=torch.int32, device="cuda")
    n0 = grid_scratch.launches

    def kernel():
        launch(x, out, out_row, torch.float32)

    ms = time_ms(kernel, flush)
    plain_ms = time_ms(lambda: grid_scratch_reference(x, racing=False),
                       flush)
    library_ms = time_ms(lambda: torch.mul(x, 2), flush)
    seen_here = profiler_tally(kernel, flush, "grid_scratch_kernel")[1]
    grid_scratch.launches = n0           # timing launches are not the path
    profiler_ms = _f1_profiler_ms_fresh()
    R, C = x.shape
    nbytes = 2 * R * C * 4 + R * 4       # x and out_row read, out written
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, R * C / F32_FLOPS
    bound_ms = max(t_bytes, t_ops) * 1e3
    print(f"chip_smoke: lint (a) F1 {ms:.6f} ms per launch, plain "
          f"{plain_ms:.6f} ms, torch.mul "
          f"{library_ms:.6f} ms, bound {bound_ms:.9f} ms ({nbytes} bytes); "
          f"{launches} launches from the fixtures; profiler cross-check "
          f"{profiler_ms:.6f} ms (a process of its own, 40 of 40 seen; in "
          f"this process, after phase 13 (b)'s --profile session, the "
          f"profiler saw {seen_here} of 40)")
    rec["grid"] = dict(launches=launches, verdicts=verdicts,
                       race_cells=cells, ms=ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, profiler_ms=profiler_ms,
                       profiler_seen_in_process=seen_here)
    return {
        "name": "grid_scratch",
        "route": "cuda",
        "source": f"{PORT}/ops/csrc/grid_scratch.cu",
        "replaces": "simple_distributed_machine_learning_tpu/analysis/"
                    "fixtures.py:428",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }


def f1_profiler_ms() -> float:
    """F1's ``torch.profiler`` cross-check of phase 14 (a)'s CUDA-event
    time: the mean device time of the launches named
    ``grid_scratch_kernel`` over 40 (flush, F1) calls, all 40 seen."""
    import torch

    from simple_distributed_machine_learning_tpu_torch.analysis.fixtures import (  # noqa: E501
        grid_input,
        launch,
    )
    x = grid_input("cuda")
    out = torch.full_like(x, float("nan"))
    out_row = torch.arange(x.shape[0], dtype=torch.int32, device="cuda")
    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32,
                        device="cuda")

    def kernel():
        launch(x, out, out_row, torch.float32)

    for _ in range(3):
        kernel()
    return profiled_kernel_ms(kernel, flush, "grid_scratch_kernel")


def _f1_profiler_ms_fresh() -> float:
    """:func:`f1_profiler_ms` in a process of its own. In this process
    phase 13 (b)'s ``--profile`` run has held a scheduled
    ``torch.profiler`` session, and later sessions here lose CUDA
    records (phase 14 (a) prints how many of 40 F1 launches one sees);
    a fresh process sees all 40."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import chip_smoke; print(chip_smoke.f1_profiler_ms())"],
        cwd=HERE, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0,
          f"F1's profiler cross-check: rc {proc.returncode}\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    return float(proc.stdout.strip().splitlines()[-1])


def _k4_specs_full_width(stages, cfg, rec: dict) -> None:
    """(b) One decode and one verify tick of phase 3's deployment, f32 and
    int8, through ``programs.kernel_report``: lint clean, derived K/V
    bytes equal to the byte model's."""
    from simple_distributed_machine_learning_tpu_torch.analysis import (
        programs,
    )
    rec["k4"] = {}
    for cache in (None, "int8"):
        sspec = programs.ServeSpec(
            cfg, n_slots=SERVE_SLOTS, kv_layout="paged",
            block_size=SERVE_BLOCK, prompt_lens=SERVE_SIM["prompt_lens"],
            cache_dtype=cache, spec_k=SPEC_K, draft_cfg=cfg,
            attn_kernel="fused")
        report = programs.kernel_report(stages, sspec, draft_stages=stages,
                                        device=MAIN_DEVICE)
        rows = {(h.program, h.op): h.bytes_per_tick for h in report.hbm}
        pairs = {prog: (rows.get((prog, "kernel.kv_stream")),
                        rows[(prog, op)])
                 for prog, op in (("paged_decode", "decode.kv_gather"),
                                  ("paged_verify", "verify.kv_gather"))}
        name = cache or "float32"
        print(f"chip_smoke: lint (b) {name}: findings "
              f"{[f.rule for f in report.findings]}; derived vs model K/V "
              f"bytes per tick {pairs}")
        check(report.ok(fail_on="warning")
              and all(d == m for d, m in pairs.values()),
              f"K4's recorded launches ({name}): {report.format()}")
        if cache is None:
            check(pairs["paged_decode"][1] == SERVE_SLOTS * cfg.n_layers
                  * cfg.seq_len * 2 * cfg.d_model * 4 == 33_554_432,
                  f"decode.kv_gather {pairs['paged_decode'][1]}")
        rec["k4"][name] = pairs


def _drift_trace(stages, cfg, sim: dict) -> list[tuple]:
    """Phase 3's trace (``sim`` overriding ``SERVE_SIM``) through a metered
    fused engine: per busy tick (drift, predicted, resident bytes, host ms
    of one more ``kv_drift()`` call at the tick's end)."""
    from simple_distributed_machine_learning_tpu_torch.serve import (
        SimConfig,
        simulate,
    )
    engine = _warm_engine(stages, cfg, "fused", device=MAIN_DEVICE)
    rows: list[tuple] = []
    step = engine.step

    def recorded():
        busy = engine.busy
        out = step()
        m = engine.metrics
        if busy:
            t0 = time.perf_counter()
            engine.kv_drift()
            rows.append((int(m.kv_drift_bytes.value),
                         int(m.kv_bytes_predicted.value),
                         int(m.kv_bytes_resident.value),
                         (time.perf_counter() - t0) * 1e3))
        return out

    engine.step = recorded
    rep = simulate(engine, SimConfig(**{**SERVE_SIM, **sim}))
    check(rep["completed"] == SERVE_SIM["n_requests"],
          f"drift trace {sim}: {rep['completed']} completed")
    return rows


def _kv_drift_on_card(stages, cfg, rec: dict) -> None:
    """(c) The KV-drift gauge on every tick of phase 3's trace, without
    and with a shared prefix."""
    plain = _drift_trace(stages, cfg, {})
    check(plain and all(d == 0 and p == r for d, p, r, _ in plain),
          f"KV drift on phase 3's trace: "
          f"{[t for t in plain if t[0] or t[1] != t[2]][:5]}")
    shared = _drift_trace(stages, cfg, {"shared_prefix_len": PREFIX_LEN})
    neg = sum(t[0] < 0 for t in shared)
    check(all(t[0] <= 0 for t in shared) and neg > 0,
          f"KV drift with a shared prefix: max {max(shared)[0]}, {neg} "
          f"ticks below 0")
    drift_ms = statistics.median(t[3] for t in plain + shared)
    print(f"chip_smoke: lint (c) KV drift 0 on all {len(plain)} ticks of "
          f"phase 3's trace (predicted == resident, peak "
          f"{max(t[1] for t in plain)} bytes); with a {PREFIX_LEN}-token "
          f"shared prefix <= 0 on all {len(shared)} ticks, below 0 on "
          f"{neg} (min {min(t[0] for t in shared)} bytes); kv_drift() "
          f"{drift_ms:.4f} ms of host time per tick (median)")
    rec["drift"] = dict(ticks=len(plain), shared_ticks=len(shared),
                        shared_negative=neg,
                        shared_min=min(t[0] for t in shared),
                        kv_drift_ms_p50=drift_ms)


def _analysis_cli(rec: dict) -> None:
    """(d) The analysis CLI as a user runs it, in processes of its own."""
    runs = {}
    for label, argv, env, want in (
            ("serve-kernel", ["--serve-kernel"], {}, 0),
            ("serve-kernel drill", ["--serve-kernel"],
             {"SDML_LINT_INJECT": "drill"}, 1),
            ("fixtures", ["--fixtures"], {}, 0)):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"{PORT}.analysis", *argv, "--device",
             MAIN_DEVICE], cwd=HERE,
            env={**os.environ, **env}, capture_output=True, text=True,
            timeout=600)
        s = time.perf_counter() - t0
        last = (proc.stdout.strip().splitlines() or [""])[-1]
        print(f"chip_smoke: lint (d) analysis {' '.join(argv)} "
              f"{'(SDML_LINT_INJECT) ' if env else ''}rc "
              f"{proc.returncode} in {s:.1f} s: {last}")
        check(proc.returncode == want,
              f"analysis {label}: rc {proc.returncode}\n{proc.stdout[-3000:]}"
              f"\n{proc.stderr[-3000:]}")
        runs[label] = dict(rc=proc.returncode, s=s, last=last)
    rec["cli"] = runs


def phase_lint_drift(record: dict) -> tuple[dict, int]:
    """Phase 14 (module docstring). Returns F1's row of the kernels line
    and K4's launches in (b) and (c)."""
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        GPTConfig,
        make_gpt_stages,
    )
    from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (  # noqa: E501
        paged_attention,
    )
    rec: dict = {}
    record["lint_drift"] = rec
    t0 = time.perf_counter()
    f1 = _grid_on_card(rec)
    cfg = GPTConfig(**SERVE_CFG)
    stages = make_gpt_stages(0, cfg, 1, device=MAIN_DEVICE)[0]  # phase 3's
    paged_attention.launches = 0
    _k4_specs_full_width(stages, cfg, rec)
    _kv_drift_on_card(stages, cfg, rec)
    k4 = paged_attention.launches
    print(f"chip_smoke: lint (b)-(c) paged_attention launches {k4}")
    check(k4 > 0, "phase 14 (b)-(c) launched no K4")
    del stages
    _analysis_cli(rec)
    rec["seconds"] = time.perf_counter() - t0
    print(f"chip_smoke: phase 14 took {rec['seconds']:.1f} s")
    return f1, k4


# -- phase 15: the reference's own topology, stages on one card ---------------


def _stage_cli(argv: list[str], tmp: str, name: str) -> dict:
    """One CLI training run (``--dryrun STAGE_CLI_STEPS``) with
    ``--metrics-json``: its console lines and its epoch record."""
    import json as _json
    path = os.path.join(tmp, f"{name}.jsonl")
    lines = _cli(argv + ["--dryrun", str(STAGE_CLI_STEPS),
                         "--metrics-json", path])
    with open(path) as f:
        [rec] = [_json.loads(ln) for ln in f]
    return dict(lines=lines, train_loss=rec["train_loss"],
                eval_loss=rec["eval_loss"], correct=rec["correct"])


def _stages_cli(rec: dict) -> tuple[int, int, int]:
    """(a) ``bench.py::_configs``'s lenet (conv | fc), mlp4 and tiny gpt
    rows through the CLI at ``--stages`` 2, 4 and 2 (the gpt row with
    ``--microbatches 4``), each under GPipe and 1F1B, every stage on the
    one card: the placement line, the train and test losses after
    ``STAGE_CLI_STEPS`` steps equal to the one-stage run's within
    ``STAGE_CLI_RTOL``, LeNet's ``Test set:`` line, and the tiny gpt's
    exact K1-K3 launches (its f32 kernels; kept out of the ``kernels``
    line, whose flash rows are the bf16 ones). Returns those launches."""
    import math
    import tempfile
    out = {}
    counts = [0, 0, 0]
    n_eval = -(-1000 // 32)              # the tiny gpt's eval batches
    with tempfile.TemporaryDirectory() as tmp:
        for row, (argv, S, M) in STAGE_CLI_ROWS.items():
            one = _stage_cli(argv + ["--stages", "1"], tmp, f"{row}-1")
            for sched in ("gpipe", "1f1b"):
                _reset_flash_counts()
                run = _stage_cli(argv + ["--stages", str(S),
                                         "--microbatches", str(M),
                                         "--schedule", sched], tmp,
                                 f"{row}-{S}-{sched}")
                got = _flash_counts()
                want_place = (f"| pipeline: {S} stages on "
                              + ", ".join([_stage_card()] * S))
                check(want_place in run["lines"],
                      f"{row} {sched}: no placement line {want_place!r}")
                gaps = [abs(run[k] - one[k]) / abs(one[k])
                        for k in ("train_loss", "eval_loss")]
                check(all(math.isfinite(v) for v in gaps)
                      and max(gaps) <= STAGE_CLI_RTOL,
                      f"{row} at {S} stages ({sched}): losses "
                      f"{run['train_loss']}/{run['eval_loss']} vs one "
                      f"stage {one['train_loss']}/{one['eval_loss']}")
                if row == "lenet":
                    check(any(TEST_RE.match(ln) for ln in run["lines"]),
                          "lenet at 2 stages printed no Test set: line")
                if row == "gpt":
                    # per step: K2 = K3 = n_layers x M; K1 as many, and
                    # under 1F1B the first stage's layer again (its
                    # backward tick's recompute); eval: n_layers x M per
                    # batch
                    k1 = (2 * M + (M if sched == "1f1b" else 0))
                    want = (k1 * STAGE_CLI_STEPS + 2 * M * n_eval,
                            2 * M * STAGE_CLI_STEPS, 2 * M * STAGE_CLI_STEPS)
                    check(got == want, f"gpt {sched}: K1-K3 launches {got} "
                                       f"!= {want}")
                    counts = [a + b for a, b in zip(counts, got)]
                out[f"{row}-{sched}"] = dict(
                    stages=S, microbatches=M, train_loss=run["train_loss"],
                    eval_loss=run["eval_loss"],
                    one_stage=[one["train_loss"], one["eval_loss"]],
                    max_rel_gap=max(gaps), flash_launches=got)
                print(f"chip_smoke: stages (a) {row} at {S} stages, M {M}, "
                      f"{sched}: train/eval loss {run['train_loss']:.6f}/"
                      f"{run['eval_loss']:.6f}, one stage "
                      f"{one['train_loss']:.6f}/{one['eval_loss']:.6f}, "
                      f"max rel gap {max(gaps):.2e}"
                      + (f", K1-K3 {got}" if row == "gpt" else ""))
    rec["cli"] = out
    return tuple(counts)


def _stage_pipe(S: int, M: int, **kw):
    """The gpt_bf16 row (flash, bf16) at ``S`` stages on the one card, its
    AdamW and the row's weights from seed 0."""
    import torch
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        GPTConfig,
        make_gpt_stages,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        Pipeline,
        make_mesh,
    )
    from simple_distributed_machine_learning_tpu_torch.train import adamw
    row = TRAIN_ROWS["gpt_bf16"]
    cfg = GPTConfig(**row["cfg"], attn_impl="flash")
    stages, wd, od = make_gpt_stages(0, cfg, S, device=MAIN_DEVICE)
    mesh = (make_mesh(S, devices=[_stage_card()] * S) if S > 1 else None)
    pipe = Pipeline(stages, mesh, wd, od, n_microbatches=M,
                    compute_dtype=torch.bfloat16,
                    device=None if mesh else MAIN_DEVICE, **kw)
    return cfg, pipe, adamw(1e-3)


def _stage_card() -> str:
    """The one card every stage runs on (the CPU in a rehearsal)."""
    return "cuda:0" if MAIN_DEVICE == "cuda" else MAIN_DEVICE


def _stage_batch(cfg, batch: int, seed: int):
    import torch
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(0, cfg.vocab, (batch, cfg.seq_len), generator=gen)
    t = torch.randint(0, cfg.vocab, (batch, cfg.seq_len), generator=gen)
    return x.float().to(MAIN_DEVICE), t.to(MAIN_DEVICE)


def _peak_activation_bytes(S: int, M: int, **kw) -> int:
    """One AdamW train step at microbatch ``STAGE_MICRO``: the allocator's
    peak during the step less what was allocated before it (parameters,
    optimizer state and the batch)."""
    import torch

    from simple_distributed_machine_learning_tpu_torch.train import (
        make_train_step,
    )
    cfg, pipe, opt = _stage_pipe(S, M, **kw)
    params = pipe.init_params()
    state = opt.init(params)
    step = make_train_step(pipe, opt)
    x, t = _stage_batch(cfg, STAGE_MICRO * M, 5)
    params, state, _ = step(params, state, x, t, 0)      # warm, allocate
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params, state, loss = step(params, state, x, t, 1)
    torch.cuda.synchronize()
    check(torch.isfinite(loss).item(), f"non-finite loss at S={S} M={M}")
    return torch.cuda.max_memory_allocated() - base


def stage_profile() -> dict:
    """(b)'s device busy share: ``STAGE_PROFILED_STEPS`` gpt_bf16 steps at
    2 stages and M = 4 under each schedule, under ``torch.profiler`` —
    run in a process of its own (after phase 13 (b)'s scheduled session,
    later sessions in the same process lose CUDA records)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from simple_distributed_machine_learning_tpu_torch.train import (
        make_train_step,
    )
    out = {}
    for name, kw in STAGE_SCHEDULES.items():
        cfg, pipe, opt = _stage_pipe(2, 4, **kw)
        params = pipe.init_params()
        state = opt.init(params)
        step = make_train_step(pipe, opt)
        x, t = _stage_batch(cfg, TRAIN_ROWS["gpt_bf16"]["batch"], 1)
        for i in range(2):
            params, state, _ = step(params, state, x, t, i)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(STAGE_PROFILED_STEPS):
                params, state, _ = step(params, state, x, t, i)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy, launches = 0.0, 0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                busy += float(getattr(e, "self_device_time_total", None)
                              or getattr(e, "self_cuda_time_total", 0))
                launches += e.count
        n = STAGE_PROFILED_STEPS
        out[name] = dict(profiled_step_ms=wall_us / 1e3 / n,
                         device_busy_share=busy / wall_us,
                         device_ms_per_step=busy / 1e3 / n,
                         kernel_launches_per_step=launches / n)
        del params, state, pipe
        torch.cuda.empty_cache()
    return out


def _stage_profile_fresh() -> dict:
    proc = subprocess.run(
        [sys.executable, "-c",
         "import json, chip_smoke; "
         "print(json.dumps(chip_smoke.stage_profile()))"],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0,
          f"phase 15 (b)'s profiled window: rc {proc.returncode}\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _stages_full_width(rec: dict, record: dict) -> tuple[int, int, int]:
    """(b) The gpt_bf16 row at 2 stages and M = 4 under GPipe, 1F1B and
    GPipe with remat: loss and gradients against one stage (bf16,
    ``STAGE_BF16_RTOL`` on the loss and on the gradients' norm-relative
    gap); exact K1-K3 launches per step (counts set to 0 just before the
    timed steps, read just after: the main path's count); the host-clock
    step; the peak activation bytes at M = 4 and 16 (microbatch 4):
    GPipe grows more than ``STAGE_GPIPE_GROWTH``x, 1F1B less than
    ``STAGE_ONEFB_GROWTH``x. Returns the K1-K3 launches of the timed
    steps."""
    import torch

    from simple_distributed_machine_learning_tpu_torch.train import (
        make_train_step,
    )
    row = TRAIN_ROWS["gpt_bf16"]
    cfg, one, _ = _stage_pipe(1, 1)
    x, t = _stage_batch(cfg, row["batch"], 1)
    l1, g1 = one.loss_and_grads(one.init_params(), x, t, deterministic=True)
    g1 = torch.cat([g.reshape(-1) for g in g1])
    del one
    counts = [0, 0, 0]
    out: dict = {}
    for name, kw in STAGE_SCHEDULES.items():
        _, pipe, opt = _stage_pipe(2, 4, **kw)
        if name == "gpipe":
            print(f"chip_smoke: stages (b) placement: 2 stages on "
                  + ", ".join(str(d) for d in pipe.devices) + " (one card)")
        params = pipe.init_params()
        ls, gs = pipe.loss_and_grads(params, x, t, deterministic=True)
        gs = torch.cat([g.reshape(-1) for g in gs])
        loss_gap = abs(float(ls) - float(l1)) / abs(float(l1))
        grad_gap = float((gs - g1).norm() / g1.norm())
        check(loss_gap <= STAGE_BF16_RTOL and grad_gap <= STAGE_BF16_RTOL,
              f"{name}: loss gap {loss_gap}, gradient gap {grad_gap} "
              f"against one stage (limit {STAGE_BF16_RTOL})")
        del gs
        state = opt.init(params)
        step = make_train_step(pipe, opt)
        for i in range(2):
            params, state, _ = step(params, state, x, t, i)
        torch.cuda.synchronize()
        _reset_flash_counts()
        t0 = time.perf_counter()
        for i in range(STAGE_TIMED_STEPS):
            params, state, loss = step(params, state, x, t, i)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / STAGE_TIMED_STEPS
        got = _flash_counts()
        per = tuple(c / STAGE_TIMED_STEPS for c in got)
        want = STAGE_LAUNCHES[name]
        check(per == want, f"{name}: K1-K3 launches per step {per} != "
                           f"{want}")
        counts = [a + b for a, b in zip(counts, got)]
        out[name] = dict(loss_gap=loss_gap, grad_gap=grad_gap,
                         step_ms=step_ms, launches_per_step=per,
                         final_loss=float(loss))
        del params, state, pipe
        torch.cuda.empty_cache()
    for name, kw in (("gpipe", {}), ("1f1b", dict(schedule="1f1b")),
                     ("gpipe_remat", dict(remat=True))):
        peaks = [_peak_activation_bytes(2, M, **kw) for M in (4, 16)]
        growth = peaks[1] / peaks[0]
        out[name].update(peak_activation_bytes=peaks, growth=growth)
        torch.cuda.empty_cache()
    check(out["gpipe"]["growth"] > STAGE_GPIPE_GROWTH,
          f"GPipe's activation bytes grew {out['gpipe']['growth']:.3f}x "
          f"from M = 4 to 16 (must exceed {STAGE_GPIPE_GROWTH})")
    check(out["1f1b"]["growth"] < STAGE_ONEFB_GROWTH,
          f"1F1B's activation bytes grew {out['1f1b']['growth']:.3f}x "
          f"from M = 4 to 16 (must stay under {STAGE_ONEFB_GROWTH})")
    prof = _stage_profile_fresh()
    one_ms = record["train"]["gpt_bf16"]["step_ms"]
    one_busy = record.get("train_profile", {}).get("device_busy_share")
    for name, r in out.items():
        r.update({f"profiled_{k}": v for k, v in prof[name].items()})
        print(f"chip_smoke: stages (b) gpt_bf16 S=2 M=4 {name}: step "
              f"{r['step_ms']:.3f} ms (host clock; one stage, phase 5: "
              f"{one_ms:.3f}), K1/K2/K3 per step {r['launches_per_step']}, "
              f"device busy {prof[name]['device_busy_share']:.4f} (one "
              f"stage, phase 6: {one_busy}), "
              f"{prof[name]['kernel_launches_per_step']:.1f} kernels/step, "
              f"loss/grad gap vs one stage {r['loss_gap']:.2e}/"
              f"{r['grad_gap']:.2e}, peak activations M=4/16 "
              f"{r['peak_activation_bytes'][0]}/"
              f"{r['peak_activation_bytes'][1]} B ({r['growth']:.3f}x)")
    rec["full_width"] = out
    return tuple(counts)


def _stages_pp_decode(rec: dict) -> None:
    """(c) ``make_pp_decoder`` at phase 3's GPT width over 2 stages on the
    card: greedy tokens equal to the one-card ``make_cached_decoder``'s;
    a bf16 cache's beside them; host ms per decode."""
    import torch

    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        GPTConfig,
        make_cached_decoder,
        make_gpt_stages,
    )
    from simple_distributed_machine_learning_tpu_torch.models.pp_decode import (  # noqa: E501
        make_pp_decoder,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        Pipeline,
        make_mesh,
    )
    cfg = GPTConfig(**SERVE_CFG)
    stages, wd, od = make_gpt_stages(0, cfg, 2, device=MAIN_DEVICE)
    pipe = Pipeline(stages, make_mesh(2, devices=[_stage_card()] * 2), wd,
                    od)
    params = pipe.init_params()
    gen = torch.Generator().manual_seed(4)
    prompt = torch.randint(0, cfg.vocab, (1, PP_DECODE["t0"]),
                           generator=gen)
    t0, n = PP_DECODE["t0"], PP_DECODE["n_new"]
    decoders = {"pp": make_pp_decoder(pipe, cfg, t0, n),
                "pp_bf16": make_pp_decoder(pipe, cfg, t0, n,
                                           cache_dtype=torch.bfloat16),
                "cached": make_cached_decoder(stages, cfg, t0, n,
                                              device=MAIN_DEVICE)}
    toks, ms = {}, {}
    for name, dec in decoders.items():
        dec(params, prompt)                       # warm
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        for _ in range(PP_DECODE["reps"]):
            out = dec(params, prompt)
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t_start) * 1e3 / PP_DECODE["reps"]
        toks[name] = out.cpu()
    check(torch.equal(toks["pp"], toks["cached"]),
          f"pp_decode's tokens differ from the cached decoder's: "
          f"{toks['pp'].tolist()} vs {toks['cached'].tolist()}")
    same = int((toks["pp_bf16"] == toks["pp"]).sum()) - t0
    rec["pp_decode"] = dict(ms=ms, tokens=toks["pp"].tolist(),
                            bf16_tokens=toks["pp_bf16"].tolist(),
                            bf16_equal_new_tokens=same)
    print(f"chip_smoke: stages (c) pp_decode 2 stages, prompt {t0} + {n} "
          f"greedy: tokens equal to the cached decoder's; "
          f"{ms['pp']:.3f} ms per decode (cached, one stage: "
          f"{ms['cached']:.3f}); a bf16 cache {ms['pp_bf16']:.3f} ms, "
          f"{same}/{n} new tokens equal to f32's")


def _stages_drill(rec: dict) -> None:
    """(d) The JAX CLI test's elastic drill at 2 stages on the card:
    a host-kill at step 6, restored from the store and repacked onto 1
    stage; JAX's two pinned lines, exit 0; the restart cost as the
    drill's host time less a clean run's of the same steps."""
    import tempfile
    base = ["--model", "mlp", "--mlp-dims", "784,32,10", "--stages", "2",
            "--epochs", "3", "--max-steps-per-epoch", "4"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _cli(base + ["--checkpoint-dir", os.path.join(tmp, "clean")])
        clean_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        lines = _cli(base + ["--checkpoint-dir", os.path.join(tmp, "store"),
                             "--chaos", ELASTIC_KILL, "--chaos-stages",
                             "2,1"])
        drill_s = time.perf_counter() - t0
    for pin in STAGE_DRILL_PINS:
        check(any(pin in ln for ln in lines),
              f"the stage-ladder drill did not print {pin!r}: {lines}")
    rec["drill"] = dict(clean_s=clean_s, drill_s=drill_s,
                        restart_cost_ms=(drill_s - clean_s) * 1e3)
    print(f"chip_smoke: stages (d) --chaos {ELASTIC_KILL} --chaos-stages "
          f"2,1: both JAX lines, rc 0; restart cost "
          f"{(drill_s - clean_s) * 1e3:.1f} ms (drill {drill_s:.3f} s, "
          f"clean run {clean_s:.3f} s, host clock)")


def phase_stages(record: dict) -> tuple[int, int, int]:
    """Phase 15: the pipeline over several stages, every stage on the one
    card. Returns (b)'s K1-K3 launches (the main path's, bf16)."""
    rec: dict = {}
    record["stages"] = rec
    secs = {}
    t0 = time.perf_counter()
    rec["cli_flash_launches"] = _stages_cli(rec)
    secs["a"] = time.perf_counter() - t0
    launches = _stages_full_width(rec, record)
    secs["b"] = time.perf_counter() - t0 - sum(secs.values())
    _stages_pp_decode(rec)
    secs["c"] = time.perf_counter() - t0 - sum(secs.values())
    _stages_drill(rec)
    secs["d"] = time.perf_counter() - t0 - sum(secs.values())
    rec["seconds"] = dict(secs, total=time.perf_counter() - t0)
    print(f"chip_smoke: phase 15 took {rec['seconds']['total']:.1f} s ("
          + ", ".join(f"({k}) {v:.1f}" for k, v in secs.items()) + ")")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available — this smoke runs on the "
              "GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        __import__(PORT)
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        GPTConfig,
        make_gpt_stages,
    )
    record: dict = {}
    t_start = time.perf_counter()
    try:
        phase_build(record)
        variants = phase_kernels(record)
        flash_variants = phase_flash_kernels(record)
        cfg = GPTConfig(**SERVE_CFG)
        stages = make_gpt_stages(0, cfg, 1)[0]
        serve, plain_handles = phase_serve(stages, cfg, record)
        spec = phase_spec_serve(stages, cfg, serve, plain_handles, record)
        phase_profile(stages, cfg, record)
        fault_launches = phase_serve_faults(stages, cfg, serve,
                                            plain_handles, record)
        fleet_launches = phase_fleet(stages, cfg, serve, plain_handles,
                                     record)
        tier_launches = phase_host_tier_adapters(stages, cfg, serve, record)
        protocol_launches = phase_protocol_beam_dense(
            stages, cfg, serve, plain_handles, spec, record)
        del stages
        train = phase_train("gpt_bf16", TRAIN_ROWS["gpt_bf16"], record)
        phase_train("gpt", TRAIN_ROWS["gpt"], record)
        phase_train_profile(TRAIN_ROWS["gpt_bf16"], record)
        phase_main_path(record)
        resilience_launches = phase_resilience(record)
        telemetry_launches = phase_telemetry_native(record)
        f1_row, lint_launches = phase_lint_drift(record)
        stage_launches = phase_stages(record)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    main_v = next(v for v in variants
                  if v["dtype"] == "float32" and v["K"] == 1)
    kernels = {"kernels": [{
        "name": "paged_attention",
        "route": "cuda",
        "source": f"{PORT}/ops/csrc/paged_attention.cu",
        "replaces": "simple_distributed_machine_learning_tpu/ops/"
                    "paged_attention.py:67",
        # phase 3's decode ticks, phase 3b's speculative verify steps,
        # phase 8's scenarios and drills, phase 9's fleet runs, phase 11's
        # host-tier and adapter runs, phase 12's protocol drills and phase
        # 14's recorded ticks and drift traces
        "launches": (serve["launches"] + spec["launches"] + fault_launches
                     + fleet_launches + tier_launches + protocol_launches
                     + lint_launches),
        "max_abs_err": max(v["max_abs_err"] for v in variants),
        "ms": main_v["ms"],
        "plain_ms": main_v["plain_ms"],
        "bound_ms": main_v["bound_ms"],
        "bound_by": main_v["bound_by"],
        "library_ms": None,
    }]}
    # the flash kernels' times at the gpt_bf16 row's shape; launches from
    # that row's flash training run, phase 10 (b)'s runs of that row,
    # phase 13 (b)'s bf16 CLI run and phase 15 (b)'s runs of that row at 2
    # stages
    for i, (name, line) in enumerate((("flash_forward", 127),
                                      ("flash_dq", 300),
                                      ("flash_dkv", 338))):
        timed = next(v for v in flash_variants if v["name"] == name
                     and v["dtype"] == "bfloat16"
                     and tuple(v["shape"]) == FLASH_SHAPE)
        kernels["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": f"{PORT}/ops/csrc/flash_attention.cu",
            "replaces": "simple_distributed_machine_learning_tpu/ops/"
                        f"flash_attention.py:{line}",
            "launches": (train["launches"][i] + resilience_launches[i]
                         + telemetry_launches[i] + stage_launches[i]),
            "max_abs_err": max(v["max_abs_err"] for v in flash_variants
                               if v["name"] == name),
            "ms": timed["ms"],
            "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"],
            "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"],
        })
    kernels["kernels"].append(f1_row)
    record["kernels"] = kernels["kernels"]
    record["seconds"] = round(time.perf_counter() - t_start, 3)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(f"chip_smoke: card {card_line()}")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
