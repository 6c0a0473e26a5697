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
   with ptxas's registers and spills per kernel (a spill in K4, either
   design, in K1 or the f32 K2 or K3 at a head dim up to 64, or in the
   bf16 wide K1, K2 or K3 fails), and the count of tensor-core instructions (``HMMA``, and
   ``HGMMA`` for wgmma) in each kernel's SASS (``cuobjdump``): all 12 bf16
   and all 12 f32 (split-TF32) K1-K3 instantiations and the 8 wide ones
   (head dims past 128, both dtypes; K1 one up to dh 256 and one past it)
   must have some, the bf16 wide K1, K2 and K3 ``HGMMA`` (wgmma), the f32
   wide ones ``HMMA.1688.F32.TF32``, K4 and F1 none;
2. every kernel against its plain PyTorch version on the card, at the
   serving shapes (H = 8, dh = 64, block 16, 8 slots, positions up to
   255), for every cache dtype and K = 1 and 4, within rtol = atol =
   1e-5 (both read the same stored bytes); a narrow pool's answer also
   within ``tests/tolerances.py::attn_tol`` of the unquantised f32
   pool's; then K4's edge cases (``K4_EDGES``: head dims 40 and 128, and
   past 128 (the wide kernel: P blocks a slot, slabs through shared
   memory) 160, 196, 256, 320 and 512, f32, bf16 and int8,
   phase 8's head dims 16 (blocks of 8) and 32, blocks of 8 and 32, a
   table longer than the warp count, K = 4 and 8, a
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
   cases (f32, 4 slots, K = 4 and K = 16), the decode tick's at head
   dims 256 and 512 (``K4_HEAD_DIMS``, f32 and int8, beside their times
   in K4's first design past 128, ``WIDE_K4_FIRST_MS``) and at a long
   context (``K4_LONG``: 1 and 8 slots x 16 heads x dh 256 at position
   2047 in f32, 8 in bf16, 8 x 8 heads x dh 512 in int8; each pool built
   on the card, held against the plain version, beside the first
   design's times ``K4_LONG_FIRST_MS``);
   then the flash kernels K1 (forward), K2 (dq) and K3 (dk/dv) against
   their plain versions, f32 and bf16, at the training shape (16, 8, 256,
   64), at a ragged T = 200 and at the tiny row's (32, 4, 64, 32), and in
   both dtypes at the edges of the tensor-core kernels (head dims 8, 32,
   40 and 128, and the wide kernels' 160, 192, 196 (not a multiple of 8),
   256, 320 and 512, T = 1, 65, 129 and 200, and ``FLASH_UNALIGNED``'s
   inputs whose storage starts one element in: the wide kernels' plain
   copies where TMA cannot go), within ``FLASH_TOL``; then at
   ``FLASH_WIDE_SHAPES`` (phase 23's attention, 2 x 16 heads x 2048 x
   256, and 8 heads of 512), in both dtypes, timed (runs of 10, median of
   3) beside their bounds, SDPA's forward and backward and the times of
   their first designs (``WIDE_K1_FIRST_MS``, ``WIDE_K2_K3_FIRST_MS``).
   The training shape's rows are timed
   the same way beside their bounds (the f32 rows also beside the bound at
   the CUDA cores' 67 TFLOP/s) and the library yardstick
   (``scaled_dot_product_attention``, forward and backward; K1 against
   SDPA's forward and K2 + K3 against SDPA's backward, each on one line,
   and the f32 K2 + K3 at the tiny row against SDPA's f32 backward);
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
   Trainer's key set (``JAX_EPOCH_KEYS``) plus ``device_memory`` and the
   step probe's ``ICI_KEYS`` (0 bytes: one stage has no collective), every
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
   F1 timed as phase 2 times K4 beside its plain version, its byte bound,
   ``torch.mul(x, 2)`` and the launch floor (a one-element ``torch.mul``
   in the same harness, the least of three medians), its profiler
   cross-check in a process of its own (all 40 launches seen); (b) ``programs.kernel_report`` on phase 3's
   deployment, f32 and int8, with ``spec_k`` 4 (draft == target): one
   decode and one verify tick's recorded K4 launches lint clean under
   the registry's contracts, and their derived ``kernel.kv_stream`` bytes
   equal the byte model's ``decode.kv_gather`` (33,554,432 at f32) and
   ``verify.kv_gather``; (c) phase 3's trace through a metered engine —
   ``serve_kv_drift_bytes`` 0 on every tick and ``kv_bytes_predicted``
   equal to the pool's ``kv_bytes_resident`` — and again with a
   ``PREFIX_LEN``-token shared prefix, the drift <= 0 on every tick and
   below 0 on some; (d) ``python -m ...analysis --serve-kernel`` exiting
   0, and 1 under ``SDML_LINT_INJECT`` (``--fixtures``, which now holds
   the program linter's fixtures too, runs in phase 20 (d));
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
16. the reference's launch line: the port's CLI as real processes on the
   one card (``PROC_*`` below): LeNet over two processes, the gpt_bf16 row
   one stage per process (each process, and the one-process reference,
   also registers its step with a telemetry session's probe: phase 20
   (e)), the mlp data x pipeline mesh over four, and a killed and a
   stopped peer;
17. tensor parallelism, the model axis on the one card: (a) the gpt_bf16
   row with dense attention (a tensor-parallel block shards attention by
   head and runs the dense core on its heads, as the JAX package does) at
   ``n_tensor_parallel`` 1, 2 and 4, ``TP_STEPS`` AdamW steps each from
   the same weights and batch: losses within ``TP_BF16_RTOL`` of tp = 1's,
   no flash launch, and per tp the host-clock step p50, the peak memory,
   and (a profiled window in a process of its own) kernel launches per
   step and the device's busy share; the f32 ``gpt`` row at tp = 2 within
   ``TP_F32_RTOL`` of tp = 1; (b) the CLI at ``--tp 2``: ``--model mlp``
   at 2 stages, ``--model gpt`` at 2 stages under 1F1B with ``--clip-norm
   1.0``, and ``--model gpt --stages 1`` over two processes (the model
   axis split between them, its sums over gloo), each run's train and eval
   losses within ``STAGE_CLI_RTOL`` of its tp = 1 run's and the placement
   line; (c) ``python -m ...analysis --hostlint`` exiting 0 on the tree,
   and the torch-free ``analysis/hostlint.py`` exiting 0 in a subprocess
   with torch and jax blocked.
18. sequence and expert parallelism on the one card: (a) the gpt_bf16 row
   (dense attention) at ``n_seq`` 2 and 4 with ring attention and with
   Ulysses, ``SPEP_STEPS`` AdamW steps from the weights and batch of the
   dense ``n_seq`` = 1 run: losses within ``SPEP_BF16_RTOL`` of its, no
   flash launch; (b) the row as a mixture of experts (``EP_MOE``: 8
   experts, top 2, capacity factor 2.0, ``attn_impl="flash"``) at
   ``n_expert_parallel`` 1, 2 and 4: losses and aux within
   ``SPEP_BF16_RTOL`` of ep 1's, K1, K2 and K3 each exactly ``n_layers``
   launches per step (counted into the ``kernels`` line); for every run
   the host-clock step p50, the peak memory and (a profiled window in a
   process of its own) launches per step and the device's busy share;
   (c) the CLI: ``--model gpt --sp 2`` with ``--attn ring`` and
   ``ulysses`` at 2 stages under GPipe and 1F1B, ``--experts 4 --ep 2
   --attn flash`` at 2 stages, and ``--sp 2`` and ``--experts 4 --ep 2``
   at 1 stage over two processes (the axis split between them), each
   run's train and eval losses within ``STAGE_CLI_RTOL`` of its ``--sp
   1`` / ``--ep 1`` twin.
19. the overlapped collectives and tensor-parallel serving on the one
   card: (a) the gpt_bf16 row (dense attention) at tp 2 and 4 with
   ``overlap="ring"`` (the ring-closed attention and the scattered MLP
   pair of ``parallel/overlap.py``), ``TP_STEPS`` AdamW steps from phase
   17's weights and batch: losses within ``TP_BF16_RTOL`` of phase 17's
   ``"none"`` run at that width, no flash launch, step p50, peak memory,
   and (a profiled window in a process of its own) launches per step and
   the device's busy share; phase 18 (b)'s MoE row at ep 2 with the ring
   dispatch within ``SPEP_BF16_RTOL`` of its all-to-all run, K1-K3
   ``n_layers`` a step (counted into the ``kernels`` line); (b) phase 3's
   trace through ``InferenceEngine(attn_kernel="fused", mesh=...)`` at
   ``TP_SERVE_RUNS`` (tp 2 and 4 with ``"none"``, tp 2 with ``"ring"``):
   24/24, K4 launched exactly ``tp x n_layers`` times per decode call (one
   launch per shard pool and layer, counted into the ``kernels`` line),
   the per-shard resident K/V bytes equal to the byte model on every tick,
   every greedy stream equal to phase 3's, TTFT/TPOT, tokens/s and the
   tick p50 beside phase 3's; the int8 pool at tp 2 against an int8 tp 1
   engine's streams; a tp 2 speculative target (the CLI's draft, spec_k
   4: a single-device propose, then the verify over the shards) equal to
   phase 3's streams; (c) K4 on one shard's 4 and 2 heads (f32 and int8,
   K = 1) against its plain version, timed as phase 2 times it beside its
   bound; (d) the CLI at ``--serve-sim 8 --serve-tp 2`` (the placement
   line, 8/8, ``| serve: tp 2``) and ``--model gpt --tp 2 --overlap
   ring`` (within ``STAGE_CLI_RTOL`` of phase 17 (b)'s tp 1 run).
20. the program linter on the card (``analysis/``: programs traced on fake
   tensors, nothing launched): (a) the gpt_bf16 row's train step traced
   and linted at full width — clean, its host ms, K1-K3 as one graph node
   each per layer, the launch counts unchanged across the trace and the
   allocator's peak across it at its start (nothing allocated) — then the CLI's ``--lint-only`` on ``--model
   gpt --attn flash --bf16`` and ``--model lenet`` (``| --lint: preflight
   clean``, no step) and a ``--lint --dryrun LINT_TRAIN_STEPS`` run that
   trains with K1-K3 launched; (b) phase 3's trace through
   ``InferenceEngine(lint=True, attn_kernel="fused")`` at tp 1 and on a tp
   2 mesh: the lint clean with its host ms and no K4 launch, the K4 nodes'
   derived K/V bytes ``tp`` x the byte model's row, 24/24, every greedy
   stream equal to phase 3's, K4 exactly ``tp x n_layers`` per decode
   call; (c) the CLI's ``--serve-sim 8 --lint`` (the protocol line, 8/8)
   and ``SDML_LINT_INJECT=drill`` making the serving and the training
   ``--lint-only`` exit 2; (d) ``python -m ...analysis --dryrun 8 --serve
   --fixtures`` and ``--dryrun 4`` exiting 0, every fixture meeting its
   contract; (e) phase 16 (b)'s processes' ``ici_bytes_per_step`` equal
   to the wire's bytes per step (``WIRE``) plus the loss's 16 B sum over
   the world, the one-process run's 8 in-card hops; (f) the claims on
   the model and expert axes at full width: the gpt_bf16 row's step at
   tp 2 (dense attention, phase 17's) and phase 18's MoE row at ep 2
   traced and linted — each clean, no launch, ``memory_allocated()``
   unchanged, its graph nodes and host seconds printed — and again with
   a defect seeded by a patch inside the phase (the model sum cut to one
   shard's part; the replicated leaves left untied over the expert axis),
   each flagged ``unreduced-gradient.missing-reduce`` on its axis; then
   the CLI's ``--lint`` at ``--tp 2`` and at ``--experts 8 --ep 2 --attn
   flash``, each training ``LINT_TRAIN_STEPS`` steps after a clean gate
   (the MoE run's K1-K3 counted into the ``kernels`` line), their losses
   printed.
21. serving across processes on the one card: (a) two fresh processes
   (``--serve-worker``) serve phase 3's trace through the fused
   tensor-parallel engine at tp 2 over one model mesh split between them
   (one coordinate each, the sums over gloo through the host, every
   clock read rank 0's, broadcast): 24/24 on each, every greedy stream
   equal on both ranks and to phases 3 and 19 (b)'s, K4 exactly
   ``tp / W x n_layers`` (4) per decode call in each process (counted
   into the ``kernels`` line), ``2 x n_layers`` sums of one ``[n_slots,
   1, d_model]`` f32 block per decode call on each rank's wire (``WIRE``),
   the per-shard K/V bytes equal to the byte model on every tick, and the
   tick p50 beside phase 19 (b)'s one-process tp 2; (b) the CLI over two
   processes: ``--serve-sim 8`` at tp 1 and at ``--serve-tp 2`` (both
   ranks exit 0 with equal request and token counts) and ``--scenario
   steady`` (both ranks print the one-process run's lines, made in this
   call).
22. the full-prefix decoder (``models/gpt.py::make_decoder``): (a) K1 at
   its decode shapes (``DECODE_SHAPES``: B = 1 and 2 sequences of the
   serving model's 8 heads x 256 x 64, f32) against its plain version
   within phase 2's f32 tolerance, timed as phase 2 times it beside its
   plain version, its bound and SDPA's forward, and at one sequence of T =
   64 and 128 for the time a k tile adds (run right after phase 2, alone
   on the card); (b) ``make_decoder`` greedy at ``SERVE_CFG`` with
   ``attn_impl="flash"``, f32, B = 2, a 16-token prompt and 32 new tokens
   (``FULL_DECODE``): exactly ``n_layers x n_new`` (128) K1 launches and
   no K2/K3, every decoded position's log-probs within ``DECODE_LOGP_TOL``
   of the dense-attention forward's on the same buffer (one
   teacher-forced pass) and each token the dense argmax or within that
   tolerance of it; ``make_cached_decoder``'s greedy tokens on the same
   weights are reported beside them (first divergence and the top-2 gap
   there), not asserted; (c) the same for the mixture-of-experts build
   (``EP_MOE``), whose teacher-forced rows are taken step by step (the
   router's rank-major capacity lets a later token's first choice take an
   earlier token's second-choice slot, so each step's buffer is
   rebuilt), and ``make_cached_decoder`` on it must raise naming
   ``make_decoder``; (d) ``decoder_from_pipeline`` on a one-stage
   ``gpt_bf16`` pipeline: ``PIPE_DECODE`` AdamW steps change its tokens,
   which equal ``make_cached_decoder``'s on the live params. The host ms
   per decoded token of (b) and (c) is printed; the K1-K3 launches of
   (b)-(d) go into the ``kernels`` line.
23. a GPT at GPT-J-6B's widths (``GPTJ_CFG``: d 4096, 16 heads of 256,
   seq 2048, vocab 256, 2 of its 28 layers, 413 M parameters; random
   weights from seed 0), through the port's entry points on the card: (a)
   one-stage ``Pipeline`` training in f32 and in bf16, batch 2: the first
   step's loss and gradients against an ``attn_impl="dense"`` twin's on
   the same weights and batch (``GPTJ_TOL``), then 3 AdamW steps
   (``make_train_step``) with finite losses, K1-K3 (the wide kernels, at
   [2, 16, 2048, 256]) exactly ``n_layers`` times a step; (b)
   ``make_decoder`` greedy in f32, 8 tokens from a 64-token prompt, K1
   once per layer per token, the tokens equal to the dense decoder's; (c)
   ``InferenceEngine(attn_kernel="fused")`` serving 4 greedy requests
   (prompts 16-64, 8 new tokens) through K4 at head dim 256 (the wide
   kernel, the ``kernels`` line's ``paged_attention_wide``), K4 launched
   ``n_layers`` times per decode call, every stream equal to solo decode
   (``make_cached_decoder``). Its launches go into the ``kernels`` line.

The phases run in two lanes. The first, this process, runs phases 1-4
alone: the kernels' times and phase 4's breakdown are taken with nothing
else on the card. It then starts the second lane, ``chip_smoke.py --lane``
(a process of its own, stopped with its children if this one fails or
it runs past ``LANE_DEADLINE_S``), which runs phases 16-18, phase 19's
(a) and (d) (they read phases 17 and 18's records) and phase 23, while this process
runs phases 8, 9, 11, 12, 5, 6, 7, 10, 13, 14, 15, 19 (b)-(c), 20
(a)-(d), 21 and 22 (b)-(d). It then waits for the second lane, prints its output,
adds its records and launch counts to its own, and runs phase 20 (e)
(it reads phase 16's record). So every host-clock and device time after
phase 4 was taken beside the other lane's work on the same card and
CPUs; the kernel line's times come from phase 2. Within a lane, phase
20 (d)'s two analysis runs start before phase 14 and run beside phases
14-20 (c); phase 18 (c)'s two two-process launches run together, beside
its one-process runs; phase 21 (b)'s three two-process launches run
together, beside its one-process ``--scenario steady``. The script
prints the seconds each phase took before the kernels line.

To make room for phase 19, PR 18 cut earlier phases' depth: phase 15
(b) times 5 steps and profiles 3 (was 10 and 5), phase 16 runs 10 steps
(was 20), phase 17 runs and its CLI runs 6 steps (was 10) and profiles 3
(was 5), phase 18's CLI runs 6 steps (was 10) and it profiles 2 (was 3).

Before the last line it prints the kernels as one JSON object (times in
ms, measured in this run; ``bound_ms`` computed from this run's inputs);
the last line is ``{"ok": true, "device": {...}}``. Details also go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import gc
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
# tensor cores (K4's and F1's products), dense TF32 tensor-core FLOP/s (the
# f32 K1-K3: three TF32 products per f32 one, split TF32) and dense bf16
# tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
# flash kernel shapes [B, H, T, dh]: the gpt_bf16 row (batch 16, 8 heads,
# seq 256, d 512), the same at a ragged T, and the tiny gpt row's f32
# shape (batch 32 as one fused microbatch, 4 heads, seq 64, d 128)
FLASH_SHAPE = (16, 8, 256, 64)
FLASH_RAGGED = (16, 8, 200, 64)
FLASH_TINY_SHAPE = (32, 4, 64, 32)
# edge shapes of the tensor-core K1-K3 (bf16 and f32), held in both
# dtypes at a small B*H: head dims padded to 32 and 128 and one not a
# multiple of 16 (40), each at T = 1 (one row), 65 (one row past a tile) and
# 200 (a ragged tail); dh 64 at T = 1, 65; and dh 8 (padded to 16, the
# smallest instantiation) at T = 65, 200
FLASH_EDGES = ([(2, 4, t, dh) for dh in (32, 40, 128) for t in (1, 65, 200)]
               + [(2, 4, t, 64) for t in (1, 65)]
               + [(2, 4, t, 8) for t in (65, 200)]
               # past dh 128, the wide kernels (resident rows up to dh 256,
               # chunks of 256 columns past it; K1 128 q rows a block, so
               # T = 65, 129 and 200 end in its second half or a second
               # block); dh 196 is not a multiple of 8, which TMA cannot
               # take
               + [(2, 4, t, dh) for dh in (160, 192, 196, 256, 320, 512)
                  for t in (1, 65, 129, 200)])
# wide shapes held with inputs whose storage starts one element in
# (contiguous, not 16-byte aligned: the wide kernels' plain copies)
FLASH_UNALIGNED = ((2, 4, 200, 160), (2, 4, 129, 256), (2, 4, 65, 512))
# the wide kernels timed, both dtypes: phase 23's GPT-J-width attention
# (batch 2, 16 heads x 2048 x 256) and the same width at head dim 512 (8
# heads)
FLASH_WIDE_SHAPES = ((2, 16, 2048, 256), (2, 8, 2048, 512))
# K1 and K2 + K3 device ms at those shapes in their first design (the
# contraction in 256-byte slices, the scores recomputed per output chunk;
# this script's phase 2 on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md),
# printed beside this run's
WIDE_K1_FIRST_MS = {("bfloat16", (2, 16, 2048, 256)): 0.8621,
                    ("bfloat16", (2, 8, 2048, 512)): 1.6736,
                    ("float32", (2, 16, 2048, 256)): 3.2819,
                    ("float32", (2, 8, 2048, 512)): 5.5883}
WIDE_K2_K3_FIRST_MS = {("bfloat16", (2, 16, 2048, 256)): 1.5070 + 3.8230,
                      ("bfloat16", (2, 8, 2048, 512)): 3.4837 + 6.5997,
                      ("float32", (2, 16, 2048, 256)): 6.1297 + 11.3614,
                      ("float32", (2, 8, 2048, 512)): 11.1779 + 20.5372}
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
            # past 128: the wide kernel (P blocks a slot, slabs through
            # shared memory), at 160 and 196 (rows of 392 f32 bytes: too
            # narrow for 16-byte copies in bf16) too
            ("float32", 1, dict(dh=160)), ("bfloat16", 4, dict(dh=196)),
            ("int8", 9, dict(dh=160)), ("float32", 1, dict(dh=196, bs=8)),
            ("float32", 1, dict(dh=256)), ("bfloat16", 1, dict(dh=256)),
            ("int8", 1, dict(dh=40)),
            ("float32", 1, dict(bs=8)),     # 32 blocks: past the warp count
            ("float32", 1, dict(bs=32)), ("float32", 4, dict(bs=8)),
            ("float32", 8, {}), ("int8", 8, dict(dh=128)),
            ("float8_e4m3fn", 4, dict(dh=40, bs=32)),
            ("float32", 1, dict(layout="block-major")),
            ("bfloat16", 4, dict(layout="misaligned")),
            ("float32", 1, dict(dh=320)), ("int8", 1, dict(dh=320)),
            ("float32", 4, dict(dh=512)), ("int8", 8, dict(dh=512))]
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
# K4 timed at phase 23's head dim and past it (f32 and int8, 8 slots)
K4_HEAD_DIMS = (("float32", 256), ("float32", 512), ("int8", 512))
# their device ms in K4's first design past dh 128 (dh 256 on the
# register-resident kernel with two f32 loads a lane, dh 512 in output
# chunks of 256 columns; this script's phase 2 on an NVIDIA H100 80GB HBM3
# at 700 W, PERF.md), printed beside this run's
WIDE_K4_FIRST_MS = {("float32", 256): 0.0240, ("float32", 512): 0.0356,
                    ("int8", 512): 0.0297}
# K4 at a long context: (storage dtype, slots, heads, dh), every slot at
# position 2047 (GPT-J-6B's 2048 positions), blocks of 16, K = 1; one
# layer's pool built on the card from a seeded CUDA generator
K4_LONG = (("float32", 1, 16, 256), ("float32", 8, 16, 256),
           ("bfloat16", 8, 16, 256), ("int8", 8, 8, 512))
K4_LONG_POS = 2047
# their device ms on that first design, this script's cases timed on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md), printed beside this run's
K4_LONG_FIRST_MS = {("float32", 1, 16, 256): 0.1491,
                    ("float32", 8, 16, 256): 0.2030,
                    ("bfloat16", 8, 16, 256): 0.1513,
                    ("int8", 8, 8, 512): 0.2044}
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
# Trainer's epoch-record keys on a one-stage mesh without its ICI probe
# (which does not run on this tree), the probe's two keys beside them
TELEMETRY_EPOCHS, TELEMETRY_EVERY, NATIVE_STEPS = 2, (1, 4), 20
JAX_EPOCH_KEYS = frozenset((
    "accuracy", "bubble_fraction", "compile_time_s", "correct", "epoch",
    "eval_loss", "examples_per_sec", "kind", "live_array_bytes", "n_eval",
    "n_microbatches", "n_stages", "samples_per_sec", "schedule", "schema",
    "step", "step_time_ms_max", "step_time_ms_p50", "step_time_ms_p95",
    "steps", "time", "tokens_per_sec", "train_loss"))
ICI_KEYS = frozenset(("ici_bytes_per_step", "ici_top_collectives"))
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
STAGE_TIMED_STEPS, STAGE_PROFILED_STEPS = 5, 3
PP_DECODE = dict(t0=32, n_new=24, reps=3)
STAGE_DRILL_PINS = (
    "restored ckpt-00000004.npz (step 4, written at 2 stages, repacked "
    "onto 1); resuming at epoch 2",
    "chaos: completed after 1 restart(s); attempts: 2st/fault(HostLost) "
    "-> 1st/completed")


# phase 16: the CLI as real processes on the one card — (a) LeNet on the
# reference's launch line and (c) the mlp data x pipeline mesh, each cut to
# PROC_STEPS steps per epoch; (b) the gpt_bf16 row at 2 stages, M = 4, one
# stage per process, its losses held equal to the one-process run's (the
# same kernels on the same inputs, the dropout state on the wire; only the
# hops' host round trip differs), PROC_GENERATE tokens decoded from a
# PROC_DECODE_T0-token prompt, PROC_PINGS round trips of one microbatch's
# activation; (d) a killed and a stopped peer under --peer-timeout
# PROC_PEER_TIMEOUT, rank 0 out within PROC_PEER_LIMIT_S; every launch
# within PROC_TIMEOUT_S
PROC_STEPS = 10
# phase 20: the program linter on the card — (a) the gpt_bf16 row's step
# traced and linted at full width, the CLI's --lint-only on the flash bf16
# GPT and LeNet, and a --lint run of LINT_TRAIN_STEPS steps; (b) phase 3's
# trace through InferenceEngine(lint=True) at tp 1 and 2; (c) the CLI's
# serve gate and its SDML_LINT_INJECT drills; (d) the analysis CLI's
# --dryrun 8 --serve --fixtures and --dryrun 4; (e) phase 16 (b)'s gauge;
# (f) the model and expert claims at tp 2 and ep 2, then their --lint CLIs
LINT_TRAIN_STEPS = 3
PROC_GENERATE, PROC_DECODE_T0, PROC_PINGS = 8, 16, 20
PROC_PEER_TIMEOUT, PROC_PEER_LIMIT_S, PROC_TIMEOUT_S = 8, 60, 240


# phase 17: tensor parallelism on the one card — (a) the gpt_bf16 row
# (attention dense: tensor parallelism shards it by head) at each TP_WIDTHS
# width, TP_STEPS AdamW steps from the same weights, losses held to tp =
# 1's within TP_BF16_RTOL (bf16 partial products are rounded before the
# model sum, one matmul rounds once); TP_PROFILED_STEPS profiled in a
# process of its own; the f32 gpt row at tp = 2 within TP_F32_RTOL; (b) the
# CLI at --tp 2, STAGE_CLI_STEPS steps in one process and TP_CLI_STEPS over
# two, held to tp = 1 within STAGE_CLI_RTOL; TP_MLP_DIMS is mlp4's widths
# as two column -> row pairs
TP_WIDTHS, TP_STEPS, TP_PROFILED_STEPS = (1, 2, 4), 6, 3
TP_BF16_RTOL, TP_F32_RTOL = 1e-2, 1e-5
TP_CLI_STEPS = 6
TP_MLP_DIMS = [784, 512, 512, 512, 10]
# phase 18: sequence and expert parallelism on the one card — (a) the
# gpt_bf16 row at each SP_RUNS (attention, n_seq), (b) as a mixture of
# experts (EP_MOE) at each EP_WIDTHS width, SPEP_STEPS AdamW steps each
# from the same weights, losses held to the n_seq = 1 / ep = 1 run's
# within SPEP_BF16_RTOL (bf16: a chunk's or a coordinate's products round
# in another order, and a near tie in the router can flip a token's
# expert); SPEP_PROFILED_STEPS profiled in a process of its own; (c) the
# CLI, SPEP_CLI_STEPS steps in one process and over two
SP_RUNS = (("dense", 1), ("ring", 2), ("ring", 4), ("ulysses", 2),
           ("ulysses", 4))
EP_WIDTHS = (1, 2, 4)
EP_MOE = dict(n_experts=8, moe_top_k=2, moe_capacity_factor=2.0,
              attn_impl="flash")
SPEP_STEPS, SPEP_PROFILED_STEPS = 6, 2
SPEP_BF16_RTOL = 1e-2
SPEP_CLI_STEPS = 6
# phase 19: the overlapped collectives and tensor-parallel serving on the
# one card — (a) the gpt_bf16 row at each OVERLAP_WIDTHS width with
# overlap="ring", TP_STEPS AdamW steps from phase 17's weights and batch,
# losses held to phase 17's "none" run at that width within TP_BF16_RTOL
# (the ring adds the model sum's chunks in another order); phase 18 (b)'s
# MoE row at ep 2 with the ring dispatch against its all-to-all run within
# SPEP_BF16_RTOL; (b) phase 3's trace on the tensor-parallel engine at each
# TP_SERVE_RUNS (tp, overlap), the int8 pool at tp 2 against tp 1's, and a
# tp 2 speculative target; (c) K4 at one shard's TP_SERVE_HEADS heads
OVERLAP_WIDTHS = (2, 4)
TP_SERVE_RUNS = ((2, "none"), (4, "none"), (2, "ring"))
TP_SERVE_HEADS = (4, 2)
# phase 21: serving across processes on the one card — (a) phase 3's trace
# through the tensor-parallel engine at SERVE_RANKS_TP over
# SERVE_RANKS_WORLD processes (one model coordinate each, the sums over
# gloo through the host, every clock read rank 0's); (b) the CLI's
# --serve-sim SERVE_RANKS_CLI_N at tp 1 and tp 2 and --scenario steady over
# two processes
SERVE_RANKS_WORLD, SERVE_RANKS_TP, SERVE_RANKS_CLI_N = 2, 2, 8
# phase 22: the full-prefix decoder — (a) K1 at the decode shapes, f32;
# (b), (c) make_decoder greedy at SERVE_CFG (flash, then EP_MOE), B = 2,
# held to the dense-attention forward's log-probs within DECODE_LOGP_TOL:
# K1 matches its plain version within 1e-5 (FLASH_TOL), and four layers,
# the final LayerNorm and the 8192-way head carry that to log-prob errors
# near 1e-5 absolute, so 1e-4 leaves a tenfold margin while a decode that
# read the wrong row or attended the padding moves the log-probs by far
# more (random weights: the top-2 gap is often below 1e-3, which is why a
# token may differ from the dense argmax within the tolerance); (d)
# decoder_from_pipeline on the gpt_bf16 row after PIPE_DECODE["steps"]
# AdamW steps
DECODE_SHAPES = ((1, 8, 256, 64), (2, 8, 256, 64))
# one sequence at shorter prefixes: K1's longest block walks T / 64 k
# tiles, so the times over T = 64, 128, 256 give the cost of one k tile
DECODE_SWEEP_T = (64, 128)
FULL_DECODE = dict(batch=2, t0=16, n_new=32, seed=22)
DECODE_LOGP_TOL = 1e-4
PIPE_DECODE = dict(t0=16, n_new=16, steps=3)
# the second lane (phases 16-18, 19 (a), (d) and 23) must end this many
# seconds after the script starts; it is stopped then
LANE_DEADLINE_S = 1100
# phase 23: a GPT at GPT-J-6B's widths (EleutherAI's config: n_embd 4096,
# n_head 16, so head dim 256; n_positions 2048) in the repo's own block
# (learned positions, no rotary), cut from 28 layers to 2; vocab 256 (the
# repo's byte-level corpus). Random weights from seed 0.
GPTJ_CFG = dict(vocab=256, seq_len=2048, d_model=4096, n_heads=16,
                mlp_ratio=4, n_layers=2)
GPTJ_TRAIN = dict(batch=2, steps=3)
GPTJ_DECODE = dict(t0=64, n_new=8, seed=25)
GPTJ_SERVE = dict(n_slots=4, prompt_lens=(16, 32, 48, 64), max_new=8)
# (loss rtol, gradients' relative L2 distance) of the first step, flash
# against dense on the same weights and batch: f32 at the f32 kernels'
# 1e-5 / 1e-4 (summation order); bf16 at the gpt_bf16 row's loss limit
# (2e-3: the dense bf16 path rounds scores and probabilities to bf16, the
# kernels keep them in f32) and 5e-2 for the gradients, whose bf16
# products round p and ds at other places in each path
GPTJ_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-3, 5e-2)}
# phase 23's host ms with the first design of the wide K1 (an f32 and a
# bf16 AdamW step, the first included, and a decoded token; this script on
# an NVIDIA H100 80GB HBM3 at 700 W, PERF.md), printed beside this run's:
# host clocks vary between calls
GPTJ_FIRST_K1_MS = {"train float32": 249.5, "train bfloat16": 46.0,
                    "decode": 37.2}


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
    """K4 everywhere (both designs); K1 (bf16 and f32) and the f32 K2 and
    K3 at head dims padded to 16, 32 or 64; the bf16 wide K1, K2 and K3
    (wgmma, whose accumulators must stay in registers)."""
    import re
    if ("paged_attn_kernel" in name or "paged_attn_wide_kernel" in name
            or "_kernel_wide_wgmma" in name):
        return True
    m = re.search(r"flash_(?:fwd_kernel_(?:bf16_mma|tf32)"
                  r"|(?:dq|dkv)_kernel_tf32)(?:<(?:\(int\))?|ILi)(\d+)", name)
    return bool(m) and int(m.group(1)) <= 64


def sass_hmma_counts(lib_path, ops=("HMMA", "HGMMA")) -> dict[str, int]:
    """Tensor-core instructions (``ops``: ``HMMA`` for mma.sync, ``HGMMA``
    for wgmma) in each kernel of a built library, from ``cuobjdump
    -sass`` (beside ``nvcc``); names demangled with ``cu++filt`` where the
    toolkit has it."""
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
        elif name is not None and any(op in line for op in ops):
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
    # a fresh build reports the 12 K1-K3 variants at dh <= 64 (bf16 K1,
    # f32 K1, f32 K2 and f32 K3, each 16 / 32 / 64), the bf16 wide K1 (up
    # to dh 256 and past it), K2 and K3 and K4's 30 (5 storage types x K up
    # to 1, 4, 8, in each design: up to dh 128 and past it)
    check(not ptxas or len(held) == 12 + 4 + 30,
          f"ptxas reported {len(held)} K1-K3/K4 kernels, not 46: {held}")
    spills = [n for n in held if ptxas[n].get("spill_stores", 0)
              or ptxas[n].get("spill_loads", 0)]
    check(not spills, f"K4, K1, the f32 K2 or K3 at dh <= 64 or the bf16 "
                      f"wide K1, K2 or K3 spills registers: {spills}")
    record["ptxas"] = ptxas
    print(f"chip_smoke: kernels built in {record['build_s']} s")
    hmma = sass_hmma_counts(builds[1].path)
    k4_hmma = sass_hmma_counts(builds[0].path)
    k4_hmma.update(sass_hmma_counts(builds[2].path))      # and F1
    hgmma = sass_hmma_counts(builds[1].path, ("HGMMA",))
    tf32 = sass_hmma_counts(builds[1].path, ("HMMA.1688.F32.TF32",))
    for name, n in sorted({**hmma, **k4_hmma}.items()):
        print(f"chip_smoke:   SASS HMMA/HGMMA {n:5d} (HGMMA "
              f"{hgmma.get(name, 0):4d})  {name}")

    def tensor_core(name):
        return ("_bf16_mma" in name or "_tf32" in name
                or "_wide" in name) and "paged_attn" not in name

    mma = {n: c for n, c in hmma.items() if tensor_core(n)}
    # the bf16 and the f32 (HMMA.1688.F32.TF32) K1, K2 and K3, each at head
    # dims padded to 16, 32, 64, 128, and the wide K1 (two each), K2 and K3
    # in both dtypes
    check(len(mma) == 32 and all(c > 0 for c in mma.values()),
          f"the bf16 and f32 K1-K3 kernels are not all on the tensor "
          f"cores: {mma}")
    wgmma = {n: hgmma.get(n, 0) for n in hmma if "_kernel_wide_wgmma" in n}
    # the bf16 wide K1 (two), K2 and K3 on the warpgroup tensor cores
    check(len(wgmma) == 4 and all(c > 0 for c in wgmma.values()),
          f"the bf16 wide K1, K2 and K3 do not run wgmma: {wgmma}")
    wide_tf32 = {n: tf32.get(n, 0) for n in hmma if "_kernel_wide_tf32" in n}
    # the f32 wide K1 (two), K2 and K3 in split TF32 on mma.sync
    check(len(wide_tf32) == 4 and all(c > 0 for c in wide_tf32.values()),
          f"the f32 wide K1, K2 and K3 do not run TF32 mma.sync: "
          f"{wide_tf32}")
    simt = {n: c for n, c in {**hmma, **k4_hmma}.items()
            if not tensor_core(n) and c}
    check(not simt, f"K4 or F1 use tensor cores: {simt}")
    record["sass_hmma"] = {**hmma, **k4_hmma}
    record["sass_hgmma"] = hgmma


# -- phase 2 ------------------------------------------------------------------

def _pool_case(name: str, K: int, gen, dev, dh: int = 64,
               bs: int = SERVE_BLOCK, layout: str = "layer",
               pos0: bool = False, slots: int = SERVE_SLOTS,
               spec_plan: bool = False, heads: int = 8):
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
    so its queries straddle it; ``heads``: one tensor-parallel shard's
    head count (phase 19)."""
    import torch
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        _quantize_rows,
    )
    L, H, S = 4, heads, slots
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


def _long_case(name: str, S: int, H: int, dh: int, dev, seed: int) -> dict:
    """One layer's pool for ``S`` slots at position ``K4_LONG_POS``, each
    slot's table a random run of distinct blocks (block 0 the trash), all
    made on the card from a seeded CUDA generator."""
    import torch
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        _quantize_rows,
    )
    gen = torch.Generator(device=dev).manual_seed(seed)
    bs = SERVE_BLOCK
    NB = (K4_LONG_POS + 1) // bs
    nblk = S * NB + 1
    kc = torch.randn((nblk, H, bs, dh), generator=gen, device=dev)
    vc = torch.randn((nblk, H, bs, dh), generator=gen, device=dev)
    if name in ("int8", "float8_e4m3fn", "float8_e5m2"):
        (kd, ks), (vd, vs) = _quantize_rows(kc, name), _quantize_rows(vc, name)
    else:
        kd, vd = kc.to(getattr(torch, name)), vc.to(getattr(torch, name))
        ks = vs = None
    del kc, vc
    perm = torch.randperm(nblk - 1, generator=gen, device=dev) + 1
    return dict(q=torch.randn((S, H, 1, dh), generator=gen, device=dev),
                kc=kd, vc=vd, kscale=ks, vscale=vs, bs=bs,
                tables=perm.view(S, NB).to(torch.int32).contiguous(),
                qpos=torch.full((S, 1), K4_LONG_POS, dtype=torch.int32,
                                device=dev))


def _k4_long(flush) -> list[dict]:
    """``K4_LONG``'s cases: each against its plain version
    (``SAME_BYTES_TOL``), then timed as the serving cases, beside its
    bound and its time in K4's first design past dh 128
    (``K4_LONG_FIRST_MS``)."""
    import torch
    from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (  # noqa: E501
        paged_attention,
        paged_attention_reference,
    )
    rows = []
    for i, (name, S, H, dh) in enumerate(K4_LONG):
        c = _long_case(name, S, H, dh, torch.device("cuda"), 28 + i)
        args = (c["q"], c["kc"], c["vc"], c["tables"], c["qpos"])
        kw = dict(block_size=c["bs"], kscale=c["kscale"], vscale=c["vscale"])
        out = paged_attention(*args, **kw)
        ref = paged_attention_reference(*args, **kw)
        err = (out - ref).abs()
        rtol, atol = SAME_BYTES_TOL
        ok = bool(torch.isfinite(out).all()) and bool(
            (err <= atol + rtol * ref.abs()).all())
        del out, ref
        v = dict(dtype=name, slots=S, heads=H, dh=dh, K=1, pos=K4_LONG_POS,
                 bs=c["bs"], max_abs_err=float(err.max()), rtol=rtol,
                 atol=atol)
        del err
        v["bound_ms"], v["bound_by"] = _bound(c)
        v["ms"] = time_ms(lambda: paged_attention(*args, **kw), flush)
        v["plain_ms"] = time_ms(
            lambda: paged_attention_reference(*args, **kw), flush, n=10,
            reps=3)
        first = K4_LONG_FIRST_MS.get((name, S, H, dh))
        v["first_ms"] = first
        rows.append(v)
        was = f"; first design {first:.4f} ms" if first else ""
        print(f"chip_smoke: paged_attention long {name} {S} slots x {H} "
              f"heads x dh {dh} at position {K4_LONG_POS}: vs plain max abs "
              f"{v['max_abs_err']:.3e} {'ok' if ok else 'FAIL'}; kernel "
              f"{v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms, bound "
              f"{v['bound_ms']:.4f} ms ({v['bound_by']}): "
              f"{v['ms'] / v['bound_ms']:.2f}x the bound{was}")
        check(ok, f"paged_attention long case {name} S={S} H={H} dh={dh} "
                  f"disagrees with its plain version: {v}")
        del c, args, kw
        torch.cuda.empty_cache()
    return rows


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
    # the decode tick at phase 23's head dim (256) and past it (512), f32
    # and int8, 8 slots, K = 1: the wide kernel, beside its first design
    head_dims = []
    for name, dh in K4_HEAD_DIMS:
        c = _pool_case(name, 1, gen, dev, dh=dh)
        args = (c["q"], c["kc"], c["vc"], c["tables"], c["qpos"])
        kw = dict(block_size=c["bs"], kscale=c["kscale"], vscale=c["vscale"])
        v, ok, wide_ok = _against_plain(name, c)
        v["bound_ms"], v["bound_by"] = _bound(c)
        v["ms"] = time_ms(lambda: paged_attention(*args, **kw), flush)
        v["plain_ms"] = time_ms(
            lambda: paged_attention_reference(*args, **kw), flush)
        v["first_ms"] = WIDE_K4_FIRST_MS[(name, dh)]
        head_dims.append(v)
        print(f"chip_smoke: paged_attention {name} K=1 dh={dh}: vs plain max "
              f"abs {v['max_abs_err']:.3e} {'ok' if ok else 'FAIL'}; kernel "
              f"{v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms, bound "
              f"{v['bound_ms']:.4f} ms ({v['bound_by']}): "
              f"{v['ms'] / v['bound_ms']:.1f}x the bound; first design "
              f"{v['first_ms']:.4f} ms")
        check(ok and wide_ok, f"paged_attention {name} dh={dh} disagrees: "
                              f"{v}")
    record["kernel_head_dims"] = head_dims
    record["kernel_long"] = _k4_long(flush)
    print("chip_smoke: paged_attention library_ms: none — no single "
          "PyTorch call computes block-table-gathered attention "
          "(scaled_dot_product_attention needs the rows gathered first)")
    record["kernel_variants"] = variants
    record["kernel_edges"] = edges
    record["kernel_multi_group"] = multi
    record["kernel_spec_verify"] = spec_timed
    return variants + edges + multi + spec_timed + head_dims + record[
        "kernel_long"]


def _flash_work(name: str, shape, dtype) -> tuple[int, int]:
    """(bytes, FLOP) of one flash kernel's work at ``shape`` [B, H, T, dh]:
    each [B, H, T, dh] operand read once, each output written once, f32
    row statistics; the causal products' operations, 2 per multiply-add
    over the T(T+1)/2 live pairs per head (K1 does q.k and p.v, K2 adds
    do.v and ds.k, K3 q.k, do.v, p.do and ds.q)."""
    B, H, T, dh = shape
    e = 2 if dtype == "bfloat16" else 4
    slab, rows = B * H * T * dh * e, B * H * T * 4
    nbytes, products = {
        "flash_forward": (3 * slab + slab + 2 * rows, 2),
        "flash_dq": (4 * slab + 3 * rows + slab, 3),
        "flash_dkv": (4 * slab + 3 * rows + 2 * slab, 4),
    }[name]
    return nbytes, products * 2 * B * H * (T * (T + 1) // 2) * dh


def _flash_bound(name: str, shape, dtype) -> tuple[float, str]:
    """Least time for one flash kernel's work at ``shape`` (``_flash_work``):
    the larger of its bytes / HBM rate and its operations / the rate of
    the units that do them: the bf16 tensor cores; for f32 the TF32 tensor
    cores at three TF32 products per f32 one (split TF32)."""
    nbytes, flops = _flash_work(name, shape, dtype)
    t_bytes = nbytes / HBM_BYTES_PER_S
    if dtype == "bfloat16":
        t_ops = flops / BF16_FLOPS
    else:
        t_ops = 3 * flops / TF32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _flash_simt_bound(name: str, shape) -> float:
    """The f32 bound as it stood while every f32 kernel ran on the CUDA
    cores: bytes / HBM rate against FLOP / 67 TFLOP/s, in ms."""
    nbytes, flops = _flash_work(name, shape, "float32")
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3


def _flash_inputs(shape, dtype, gen, dev, unaligned: bool = False):
    """q, k, v, do from ``gen``; ``unaligned``: each contiguous with its
    storage one element into a buffer, so not 16-byte aligned."""
    import torch
    dt = getattr(torch, dtype)
    out = []
    for _ in range(4):
        x = torch.randn(shape, generator=gen)
        if unaligned:
            buf = torch.empty(x.numel() + 1, dtype=dt, device=dev)
            out.append(buf[1:].view(shape).copy_(x))
        else:
            out.append(x.to(dev, dt))
    return tuple(out)


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
    masked tail live), plus the tiny ``gpt`` row's f32 shape and the edge
    shapes ``FLASH_EDGES`` of the tensor-core kernels and the unaligned
    inputs ``FLASH_UNALIGNED``, in both dtypes. The
    f32 rows timed also print the bound at the CUDA cores' 67 TFLOP/s
    beside the split-TF32 one. K2 and K3 are
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
    cases = [("bfloat16", FLASH_SHAPE, False), ("bfloat16", FLASH_RAGGED, False),
             ("float32", FLASH_SHAPE, False), ("float32", FLASH_RAGGED, False),
             ("float32", FLASH_TINY_SHAPE, False)]
    cases += [(dtype, shape, False) for dtype in ("bfloat16", "float32")
              for shape in FLASH_EDGES]
    cases += [(dtype, shape, True) for dtype in ("bfloat16", "float32")
              for shape in FLASH_UNALIGNED]
    wide = [(dtype, shape) for shape in FLASH_WIDE_SHAPES
            for dtype in ("bfloat16", "float32")]
    cases += [(dtype, shape, False) for dtype, shape in wide]
    timed = {("bfloat16", FLASH_SHAPE), ("float32", FLASH_TINY_SHAPE), *wide}
    out = []
    for dtype, shape, unaligned in cases:
        # the wide shapes' calls take milliseconds: fewer of them
        n, reps = (10, 3) if (dtype, shape) in wide else (40, 5)
        q, k, v, do = _flash_inputs(shape, dtype, gen, dev, unaligned)
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
        if (dtype, shape) in timed and not unaligned:
            qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(qg, kg, vg,
                                                      is_causal=True)

            def sdpa_fb():
                return torch.autograd.grad(sdpa(), (qg, kg, vg), do)

            fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True), flush, n, reps)
            lib = {"flash_forward": fwd_ms,
                   "backward": time_ms(sdpa_fb, flush, n, reps) - fwd_ms}
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
                      unaligned=unaligned, max_abs_err=max(errs.values()),
                      errs=errs)
            line = (f"chip_smoke: {name:13} {dtype:>8} {tuple(shape)}"
                    f"{' unaligned' if unaligned else ''}: vs "
                    f"plain max abs " + ", ".join(
                        f"{p} {e:.3e}" for p, e in errs.items())
                    + f" {'ok' if ok else 'FAIL'}")
            if lib:
                v_["ms"] = time_ms(kernel, flush, n, reps)
                v_["plain_ms"] = time_ms(plain, flush, n, reps)
                v_["bound_ms"], v_["bound_by"] = _flash_bound(name, shape,
                                                              dtype)
                v_["library_ms"] = lib.get(name, lib["backward"])
                line += (f"; kernel {v_['ms']:.4f} ms, plain "
                         f"{v_['plain_ms']:.4f} ms, bound "
                         f"{v_['bound_ms']:.4f} ms ({v_['bound_by']}), "
                         f"library {v_['library_ms']:.4f} ms")
                if dtype == "float32":
                    v_["simt_bound_ms"] = _flash_simt_bound(name, shape)
                    line += (f" (bound at 67 TFLOP/s f32: "
                             f"{v_['simt_bound_ms']:.4f} ms)")
            print(line)
            check(ok, f"{name} {dtype} {tuple(shape)} (unaligned "
                      f"{unaligned}) disagrees with its plain version: "
                      f"{errs}")
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
    tiny = {v["name"]: v for v in out if v["dtype"] == "float32"
            and tuple(v["shape"]) == FLASH_TINY_SHAPE}
    bwd32 = tiny["flash_dq"]["ms"] + tiny["flash_dkv"]["ms"]
    sdpa32 = tiny["flash_dq"]["library_ms"]
    print(f"chip_smoke: K2 + K3 f32 {FLASH_TINY_SHAPE}: {bwd32:.4f} ms "
          f"against SDPA's backward {sdpa32:.4f} ms: {bwd32 / sdpa32:.2f}x")
    record["flash_backward_f32_vs_sdpa"] = dict(k2_k3_ms=bwd32,
                                                sdpa_backward_ms=sdpa32,
                                                ratio=bwd32 / sdpa32)
    record["flash_wide"] = []
    for dtype, shape in wide:
        w = {v["name"]: v for v in out if v["dtype"] == dtype
             and tuple(v["shape"]) == shape and not v["unaligned"]}
        k23 = w["flash_dq"]["ms"] + w["flash_dkv"]["ms"]
        row = dict(dtype=dtype, shape=list(shape),
                   k1_ms=w["flash_forward"]["ms"],
                   k1_bound_ms=w["flash_forward"]["bound_ms"],
                   sdpa_forward_ms=w["flash_forward"]["library_ms"],
                   k1_first_ms=WIDE_K1_FIRST_MS[(dtype, shape)],
                   k2_ms=w["flash_dq"]["ms"], k3_ms=w["flash_dkv"]["ms"],
                   k2_k3_ms=k23, sdpa_backward_ms=w["flash_dq"]["library_ms"],
                   k2_k3_bound_ms=(w["flash_dq"]["bound_ms"]
                                   + w["flash_dkv"]["bound_ms"]),
                   k2_k3_first_ms=WIDE_K2_K3_FIRST_MS[(dtype, shape)])
        record["flash_wide"].append(row)
        print(f"chip_smoke: wide K1 {dtype} {shape}: {row['k1_ms']:.4f} ms "
              f"(bound {row['k1_bound_ms']:.4f}) against SDPA's forward "
              f"{row['sdpa_forward_ms']:.4f} ms: "
              f"{row['k1_ms'] / row['sdpa_forward_ms']:.2f}x; the first "
              f"design's K1 {row['k1_first_ms']:.4f} ms: "
              f"{row['k1_first_ms'] / row['k1_ms']:.2f}x this run's; K2 + K3 "
              f"{row['k2_ms']:.4f} + {row['k3_ms']:.4f} = {k23:.4f} ms "
              f"(bound {row['k2_k3_bound_ms']:.4f}) against SDPA's backward "
              f"{row['sdpa_backward_ms']:.4f} ms: "
              f"{k23 / row['sdpa_backward_ms']:.2f}x; the first design's "
              f"K2 + K3 {row['k2_k3_first_ms']:.4f} ms: "
              f"{row['k2_k3_first_ms'] / k23:.2f}x this run's")
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
    attr = ("_decode" if not engine.speculative
            else "_spec_fused" if engine._spec_fused is not None
            else "_verify")          # a TP target's verify dispatch
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
    kernel (Chrome trace in ``chiprun_out/``). The session opens on one
    more step that its schedule records nothing of (``warmup=1``): the
    kernels launched while the session starts up can go unrecorded, and
    the launch count below is exact."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n_steps,
                                   repeat=1)) as prof:
        params, state, _ = step(params, state, xs[0], ts[0])
        torch.cuda.synchronize()
        prof.step()
        # an idle gap after the recording starts: no kernel runs near the
        # window's edge, where the device clock's mapping onto the host's
        # can place one outside it
        time.sleep(0.05)
        t0 = time.perf_counter()
        for i in range(n_steps):
            params, state, _ = step(params, state, xs[i % TRAIN_POOL],
                                    ts[i % TRAIN_POOL])
            if i < n_steps - 1:
                prof.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = []
    for e in prof.key_averages():
        # the schedule's ProfilerStep ranges show on the device's timeline
        # too: annotations, not kernels
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.key.startswith("ProfilerStep")):
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
        check(set(r) == JAX_EPOCH_KEYS | ICI_KEYS | {"device_memory"}
              and r["ici_bytes_per_step"] == 0,
              f"every={every}: record keys {sorted(r)} are not the JAX "
              f"record's plus device_memory and the ICI gauge's: "
              f"{sorted(set(r) ^ JAX_EPOCH_KEYS)}")
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
    check(set(recs[0]) == JAX_EPOCH_KEYS | ICI_KEYS | {"device_memory"}
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

    def least_of_3(fn):
        # the least of three medians, since the second lane's launches can
        # land inside a timed run; F1, torch.mul and the floor all take it
        return min(time_ms(fn, flush) for _ in range(3))

    ms = least_of_3(kernel)
    plain_ms = time_ms(lambda: grid_scratch_reference(x, racing=False),
                       flush)
    library_ms = least_of_3(lambda: torch.mul(x, 2))
    # the launch floor: one launch that moves a single element
    one = torch.ones(1, device="cuda")
    floor_ms = least_of_3(lambda: torch.mul(one, 2))
    seen_here = profiler_tally(kernel, flush, "grid_scratch_kernel")[1]
    grid_scratch.launches = n0           # timing launches are not the path
    profiler_ms = _f1_profiler_ms_fresh()
    R, C = x.shape
    nbytes = 2 * R * C * 4 + R * 4       # x and out_row read, out written
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, R * C / F32_FLOPS
    bound_ms = max(t_bytes, t_ops) * 1e3
    print(f"chip_smoke: lint (a) F1 {ms:.6f} ms per launch, plain "
          f"{plain_ms:.6f} ms, torch.mul "
          f"{library_ms:.6f} ms, bound {bound_ms:.9f} ms ({nbytes} bytes), "
          f"launch floor (a one-element torch.mul) {floor_ms:.6f} ms; "
          f"{launches} launches from the fixtures; profiler cross-check "
          f"{profiler_ms:.6f} ms (a process of its own, 40 of 40 seen; in "
          f"this process, after phase 13 (b)'s --profile session, the "
          f"profiler saw {seen_here} of 40)")
    rec["grid"] = dict(launches=launches, verdicts=verdicts,
                       race_cells=cells, ms=ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       launch_floor_ms=floor_ms,
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
             {"SDML_LINT_INJECT": "drill"}, 1)):
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


def _stage_cli(argv: list[str], tmp: str, name: str,
               steps: int = STAGE_CLI_STEPS) -> dict:
    """One CLI training run (``--dryrun steps``) with ``--metrics-json``:
    its console lines and its epoch record."""
    import json as _json
    path = os.path.join(tmp, f"{name}.jsonl")
    lines = _cli(argv + ["--dryrun", str(steps), "--metrics-json", path])
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


# -- phase 16: the reference's launch line, real processes on the one card ---

def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_cmd(rank: int, world: int, port: int, hb_port: int,
              argv: list[str]) -> list[str]:
    return [sys.executable, "-m", f"{PORT}.cli", "--rank", str(rank),
            "--world_size", str(world), "--master_addr", "localhost",
            "--master_port", str(port), "--heartbeat-port", str(hb_port),
            "--device", MAIN_DEVICE] + argv


def _child_env(extra: dict | None = None) -> dict:
    return dict(os.environ, PYTHONUNBUFFERED="1", **(extra or {}))


def _kill_all(procs) -> None:
    """Stop every process a launch started (a stopped one is continued
    first, so the kill lands)."""
    import signal
    for p in procs:
        if p.poll() is None:
            try:
                p.send_signal(signal.SIGCONT)
            except ProcessLookupError:
                pass
            p.kill()
        p.wait()


def _start_ranks(world: int, argv: list[str],
                 env: dict | None = None) -> list:
    """Start ``world`` processes of the port's CLI on the reference's
    launch line; ``_wait_ranks`` collects them."""
    port, hb_port = _free_port(), _free_port()
    return [subprocess.Popen(_rank_cmd(r, world, port, hb_port, argv),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, env=_child_env(env), cwd=HERE)
            for r in range(world)]


def _wait_ranks(procs: list, argv: list[str],
                timeout: float = PROC_TIMEOUT_S) -> list[tuple]:
    """``[(rc, stdout, stderr)]`` by rank of ``_start_ranks``'s
    processes, each of which must exit 0; every one is stopped on the way
    out."""
    out = []
    try:
        deadline = time.monotonic() + timeout
        for p in procs:
            so, se = p.communicate(timeout=max(1.0,
                                               deadline - time.monotonic()))
            out.append((p.returncode, so, se))
    finally:
        _kill_all(procs)
    for r, (rc, _, se) in enumerate(out):
        check(rc == 0, f"rank {r} of {' '.join(argv)} exited {rc}: "
                       f"{se[-2000:]}")
    return out


def _launch_ranks(world: int, argv: list[str], env: dict | None = None,
                  timeout: float = PROC_TIMEOUT_S) -> list[tuple]:
    """``world`` processes of the port's CLI on the reference's launch
    line; ``[(rc, stdout, stderr)]`` by rank."""
    return _wait_ranks(_start_ranks(world, argv, env), argv, timeout)


def _console(lines) -> list[str]:
    """The reference's console lines (the train and test lines)."""
    return [ln for ln in lines if TRAIN_RE.match(ln) or TEST_RE.match(ln)]


def _procs_launch_line(rec: dict, tmp: str) -> None:
    """(a) The reference's launch line: LeNet (conv | fc) over two
    processes, rank 0 printing the console, rank 1 none of it; rank 0's
    losses equal the one-process two-stage run's to the printed digits."""
    argv = ["--epochs", "1", "--max-steps-per-epoch", str(PROC_STEPS),
            "--data-root", os.path.join(tmp, "nodata")]
    (_, out0, _), (_, out1, _) = _launch_ranks(2, argv)
    lines0 = [ln for ln in out0.split("\n") if ln]
    one = _console(_cli(argv + ["--stages", "2"]))
    two = _console(lines0)
    check(any(ln.startswith("Train Epoch: 1") for ln in two)
          and any(TEST_RE.match(ln) for ln in two),
          f"rank 0 printed no reference console: {lines0}")
    check("Train Epoch" not in out1 and "Test set" not in out1,
          f"rank 1 printed the console: {out1!r}")
    if two != one:
        gaps = [abs(float(a.split()[-1].rstrip(",")) -
                    float(b.split()[-1].rstrip(",")))
                for a, b in zip(two, one) if TRAIN_RE.match(a)]
        check(False, f"rank 0's console differs from one process's (largest "
                     f"loss gap {max(gaps, default=None)}): {two} vs {one}")
    want = ("| distributed: 2 processes, gloo over the host, rank 0 on "
            + _stage_card())
    check(want in lines0, f"no {want!r} line: {lines0}")
    rec["launch_line"] = dict(lines=two)
    print(f"chip_smoke: processes (a) --rank 0/1 --world_size 2, lenet "
          f"conv | fc, {PROC_STEPS} steps: rank 0's {len(two)} console "
          f"lines equal the one-process --stages 2 run's; rank 1 silent")


def process_worker(rank: int, world: int, port: int, out_path: str) -> None:
    """(b)'s process (``python3 chip_smoke.py --process-worker RANK WORLD
    PORT OUT``): the gpt_bf16 row at 2 stages, M = 4, on the one card —
    one stage per process at ``world`` 2, both stages at ``world`` 1 (the
    one-process reference, timed the same way) — GPipe then 1F1B, warm-up
    and timed steps (the flash counts set to 0 just before the timed ones
    and read just after), the decode after GPipe, and at ``world`` 2 a
    ping-pong of one microbatch's activation over the wire."""
    import torch
    sys.path.insert(0, HERE)
    from simple_distributed_machine_learning_tpu_torch.models.pp_decode import (  # noqa: E501
        make_pp_decoder,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        bootstrap_distributed,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        mesh as mesh_lib,
    )
    from simple_distributed_machine_learning_tpu_torch.train import (
        make_train_step,
    )
    bootstrap_distributed(rank, world, "localhost", port, timeout_s=120)
    rec: dict = {}
    for sched in ("gpipe", "1f1b"):
        cfg, pipe, opt = _stage_pipe(2, 4, schedule=sched)
        x, t = _stage_batch(cfg, TRAIN_ROWS["gpt_bf16"]["batch"], 1)
        params = pipe.init_params()
        state = opt.init(params)
        step = make_train_step(pipe, opt)
        losses = []
        for i in range(2):
            params, state, loss = step(params, state, x, t, i)
            losses.append(loss)
        _sync()
        _reset_flash_counts()
        sends, nbytes = mesh_lib.WIRE["sends"], mesh_lib.WIRE["bytes"]
        t0 = time.perf_counter()
        for i in range(STAGE_TIMED_STEPS):
            params, state, loss = step(params, state, x, t, 2 + i)
            losses.append(loss)
        _sync()
        step_ms = (time.perf_counter() - t0) * 1e3 / STAGE_TIMED_STEPS
        rec[sched] = dict(step_ms=step_ms, launches=_flash_counts(),
                          sends=mesh_lib.WIRE["sends"] - sends,
                          bytes=mesh_lib.WIRE["bytes"] - nbytes,
                          losses=[float(v) for v in losses])
        if sched == "gpipe":
            rec["ici"] = _ici_probe(step, pipe, params, state, x, t,
                                    os.path.join(os.path.dirname(out_path),
                                                 f"tele-w{world}"))
        if sched == "gpipe":
            dec = make_pp_decoder(pipe, cfg, PROC_DECODE_T0, PROC_GENERATE)
            toks = dec(params, x[:1, :PROC_DECODE_T0].long())
            rec["tokens"] = None if toks is None else toks.cpu().tolist()
        del params, state, pipe
    if world == 1:
        with open(out_path, "w") as f:
            json.dump(rec, f)
        return
    # one microbatch's activation [4, 256, 512] bf16, host-staged, back and
    # forth: half a round trip is one hop
    act = torch.randn((TRAIN_ROWS["gpt_bf16"]["batch"] // 4,
                       TRAIN_ROWS["gpt_bf16"]["cfg"]["seq_len"],
                       TRAIN_ROWS["gpt_bf16"]["cfg"]["d_model"]),
                      device=MAIN_DEVICE).bfloat16()
    rtts = []
    for _ in range(PROC_PINGS + 1):
        _sync()
        t0 = time.perf_counter()
        if rank == 0:
            mesh_lib.send(act, 1, 21)[0].wait()
            back = mesh_lib.recv(act.shape, act.dtype, 1, MAIN_DEVICE,
                                 22)
        else:
            back = mesh_lib.recv(act.shape, act.dtype, 0, MAIN_DEVICE,
                                 21)
            mesh_lib.send(back, 0, 22)[0].wait()
        _sync()
        rtts.append(time.perf_counter() - t0)
    rec["hop_ms"] = statistics.median(rtts[1:]) * 1e3 / 2
    rec["hop_bytes"] = act.numel() * act.element_size()
    with open(out_path, "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()


def _ici_probe(step, pipe, params, state, x, t, outdir: str) -> dict:
    """Phase 20 (e) inside a phase 16 (b) worker: this rank's train step
    registered with a telemetry session's step probe (the trainer's
    call; fake tensors, nothing launched), then one epoch record —
    ``ici_bytes_per_step`` and the trace's host ms, with K1-K3's counts
    unchanged across it — and the step's whole cost table (the record
    keeps the top 5 rows), by ``ici.expected_ici_bytes``."""
    from simple_distributed_machine_learning_tpu_torch.analysis import (
        abstractify,
    )
    from simple_distributed_machine_learning_tpu_torch.telemetry import (
        Telemetry,
        ici,
    )
    args = (abstractify(params), abstractify(state), abstractify(x),
            abstractify(t), 0)
    tele = Telemetry(outdir)
    tele.set_step_probe(step, *args, mesh=pipe.mesh)
    counts = _flash_counts()
    t0 = time.perf_counter()
    rec = tele.on_epoch(1, pipe=pipe)
    ms = (time.perf_counter() - t0) * 1e3
    full = ici.expected_ici_bytes(step, *args, mesh=pipe.mesh, top=10_000)
    check(_flash_counts() == counts, "the ICI probe's trace launched a "
                                     "flash kernel")
    return dict(ici_bytes_per_step=rec.get("ici_bytes_per_step"),
                table_bytes_per_step=full["ici_bytes_per_step"],
                top=full["collectives"], trace_ms=ms)


def _bf16_workers(world: int, tmp: str) -> list[dict]:
    """``world`` fresh ``--process-worker`` processes; their records by
    rank."""
    port = _free_port()
    outs = [os.path.join(tmp, f"bf16-w{world}-rank{r}.json")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--process-worker",
         str(r), str(world), str(port), outs[r]], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_child_env(), cwd=HERE)
        for r in range(world)]
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=PROC_TIMEOUT_S)
            check(p.returncode == 0, f"(b) world {world} rank {r} exited "
                                     f"{p.returncode}: {err[-2000:]}")
    finally:
        _kill_all(procs)
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    return ranks


def _procs_flash(rec: dict, record: dict, tmp: str) -> tuple[int, int, int]:
    """(b) gpt_bf16 (flash, bf16) at S = 2, M = 4, one stage per process:
    losses equal to the one-process run's (a fresh process of its own,
    timed the same way just before), the decoded tokens equal to it, each
    rank's K1/K2/K3 its stage's share of ``STAGE_LAUNCHES``; the
    host-clock step beside one process's, bytes and ms per hop. Returns
    the timed steps' K1-K3, summed over the ranks."""
    ref = _bf16_workers(1, tmp)[0]
    ranks = _bf16_workers(2, tmp)
    # phase 20 (e) reads each process's gauge beside its wire bytes
    rec["ici"] = [dict(g["ici"], wire_bytes_per_step=g["gpipe"]["bytes"]
                       / STAGE_TIMED_STEPS,
                       wire_sends_per_step=g["gpipe"]["sends"]
                       / STAGE_TIMED_STEPS) for g in [ref] + ranks]
    counts = [0, 0, 0]
    layers = TRAIN_ROWS["gpt_bf16"]["cfg"]["n_layers"] // 2
    for sched in ("gpipe", "1f1b"):
        check(tuple(v / STAGE_TIMED_STEPS for v in ref[sched]["launches"])
              == STAGE_LAUNCHES[sched],
              f"(b) {sched} one process: K1-K3 per step "
              f"{[v / STAGE_TIMED_STEPS for v in ref[sched]['launches']]} "
              f"!= {STAGE_LAUNCHES[sched]}")
        want_losses = ref[sched]["losses"]
        for r, got in enumerate(ranks):
            gaps = [abs(a - b) for a, b in zip(got[sched]["losses"],
                                               want_losses)]
            check(got[sched]["losses"] == want_losses,
                  f"(b) {sched} rank {r}: losses {got[sched]['losses']} vs "
                  f"one process {want_losses} (largest gap "
                  f"{max(gaps, default=None)})")
            k1 = layers * 4 * (2 if sched == "1f1b" and r == 0 else 1)
            want = tuple(STAGE_TIMED_STEPS * k for k in (k1, layers * 4,
                                                         layers * 4))
            check(tuple(got[sched]["launches"]) == want,
                  f"(b) {sched} rank {r}: K1-K3 {got[sched]['launches']} "
                  f"!= {want}")
        tot = [sum(g[sched]["launches"][i] for g in ranks) for i in range(3)]
        check(tuple(v / STAGE_TIMED_STEPS for v in tot)
              == STAGE_LAUNCHES[sched],
              f"(b) {sched}: K1-K3 per step over both ranks "
              f"{[v / STAGE_TIMED_STEPS for v in tot]} != "
              f"{STAGE_LAUNCHES[sched]}")
        counts = [a + b for a, b in zip(counts, tot)]
        sends = sum(g[sched]["sends"] for g in ranks)
        nbytes = sum(g[sched]["bytes"] for g in ranks)
        step_ms = max(g[sched]["step_ms"] for g in ranks)
        # a hop: one microbatch's activation forward (with its dropout
        # generator state) or its cotangent back, between the two stages
        hops = STAGE_TIMED_STEPS * 2 * 4
        rec[sched] = dict(step_ms=step_ms,
                          one_process_step_ms=ref[sched]["step_ms"],
                          launches=tot, sends_per_step=sends
                          / STAGE_TIMED_STEPS,
                          hops_per_step=hops / STAGE_TIMED_STEPS,
                          bytes_per_hop=nbytes / hops)
        print(f"chip_smoke: processes (b) gpt_bf16 S=2 M=4 {sched} over 2 "
              f"processes: step {step_ms:.3f} ms (host clock) against one "
              f"process's {ref[sched]['step_ms']:.3f} ms (a fresh process "
              f"just before; phase 15 (b)'s is in the first lane), "
              f"{rec[sched]['hops_per_step']:.0f} hops/step of "
              f"{rec[sched]['bytes_per_hop']:.0f} B ("
              f"{rec[sched]['sends_per_step']:.0f} sends), K1/K2/K3 per step "
              f"{[v / STAGE_TIMED_STEPS for v in tot]}, losses equal to one "
              f"process's")
    check(ranks[0]["tokens"] == ref["tokens"],
          f"(b) the decoded tokens {ranks[0]['tokens']} differ from one "
          f"process's {ref['tokens']}")
    rec["tokens"] = ref["tokens"]
    rec["hop_ms"] = statistics.median(g["hop_ms"] for g in ranks)
    rec["hop_bytes"] = ranks[0]["hop_bytes"]
    print(f"chip_smoke: processes (b) --generate {PROC_GENERATE}: tokens "
          f"equal to one process's; one host-staged hop of "
          f"{rec['hop_bytes']} B (one microbatch's activation): "
          f"{rec['hop_ms']:.3f} ms (median of {PROC_PINGS} round trips / 2)")
    return tuple(counts)


def _procs_data_pipeline(rec: dict, tmp: str) -> None:
    """(c) ``--model mlp --stages 2 --dp 2 --zero1`` over four processes:
    each names its rows, ``state.npz`` bit-equal to the one-process run of
    the same mesh; a second launch resumes and trains epoch 2 only, again
    bit-equal."""
    import numpy as np
    base = ["--model", "mlp", "--stages", "2", "--dp", "2", "--zero1",
            "--max-steps-per-epoch", str(PROC_STEPS), "--data-root",
            os.path.join(tmp, "nodata")]
    four, one = os.path.join(tmp, "ck4"), os.path.join(tmp, "ck1")
    legs = []
    for epochs in (1, 2):
        argv = base + ["--epochs", str(epochs)]
        t0 = time.perf_counter()
        runs = _launch_ranks(4, argv + ["--checkpoint-dir", four],
                             env={"SDML_DEBUG_SHARDING": "1"})
        legs.append(time.perf_counter() - t0)
        _cli(argv + ["--checkpoint-dir", one])
        out0 = runs[0][1]
        if epochs == 1:
            for r, want in ((0, "[0,30) of 60"), (1, "[0,30) of 60"),
                            (2, "[30,60) of 60"), (3, "[30,60) of 60")):
                check(f"| host {r}: input rows {want}" in runs[r][2],
                      f"(c) rank {r} did not name rows {want}: "
                      f"{runs[r][2][-1500:]}")
        else:
            check("resumed from" in out0 and "Train Epoch: 2" in out0
                  and "Train Epoch: 1" not in out0,
                  f"(c) the second launch did not resume: {out0}")
        for r in range(1, 4):
            check("Train Epoch" not in runs[r][1], f"(c) rank {r} printed")
        za = np.load(os.path.join(four, "state.npz"))
        zb = np.load(os.path.join(one, "state.npz"))
        for k in ("params", "opt_0", "opt_1", "opt_2"):
            if k in zb.files:
                check(np.array_equal(za[k], zb[k]),
                      f"(c) epoch {epochs}: {k} differs from the one-process "
                      f"run's (largest gap "
                      f"{float(np.abs(za[k] - zb[k]).max())})")
    rec["data_pipeline"] = dict(launch_s=legs)
    print(f"chip_smoke: processes (c) mlp --stages 2 --dp 2 --zero1 over 4 "
          f"processes: rows [0,30)/[30,60) of 60 per replica, state.npz "
          f"bit-equal to one process's after epoch 1 and after the resumed "
          f"epoch 2 (launches {legs[0]:.1f} s, {legs[1]:.1f} s)")


def _procs_peer_loss(rec: dict, tmp: str) -> None:
    """(d) ``--peer-timeout 8``: SIGKILL, then SIGSTOP, rank 1 once rank 0
    trains; rank 0 exits non-zero within ``PROC_PEER_LIMIT_S`` with the
    watchdog's or gloo's diagnostic. Records the detection latency."""
    import signal
    argv = ["--model", "mlp", "--epochs", "500", "--peer-timeout",
            str(PROC_PEER_TIMEOUT), "--data-root", os.path.join(tmp, "nodata")]
    out: dict = {}
    for sig in (signal.SIGKILL, signal.SIGSTOP):
        port, hb_port = _free_port(), _free_port()
        log = os.path.join(tmp, f"peer-{sig.name}.log")
        with open(log, "w") as f0:
            # each rank in a session of its own: when a group holding a
            # stopped process is orphaned, the kernel hangs it up, and that
            # must not reach this script's group
            procs = [subprocess.Popen(_rank_cmd(0, 2, port, hb_port, argv),
                                      stdout=f0, stderr=subprocess.STDOUT,
                                      env=_child_env(), cwd=HERE,
                                      start_new_session=True),
                     subprocess.Popen(_rank_cmd(1, 2, port, hb_port, argv),
                                      stdout=subprocess.DEVNULL,
                                      stderr=subprocess.DEVNULL,
                                      env=_child_env(), cwd=HERE,
                                      start_new_session=True)]
            try:
                deadline = time.monotonic() + PROC_TIMEOUT_S
                while "Train Epoch" not in open(log).read():
                    check(procs[0].poll() is None,
                          f"(d) rank 0 exited early: {open(log).read()}")
                    check(time.monotonic() < deadline,
                          "(d) rank 0 never started training")
                    time.sleep(0.2)
                t0 = time.monotonic()
                procs[1].send_signal(sig)
                try:
                    rc = procs[0].wait(timeout=PROC_PEER_LIMIT_S)
                except subprocess.TimeoutExpired:
                    rc = None
                took = time.monotonic() - t0
            finally:
                _kill_all(procs)
        text = open(log).read()
        check(rc not in (0, None), f"(d) {sig.name}: rank 0 did not exit "
                                   f"non-zero within {PROC_PEER_LIMIT_S} s")
        check(any(m in text for m in ("aborting run",
                                      "Connection reset by peer",
                                      "Connection closed by peer")),
              f"(d) {sig.name}: no peer-loss diagnostic: {text[-1500:]}")
        out[sig.name] = dict(rc=rc, detect_s=took)
        print(f"chip_smoke: processes (d) {sig.name} rank 1: rank 0 exited "
              f"{rc} after {took:.2f} s (--peer-timeout "
              f"{PROC_PEER_TIMEOUT})")
    rec["peer_loss"] = out


def phase_processes(record: dict) -> tuple[int, int, int]:
    """Phase 16: the port's CLI as real processes on the one card. Returns
    (b)'s K1-K3 launches, summed over its ranks."""
    import tempfile
    rec: dict = {}
    record["processes"] = rec
    secs = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        _procs_launch_line(rec, tmp)
        secs["a"] = time.perf_counter() - t0
        launches = _procs_flash(rec, record, tmp)
        secs["b"] = time.perf_counter() - t0 - sum(secs.values())
        _procs_data_pipeline(rec, tmp)
        secs["c"] = time.perf_counter() - t0 - sum(secs.values())
        _procs_peer_loss(rec, tmp)
        secs["d"] = time.perf_counter() - t0 - sum(secs.values())
    rec["seconds"] = dict(secs, total=time.perf_counter() - t0)
    print(f"chip_smoke: phase 16 took {rec['seconds']['total']:.1f} s ("
          + ", ".join(f"({k}) {v:.1f}" for k, v in secs.items()) + ")")
    return launches


def _tp_pipe(row: dict, tp: int, overlap: str = "none"):
    """A bench row with dense attention at ``n_tensor_parallel = tp`` on
    the one card (weights from seed 0: every width slices the same dense
    init) and the collective schedule ``overlap``, its pipeline and its
    optimizer."""
    import torch
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        GPTConfig,
        make_gpt_stages,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        Pipeline,
        make_mesh,
    )
    from simple_distributed_machine_learning_tpu_torch.train import (
        adamw,
        sgd,
    )
    cfg = GPTConfig(**row["cfg"], n_tensor_parallel=tp, overlap=overlap)
    stages, wd, od = make_gpt_stages(0, cfg, 1, device=MAIN_DEVICE)
    mesh = (make_mesh(1, n_model=tp, devices=[_stage_card()] * tp)
            if tp > 1 else None)
    pipe = Pipeline(stages, mesh, wd, od, n_microbatches=row["n_micro"],
                    compute_dtype=row["dtype"] and getattr(torch,
                                                           row["dtype"]),
                    overlap=overlap, device=None if mesh else MAIN_DEVICE)
    opt = (adamw(1e-3) if row["opt"] == "adamw"
           else sgd(0.1, momentum=0.5))
    return cfg, pipe, opt


def _tp_steps(row: dict, tp: int, steps: int,
              overlap: str = "none") -> dict:
    """``steps`` train steps of ``row`` at ``tp`` (schedule ``overlap``)
    from fresh weights on one batch: the losses, each step's host-clock ms
    (synchronised), the peak memory of the run and its flash launches
    (none: attention is dense)."""
    import torch

    from simple_distributed_machine_learning_tpu_torch.train import (
        make_train_step,
    )
    cfg, pipe, opt = _tp_pipe(row, tp, overlap)
    x, t = _stage_batch(cfg, row["batch"], 7)
    params = pipe.init_params()
    state = opt.init(params)
    step = make_train_step(pipe, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_flash_counts()
    losses, ms = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        params, state, loss = step(params, state, x, t, i)
        losses.append(float(loss))             # synchronises the step
        ms.append((time.perf_counter() - t0) * 1e3)
    out = dict(losses=losses, step_ms=ms,
               peak_bytes=torch.cuda.max_memory_allocated(),
               flash=_flash_counts())
    del params, state, pipe
    torch.cuda.empty_cache()
    return out


def tp_profile(overlap: str = "none") -> dict:
    """Phase 17 (a)'s profiled window (phase 19 (a)'s with ``overlap``
    "ring", at ``OVERLAP_WIDTHS``): ``TP_PROFILED_STEPS`` gpt_bf16 steps at
    each width under ``torch.profiler``, after 2 warm-up steps — kernel
    launches per step and the device's busy share (run in a process of its
    own, as phase 15's window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from simple_distributed_machine_learning_tpu_torch.train import (
        make_train_step,
    )
    row = TRAIN_ROWS["gpt_bf16"]
    out = {}
    for tp in TP_WIDTHS if overlap == "none" else OVERLAP_WIDTHS:
        cfg, pipe, opt = _tp_pipe(row, tp, overlap)
        x, t = _stage_batch(cfg, row["batch"], 7)
        params = pipe.init_params()
        state = opt.init(params)
        step = make_train_step(pipe, opt)
        for i in range(2):
            params, state, _ = step(params, state, x, t, i)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(TP_PROFILED_STEPS):
                params, state, _ = step(params, state, x, t, i)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy, launches = 0.0, 0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                busy += float(getattr(e, "self_device_time_total", None)
                              or getattr(e, "self_cuda_time_total", 0))
                launches += e.count
        n = TP_PROFILED_STEPS
        out[str(tp)] = dict(profiled_step_ms=wall_us / 1e3 / n,
                            device_busy_share=busy / wall_us,
                            device_ms_per_step=busy / 1e3 / n,
                            kernel_launches_per_step=launches / n)
        del params, state, pipe
        torch.cuda.empty_cache()
    return out


def _tp_profile_fresh(overlap: str = "none") -> dict:
    proc = subprocess.run(
        [sys.executable, "-c",
         "import json, chip_smoke; "
         f"print(json.dumps(chip_smoke.tp_profile({overlap!r})))"],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0,
          f"the tp profiled window ({overlap}): rc {proc.returncode}\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _rel_gaps(a: list, b: list) -> list[float]:
    return [abs(x - y) / abs(y) for x, y in zip(a, b)]


def _tp_full_width(rec: dict) -> None:
    """(a) The gpt_bf16 row at each width against tp = 1, the f32 gpt row
    at tp = 2, and where the time goes."""
    import math
    row = TRAIN_ROWS["gpt_bf16"]
    runs = {tp: _tp_steps(row, tp, TP_STEPS) for tp in TP_WIDTHS}
    prof = _tp_profile_fresh()
    base = runs[1]["losses"]
    out = {}
    for tp, r in runs.items():
        gaps = _rel_gaps(r["losses"], base)
        check(all(math.isfinite(v) for v in r["losses"])
              and r["losses"][-1] < r["losses"][0],
              f"gpt_bf16 at tp {tp}: losses do not fall: {r['losses']}")
        check(max(gaps) <= TP_BF16_RTOL,
              f"gpt_bf16 at tp {tp}: losses {r['losses']} vs tp 1 {base} "
              f"(max rel gap {max(gaps):.2e} > {TP_BF16_RTOL})")
        check(r["flash"] == (0, 0, 0),
              f"gpt_bf16 at tp {tp} launched flash kernels {r['flash']}")
        p50 = statistics.median(r["step_ms"])
        out[str(tp)] = dict(losses=r["losses"], max_rel_gap=max(gaps),
                            step_ms=r["step_ms"], step_ms_p50=p50,
                            peak_bytes=r["peak_bytes"], **prof[str(tp)])
        print(f"chip_smoke: tp (a) gpt_bf16 dense at tp {tp}: step p50 "
              f"{p50:.3f} ms, {prof[str(tp)]['kernel_launches_per_step']:.1f}"
              f" launches/step, device busy "
              f"{prof[str(tp)]['device_busy_share']:.4f}, peak "
              f"{r['peak_bytes'] / 2 ** 20:.1f} MiB; losses "
              f"{r['losses'][0]:.6f} -> {r['losses'][-1]:.6f}, max rel gap "
              f"to tp 1 {max(gaps):.2e}")
    row = TRAIN_ROWS["gpt"]
    one, two = (_tp_steps(row, tp, TP_STEPS) for tp in (1, 2))
    gaps = _rel_gaps(two["losses"], one["losses"])
    check(max(gaps) <= TP_F32_RTOL,
          f"f32 gpt at tp 2: losses {two['losses']} vs tp 1 {one['losses']} "
          f"(max rel gap {max(gaps):.2e} > {TP_F32_RTOL})")
    out["gpt_f32_tp2"] = dict(losses=two["losses"], max_rel_gap=max(gaps))
    print(f"chip_smoke: tp (a) f32 gpt row at tp 2: {TP_STEPS} SGD steps, "
          f"max rel gap to tp 1 {max(gaps):.2e}")
    rec["full_width"] = out


def _tp_cli(rec: dict, tmp: str) -> None:
    """(b) The CLI at --tp 2 against tp = 1: in one process (mlp, and gpt
    under 1F1B with clipping, at 2 stages), and gpt over two processes."""
    dims = ",".join(str(d) for d in TP_MLP_DIMS)
    data = ["--data-root", os.path.join(tmp, "nodata")]
    runs = {"mlp": ["--model", "mlp", "--mlp-dims", dims, "--stages", "2"],
            "gpt_1f1b": ["--model", "gpt", "--stages", "2", "--schedule",
                         "1f1b", "--clip-norm", "1.0"]}
    out = {}
    card = _stage_card()
    for name, argv in runs.items():
        one = _stage_cli(argv + data, tmp, f"{name}-tp1")
        two = _stage_cli(argv + data + ["--tp", "2"], tmp, f"{name}-tp2")
        place = "| pipeline: 2 stages x 2 model shards on " + ", ".join(
            [card] * 4)
        check(place in two["lines"], f"{name} --tp 2: no {place!r} line")
        gaps = _rel_gaps([two["train_loss"], two["eval_loss"]],
                         [one["train_loss"], one["eval_loss"]])
        check(max(gaps) <= STAGE_CLI_RTOL,
              f"{name} --tp 2: losses {two['train_loss']}/"
              f"{two['eval_loss']} vs tp 1 {one['train_loss']}/"
              f"{one['eval_loss']}")
        out[name] = dict(tp2=[two["train_loss"], two["eval_loss"]],
                         tp1=[one["train_loss"], one["eval_loss"]],
                         max_rel_gap=max(gaps))
        print(f"chip_smoke: tp (b) CLI {name} --tp 2, {STAGE_CLI_STEPS} "
              f"steps: train/eval {two['train_loss']:.6f}/"
              f"{two['eval_loss']:.6f}, tp 1 {one['train_loss']:.6f}/"
              f"{one['eval_loss']:.6f}, max rel gap {max(gaps):.2e}")
    argv = ["--model", "gpt", "--stages", "1", "--clip-norm", "1.0"] + data
    one = _stage_cli(argv, tmp, "gpt-procs-tp1", TP_CLI_STEPS)
    path = os.path.join(tmp, "gpt-procs-tp2.jsonl")
    t0 = time.perf_counter()
    (_, out0, _), (_, out1, _) = _launch_ranks(
        2, argv + ["--tp", "2", "--dryrun", str(TP_CLI_STEPS),
                   "--metrics-json", path])
    secs = time.perf_counter() - t0
    with open(path) as f:
        [m] = [json.loads(ln) for ln in f]
    gaps = _rel_gaps([m["train_loss"], m["eval_loss"]],
                     [one["train_loss"], one["eval_loss"]])
    check(max(gaps) <= STAGE_CLI_RTOL,
          f"gpt --tp 2 over 2 processes: losses {m['train_loss']}/"
          f"{m['eval_loss']} vs one process tp 1 {one['train_loss']}/"
          f"{one['eval_loss']}")
    check("| pipeline: 1 stages x 2 model shards on "
          + ", ".join([card] * 2) in out0,
          f"rank 0 printed no placement line: {out0[-2000:]}")
    check("Train Epoch" not in out1, f"rank 1 printed the console: {out1!r}")
    out["gpt_2_processes"] = dict(tp2=[m["train_loss"], m["eval_loss"]],
                                  tp1=[one["train_loss"], one["eval_loss"]],
                                  max_rel_gap=max(gaps), seconds=secs)
    print(f"chip_smoke: tp (b) CLI gpt --tp 2 over 2 processes (the model "
          f"axis over gloo), {TP_CLI_STEPS} steps: train/eval "
          f"{m['train_loss']:.6f}/{m['eval_loss']:.6f}, one process tp 1 "
          f"{one['train_loss']:.6f}/{one['eval_loss']:.6f}, max rel gap "
          f"{max(gaps):.2e}, {secs:.1f} s")
    rec["cli"] = out


_BLOCK_TORCH_JAX = (
    "import sys, runpy\n"
    "class B:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name in ('jax', 'torch') or name.startswith(\n"
    "                ('jax.', 'jaxlib', 'torch.')):\n"
    "            raise ImportError('blocked: ' + name)\n"
    "sys.meta_path.insert(0, B())\n"
    "sys.argv = [sys.argv[1]]\n"
    "runpy.run_path(sys.argv[0], run_name='__main__')\n")


def _tp_hostlint(rec: dict) -> None:
    """(c) ``--hostlint`` through the package, and the torch-free script
    in a subprocess with torch and jax blocked."""
    from simple_distributed_machine_learning_tpu_torch.analysis.__main__ import (  # noqa: E501
        main as analysis_main,
    )
    rc, text = _quiet(analysis_main, ["--hostlint"])
    check(rc == 0 and "analysis --hostlint: clean" in text,
          f"--hostlint rc {rc}: {text[-2000:]}")
    script = os.path.join(HERE, PORT, "analysis", "hostlint.py")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _BLOCK_TORCH_JAX, script],
                          cwd=HERE, capture_output=True, text=True,
                          timeout=120)
    ms = (time.perf_counter() - t0) * 1e3
    check(proc.returncode == 0 and "clean" in proc.stdout,
          f"torch-free hostlint rc {proc.returncode}: {proc.stdout[-1000:]}"
          f"{proc.stderr[-2000:]}")
    rec["hostlint"] = dict(package_rc=rc, script_rc=proc.returncode,
                           script_ms=ms)
    print(f"chip_smoke: tp (c) --hostlint clean; the torch-free script "
          f"exits 0 with torch and jax blocked ({ms:.0f} ms)")


def phase_tensor_parallel(record: dict) -> None:
    """Phase 17: tensor parallelism on the one card."""
    import tempfile
    rec: dict = {}
    record["tensor_parallel"] = rec
    secs = {}
    t0 = time.perf_counter()
    _tp_full_width(rec)
    secs["a"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        _tp_cli(rec, tmp)
    secs["b"] = time.perf_counter() - t0 - sum(secs.values())
    _tp_hostlint(rec)
    secs["c"] = time.perf_counter() - t0 - sum(secs.values())
    rec["seconds"] = dict(secs, total=time.perf_counter() - t0)
    print(f"chip_smoke: phase 17 took {rec['seconds']['total']:.1f} s ("
          + ", ".join(f"({k}) {v:.1f}" for k, v in secs.items()) + ")")


def _spep_cfg(run: tuple):
    """The gpt_bf16 row's config for one phase 18 run: ``("sp", attn,
    n_seq)`` or ``("ep", width)``; phase 19's ``("ep", width, "ring")``
    dispatches by the ring."""
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        GPTConfig,
    )
    row = TRAIN_ROWS["gpt_bf16"]["cfg"]
    if run[0] == "sp":
        return GPTConfig(**row, attn_impl=run[1], n_seq=run[2])
    return GPTConfig(**row, **EP_MOE, n_expert_parallel=run[1],
                     overlap=run[2] if len(run) > 2 else "none")


def _spep_pipe(run: tuple):
    """One phase 18 run's pipeline on the one card (weights from seed 0:
    every n_seq draws the same model, every expert width slices the same
    dense init) and its AdamW."""
    import torch
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        make_gpt_stages,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        Pipeline,
        make_mesh,
    )
    from simple_distributed_machine_learning_tpu_torch.train import adamw
    cfg = _spep_cfg(run)
    stages, wd, od = make_gpt_stages(0, cfg, 1, device=MAIN_DEVICE)
    q, e = cfg.n_seq, cfg.n_expert_parallel
    mesh = (make_mesh(1, n_seq=q, n_expert=e, devices=[_stage_card()] * q * e)
            if q * e > 1 else None)
    pipe = Pipeline(stages, mesh, wd, od, compute_dtype=torch.bfloat16,
                    overlap=cfg.overlap,
                    device=None if mesh else MAIN_DEVICE)
    return cfg, pipe, adamw(1e-3)


def _spep_steps(run: tuple, steps: int) -> dict:
    """``steps`` train steps of one run from fresh weights on one batch:
    the losses, each step's host-clock ms (synchronised), the peak memory,
    the flash launches and, after the steps, the aux term (the
    deterministic loss less its NLL)."""
    import torch

    from simple_distributed_machine_learning_tpu_torch.train import (
        make_train_step,
    )
    cfg, pipe, opt = _spep_pipe(run)
    x, t = _stage_batch(cfg, TRAIN_ROWS["gpt_bf16"]["batch"], 7)
    params = pipe.init_params()
    state = opt.init(params)
    step = make_train_step(pipe, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_flash_counts()
    losses, ms = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        params, state, loss = step(params, state, x, t, i)
        losses.append(float(loss))             # synchronises the step
        ms.append((time.perf_counter() - t0) * 1e3)
    flash = _flash_counts()
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        det = float(pipe.loss(params, x, t, deterministic=True))
        num, den, _ = pipe.eval_metrics(params, x, t)
    out = dict(losses=losses, step_ms=ms, peak_bytes=peak, flash=flash,
               aux=det - float(num) / float(den))
    del params, state, pipe
    torch.cuda.empty_cache()
    return out


def _spep_runs() -> list[tuple]:
    return ([("sp",) + r for r in SP_RUNS]
            + [("ep", w) for w in EP_WIDTHS])


def spep_profile() -> dict:
    """(a) and (b)'s profiled window: ``SPEP_PROFILED_STEPS`` steps of each
    run under ``torch.profiler`` after 2 warm-up steps — kernel launches
    per step and the device's busy share (run in a process of its own)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from simple_distributed_machine_learning_tpu_torch.train import (
        make_train_step,
    )
    out = {}
    for run in _spep_runs():
        cfg, pipe, opt = _spep_pipe(run)
        x, t = _stage_batch(cfg, TRAIN_ROWS["gpt_bf16"]["batch"], 7)
        params = pipe.init_params()
        state = opt.init(params)
        step = make_train_step(pipe, opt)
        for i in range(2):
            params, state, _ = step(params, state, x, t, i)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(SPEP_PROFILED_STEPS):
                params, state, _ = step(params, state, x, t, i)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy, launches = 0.0, 0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                busy += float(getattr(e, "self_device_time_total", None)
                              or getattr(e, "self_cuda_time_total", 0))
                launches += e.count
        n = SPEP_PROFILED_STEPS
        out[repr(run)] = dict(profiled_step_ms=wall_us / 1e3 / n,
                              device_busy_share=busy / wall_us,
                              device_ms_per_step=busy / 1e3 / n,
                              kernel_launches_per_step=launches / n)
        del params, state, pipe
        torch.cuda.empty_cache()
    return out


def _spep_profile_fresh() -> dict:
    proc = subprocess.run(
        [sys.executable, "-c",
         "import json, chip_smoke; "
         "print(json.dumps(chip_smoke.spep_profile()))"],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0,
          f"phase 18's profiled window: rc {proc.returncode}\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _spep_full_width(rec: dict) -> tuple[int, int, int]:
    """(a) SP at each (attention, n_seq) against the dense run, (b) the
    MoE at each expert width against ep 1, and where the time goes.
    Returns (b)'s K1/K2/K3 launches, summed over its runs."""
    import math
    runs = {run: _spep_steps(run, SPEP_STEPS) for run in _spep_runs()}
    prof = _spep_profile_fresh()
    n_layers = TRAIN_ROWS["gpt_bf16"]["cfg"]["n_layers"]
    base = {"sp": runs[("sp", "dense", 1)], "ep": runs[("ep", 1)]}
    out, launches = {}, [0, 0, 0]
    for run, r in runs.items():
        name = (f"{run[1]} n_seq {run[2]}" if run[0] == "sp"
                else f"moe ep {run[1]}")
        ref = base[run[0]]
        gaps = _rel_gaps(r["losses"], ref["losses"])
        check(all(math.isfinite(v) for v in r["losses"])
              and r["losses"][-1] < r["losses"][0],
              f"gpt_bf16 {name}: losses do not fall: {r['losses']}")
        check(max(gaps) <= SPEP_BF16_RTOL,
              f"gpt_bf16 {name}: losses {r['losses']} vs {ref['losses']} "
              f"(max rel gap {max(gaps):.2e} > {SPEP_BF16_RTOL})")
        aux_gap = (abs(r["aux"] - ref["aux"]) / abs(ref["aux"])
                   if run[0] == "ep" else 0.0)
        if run[0] == "sp":
            check(r["flash"] == (0, 0, 0),
                  f"gpt_bf16 {name} launched flash kernels {r['flash']}")
        else:
            check(r["aux"] > 0 and aux_gap <= SPEP_BF16_RTOL,
                  f"gpt_bf16 {name}: aux {r['aux']} vs ep 1's "
                  f"{ref['aux']} (rel gap {aux_gap:.2e})")
            want = (n_layers * SPEP_STEPS,) * 3
            check(r["flash"] == want,
                  f"gpt_bf16 {name}: K1/K2/K3 launched {r['flash']}, "
                  f"want {want} ({n_layers} a step)")
            launches = [a + b for a, b in zip(launches, r["flash"])]
        p = prof[repr(run)]
        p50 = statistics.median(r["step_ms"])
        out[name] = dict(losses=r["losses"], max_rel_gap=max(gaps),
                         aux=r["aux"], aux_rel_gap=aux_gap,
                         step_ms=r["step_ms"], step_ms_p50=p50,
                         peak_bytes=r["peak_bytes"], flash=r["flash"], **p)
        print(f"chip_smoke: sp/ep ({'a' if run[0] == 'sp' else 'b'}) "
              f"gpt_bf16 {name}: step p50 {p50:.3f} ms, "
              f"{p['kernel_launches_per_step']:.1f} launches/step, device "
              f"busy {p['device_busy_share']:.4f}, peak "
              f"{r['peak_bytes'] / 2 ** 20:.1f} MiB; losses "
              f"{r['losses'][0]:.6f} -> {r['losses'][-1]:.6f}, max rel gap "
              f"{max(gaps):.2e}" + ("" if run[0] == "sp" else
                                    f", aux {r['aux']:.6f} (gap "
                                    f"{aux_gap:.2e}), K1/K2/K3 "
                                    f"{r['flash']}"))
    rec["full_width"] = out
    return tuple(launches)


def _spep_cli(rec: dict, tmp: str) -> None:
    """(c) The CLI at --sp 2 and --experts 4 --ep 2 against their one-wide
    twins: at 2 stages in one process, at 1 stage over two (the two
    launches run together, beside the one-process runs)."""
    data = ["--data-root", os.path.join(tmp, "nodata")]
    one_stage = ["--model", "gpt", "--stages", "1"] + data
    procs_runs = (
        ("sp2-procs", ["--attn", "ring", "--sp", "2"], ["--attn", "ring"],
         "seq"),
        ("ep2-procs", ["--experts", "4", "--ep", "2"], ["--experts", "4"],
         "expert"))
    launch = {name: one_stage + wide + [
        "--dryrun", str(SPEP_CLI_STEPS), "--metrics-json",
        os.path.join(tmp, f"{name}.jsonl")]
        for name, wide, _, _ in procs_runs}
    t0 = time.perf_counter()
    started: dict = {}
    try:
        for name, argv in launch.items():
            started[name] = _start_ranks(2, argv)
        out = _spep_cli_one_process(tmp, data)
        ones = {name: _stage_cli(one_stage + twin, tmp, name + "-twin",
                                 SPEP_CLI_STEPS)
                for name, _, twin, _ in procs_runs}
        ranks = {name: _wait_ranks(started[name], argv)
                 for name, argv in launch.items()}
    finally:
        for procs in started.values():
            _kill_all(procs)
    secs = time.perf_counter() - t0
    card = _stage_card()
    for name, _, _, axis in procs_runs:
        one = ones[name]
        (_, out0, _), (_, out1, _) = ranks[name]
        with open(os.path.join(tmp, f"{name}.jsonl")) as f:
            [m] = [json.loads(ln) for ln in f]
        gaps = _rel_gaps([m["train_loss"], m["eval_loss"]],
                         [one["train_loss"], one["eval_loss"]])
        check(max(gaps) <= STAGE_CLI_RTOL,
              f"{name}: losses {m['train_loss']}/{m['eval_loss']} vs one "
              f"process {one['train_loss']}/{one['eval_loss']}")
        check(f"| pipeline: 1 stages x 2 {axis} shards on "
              + ", ".join([card] * 2) in out0,
              f"{name}: rank 0 printed no placement line: {out0[-2000:]}")
        check("Train Epoch" not in out1,
              f"{name}: rank 1 printed the console: {out1!r}")
        out[name] = dict(wide=[m["train_loss"], m["eval_loss"]],
                         twin=[one["train_loss"], one["eval_loss"]],
                         max_rel_gap=max(gaps), seconds=secs)
        print(f"chip_smoke: sp/ep (c) CLI {name} ({axis} axis over gloo), "
              f"{SPEP_CLI_STEPS} steps: train/eval {m['train_loss']:.6f}/"
              f"{m['eval_loss']:.6f}, one process one-wide "
              f"{one['train_loss']:.6f}/{one['eval_loss']:.6f}, max rel gap "
              f"{max(gaps):.2e}")
    print(f"chip_smoke: sp/ep (c) the two launches over two processes and "
          f"the one-process runs beside them: {secs:.1f} s")
    rec["cli"] = out


def _spep_cli_one_process(tmp: str, data: list[str]) -> dict:
    """(c)'s runs at 2 stages in one process, each against its one-wide
    twin."""
    gpt = ["--model", "gpt", "--stages", "2", "--microbatches", "2"] + data
    runs = {}
    for sched in ("gpipe", "1f1b"):
        twin = gpt + ["--schedule", sched, "--attn", "ring"]
        runs[f"sp1-{sched}"] = (twin, None)
        for attn in ("ring", "ulysses"):
            runs[f"{attn}-{sched}"] = (
                gpt + ["--schedule", sched, "--attn", attn, "--sp", "2"],
                f"sp1-{sched}")
    moe = gpt + ["--experts", "4", "--attn", "flash"]
    runs["ep1"] = (moe, None)
    runs["ep2"] = (moe + ["--ep", "2"], "ep1")
    card = _stage_card()
    got, out = {}, {}
    for name, (argv, twin) in runs.items():
        got[name] = _stage_cli(argv, tmp, name, SPEP_CLI_STEPS)
        if twin is None:
            continue
        axis = "seq" if "--sp" in argv else "expert"
        place = f"| pipeline: 2 stages x 2 {axis} shards on " + ", ".join(
            [card] * 4)
        check(place in got[name]["lines"], f"{name}: no {place!r} line")
        a, b = got[name], got[twin]
        gaps = _rel_gaps([a["train_loss"], a["eval_loss"]],
                         [b["train_loss"], b["eval_loss"]])
        check(max(gaps) <= STAGE_CLI_RTOL,
              f"CLI {name}: losses {a['train_loss']}/{a['eval_loss']} vs "
              f"{twin} {b['train_loss']}/{b['eval_loss']}")
        out[name] = dict(wide=[a["train_loss"], a["eval_loss"]],
                         twin=[b["train_loss"], b["eval_loss"]],
                         max_rel_gap=max(gaps))
        print(f"chip_smoke: sp/ep (c) CLI {name}, {SPEP_CLI_STEPS} steps: "
              f"train/eval {a['train_loss']:.6f}/{a['eval_loss']:.6f}, "
              f"{twin} {b['train_loss']:.6f}/{b['eval_loss']:.6f}, max rel "
              f"gap {max(gaps):.2e}")
    return out


def phase_seq_expert(record: dict) -> tuple[int, int, int]:
    """Phase 18: sequence and expert parallelism on the one card. Returns
    (b)'s K1/K2/K3 launches."""
    import tempfile
    rec: dict = {}
    record["seq_expert_parallel"] = rec
    t0 = time.perf_counter()
    launches = _spep_full_width(rec)
    secs = {"ab": time.perf_counter() - t0}
    with tempfile.TemporaryDirectory() as tmp:
        _spep_cli(rec, tmp)
    secs["c"] = time.perf_counter() - t0 - secs["ab"]
    rec["seconds"] = dict(secs, total=time.perf_counter() - t0)
    print(f"chip_smoke: phase 18 took {rec['seconds']['total']:.1f} s ("
          + ", ".join(f"({k}) {v:.1f}" for k, v in secs.items()) + ")")
    return launches


def _overlap_training(rec: dict, record: dict) -> tuple[int, int, int]:
    """(a) The gpt_bf16 row at each ``OVERLAP_WIDTHS`` width with
    ``overlap="ring"`` against phase 17's ``"none"`` run, and phase 18
    (b)'s MoE row at ep 2 with the ring dispatch against its all-to-all
    run. Returns the MoE run's K1/K2/K3 launches."""
    import math
    row = TRAIN_ROWS["gpt_bf16"]
    none = record["tensor_parallel"]["full_width"]
    prof = _tp_profile_fresh("ring")
    out = {}
    for tp in OVERLAP_WIDTHS:
        r = _tp_steps(row, tp, TP_STEPS, overlap="ring")
        base = none[str(tp)]["losses"]
        gaps = _rel_gaps(r["losses"], base)
        check(all(math.isfinite(v) for v in r["losses"])
              and r["losses"][-1] < r["losses"][0],
              f"gpt_bf16 ring at tp {tp}: losses do not fall: "
              f"{r['losses']}")
        check(max(gaps) <= TP_BF16_RTOL,
              f"gpt_bf16 ring at tp {tp}: losses {r['losses']} vs none "
              f"{base} (max rel gap {max(gaps):.2e} > {TP_BF16_RTOL})")
        check(r["flash"] == (0, 0, 0),
              f"gpt_bf16 ring at tp {tp} launched flash kernels "
              f"{r['flash']}")
        p, p50 = prof[str(tp)], statistics.median(r["step_ms"])
        out[f"ring tp {tp}"] = dict(
            losses=r["losses"], max_rel_gap=max(gaps), step_ms=r["step_ms"],
            step_ms_p50=p50, none_step_ms_p50=none[str(tp)]["step_ms_p50"],
            peak_bytes=r["peak_bytes"], **p)
        print(f"chip_smoke: overlap (a) gpt_bf16 ring at tp {tp}: step p50 "
              f"{p50:.3f} ms (none {none[str(tp)]['step_ms_p50']:.3f}), "
              f"{p['kernel_launches_per_step']:.1f} launches/step (none "
              f"{none[str(tp)]['kernel_launches_per_step']:.1f}), device "
              f"busy {p['device_busy_share']:.4f}, peak "
              f"{r['peak_bytes'] / 2 ** 20:.1f} MiB; max rel gap to none "
              f"{max(gaps):.2e}")
    moe = _spep_steps(("ep", 2, "ring"), SPEP_STEPS)
    base = record["seq_expert_parallel"]["full_width"]["moe ep 2"]
    gaps = _rel_gaps(moe["losses"], base["losses"])
    n_layers = row["cfg"]["n_layers"]
    want = (n_layers * SPEP_STEPS,) * 3
    check(max(gaps) <= SPEP_BF16_RTOL,
          f"MoE ep 2 ring: losses {moe['losses']} vs all-to-all "
          f"{base['losses']} (max rel gap {max(gaps):.2e})")
    check(moe["flash"] == want,
          f"MoE ep 2 ring: K1/K2/K3 launched {moe['flash']}, want {want}")
    p50 = statistics.median(moe["step_ms"])
    out["moe ep 2 ring"] = dict(losses=moe["losses"], max_rel_gap=max(gaps),
                                step_ms=moe["step_ms"], step_ms_p50=p50,
                                none_step_ms_p50=base["step_ms_p50"],
                                peak_bytes=moe["peak_bytes"],
                                flash=moe["flash"])
    print(f"chip_smoke: overlap (a) MoE ep 2 ring dispatch: step p50 "
          f"{p50:.3f} ms (all-to-all {base['step_ms_p50']:.3f}), peak "
          f"{moe['peak_bytes'] / 2 ** 20:.1f} MiB, K1/K2/K3 {moe['flash']}; "
          f"max rel gap to all-to-all {max(gaps):.2e}")
    rec["training"] = out
    return moe["flash"]


def _tp_engine_run(stages, cfg, tp: int, overlap: str = "none",
                   **engine_kw) -> tuple[dict, list]:
    """Phase 3's trace through a warmed fused engine at ``tp`` (every
    coordinate on the one card), with each tick's ``kv_drift`` pair
    recorded."""
    import dataclasses

    from simple_distributed_machine_learning_tpu_torch.parallel import (
        make_mesh,
    )
    c = dataclasses.replace(cfg, n_tensor_parallel=tp,
                            overlap=overlap if tp > 1 else "none")
    mesh = (make_mesh(1, n_model=tp, devices=[_stage_card()] * tp)
            if tp > 1 else None)
    engine = _warm_engine(stages, c, "fused", mesh=mesh, **engine_kw)
    drift = []
    inner = engine.kv_drift

    def recorded():
        out = inner()
        drift.append(out)
        return out

    engine.kv_drift = recorded
    return _serve(engine), drift


def _tp_serving(stages, cfg, serve: dict, plain_handles: list,
                rec: dict) -> int:
    """(b) Phase 3's trace on the tensor-parallel engine. Returns K4's
    launches."""
    import dataclasses

    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        make_gpt_stages,
    )
    from simple_distributed_machine_learning_tpu_torch.ops.random import (
        fold_in,
    )
    from simple_distributed_machine_learning_tpu_torch.serve.slots import (
        kv_block_bytes,
    )
    ps = serve["summary"]
    L, H = cfg.n_layers, cfg.n_heads
    dh = cfg.d_model // H
    greedy = [i for i, h in enumerate(plain_handles)
              if h.temperature == 0.0]
    out, launches = {}, 0

    def held(name, run, drift, tp, want, spec=False):
        rep, s, handles = run["report"], run["summary"], run["handles"]
        same = sum(handles[i].tokens == want[i].tokens for i in greedy)
        per_call = tp * L
        off = _off_ticks(run["rows"], per_call)
        live = [a for a, _ in drift]
        exact = all(a == b for a, b in drift)
        out[name] = dict(
            completed=rep["completed"], summary=s, launches=run["launches"],
            decode_calls=run["decode"], launches_per_call=per_call,
            ticks_off=off, tick_ms=run["tick_ms"],
            tick_ms_p50=run["tick_ms_p50"], greedy=len(greedy),
            greedy_equal=same, kv_bytes_max=max(live),
            kv_drift_exact=exact,
            # phase 21 holds the two-process streams to these
            greedy_tokens=[handles[i].tokens for i in greedy])
        print(f"chip_smoke: tp serve (b) {name}: {rep['completed']}/"
              f"{rep['n_requests']}, {s['tokens_per_sec']} tok/s (phase 3 "
              f"{ps['tokens_per_sec']}), ttft p50/p95 {s['ttft_ms_p50']}/"
              f"{s['ttft_ms_p95']} ms ({ps['ttft_ms_p50']}/"
              f"{ps['ttft_ms_p95']}), tpot p50/p95 {s['tpot_ms_p50']}/"
              f"{s['tpot_ms_p95']} ms ({ps['tpot_ms_p50']}/"
              f"{ps['tpot_ms_p95']}), tick p50 {run['tick_ms_p50']:.3f} ms "
              f"({serve['tick_ms_p50']:.3f}); K4 launches {run['launches']} "
              f"= {tp} shards x {L} layers x {run['decode']} decode calls; "
              f"per-shard KV bytes max {max(live)}, equal to the byte model "
              f"every tick: {exact}"
              + (" (not held: speculation reserves ahead)" if spec else "")
              + f"; greedy streams equal {same}/"
              f"{len(greedy)}")
        check(rep["completed"] == SERVE_SIM["n_requests"],
              f"tp serve {name}: {rep['completed']}/{rep['n_requests']}")
        check(run["decode"] > 0 and not off
              and run["launches"] == per_call * run["decode"],
              f"tp serve {name}: K4 launches {run['launches']} != {tp} x "
              f"{L} x {run['decode']} calls (ticks off: {off})")
        # a speculative tick allocates its spec_k positions before it
        # knows how many survive: its resident bytes run ahead of the
        # written rows the byte model counts, so only the plain runs are
        # held to it
        check((exact or spec) and max(live) > 0,
              f"tp serve {name}: per-shard KV bytes differ from the byte "
              f"model: {[d for d in drift if d[0] != d[1]][:4]}")
        check(len(greedy) >= 2 and same == len(greedy),
              f"tp serve {name}: greedy streams differ")
        return run["launches"]

    for tp, overlap in TP_SERVE_RUNS:
        run, drift = _tp_engine_run(stages, cfg, tp, overlap)
        launches += held(f"tp {tp} {overlap}", run, drift, tp,
                         plain_handles)
    # the per-shard pool: 1/tp of a block's bytes, by construction
    for tp in (2, 4):
        check(tp * kv_block_bytes(L, H // tp, SERVE_BLOCK, dh)
              == kv_block_bytes(L, H, SERVE_BLOCK, dh),
              f"a tp {tp} shard's block is not 1/{tp} of the whole")
    # the int8 pool at tp 2 against an int8 tp 1 engine
    one8, _ = _tp_engine_run(stages, cfg, 1, cache_dtype="int8")
    launches += one8["launches"]
    run, drift = _tp_engine_run(stages, cfg, 2, cache_dtype="int8")
    launches += held("tp 2 none int8", run, drift, 2, one8["handles"])
    # a tp 2 speculative target with the CLI's draft at spec_k 4
    dcfg = dataclasses.replace(cfg, n_layers=max(1, cfg.n_layers // 2))
    dstages = make_gpt_stages(fold_in(0, 1), dcfg, 1)[0]
    run, drift = _tp_engine_run(stages, cfg, 2, draft_stages=dstages,
                                draft_cfg=dcfg, spec_k=SPEC_K)
    launches += held("tp 2 spec_k 4", run, drift, 2, plain_handles,
                     spec=True)
    out["tp 2 spec_k 4"]["accept_rate"] = run["summary"].get(
        "spec_accept_rate")
    rec["serving"] = out
    return launches


def _tp_k4_heads(rec: dict) -> list[dict]:
    """(c) K4 on one shard's heads (``TP_SERVE_HEADS``), f32 and int8 at
    K = 1, against its plain version, timed as phase 2 times it."""
    import torch
    from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (  # noqa: E501
        paged_attention,
        paged_attention_reference,
    )
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(19)
    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=dev)
    out = []
    for heads in TP_SERVE_HEADS:
        for name in ("float32", "int8"):
            c = _pool_case(name, 1, gen, dev, heads=heads)
            args = (c["q"], c["kc"], c["vc"], c["tables"], c["qpos"])
            kw = dict(block_size=c["bs"], kscale=c["kscale"],
                      vscale=c["vscale"])
            v, ok, wide_ok = _against_plain(name, c)
            v["heads"] = heads
            v["bound_ms"], v["bound_by"] = _bound(c)
            v["ms"] = time_ms(lambda: paged_attention(*args, **kw), flush)
            v["plain_ms"] = time_ms(
                lambda: paged_attention_reference(*args, **kw), flush)
            out.append(v)
            print(f"chip_smoke: tp serve (c) paged_attention {name:>7} at "
                  f"{heads} heads ({SERVE_SLOTS} slots, K=1): vs plain max "
                  f"abs {v['max_abs_err']:.3e} {'ok' if ok else 'FAIL'}; "
                  f"kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms, "
                  f"bound {v['bound_ms']:.4f} ms ({v['bound_by']}): "
                  f"{v['ms'] / v['bound_ms']:.1f}x the bound")
            check(ok and wide_ok, f"paged_attention at {heads} heads "
                                  f"{name} disagrees: {v}")
    rec["k4_heads"] = out
    return out


def _tp_serve_cli(rec: dict, record: dict, tmp: str) -> int:
    """(d) The CLI at ``--serve-sim 8 --serve-tp 2`` and at ``--tp 2
    --overlap ring`` (one process, one stage; held to phase 17 (b)'s tp 1
    run). Returns the serving run's K4 launches."""
    from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (  # noqa: E501
        paged_attention,
    )
    card = _stage_card()
    l0 = paged_attention.launches
    lines = _cli(["--model", "gpt", "--serve-sim", "8", "--serve-tp", "2"])
    launches = paged_attention.launches - l0
    done = [ln for ln in lines
            if ln.startswith("| serve: 8/8 requests completed")]
    check(f"| serving: tp 2 on {card}, {card}" in lines and done
          and "| serve: tp 2" in lines and launches > 0,
          f"--serve-sim 8 --serve-tp 2 printed {lines} ({launches} K4 "
          f"launches)")
    print(f"chip_smoke: tp serve (d) CLI --serve-sim 8 --serve-tp 2: "
          f"{done[0]}; {launches} K4 launches")
    data = ["--data-root", os.path.join(tmp, "nodata")]
    argv = ["--model", "gpt", "--stages", "1", "--clip-norm", "1.0"] + data
    ring = _stage_cli(argv + ["--tp", "2", "--overlap", "ring"], tmp,
                      "gpt-ring-tp2", TP_CLI_STEPS)
    one = record["tensor_parallel"]["cli"]["gpt_2_processes"]["tp1"]
    gaps = _rel_gaps([ring["train_loss"], ring["eval_loss"]], one)
    place = "| pipeline: 1 stages x 2 model shards on " + ", ".join(
        [card] * 2)
    check(place in ring["lines"] and max(gaps) <= STAGE_CLI_RTOL,
          f"--tp 2 --overlap ring: losses {ring['train_loss']}/"
          f"{ring['eval_loss']} vs tp 1 {one} (placement line "
          f"{place in ring['lines']})")
    print(f"chip_smoke: tp serve (d) CLI gpt --tp 2 --overlap ring, "
          f"{TP_CLI_STEPS} steps: train/eval {ring['train_loss']:.6f}/"
          f"{ring['eval_loss']:.6f}, tp 1 {one[0]:.6f}/{one[1]:.6f}, max "
          f"rel gap {max(gaps):.2e}")
    rec["cli"] = dict(serve_lines=lines, serve_launches=launches,
                      ring=[ring["train_loss"], ring["eval_loss"]], tp1=one,
                      max_rel_gap=max(gaps))
    return launches


def phase_overlap_training(record: dict) -> tuple:
    """Phase 19 (a) and (d), in the second lane (they read phases 17 and
    18's records): the overlapped collectives in training and the CLI.
    Returns (a)'s K1/K2/K3 and (d)'s K4 launches."""
    import tempfile
    rec: dict = {}
    record["overlap_tp_serve"] = rec
    t0 = time.perf_counter()
    flash = _overlap_training(rec, record)
    secs = {"a": time.perf_counter() - t0}
    with tempfile.TemporaryDirectory() as tmp:
        launches = _tp_serve_cli(rec, record, tmp)
    secs["d"] = time.perf_counter() - t0 - secs["a"]
    rec["seconds_ad"] = dict(secs, total=time.perf_counter() - t0)
    print(f"chip_smoke: phase 19 (a), (d) took "
          f"{rec['seconds_ad']['total']:.1f} s ("
          + ", ".join(f"({k}) {v:.1f}" for k, v in secs.items()) + ")")
    return flash, launches


def phase_overlap_tp_serve(record: dict, serve: dict,
                           plain_handles: list) -> int:
    """Phase 19 (b) and (c): tensor-parallel serving on the one card.
    Returns K4's launches."""
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        GPTConfig,
        make_gpt_stages,
    )
    rec = record.setdefault("overlap_tp_serve", {})
    t0 = time.perf_counter()
    cfg = GPTConfig(**SERVE_CFG)
    stages = make_gpt_stages(0, cfg, 1)[0]
    launches = _tp_serving(stages, cfg, serve, plain_handles, rec)
    del stages
    secs = {"b": time.perf_counter() - t0}
    _tp_k4_heads(rec)
    secs["c"] = time.perf_counter() - t0 - secs["b"]
    rec["seconds_bc"] = dict(secs, total=time.perf_counter() - t0)
    print(f"chip_smoke: phase 19 (b), (c) took "
          f"{rec['seconds_bc']['total']:.1f} s ("
          + ", ".join(f"({k}) {v:.1f}" for k, v in secs.items()) + ")")
    return launches


# -- phase 20: the program linter on the card ----------------------------------

def _lint_training(rec: dict) -> tuple[int, int, int]:
    """(a) The training lint: ``lint``-style analysis of the gpt_bf16 row's
    exact step at full width (flash, bf16, AdamW) — host ms, K1-K3 counts
    and the allocator's peak at its start across the trace, the
    kernel nodes traced — then the CLI's ``--lint-only`` on the flash bf16
    GPT and LeNet (clean, exit 0), and a ``--lint`` run that trains with
    K1-K3 launched. Returns that run's K1-K3."""
    import torch

    from simple_distributed_machine_learning_tpu_torch.analysis import (
        abstractify,
        analyze,
        spec,
        trace,
    )
    from simple_distributed_machine_learning_tpu_torch.train import (
        make_train_step,
    )
    row = TRAIN_ROWS["gpt_bf16"]
    cfg, pipe, opt = _stage_pipe(1, 1)
    params = pipe.init_params()
    state = opt.init(params)
    B, T, V = row["batch"], cfg.seq_len, cfg.vocab
    args = (abstractify(params), abstractify(state),
            spec((B, T), torch.int64, 0, V - 1),
            spec((B, T), torch.int64, 0, V - 1), 0)
    step = make_train_step(pipe, opt)
    # earlier phases' garbage first: a collection inside the trace would
    # free their memory; the allocator's peak across the trace is what
    # an allocation by it would raise
    gc.collect()
    _sync()
    torch.cuda.reset_peak_memory_stats()
    counts, mem = _flash_counts(), torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    report = analyze(step, *args, name="train_step")
    lint_ms = (time.perf_counter() - t0) * 1e3
    _sync()
    peak, after = torch.cuda.max_memory_allocated(), \
        torch.cuda.memory_allocated()
    check(_flash_counts() == counts and peak == mem and after <= mem,
          f"(a) the trace launched or allocated: K1-K3 {counts} -> "
          f"{_flash_counts()}, memory {mem} -> peak {peak}, after {after}")
    check(report.ok(), f"(a) gpt_bf16 train step:\n{report.format()}")
    prog = trace.trace_program(step, *[abstractify(a) for a in args])
    nodes = [trace.op_name(n) for n in prog.graph.nodes]
    kn = tuple(nodes.count(f"sdml.{k}") for k in
               ("flash_forward", "flash_dq", "flash_dkv"))
    L = cfg.n_layers
    check(kn == (L, L, L), f"(a) K1-K3 nodes {kn} != {L} each")
    rec["train_lint"] = dict(lint_ms=lint_ms, nodes=len(nodes),
                             kernel_nodes=kn, findings=len(report.findings))
    print(f"chip_smoke: linter (a) gpt_bf16 train step traced and linted in "
          f"{lint_ms:.1f} ms (host clock), {len(nodes)} graph nodes, K1/K2/"
          f"K3 nodes {kn}, {len(report.findings)} findings; K1-K3 launches "
          f"unchanged, the allocator's peak across the trace its start "
          f"({mem} B)")
    del params, state, pipe, prog
    cli = {}
    for name, argv in (("gpt flash bf16", ["--model", "gpt", "--attn",
                                           "flash", "--bf16"]),
                       ("lenet", ["--model", "lenet"])):
        counts = _flash_counts()
        t0 = time.perf_counter()
        lines = _cli(argv + ["--lint-only", "--data-root", "/nonexistent"])
        s = time.perf_counter() - t0
        check("| --lint: preflight clean" in lines
              and not any(ln.startswith("Train Epoch") for ln in lines),
              f"(a) {name} --lint-only: {lines[-6:]}")
        check(_flash_counts() == counts, f"(a) {name} --lint-only launched")
        cli[name] = s
        print(f"chip_smoke: linter (a) CLI {name} --lint-only: preflight "
              f"clean in {s:.1f} s (host clock, build included)")
    _reset_flash_counts()
    lines = _cli(["--model", "gpt", "--attn", "flash", "--bf16", "--lint",
                  "--dryrun", str(LINT_TRAIN_STEPS), "--data-root",
                  "/nonexistent"])
    got = _flash_counts()
    check("| --lint: preflight clean" in lines
          and any(ln.startswith("Test set") for ln in lines),
          f"(a) --lint run: {lines[-6:]}")
    # the CLI's GPT has 2 layers: K2/K3 once a layer per trained step
    check(got[1] == got[2] == 2 * LINT_TRAIN_STEPS and got[0] > got[1],
          f"(a) --lint run: K1-K3 {got}")
    rec["train_cli"] = dict(lint_only_s=cli, lint_run_launches=got)
    print(f"chip_smoke: linter (a) --lint --dryrun {LINT_TRAIN_STEPS}: "
          f"preflight clean, then trained: K1/K2/K3 {got}")
    return got


def _traced_lint(step, args, mesh, name: str):
    """``analyze`` of ``step`` in its parts (one trace): the report, the
    graph's node count and the host seconds."""
    from simple_distributed_machine_learning_tpu_torch.analysis import (
        _unwrap_specs,
        analyze_program,
        trace,
    )
    t0 = time.perf_counter()
    a, kw, ranges, vary, positions = _unwrap_specs(args, {})
    prog = trace.trace_program(step, *a, name=name, **kw)
    report = analyze_program(prog, mesh=mesh, name=name, arg_ranges=ranges,
                             arg_vary=vary, arg_positions=positions)
    return report, len(prog.graph.nodes), time.perf_counter() - t0


def _lint_claims(rec: dict) -> tuple[int, int, int]:
    """(f) The claims on the model and expert axes at full width: the
    gpt_bf16 row's step at tp 2 (dense attention, as phase 17 runs it)
    and phase 18's MoE row at ep 2 (8 experts, top 2, flash), each traced
    and linted clean with no launch and nothing allocated, then with its
    defect seeded here — the model sum cut to one shard's part, the
    replicated leaves left untied over the expert axis — flagged on its
    axis; then the CLI's ``--lint`` at ``--tp 2`` and at ``--experts 8
    --ep 2 --attn flash``. Returns the MoE CLI run's K1-K3."""
    import tempfile

    import numpy as np
    import torch

    from simple_distributed_machine_learning_tpu_torch.analysis import (
        abstractify,
        spec,
    )
    from simple_distributed_machine_learning_tpu_torch.models import gpt
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        tensor as tensor_lib,
    )
    from simple_distributed_machine_learning_tpu_torch.train import (
        make_train_step,
    )
    row = TRAIN_ROWS["gpt_bf16"]

    def drop_model_sum():
        orig = tensor_lib.model_sum
        # BUG: each model coordinate keeps only its own partial product
        tensor_lib.model_sum = (lambda parts, group=None, axis="model",
                                size=None: parts[0])
        return lambda: setattr(tensor_lib, "model_sum", orig)

    def untie_experts():
        orig = gpt._grad_sync_non_tp

        def untied(shards, axis, path=(), sharded=None):
            # BUG: every leaf handled as its shard's own, the replicated
            # ones too: each copy keeps its own gradient
            return orig(shards, axis, path, lambda p: True)
        gpt._grad_sync_non_tp = untied
        return lambda: setattr(gpt, "_grad_sync_non_tp", orig)

    runs = (("tp2", "model", lambda: _tp_pipe(row, 2), drop_model_sum),
            ("ep2", "expert", lambda: _spep_pipe(("ep", 2)), untie_experts))
    out = {}
    for name, axis, build, seed_defect in runs:
        cfg, pipe, opt = build()
        params = pipe.init_params()
        state = opt.init(params)
        ids = spec((row["batch"], cfg.seq_len), torch.int64, 0,
                   cfg.vocab - 1)
        args = (abstractify(params), abstractify(state), ids, ids, 0)
        step = make_train_step(pipe, opt)
        gc.collect()
        _sync()
        torch.cuda.reset_peak_memory_stats()
        counts, mem = _flash_counts(), torch.cuda.memory_allocated()
        clean, nodes, secs = _traced_lint(step, args, pipe.mesh,
                                          f"{name} train_step")
        restore = seed_defect()
        try:
            bad, _, bad_secs = _traced_lint(step, args, pipe.mesh,
                                            f"{name} seeded defect")
        finally:
            restore()
        _sync()
        peak, after = torch.cuda.max_memory_allocated(), \
            torch.cuda.memory_allocated()
        check(_flash_counts() == counts and peak == mem and after <= mem,
              f"(f) {name}: the traces launched or allocated: K1-K3 "
              f"{counts} -> {_flash_counts()}, memory {mem} -> peak {peak}, "
              f"after {after}")
        # clean: no ERROR (the bf16 model sums warn low-precision-reduction,
        # as in phase 17's lint)
        check(clean.ok(), f"(f) {name} train step:\n{clean.format()}")
        flagged = [f for f in bad.findings
                   if f.rule == "unreduced-gradient.missing-reduce"
                   and f"['{axis}']" in f.message]
        check(flagged and not bad.ok(),
              f"(f) {name}: the seeded defect passed:\n{bad.format()}")
        warned = sorted({f.rule for f in clean.findings})
        out[name] = dict(nodes=nodes, lint_s=secs, defect_lint_s=bad_secs,
                         flagged=len(flagged), warnings=warned)
        print(f"chip_smoke: linter (f) {name} gpt_bf16 train step "
              f"({cfg.n_layers} layers, d {cfg.d_model}): clean (no ERROR; "
              f"{len(clean.findings)} WARNING {warned}), {nodes} graph "
              f"nodes, traced and linted in {secs:.2f} s (host clock), no "
              f"launch, memory unchanged ({mem} B); the seeded defect "
              f"flagged {len(flagged)} x missing-reduce on '{axis}' in "
              f"{bad_secs:.2f} s")
        del params, state, pipe, args, step
        torch.cuda.empty_cache()
    cli = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-claims-") as tmp:
        data = ["--data-root", os.path.join(tmp, "nodata")]
        for name, argv in (("tp2", ["--tp", "2"]),
                           ("ep2", ["--experts", "8", "--ep", "2", "--attn",
                                    "flash"])):
            counts = _flash_counts()
            r = _stage_cli(["--model", "gpt", "--lint"] + argv + data, tmp,
                           f"claims-{name}", LINT_TRAIN_STEPS)
            got = tuple(a - b for a, b in zip(_flash_counts(), counts))
            check("| --lint: preflight clean" in r["lines"]
                  and any(ln.startswith("Test set") for ln in r["lines"])
                  and np.isfinite([r["train_loss"], r["eval_loss"]]).all(),
                  f"(f) --lint {' '.join(argv)}: {r['lines'][-6:]}")
            # the CLI's GPT has 2 layers: K2/K3 once a layer per step
            want = 2 * LINT_TRAIN_STEPS if name == "ep2" else 0
            check(got[1] == got[2] == want and got[0] >= got[1],
                  f"(f) --lint {' '.join(argv)}: K1-K3 {got}")
            cli[name] = dict(train_loss=r["train_loss"],
                             eval_loss=r["eval_loss"], flash=got)
            print(f"chip_smoke: linter (f) CLI --lint {' '.join(argv)} "
                  f"--dryrun {LINT_TRAIN_STEPS}: preflight clean, then "
                  f"trained: train/eval loss {r['train_loss']:.6f}/"
                  f"{r['eval_loss']:.6f}, K1/K2/K3 {got}")
    rec["claims"] = dict(steps=out, cli=cli)
    return cli["ep2"]["flash"]


def _lint_engine_run(stages, cfg, tp: int) -> tuple[dict, dict]:
    """An ``InferenceEngine(lint=True, attn_kernel="fused")`` at ``tp``
    (its coordinates on the one card): the construction (its lint
    included) and the lint alone on the built engine, timed, with K4's
    count unchanged across it; then phase 3's trace through it."""
    import dataclasses

    import numpy as np

    from simple_distributed_machine_learning_tpu_torch.analysis.programs import (  # noqa: E501
        lint_engine,
    )
    from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (  # noqa: E501
        paged_attention,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        make_mesh,
    )
    from simple_distributed_machine_learning_tpu_torch.serve import (
        InferenceEngine,
        ServeMetrics,
    )
    c = dataclasses.replace(cfg, n_tensor_parallel=tp)
    mesh = (make_mesh(1, n_model=tp, devices=[_stage_card()] * tp)
            if tp > 1 else None)
    k4 = paged_attention.launches
    t0 = time.perf_counter()
    engine = InferenceEngine(stages, c, n_slots=SERVE_SLOTS,
                             block_size=SERVE_BLOCK, attn_kernel="fused",
                             mesh=mesh, lint=True)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    report = lint_engine(engine)
    lint_ms = (time.perf_counter() - t0) * 1e3
    check(paged_attention.launches == k4,
          f"(b) tp {tp}: the lint launched K4")
    # a live engine declares no prompt buckets and this one no prefill
    # chunk: the retrace policy's WARNING stands, ERRORs gate
    check(report.ok() and {f.rule for f in report.findings}
          <= {"retrace-explosion.unbounded-trace-key"},
          f"(b) tp {tp} engine lint:\n{report.format()}")
    rows = {(h.program, h.op): h.bytes_per_tick for h in report.hbm}
    want = rows[("paged_decode", "decode.kv_gather")]
    check(rows.get(("paged_decode", "kernel.kv_stream")) == tp * want,
          f"(b) tp {tp}: K4 nodes' bytes {rows.get(('paged_decode', 'kernel.kv_stream'))} "  # noqa: E501
          f"!= {tp} x the model's {want}")
    for t in SERVE_SIM["prompt_lens"]:
        engine.submit(np.zeros(t, np.int32), max_new_tokens=2)
    engine.drain()
    engine.metrics = ServeMetrics()
    run = _serve(engine)
    return run, dict(build_s=build_s, lint_ms=lint_ms,
                     programs=len({h.program for h in report.hbm}),
                     kv_stream=rows[("paged_decode", "kernel.kv_stream")],
                     model_kv_gather=want)


def _lint_serving(stages, cfg, serve: dict, plain_handles: list,
                  rec: dict) -> int:
    """(b) Phase 3's trace through ``InferenceEngine(lint=True,
    attn_kernel="fused")`` at tp 1 and 2: the lint clean, its ms, K4's
    derived bytes equal to the model's; 24/24, the greedy streams equal
    to phase 3's, K4 exactly ``tp x n_layers`` per decode call. Returns
    K4's launches."""
    L = cfg.n_layers
    greedy = [i for i, h in enumerate(plain_handles)
              if h.temperature == 0.0]
    out, launches = {}, 0
    for tp in (1, 2):
        run, lint = _lint_engine_run(stages, cfg, tp)
        handles = run["handles"]
        same = sum(handles[i].tokens == plain_handles[i].tokens
                   for i in greedy)
        off = _off_ticks(run["rows"], tp * L)
        check(run["report"]["completed"] == SERVE_SIM["n_requests"],
              f"(b) tp {tp}: {run['report']['completed']} completed")
        check(run["decode"] > 0 and not off
              and run["launches"] == tp * L * run["decode"],
              f"(b) tp {tp}: K4 {run['launches']} != {tp} x {L} x "
              f"{run['decode']} (ticks off: {off})")
        check(len(greedy) >= 2 and same == len(greedy),
              f"(b) tp {tp}: greedy streams {same}/{len(greedy)}")
        launches += run["launches"]
        out[f"tp {tp}"] = dict(lint, launches=run["launches"],
                               decode_calls=run["decode"], greedy=same,
                               tick_ms_p50=run["tick_ms_p50"])
        print(f"chip_smoke: linter (b) InferenceEngine(lint=True) tp {tp}: "
              f"lint {lint['lint_ms']:.1f} ms (host clock; construction "
              f"with it {lint['build_s']:.1f} s), K4 nodes' K/V bytes "
              f"{lint['kv_stream']} = {tp} x the model's "
              f"{lint['model_kv_gather']}; served {run['report']['completed']}"
              f"/{SERVE_SIM['n_requests']}, K4 {run['launches']} = {tp} x {L}"
              f" x {run['decode']} decode calls, greedy streams equal "
              f"{same}/{len(greedy)}, tick p50 {run['tick_ms_p50']:.3f} ms "
              f"(phase 3 {serve['tick_ms_p50']:.3f})")
    rec["serving"] = out
    return launches


def _lint_cli_gates(rec: dict) -> int:
    """(c) The CLI gates: ``--serve-sim 8 --lint`` passes (its protocol
    line), ``SDML_LINT_INJECT=drill`` makes ``--lint-only`` exit 2 on the
    serving and the training gate. Returns K4's launches."""
    from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (  # noqa: E501
        paged_attention,
    )
    paged_attention.launches = 0
    t0 = time.perf_counter()
    lines = _cli(["--model", "gpt", "--serve-sim", "8", "--lint"])
    s = time.perf_counter() - t0
    k4 = paged_attention.launches
    proto = [ln for ln in lines if ln.startswith("| serve --lint protocol")]
    check(proto and "| serve --lint: preflight clean" in lines
          and any("8/8 requests completed" in ln for ln in lines) and k4,
          f"(c) --serve-sim 8 --lint: {lines[-8:]}")
    drills = {}
    for name, argv in (("serve", ["--model", "gpt", "--serve-sim", "8"]),
                       ("train", ["--model", "lenet", "--data-root",
                                  "/nonexistent"])):
        os.environ["SDML_LINT_INJECT"] = "drill"
        try:
            _cli(argv + ["--lint-only"])
            code = 0
        except SystemExit as e:
            code = e.code
        finally:
            del os.environ["SDML_LINT_INJECT"]
        check(code == 2, f"(c) {name} drill exited {code}, not 2")
        drills[name] = code
    rec["cli_gates"] = dict(serve_lint_s=s, protocol=proto[0], k4=k4,
                            drills=drills)
    print(f"chip_smoke: linter (c) --serve-sim 8 --lint: 8/8 in {s:.1f} s, "
          f"{proto[0]}; SDML_LINT_INJECT --lint-only exits "
          f"{drills['serve']} (serve) and {drills['train']} (train)")
    return k4


ANALYSIS_RUNS = (
    ("dryrun 8 + serve + fixtures", ["--dryrun", "8", "--serve", "--fixtures"],
     ["analysis --dryrun 8: 4 steps clean",
      "analysis --serve: 9 layouts clean", "fixture self-test: OK"]),
    ("dryrun 4", ["--dryrun", "4"], ["analysis --dryrun 4: 3 steps clean"]))


def start_analysis_cli() -> list:
    """Start (d)'s analysis CLI runs, each in a process of its own, so they
    run beside phases 14-20 (c); ``_lint_analysis_cli`` collects them."""
    import tempfile
    out = []
    for label, argv, want in ANALYSIS_RUNS:
        # files, not pipes: nothing reads them until (d)
        logs = (tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
        out.append((label, argv, want, logs, time.perf_counter(),
                    subprocess.Popen(
                        [sys.executable, "-m", f"{PORT}.analysis", *argv,
                         "--device", MAIN_DEVICE], cwd=HERE,
                        env=dict(os.environ), stdout=logs[0],
                        stderr=logs[1], text=True)))
    return out


def _lint_analysis_cli(rec: dict, started: list) -> None:
    """(d) The analysis CLI, each in a process of its own: ``--dryrun 8
    --serve --fixtures`` (the modes compose: one process) and ``--dryrun
    4``, exit 0; every fixture meets its contract."""
    runs = {}
    try:
        for label, argv, want, logs, t0, proc in started:
            proc.wait(timeout=900)
            s = time.perf_counter() - t0
            stdout, stderr = (_rewind(f) for f in logs)
            lines = stdout.splitlines()
            bad = [ln for ln in lines if "CONTRACT VIOLATED" in ln]
            check(proc.returncode == 0 and all(w in lines for w in want)
                  and not bad,
                  f"(d) analysis {label}: rc {proc.returncode} {bad}\n"
                  f"{stdout[-3000:]}\n{stderr[-3000:]}")
            runs[label] = dict(rc=proc.returncode, s=s)
            print(f"chip_smoke: linter (d) analysis {' '.join(argv)}: rc 0 "
                  f"in {s:.1f} s from its start beside phases 14-20 (c) — "
                  + "; ".join(want))
    finally:
        _kill_all([proc for *_, proc in started])
    rec["analysis_cli"] = runs


def _rewind(f) -> str:
    f.seek(0)
    return f.read()


def _lint_ici(record: dict, rec: dict) -> None:
    """(e) The collective-bytes gauge of phase 16 (b)'s processes: each
    rank's ``ici_bytes_per_step`` (its traced step's sends and sums)
    against the wire's bytes per step on the real steps (``WIRE``): equal
    but for the loss's two f64 summed over the world, 16 B, named."""
    ici = record.get("processes", {}).get("ici")
    check(ici is not None and len(ici) == 3, "(e) phase 16 (b) recorded no "
                                             "gauge")
    one, ranks = ici[0], ici[1:]
    out = []
    for r, g in enumerate(ranks):
        diff = g["ici_bytes_per_step"] - g["wire_bytes_per_step"]
        rows = [c for c in g["top"] if c["prim"] == "psum"
                and c["bytes_per_step"]]
        check(diff == 16 and [c["bytes_per_step"] for c in rows] == [16]
              and g["table_bytes_per_step"] == g["ici_bytes_per_step"],
              f"(e) rank {r}: gauge {g['ici_bytes_per_step']} - wire "
              f"{g['wire_bytes_per_step']} = {diff}, psum rows {rows}")
        out.append(dict(rank=r, ici=g["ici_bytes_per_step"],
                        wire=g["wire_bytes_per_step"],
                        sends=g["wire_sends_per_step"],
                        trace_ms=g["trace_ms"]))
        print(f"chip_smoke: linter (e) rank {r}: ici_bytes_per_step "
              f"{g['ici_bytes_per_step']} = WIRE {g['wire_bytes_per_step']:.0f}"
              f" B/step ({g['wire_sends_per_step']:.0f} sends) + 16 B (the "
              f"loss psum over the world, which WIRE's sends do not count); "
              f"probe trace {g['trace_ms']:.0f} ms")
    # one process holds both stages: its 4 microbatches hop in the card,
    # activation forward and cotangent back, [4, 256, 512] bf16 each (the
    # dropout state travels with the activation, unbilled)
    row = TRAIN_ROWS["gpt_bf16"]
    act = (row["batch"] // 4 * row["cfg"]["seq_len"] * row["cfg"]["d_model"]
           * 2)
    check(one["wire_bytes_per_step"] == 0
          and one["ici_bytes_per_step"] == 2 * 4 * act,
          f"(e) one process: gauge {one['ici_bytes_per_step']} != 8 hops "
          f"of {act} B (wire {one['wire_bytes_per_step']})")
    print(f"chip_smoke: linter (e) one process, both stages: "
          f"ici_bytes_per_step {one['ici_bytes_per_step']} = 8 in-card hops "
          f"of {act} B; the two ranks' wire: "
          f"{[g['wire_bytes_per_step'] for g in ranks]} B/step")
    rec["ici"] = dict(ranks=out, one_process=one["ici_bytes_per_step"])


def phase_program_lint(record: dict, serve: dict, plain_handles: list,
                       analysis: list) -> tuple[tuple, int]:
    """Phase 20 (a)-(d) and (f): the program linter on the card ((e) reads
    phase 16's record, so ``main`` runs it once the second lane is
    joined). Returns (a) and (f)'s K1-K3 and (b)-(c)'s K4 launches."""
    import torch

    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        GPTConfig,
        make_gpt_stages,
    )
    rec: dict = {}
    record["program_lint"] = rec
    secs = {}
    t0 = time.perf_counter()
    flash = _lint_training(rec)
    secs["a"] = time.perf_counter() - t0
    cfg = GPTConfig(**SERVE_CFG)
    stages = make_gpt_stages(0, cfg, 1, device=MAIN_DEVICE)[0]  # phase 3's
    k4 = _lint_serving(stages, cfg, serve, plain_handles, rec)
    del stages
    torch.cuda.empty_cache()
    secs["b"] = time.perf_counter() - t0 - sum(secs.values())
    k4 += _lint_cli_gates(rec)
    secs["c"] = time.perf_counter() - t0 - sum(secs.values())
    _lint_analysis_cli(rec, analysis)
    secs["d"] = time.perf_counter() - t0 - sum(secs.values())
    claims = _lint_claims(rec)
    flash = tuple(a + b for a, b in zip(flash, claims))
    secs["f"] = time.perf_counter() - t0 - sum(secs.values())
    rec["seconds"] = dict(secs, total=time.perf_counter() - t0)
    print(f"chip_smoke: phase 20 took {rec['seconds']['total']:.1f} s ("
          + ", ".join(f"({k}) {v:.1f}" for k, v in secs.items()) + ")")
    return flash, k4


# -- phase 21: serving across processes on the one card -------------------

def serve_rank_worker(rank: int, world: int, port: int,
                      out_path: str) -> None:
    """(a)'s process (``python3 chip_smoke.py --serve-worker RANK WORLD
    PORT OUT``): phase 3's weights and trace through the fused
    tensor-parallel engine over a ``SERVE_RANKS_TP``-wide model mesh split
    over ``world`` processes on the one card, warmed as phase 3 warms;
    per decode call its K4 launches and the sums and bytes it put on the
    wire, per tick its ``kv_drift`` pair."""
    import dataclasses

    import torch
    sys.path.insert(0, HERE)
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        GPTConfig,
        make_gpt_stages,
    )
    from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (  # noqa: E501
        paged_attention,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        mesh as mesh_lib,
    )
    mesh_lib.bootstrap_distributed(rank, world, "localhost", port,
                                   timeout_s=120)
    cfg = GPTConfig(**SERVE_CFG)
    stages = make_gpt_stages(0, cfg, 1)[0]
    card = _stage_card()
    mesh = mesh_lib.make_mesh(1, n_model=SERVE_RANKS_TP,
                              devices=[card] * SERVE_RANKS_TP)
    engine = _warm_engine(
        stages, dataclasses.replace(cfg, n_tensor_parallel=SERVE_RANKS_TP),
        "fused", mesh=mesh)
    calls: list[dict] = []
    decode = engine._decode

    def counted(*args):
        w0, l0 = dict(mesh_lib.WIRE), paged_attention.launches
        out = decode(*args)
        calls.append(dict(
            launches=paged_attention.launches - l0,
            **{k: mesh_lib.WIRE[k] - w0[k] for k in mesh_lib.WIRE}))
        return out

    engine._decode = counted
    drift = []
    inner = engine.kv_drift

    def recorded():
        pair = inner()
        drift.append(pair)
        return pair

    engine.kv_drift = recorded
    # where a sum's time goes: the wait for this process's own kernels
    # (the host copy syncs on them anyway) and the gloo exchange, which
    # holds the wait for the peer
    split: dict = {"device_ms": [], "wire_ms": []}
    all_reduce = mesh_lib.all_reduce

    def timed(t, group=None, axes=()):
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = all_reduce(t, group, axes)
        split["device_ms"].append((t1 - t0) * 1e3)
        split["wire_ms"].append((time.perf_counter() - t1) * 1e3)
        return out

    mesh_lib.all_reduce = timed
    w0 = dict(mesh_lib.WIRE)
    run = _serve(engine)
    mesh_lib.all_reduce = all_reduce
    rec = dict(
        rank=rank, owned=list(mesh.view(0, 0, "model").owned),
        completed=run["report"]["completed"], summary=run["summary"],
        tokens=[h.tokens for h in run["handles"]],
        greedy=[h.temperature == 0.0 for h in run["handles"]],
        launches=run["launches"], decode_calls=run["decode"],
        per_call=calls, drift=drift, tick_ms=run["tick_ms"],
        tick_ms_p50=run["tick_ms_p50"],
        wire={k: mesh_lib.WIRE[k] - w0[k] for k in mesh_lib.WIRE},
        ticks=len(run["rows"]),
        sum_device_ms_p50=statistics.median(split["device_ms"]),
        sum_wire_ms_p50=statistics.median(split["wire_ms"]),
        sum_device_ms_per_tick=sum(split["device_ms"]) / len(run["rows"]),
        sum_wire_ms_per_tick=sum(split["wire_ms"]) / len(run["rows"]))
    with open(out_path, "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()


def _serve_rank_workers(tmp: str) -> list[dict]:
    """``SERVE_RANKS_WORLD`` fresh ``--serve-worker`` processes; their
    records by rank."""
    port = _free_port()
    outs = [os.path.join(tmp, f"serve-rank{r}.json")
            for r in range(SERVE_RANKS_WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--serve-worker",
         str(r), str(SERVE_RANKS_WORLD), str(port), outs[r]],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_child_env(), cwd=HERE) for r in range(SERVE_RANKS_WORLD)]
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=PROC_TIMEOUT_S)
            check(p.returncode == 0, f"serve ranks (a) rank {r} exited "
                                     f"{p.returncode}: {err[-2000:]}")
    finally:
        _kill_all(procs)
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    return ranks


def _serve_ranks_engine(rec: dict, record: dict, serve: dict,
                        plain_handles: list) -> int:
    """(a) Phase 3's trace on the TP engine over two processes. Returns
    K4's launches, summed over the ranks."""
    import tempfile

    from simple_distributed_machine_learning_tpu_torch.serve.slots import (
        kv_block_bytes,
    )
    cfg = SERVE_CFG
    L, d = cfg["n_layers"], cfg["d_model"]
    per_call = SERVE_RANKS_TP // SERVE_RANKS_WORLD * L
    # the wire per decode call: the attention output's and the MLP pair's
    # sums of every layer, one [n_slots, 1, d_model] f32 row block each
    sums_per_call = 2 * L
    bytes_per_call = sums_per_call * SERVE_SLOTS * d * 4
    with tempfile.TemporaryDirectory() as tmp:
        ranks = _serve_rank_workers(tmp)
    greedy = [i for i, h in enumerate(plain_handles)
              if h.temperature == 0.0]
    phase3 = [plain_handles[i].tokens for i in greedy]
    tp2 = record["overlap_tp_serve"]["serving"]["tp 2 none"]
    one_tp2_p50 = tp2["tick_ms_p50"]
    launches = 0
    for r, g in enumerate(ranks):
        calls = g["per_call"]
        mine = [g["tokens"][i] for i in greedy]
        exact = all(a == b for a, b in g["drift"])
        live = max(a for a, _ in g["drift"])
        h = cfg["n_heads"] // SERVE_RANKS_TP
        shard_block = kv_block_bytes(L, h, SERVE_BLOCK, d // cfg["n_heads"])
        s = g["summary"]
        print(f"chip_smoke: serve ranks (a) rank {r} (model coordinate(s) "
              f"{g['owned']}): {g['completed']}/{SERVE_SIM['n_requests']}, "
              f"{s['tokens_per_sec']} tok/s, ttft p50/p95 "
              f"{s['ttft_ms_p50']}/{s['ttft_ms_p95']} ms, tpot p50/p95 "
              f"{s['tpot_ms_p50']}/{s['tpot_ms_p95']} ms; tick p50 "
              f"{g['tick_ms_p50']:.3f} ms (phase 19 (b) one-process tp 2 "
              f"{one_tp2_p50:.3f}, phase 3 {serve['tick_ms_p50']:.3f}); K4 "
              f"{g['launches']} = {per_call} x {g['decode_calls']} decode "
              f"calls; per decode call {sums_per_call} sums of "
              f"{bytes_per_call // sums_per_call} B: "
              f"{sorted({c['sums'] for c in calls})} sums, "
              f"{sorted({c['sum_bytes'] for c in calls})} B; wire over the "
              f"trace {g['wire']}; per-shard KV bytes max {live} (a block "
              f"{shard_block} B), equal to the byte model every tick: "
              f"{exact}; greedy streams equal to phase 3's "
              f"{sum(a == b for a, b in zip(mine, phase3))}/{len(greedy)}; "
              f"a sum's p50 {g['sum_device_ms_p50']:.3f} ms waiting for "
              f"its own kernels + {g['sum_wire_ms_p50']:.3f} ms on gloo, "
              f"per tick {g['sum_device_ms_per_tick']:.3f} + "
              f"{g['sum_wire_ms_per_tick']:.3f} ms")
        check(g["completed"] == SERVE_SIM["n_requests"],
              f"serve ranks rank {r}: {g['completed']}/"
              f"{SERVE_SIM['n_requests']}")
        check(g["decode_calls"] > 0 and len(calls) == g["decode_calls"]
              and all(c["launches"] == per_call for c in calls)
              and g["launches"] == per_call * g["decode_calls"],
              f"serve ranks rank {r}: K4 per decode call "
              f"{sorted({c['launches'] for c in calls})} != {per_call}")
        check(all(c["sums"] == sums_per_call
                  and c["sum_bytes"] == bytes_per_call
                  and c["sends"] == 0 for c in calls),
              f"serve ranks rank {r}: the wire per decode call differs "
              f"from {sums_per_call} sums of {bytes_per_call} B: "
              f"{calls[:3]}")
        check(g["wire"]["broadcast_bytes"] == 8 * g["wire"]["broadcasts"]
              > 0, f"serve ranks rank {r}: the clock broadcasts "
                   f"{g['wire']}")
        check(exact and live > 0 and live % shard_block == 0,
              f"serve ranks rank {r}: per-shard KV bytes differ from the "
              f"byte model: {[p for p in g['drift'] if p[0] != p[1]][:4]}")
        check(len(greedy) >= 2 and mine == phase3
              and mine == tp2["greedy_tokens"],
              f"serve ranks rank {r}: greedy streams differ from phase 3's "
              f"or phase 19 (b)'s one-process tp 2")
        launches += g["launches"]
    check(ranks[0]["tokens"] == ranks[1]["tokens"]
          and ranks[0]["wire"] == ranks[1]["wire"],
          "serve ranks: the two ranks' streams or wire counts differ")
    rec["engine"] = dict(
        ranks=[{k: v for k, v in g.items() if k not in ("per_call", "drift",
                                                         "tokens")}
               for g in ranks],
        launches_per_call=per_call, sums_per_call=sums_per_call,
        sum_bytes_per_call=bytes_per_call,
        one_process_tp2_tick_ms_p50=one_tp2_p50,
        phase3_tick_ms_p50=serve["tick_ms_p50"],
        greedy=len(greedy))
    return launches


def _serve_ranks_cli(rec: dict) -> None:
    """(b) The CLI over two processes: ``--serve-sim`` at tp 1 and at
    ``--serve-tp 2`` (both ranks 0-exit with equal request and token
    counts, every rank printing), ``--scenario steady`` (both ranks print
    the one-process run's lines, made in this call)."""
    done = re.compile(r"^\| serve: (\d+/\d+) requests completed, (\d+) "
                      r"tokens")
    base = ["--model", "gpt", "--serve-sim", str(SERVE_RANKS_CLI_N)]
    runs = {"tp1": base, "tp2": base + ["--serve-tp", "2"],
            "scenario": ["--scenario", "steady"]}
    # the three launches run together, beside the one-process run
    t0 = time.perf_counter()
    started: dict = {}
    try:
        for name, argv in runs.items():
            started[name] = _start_ranks(2, argv)
        one = [ln for ln in _cli(["--scenario", "steady"])
               if ln.startswith("| scenario")]
        done_ranks = {name: _wait_ranks(started[name], argv)
                      for name, argv in runs.items()}
    finally:
        for procs in started.values():
            _kill_all(procs)
    launch_s = time.perf_counter() - t0
    out = {}
    for name in ("tp1", "tp2"):
        ranks = done_ranks[name]
        counts = [[m.groups() for m in map(done.match, so.splitlines()) if m]
                  for _, so, _ in ranks]
        check(len(counts[0]) == 1 and counts[0] == counts[1]
              and counts[0][0][0] == f"{SERVE_RANKS_CLI_N}/"
                                     f"{SERVE_RANKS_CLI_N}"
              and all(("| serve: tp 2" in so) == (name == "tp2")
                      for _, so, _ in ranks),
              f"--serve-sim over two processes ({name}): {counts} "
              f"{[so for _, so, _ in ranks]}")
        out[name] = dict(counts=counts[0][0])
        print(f"chip_smoke: serve ranks (b) CLI --serve-sim "
              f"{SERVE_RANKS_CLI_N}{' --serve-tp 2' if name == 'tp2' else ''}"
              f" --world_size 2: both ranks exit 0, {counts[0][0][0]} "
              f"requests, {counts[0][0][1]} tokens each")
    lines = [[ln for ln in so.splitlines() if ln.startswith("| scenario")]
             for _, so, _ in done_ranks["scenario"]]
    check(len(one) >= 3 and lines[0] == one and lines[1] == one,
          f"--scenario steady over two processes: {lines} vs one process "
          f"{one}")
    out["scenario_steady"] = one
    out["launch_s"] = launch_s
    print(f"chip_smoke: serve ranks (b) CLI --scenario steady --world_size "
          f"2: both ranks print the one-process run's {len(one)} lines "
          f"({one[-1]}); the three two-process launches together "
          f"{launch_s:.1f} s")
    rec["cli"] = out


def phase_serve_ranks(record: dict, serve: dict, plain_handles: list) -> int:
    """Phase 21: serving across processes on the one card. Returns K4's
    launches in (a)'s processes."""
    rec: dict = {}
    record["serve_ranks"] = rec
    t0 = time.perf_counter()
    launches = _serve_ranks_engine(rec, record, serve, plain_handles)
    secs = {"a": time.perf_counter() - t0}
    _serve_ranks_cli(rec)
    secs["b"] = time.perf_counter() - t0 - secs["a"]
    rec["seconds"] = dict(secs, total=time.perf_counter() - t0)
    print(f"chip_smoke: phase 21 took {rec['seconds']['total']:.1f} s ("
          + ", ".join(f"({k}) {v:.1f}" for k, v in secs.items()) + ")")
    return launches


# -- phase 22 ------------------------------------------------------------------

def phase_decode_kernel(record: dict) -> list[dict]:
    """22 (a): K1 at the full-prefix decoder's shapes, f32, against its
    plain version (phase 2's f32 tolerance), timed as phase 2 times it;
    then at one sequence of T = 64 and 128 (``DECODE_SWEEP_T``), for the
    time one k tile adds to the longest block."""
    import torch
    import torch.nn.functional as F
    from simple_distributed_machine_learning_tpu_torch.ops import (
        flash_attention as fa,
    )
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(22)
    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=dev)
    out = []
    for shape in DECODE_SHAPES:
        q, k, v, _ = _flash_inputs(shape, "float32", gen, dev)
        got, ref = fa.flash_forward(q, k, v), fa.flash_forward_reference(
            q, k, v)
        torch.cuda.synchronize()
        errs, ok = {}, True
        for part, g, r in zip(("o", "l", "m"), got, ref):
            rtol, atol = FLASH_TOL[("float32", part in ("l", "m"), False)]
            errs[part], part_ok = _flash_err(g, r, rtol, atol)
            ok = ok and part_ok
        check(ok, f"K1 f32 {shape} disagrees with its plain version: {errs}")
        row = dict(shape=list(shape), max_abs_err=max(errs.values()),
                   ms=time_ms(lambda: fa.flash_forward(q, k, v), flush),
                   plain_ms=time_ms(lambda: fa.flash_forward_reference(
                       q, k, v), flush),
                   library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                       q, k, v, is_causal=True), flush))
        row["bound_ms"], row["bound_by"] = _flash_bound("flash_forward",
                                                        shape, "float32")
        row["simt_bound_ms"] = _flash_simt_bound("flash_forward", shape)
        print(f"chip_smoke: 22 (a) K1 f32 {shape}: vs plain max abs "
              + ", ".join(f"{p} {e:.3e}" for p, e in errs.items())
              + f"; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} "
              f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
              f"library {row['library_ms']:.4f} ms (bound at 67 TFLOP/s "
              f"f32: {row['simt_bound_ms']:.4f} ms); "
              f"{row['library_ms'] / row['ms']:.2f}x SDPA's speed")
        out.append(row)
    sweep = {}
    for t in DECODE_SWEEP_T:
        q, k, v, _ = _flash_inputs((1, 8, t, 64), "float32", gen, dev)
        sweep[t] = time_ms(lambda: fa.flash_forward(q, k, v), flush)
    sweep[256] = out[0]["ms"]
    per_tile = (sweep[256] - sweep[64]) / 3
    print("chip_smoke: 22 (a) K1 f32 (1, 8, T, 64): "
          + ", ".join(f"T {t} {ms:.4f} ms" for t, ms in sorted(sweep.items()))
          + f"; {per_tile:.4f} ms per k tile of the longest block")
    record["decode_kernel"] = out
    record["decode_kernel_sweep"] = dict(ms=sweep, per_k_tile_ms=per_tile)
    return out


def _decode_prompt(params, vocab: int, t0: int, batch: int, seed: int):
    """Seeded prompt tokens on the device of ``params``' embedding."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (batch, t0), generator=gen).to(
        params[0]["embed"]["tok"].device)


def _decode_rows(fused, params, toks, t0: int, seq_len: int,
                 per_step: bool):
    """The log-prob rows ``[B, n_new, V]`` a decode read at positions
    ``t0 - 1 .. total - 2``, recomputed through ``fused`` on the decoded
    tokens: one pass over the whole buffer, or (``per_step``) one pass per
    position over the buffer as the decode held it then (zeros after)."""
    import torch
    b, total = toks.shape
    with torch.no_grad():
        if not per_step:
            buf = torch.zeros((b, seq_len), dtype=torch.int64,
                              device=toks.device)
            buf[:, :total] = toks
            return fused(params, buf, None, True)[:, t0 - 1:total - 1]
        rows = []
        for i in range(t0, total):
            buf = torch.zeros((b, seq_len), dtype=torch.int64,
                              device=toks.device)
            buf[:, :i] = toks[:, :i]
            rows.append(fused(params, buf, None, True)[:, i - 1])
        return torch.stack(rows, 1)


def _decode_full_width(name: str, extra: dict, rec: dict) -> int:
    """22 (b)/(c): ``make_decoder`` greedy on the flash build ``extra`` of
    ``SERVE_CFG``; returns its K1 launches."""
    import torch
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        GPTConfig,
        make_cached_decoder,
        make_decoder,
        make_gpt_stages,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (  # noqa: E501
        fused_reference,
    )
    fd = FULL_DECODE
    cfg = GPTConfig(**SERVE_CFG, **extra)
    dense_cfg = GPTConfig(**SERVE_CFG, **dict(extra, attn_impl="dense"))
    stages = make_gpt_stages(0, cfg, 1)[0]
    dense = make_gpt_stages(0, dense_cfg, 1)[0]
    params = [s.params for s in stages]
    check(all(torch.equal(a, b) for a, b in zip(
        params[0].state_dict().values(), dense[0].params.state_dict()
        .values())), f"22 {name}: the dense twin holds other weights")
    t0, n_new = fd["t0"], fd["n_new"]
    prompt = _decode_prompt(params, cfg.vocab, t0, fd["batch"], fd["seed"])
    dec = make_decoder(stages, t0, n_new)

    def run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = dec(params, prompt)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3 / n_new

    first_ms = run()[1]             # this shape's first forward: warm-up
    _reset_flash_counts()
    toks, host_ms = run()
    launches = _flash_counts()
    prof = _profiled(lambda: dec(params, prompt))
    want = cfg.n_layers * n_new
    check(launches == (want, 0, 0),
          f"22 {name}: make_decoder launched K1/K2/K3 {launches} times, "
          f"not ({want}, 0, 0)")
    check(toks.shape == (fd["batch"], t0 + n_new)
          and torch.equal(toks[:, :t0].long(), prompt)
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab,
          f"22 {name}: malformed tokens {tuple(toks.shape)}")
    moe = cfg.n_experts > 0
    rows = _decode_rows(fused_reference(dense), params, toks, t0,
                        cfg.seq_len, per_step=moe)
    flash_rows = _decode_rows(fused_reference(stages), params, toks, t0,
                              cfg.seq_len, per_step=moe)
    err = float((flash_rows - rows).abs().max())
    picked = rows.gather(-1, toks[:, t0:].long()[..., None])[..., 0]
    shortfall = float((rows.max(-1).values - picked).max())
    argmax_hits = int((rows.argmax(-1) == toks[:, t0:].long()).sum())
    check(err <= DECODE_LOGP_TOL and shortfall <= DECODE_LOGP_TOL,
          f"22 {name}: flash decode log-probs {err:.3e} from the dense "
          f"forward's, a token {shortfall:.3e} below the dense argmax "
          f"(tolerance {DECODE_LOGP_TOL})")
    r = dict(k1_launches=launches[0], host_ms_per_token=host_ms,
             first_call_host_ms_per_token=first_ms,
             device_busy_share=prof["device_busy_share"],
             launches_per_token=prof["launches"] / n_new,
             max_abs_logp_err=err, argmax_shortfall=shortfall,
             argmax_hits=argmax_hits, tokens=fd["batch"] * n_new,
             teacher_forced="per step" if moe else "one pass")
    if moe:
        try:
            make_cached_decoder(stages, cfg, t0, n_new)
            cached_err = None
        except ValueError as e:
            cached_err = str(e)
        check(cached_err is not None and "make_decoder" in cached_err,
              f"22 {name}: make_cached_decoder on the MoE build did not "
              f"refuse naming make_decoder: {cached_err}")
        r["cached_refusal"] = cached_err
    else:
        cached = make_cached_decoder(dense, dense_cfg, t0, n_new)(params,
                                                                  prompt)
        div = []
        for bi in range(fd["batch"]):
            diff = (cached[bi, t0:] != toks[bi, t0:]).nonzero()
            if len(diff) == 0:
                div.append(None)
                continue
            j = int(diff[0])
            top2 = rows[bi, j].topk(2).values
            div.append(dict(position=t0 + j,
                            top2_gap=float(top2[0] - top2[1])))
        r["cached_divergence"] = div
    print(f"chip_smoke: 22 {name}: make_decoder {fd['batch']} x {n_new} "
          f"tokens, K1 {launches[0]} launches, {host_ms:.3f} host ms per "
          f"decoded token (first call {first_ms:.3f}; profiled: busy "
          f"{r['device_busy_share']:.4f}, {r['launches_per_token']:.1f} "
          f"launches per token); teacher-forced ({r['teacher_forced']}) dense "
          f"log-probs max abs {err:.3e}, argmax shortfall {shortfall:.3e}, "
          f"{argmax_hits}/{r['tokens']} the dense argmax"
          + (f"; make_cached_decoder refuses: {r['cached_refusal']!r}" if moe
             else f"; make_cached_decoder first divergence per row "
                  f"{r['cached_divergence']}"))
    rec[name] = r
    return launches[0]


def _decode_from_pipeline(rec: dict) -> tuple[int, int, int]:
    """22 (d): ``decoder_from_pipeline`` on a one-stage gpt_bf16 pipeline
    reads the live params: AdamW steps change its greedy tokens, which
    equal ``make_cached_decoder``'s on those params."""
    import torch
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        decoder_from_pipeline,
        make_cached_decoder,
    )
    from simple_distributed_machine_learning_tpu_torch.train import (
        make_train_step,
    )
    pd = PIPE_DECODE
    cfg, pipe, opt, xs, ts = _train_setup(TRAIN_ROWS["gpt_bf16"], "flash")
    params = pipe.init_params()
    state = opt.init(params)
    prompt = _decode_prompt(params, cfg.vocab, pd["t0"], 1,
                            FULL_DECODE["seed"])
    dec = decoder_from_pipeline(pipe, cfg, pd["t0"], pd["n_new"])
    before = dec(params, prompt)
    step = make_train_step(pipe, opt)
    _reset_flash_counts()
    for i in range(pd["steps"]):
        params, state, loss = step(params, state, xs[0], ts[0], i)
    torch.cuda.synchronize()
    launches = _flash_counts()
    after = dec(params, prompt)
    live = make_cached_decoder(pipe.stages, cfg, pd["t0"], pd["n_new"])(
        list(params), prompt)
    want = cfg.n_layers * pd["steps"]
    check(launches == (want, want, want),
          f"22 (d): {pd['steps']} flash steps launched K1/K2/K3 {launches}")
    check(not torch.equal(before, after),
          "22 (d): decoder_from_pipeline ignored the training updates")
    check(torch.equal(after, live),
          "22 (d): decoder_from_pipeline differs from make_cached_decoder "
          "on the live params")
    changed = int((before != after)[:, pd["t0"]:].sum())
    print(f"chip_smoke: 22 (d) decoder_from_pipeline on gpt_bf16: "
          f"{pd['steps']} AdamW steps (loss {float(loss):.4f}) changed "
          f"{changed}/{pd['n_new']} decoded tokens; equal to "
          f"make_cached_decoder on the live params")
    rec["pipeline"] = dict(steps=pd["steps"], changed_tokens=changed,
                           launches=list(launches))
    return launches


def phase_full_prefix_decode(record: dict) -> tuple[int, int, int]:
    """22 (b)-(d); returns their K1-K3 launches."""
    rec = record.setdefault("full_prefix_decode", {})
    k1 = (_decode_full_width("(b) flash", dict(attn_impl="flash"), rec)
          + _decode_full_width("(c) moe", EP_MOE, rec))
    pipe = _decode_from_pipeline(rec)
    return (k1 + pipe[0], pipe[1], pipe[2])


# -- phase 23 ------------------------------------------------------------------

def _gptj_pair(dtype: str | None):
    """Phase 23's flash build of ``GPTJ_CFG`` and its dense twin on the
    same weights (seed 0), each as a one-stage ``Pipeline`` (``dtype``: its
    compute dtype); ``(cfg, flash stages, dense stages, flash pipe, dense
    pipe)``."""
    import torch
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        GPTConfig,
        make_gpt_stages,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        Pipeline,
    )
    cfg = GPTConfig(**GPTJ_CFG, attn_impl="flash")
    stages, wd, od = make_gpt_stages(0, cfg, 1)
    dense = make_gpt_stages(0, GPTConfig(**GPTJ_CFG, attn_impl="dense"),
                            1)[0]
    check(all(torch.equal(a, b) for a, b in zip(
        stages[0].params.state_dict().values(),
        dense[0].params.state_dict().values())),
          "23: the dense twin holds other weights")
    cd = dtype and getattr(torch, dtype)
    return (cfg, stages, dense, Pipeline(stages, None, wd, od,
                                         compute_dtype=cd),
            Pipeline(dense, None, wd, od, compute_dtype=cd))


def _gptj_train(dtype: str | None, rec: dict) -> tuple[int, int, int]:
    """23 (a): the first step's loss and gradients, flash against dense
    on the same weights and batch, then ``GPTJ_TRAIN['steps']`` AdamW steps
    through ``make_train_step``; returns the flash launches."""
    import math

    import torch
    from simple_distributed_machine_learning_tpu_torch.train import (
        adamw,
        make_train_step,
    )
    name = dtype or "float32"
    cfg, stages, dense, pipe, dpipe = _gptj_pair(dtype)
    b, steps = GPTJ_TRAIN["batch"], GPTJ_TRAIN["steps"]
    gen = torch.Generator().manual_seed(23)
    shape = (steps, b, cfg.seq_len)
    xs = torch.randint(0, cfg.vocab, shape, generator=gen).float().cuda()
    ts = torch.randint(0, cfg.vocab, shape, generator=gen).cuda()
    params = pipe.init_params()
    _reset_flash_counts()
    loss, grads = pipe.loss_and_grads(params, xs[0], ts[0], 0,
                                      deterministic=True)
    first = _flash_counts()
    check(first == (cfg.n_layers,) * 3,
          f"23 {name}: one step launched K1/K2/K3 {first} times, not "
          f"{cfg.n_layers} each")
    dloss, dgrads = dpipe.loss_and_grads(dpipe.init_params(), xs[0], ts[0],
                                         0, deterministic=True)
    check(_flash_counts() == first, f"23 {name}: the dense run launched "
                                    f"a flash kernel")
    loss_rel = abs(float(loss) - float(dloss)) / abs(float(dloss))
    num = sum(float((g.float() - d.float()).pow(2).sum())
              for g, d in zip(grads, dgrads))
    den = sum(float(d.float().pow(2).sum()) for d in dgrads)
    grad_rel = math.sqrt(num / den)
    del grads, dgrads, dpipe, dense
    loss_tol, grad_tol = GPTJ_TOL[name]
    print(f"chip_smoke: 23 (a) {name}: first step flash vs dense loss "
          f"{float(loss):.6f} / {float(dloss):.6f}, rel diff "
          f"{loss_rel:.3e} (limit {loss_tol}); gradients' relative L2 "
          f"distance {grad_rel:.3e} (limit {grad_tol})")
    check(loss_rel <= loss_tol and grad_rel <= grad_tol,
          f"23 {name}: flash and dense differ at the first step: loss "
          f"{loss_rel}, gradients {grad_rel}")
    opt = adamw(1e-4)
    state = opt.init(params)
    step = make_train_step(pipe, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_flash_counts()
    t0 = time.perf_counter()
    losses = []
    for i in range(steps):
        params, state, loss = step(params, state, xs[i], ts[i], 0)
        losses.append(float(loss))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    counts = _flash_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_params = sum(p.numel() for p in stages[0].params.parameters())
    print(f"chip_smoke: 23 (a) {name}: {steps} AdamW steps at batch {b} x "
          f"{cfg.seq_len} ({n_params} params), losses "
          + ", ".join(f"{v:.4f}" for v in losses)
          + f"; K1/K2/K3 {counts}; {step_ms:.1f} host ms a step (the first "
          f"included; with the first wide K1: "
          f"{GPTJ_FIRST_K1_MS['train ' + name]:.1f}), peak {peak:.2f} GiB")
    check(all(math.isfinite(v) for v in losses),
          f"23 {name}: non-finite loss {losses}")
    check(counts == (cfg.n_layers * steps,) * 3,
          f"23 {name}: {steps} steps launched K1/K2/K3 {counts} times")
    rec[f"train {name}"] = dict(
        loss_rel=loss_rel, grad_rel=grad_rel, losses=losses,
        launches=counts, step_ms=step_ms, peak_gib=peak, n_params=n_params)
    return tuple(a + c for a, c in zip(first, counts))


def _gptj_decode_serve(rec: dict) -> tuple[int, int]:
    """23 (b) and (c): ``make_decoder`` greedy, flash against dense, and
    ``InferenceEngine`` through K4 against solo decode; returns the K1 and
    K4 launches."""
    import numpy as np
    import torch
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        make_cached_decoder,
        make_decoder,
    )
    from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (  # noqa: E501
        paged_attention,
    )
    from simple_distributed_machine_learning_tpu_torch.ops.random import (
        key_data,
    )
    from simple_distributed_machine_learning_tpu_torch.serve import (
        InferenceEngine,
    )
    cfg, stages, dense, _, _ = _gptj_pair(None)
    params = [s.params for s in stages]
    t0, n_new = GPTJ_DECODE["t0"], GPTJ_DECODE["n_new"]
    prompt = _decode_prompt(params, cfg.vocab, t0, 1, GPTJ_DECODE["seed"])
    dec = make_decoder(stages, t0, n_new)
    dec(params, prompt)                          # warm-up
    torch.cuda.synchronize()
    _reset_flash_counts()
    t = time.perf_counter()
    toks = dec(params, prompt)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3 / n_new
    k1 = _flash_counts()
    want = make_decoder(dense, t0, n_new)(params, prompt)
    check(k1 == (cfg.n_layers * n_new, 0, 0),
          f"23 (b): make_decoder launched K1/K2/K3 {k1} times, not "
          f"({cfg.n_layers * n_new}, 0, 0)")
    same = torch.equal(toks.long(), want.long())
    print(f"chip_smoke: 23 (b) make_decoder f32 {n_new} tokens from a "
          f"{t0}-token prompt: K1 {k1[0]} launches at [1, {cfg.n_heads}, "
          f"{cfg.seq_len}, {cfg.d_model // cfg.n_heads}], {host_ms:.1f} host "
          f"ms a token (with the first wide K1: "
          f"{GPTJ_FIRST_K1_MS['decode']:.1f}); tokens "
          f"{toks[0, t0:].tolist()} equal the dense "
          f"decoder's: {same}")
    check(same, f"23 (b): flash tokens {toks.tolist()} != dense "
                f"{want.tolist()}")
    engine = InferenceEngine(stages, cfg, n_slots=GPTJ_SERVE["n_slots"],
                             block_size=SERVE_BLOCK, attn_kernel="fused")
    rng = np.random.default_rng(GPTJ_DECODE["seed"])
    paged_attention.launches = 0
    calls = _decode_calls_of(engine)
    c0 = calls[0]
    handles = [engine.submit(rng.integers(0, cfg.vocab, n).astype(np.int32),
                             max_new_tokens=GPTJ_SERVE["max_new"])
               for n in GPTJ_SERVE["prompt_lens"]]
    t = time.perf_counter()
    engine.drain()
    wall = time.perf_counter() - t
    k4, decode = paged_attention.launches, calls[0] - c0
    same_solo = 0
    for h in handles:
        n = int(h.prompt.shape[0])
        solo = make_cached_decoder(stages, cfg, n, h.max_new_tokens)(
            params, h.prompt[None], key_data(h.seed))
        same_solo += solo[0, n:].tolist() == h.tokens
    print(f"chip_smoke: 23 (c) InferenceEngine (fused, {len(handles)} "
          f"requests, prompts {GPTJ_SERVE['prompt_lens']}, "
          f"{GPTJ_SERVE['max_new']} new): {wall:.2f} s, K4 {k4} launches = "
          f"{cfg.n_layers} layers x {decode} decode calls: "
          f"{k4 == cfg.n_layers * decode}; greedy streams equal to solo "
          f"decode {same_solo}/{len(handles)}")
    check(all(len(h.tokens) == h.max_new_tokens for h in handles),
          "23 (c): a request did not finish")
    check(decode > 0 and k4 == cfg.n_layers * decode,
          f"23 (c): K4 launches {k4} != {cfg.n_layers} x {decode}")
    check(same_solo == len(handles),
          f"23 (c): {len(handles) - same_solo} greedy streams differ from "
          f"solo decode")
    rec["decode"] = dict(k1_launches=k1[0], host_ms_per_token=host_ms,
                         tokens=toks[0, t0:].tolist(), equal_dense=same)
    rec["serve"] = dict(k4_launches=k4, decode_calls=decode, wall_s=wall,
                        equal_solo=same_solo, requests=len(handles))
    return k1[0], k4


def phase_gptj(record: dict) -> tuple[tuple[int, int, int], int]:
    """23: ``GPTJ_CFG`` trains (f32, bf16), decodes and serves on the
    card; returns its K1-K3 and K4 launches."""
    rec = record.setdefault("gptj", {})
    f32 = _gptj_train(None, rec)
    gc.collect()
    bf16 = _gptj_train("bfloat16", rec)
    gc.collect()
    k1, k4 = _gptj_decode_serve(rec)
    gc.collect()
    return (f32[0] + bf16[0] + k1, f32[1] + bf16[1], f32[2] + bf16[2]), k4


def lane_main(out_path: str) -> int:
    """The second lane: phases 16-18, 19 (a), (d) and 23 in a process of
    their own, beside the first lane's serving, stages, linter and
    cross-process serving phases. Its records and launch counts go to
    ``out_path``."""
    import signal

    def stop(signum, frame):
        raise SmokeFailure(f"the second lane was stopped (signal {signum})")
    # a stop unwinds through every phase's ``finally``, which stops the
    # processes the phase started
    signal.signal(signal.SIGTERM, stop)
    sys.path.insert(0, HERE)
    record: dict = {}
    secs: dict = {}
    try:
        t = time.perf_counter()
        process_launches = phase_processes(record)
        secs["16"] = time.perf_counter() - t
        phase_tensor_parallel(record)
        secs["17"] = time.perf_counter() - t - sum(secs.values())
        spep_launches = phase_seq_expert(record)
        secs["18"] = time.perf_counter() - t - sum(secs.values())
        overlap_flash, cli_k4 = phase_overlap_training(record)
        secs["19 (a), (d)"] = time.perf_counter() - t - sum(secs.values())
        gptj_flash, gptj_k4 = phase_gptj(record)
        secs["23"] = time.perf_counter() - t - sum(secs.values())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    flash = [process_launches[i] + spep_launches[i] + overlap_flash[i]
             + gptj_flash[i] for i in range(3)]
    with open(out_path, "w") as f:
        json.dump({"record": record, "flash": flash,
                   "k4": cli_k4 + gptj_k4, "k4_wide": gptj_k4,
                   "seconds": secs}, f)
    return 0


def start_lane(tmp: str):
    """Start the second lane, its output to files under ``tmp``."""
    out = open(os.path.join(tmp, "lane.out"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--lane",
         os.path.join(tmp, "lane.json")], stdout=out,
        stderr=subprocess.STDOUT, env=_child_env(), cwd=HERE,
        start_new_session=True)
    out.close()
    return proc


def _lane_log(tmp: str) -> str:
    with open(os.path.join(tmp, "lane.out")) as f:
        return f.read()


def join_lane(proc, tmp: str, deadline: float) -> dict:
    """Wait for the second lane (until ``deadline`` on the monotonic
    clock), print its output here and return its results."""
    try:
        rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        rc = None
    text = _lane_log(tmp)
    check(rc == 0, f"the second lane (phases 16-18, 19 (a), (d) and 23) "
                   f"{'ran past its deadline' if rc is None else f'exited {rc}'}"
                   f": {text[-4000:]}")
    print("chip_smoke: the second lane's output (phases 16-18, 19 (a), (d) "
          "and 23, run beside phases 8-15, 19 (b)-(c), 20-22):")
    sys.stdout.write(text)
    with open(os.path.join(tmp, "lane.json")) as f:
        return json.load(f)


def stop_lane(proc) -> None:
    """Stop the second lane if it still runs: SIGTERM (its phases stop
    their processes on the way out), then SIGKILL to its whole group."""
    import signal
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
    proc.wait()


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
    import tempfile

    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        GPTConfig,
        make_gpt_stages,
    )
    record: dict = {}
    t_start = time.perf_counter()
    deadline = time.monotonic() + LANE_DEADLINE_S
    secs: dict = {}

    def timed(name: str, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        secs[name] = round(time.perf_counter() - t, 1)
        return out
    lane = None
    analysis: list = []
    lane_tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-lane-")
    try:
        timed("1", phase_build, record)
        variants = timed("2 K4", phase_kernels, record)
        flash_variants = timed("2 flash", phase_flash_kernels, record)
        timed("22 (a)", phase_decode_kernel, record)
        cfg = GPTConfig(**SERVE_CFG)
        stages = make_gpt_stages(0, cfg, 1)[0]
        serve, plain_handles = timed("3", phase_serve, stages, cfg, record)
        spec = timed("3b", phase_spec_serve, stages, cfg, serve,
                     plain_handles, record)
        timed("4", phase_profile, stages, cfg, record)
        # the kernels' times and phase 4's breakdown are taken alone; from
        # here the second lane runs beside this one
        lane = start_lane(lane_tmp.name)
        fault_launches = timed("8", phase_serve_faults, stages, cfg, serve,
                               plain_handles, record)
        fleet_launches = timed("9", phase_fleet, stages, cfg, serve,
                               plain_handles, record)
        tier_launches = timed("11", phase_host_tier_adapters, stages, cfg,
                              serve, record)
        protocol_launches = timed("12", phase_protocol_beam_dense, stages,
                                  cfg, serve, plain_handles, spec, record)
        del stages
        train = timed("5 bf16", phase_train, "gpt_bf16",
                      TRAIN_ROWS["gpt_bf16"], record)
        timed("5 f32", phase_train, "gpt", TRAIN_ROWS["gpt"], record)
        timed("6", phase_train_profile, TRAIN_ROWS["gpt_bf16"], record)
        timed("7", phase_main_path, record)
        resilience_launches = timed("10", phase_resilience, record)
        telemetry_launches = timed("13", phase_telemetry_native, record)
        analysis = start_analysis_cli()
        f1_row, lint_launches = timed("14", phase_lint_drift, record)
        stage_launches = timed("15", phase_stages, record)
        tp_serve_launches = timed("19 (b), (c)", phase_overlap_tp_serve,
                                  record, serve, plain_handles)
        lint_flash, lint_k4 = timed("20 (a)-(d), (f)", phase_program_lint,
                                    record, serve, plain_handles, analysis)
        ranks_k4 = timed("21", phase_serve_ranks, record, serve,
                         plain_handles)
        decode_flash = timed("22 (b)-(d)", phase_full_prefix_decode, record)
        t = time.perf_counter()
        laned = join_lane(lane, lane_tmp.name, deadline)
        secs["waiting for the second lane"] = round(time.perf_counter() - t,
                                                    1)
        for key, val in laned["record"].items():
            if isinstance(record.get(key), dict):
                record[key].update(val)
            else:
                record[key] = val
        _lint_ici(record, record["program_lint"])
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        _kill_all([proc for *_, proc in analysis])
        if lane is not None:
            stop_lane(lane)
        lane_tmp.cleanup()
    record["phase_seconds"] = dict(
        secs, lane={k: round(v, 1) for k, v in laned["seconds"].items()})
    print(f"chip_smoke: seconds by phase: {record['phase_seconds']}")
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
        # host-tier and adapter runs, phase 12's protocol drills, phase
        # 14's recorded ticks and drift traces, phase 19's
        # tensor-parallel serving (tp x n_layers per decode call),
        # phase 20's linted engines and CLI gate run, phase 21 (a)'s two
        # processes (tp / W x n_layers per decode call in each) and phase
        # 19 (d)'s CLI run: every head dim up to 128
        "launches": (serve["launches"] + spec["launches"] + fault_launches
                     + fleet_launches + tier_launches + protocol_launches
                     + lint_launches + tp_serve_launches + laned["k4"]
                     - laned["k4_wide"] + lint_k4 + ranks_k4),
        "max_abs_err": max(v["max_abs_err"] for v in variants
                           if v["dh"] <= 128),
        "ms": main_v["ms"],
        "plain_ms": main_v["plain_ms"],
        "bound_ms": main_v["bound_ms"],
        "bound_by": main_v["bound_by"],
        "library_ms": None,
    }]}
    # the flash kernels' times at the gpt_bf16 row's shape; launches from
    # that row's flash training run, phase 10 (b)'s runs of that row,
    # phase 13 (b)'s bf16 CLI run, phase 15 (b)'s runs of that row at 2
    # stages, phase 16 (b)'s over 2 processes (summed over the ranks),
    # phase 18 (b)'s mixture-of-experts runs of that row, phase 19 (a)'s
    # with the ring dispatch, phase 20 (a) and (f)'s --lint CLI runs and
    # phase 22 (b)-(d)'s decodes (K1 per layer per token) and training steps
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
                         + telemetry_launches[i] + stage_launches[i]
                         + laned["flash"][i] + lint_flash[i]
                         + decode_flash[i]),
            "max_abs_err": max(v["max_abs_err"] for v in flash_variants
                               if v["name"] == name),
            "ms": timed["ms"],
            "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"],
            "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"],
        })
    # K4 past head dim 128 (the same wrapper and entry point, its own
    # kernel): phase 23 (c)'s GPT-J-width serving at dh 256; its times at
    # phase 2's f32 dh 256 case
    wide_v = next(v for v in record["kernel_head_dims"]
                  if (v["dtype"], v["dh"]) == ("float32", 256))
    kernels["kernels"].append({
        "name": "paged_attention_wide",
        "route": "cuda",
        "source": f"{PORT}/ops/csrc/paged_attention.cu",
        "replaces": "simple_distributed_machine_learning_tpu/ops/"
                    "paged_attention.py:67",
        "launches": laned["k4_wide"],
        "max_abs_err": max(v["max_abs_err"] for v in variants
                           if v["dh"] > 128),
        "ms": wide_v["ms"],
        "plain_ms": wide_v["plain_ms"],
        "bound_ms": wide_v["bound_ms"],
        "bound_by": wide_v["bound_by"],
        "library_ms": None,
    })
    kernels["kernels"].append(f1_row)
    record["kernels"] = kernels["kernels"]
    idle = [k["name"] for k in kernels["kernels"] if k["launches"] <= 0]
    if idle:
        print(f"chip_smoke: FAILED: the main path never launched {idle}",
              file=sys.stderr)
        return 1
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
    if sys.argv[1:2] == ["--process-worker"]:
        process_worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                       sys.argv[5])
        sys.exit(0)
    if sys.argv[1:2] == ["--lane"]:
        sys.exit(lane_main(sys.argv[2]))
    if sys.argv[1:2] == ["--serve-worker"]:
        serve_rank_worker(int(sys.argv[2]), int(sys.argv[3]),
                          int(sys.argv[4]), sys.argv[5])
        sys.exit(0)
    sys.exit(main())
