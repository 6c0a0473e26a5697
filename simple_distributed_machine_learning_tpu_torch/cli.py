"""Reference-compatible training CLI (port of ``cli.py``'s training half).

    python -m simple_distributed_machine_learning_tpu_torch.cli --rank 0 \\
        --model lenet [--device cpu]

trains the reference's LeNet on MNIST (or its synthetic stand-in) on one
card, with the reference's console output and the JAX CLI's flags and
defaults. ``--model mlp`` trains the MLP of ``--mlp-dims``; ``--model
gpt`` the tiny GPT on a synthetic Markov stream (or ``--text-corpus``),
with ``--attn flash`` through the hand-written flash kernels and
``--generate N`` through the port's ``make_cached_decoder``. ``--model gpt
--serve-sim N`` serves N simulated requests through the port's
``InferenceEngine`` (the paged pool and its CUDA attention kernel), with
``--serve-spec-k K`` speculatively: a draft of half the layers proposes K
tokens per slot per tick and the target verifies them in one pass. With
``--serve-chaos SPEC`` or ``--serve-deadline-ms D`` the engine runs
behind the serve supervisor: a journaled, crash-restartable engine with
deadline shedding (``--serve-max-restarts`` bounds its rebuilds), and
``--telemetry-dir`` keeps the journal, the serve record and the
post-mortem bundles. ``--serve-replicas N`` serves through a fleet of N
supervised replicas (``--serve-route``, ``--serve-autoscale MIN,MAX``,
``--serve-prefill-replicas`` for disaggregated prefill/decode), and
``--serve-trace`` records every request's timeline next to the telemetry.
``--serve-host-blocks N`` (with ``--serve-prefetch-ticks T``) puts a host
offload tier of N blocks behind every paged pool, and ``--serve-adapters
N`` (rank ``--serve-adapter-rank``) serves N LoRA tenants over the shared
base weights.
SIGTERM/SIGINT during ``--serve-sim`` stop admission and drain what is in
flight. ``--scenario NAME`` runs one of the thirteen SLO scenarios on the
virtual clock (``--scenario list`` names them). ``--sentinel`` checks
every step's loss and gradient norm on the host and absorbs a numeric
fault by rollback and quarantine; ``--chaos SPEC --checkpoint-dir D``
trains ``--model mlp`` or ``gpt`` under a fault schedule through the
elastic supervisor, which restores the latest valid checkpoint of D's
store after each recoverable failure (``--chaos-max-restarts`` bounds
it). When training, ``--telemetry-dir D`` writes the telemetry session's
per-epoch records (``D/metrics.jsonl``: step-time p50/p95, the compile
split, throughput, live and device memory), ``D/trace.json`` (feed, step
and eval spans) and ``D/metrics.prom``, fencing the card every
``--telemetry-every N`` steps; with ``--generate`` it adds one ``kind:
"decode"`` record. ``--profile DIR`` captures the whole fit under
``torch.profiler`` into a Chrome trace in DIR.

``--stages S`` (default: 2 with two or more cards, else 1, as the JAX CLI)
trains over a pipeline of S stages, stage s on card ``s mod n`` of the n
visible cards (every stage on the CPU with ``--device cpu``), and prints
the placement (``| pipeline: 2 stages on cuda:0, cuda:0``);
``--microbatches M`` splits each batch into M microbatches over them,
``--schedule 1f1b`` interleaves forwards and backwards, ``--remat``
recomputes each stage in the backward, ``--generate`` decodes stage by
stage (``models/pp_decode.py``) and ``--chaos ... --chaos-stages 2,1``
steps the elastic supervisor down a stage-count ladder. On one stage
``--microbatches`` and ``--remat`` change nothing, as on the JAX
package's one-device mesh.

The reference's launch line runs W processes (``--rank R --world_size W
--master_addr A --master_port P``, one command per process): they meet in
a gloo process group (``parallel/mesh.py::bootstrap_distributed``) and
train one ``--dp D`` x ``--stages S`` mesh (default S: 2 with W > 1),
each process owning ``D * S / W`` contiguous coordinates, coordinate i on
card ``i mod n`` (every process on ``cuda:0`` with one card); hops and
reductions cross processes over the host. Process 0 alone prints the
console (and ``| distributed: ...``); each batch is cut to the process's
rows (``SDML_DEBUG_SHARDING=1`` names them on stderr); ``--zero1`` shards
the optimizer state over the data axis; checkpoints are collective. With
``--peer-timeout T`` > 0 a watchdog subprocess per process
(``utils/failure.py``, on ``--heartbeat-port``, default master_port + 1)
turns a killed or frozen peer into a non-zero exit within about T
seconds.

``--serve-sim`` and ``--scenario`` run in every process of such a launch,
and every process prints, as the JAX CLI's do: at ``--serve-tp 1`` each
process serves the whole trace (or runs the scenario) on its own card,
card ``rank mod n``; at ``--serve-tp T`` the T model coordinates of one
serving mesh lie across the W processes (T / W each, the sums over gloo
through the host, every clock read rank 0's), and every process serves
the same trace in lockstep. Under ``--telemetry-dir`` only process 0
writes the request journals and the request timeline there (two writers
would corrupt them); the others keep theirs in a temporary directory.

``--tp M`` (``--model mlp`` or ``gpt``) adds a model axis: each stage is
sharded M ways (Megatron: the MLP's column -> row pairs, the GPT's heads
and MLP width), the M model coordinates of a replica's stage share its
card, and with W processes each process owns ``D * S * M / W``
coordinates (W dividing ``D * S``, or a multiple of it that splits the
model axis: the sums then cross processes over the host).

``--sp Q`` (``--model gpt`` with ``--attn ring`` or ``ulysses``) shards
the token axis in Q chunks, attention mixing them by ring or all-to-all;
``--experts E`` gives every GPT block a mixture of E experts (top
``min(2, E)``), and ``--ep D`` shards them D ways, tokens dispatched by
all-to-all. Like the model axis, the seq and expert coordinates of a
replica's stage share its card, and across processes their collectives
go over gloo.

One flag is the port's own: ``--device`` (default CUDA; the run raises
without it unless ``--device cpu`` asks for the CPU). Every other flag of
the JAX parser is accepted.

``--lint`` traces the exact steps the run is about to execute — the
train and eval steps of a training run, the serving-program registry of
``--serve-sim`` (with the fleet protocol's bounded model check) — and
lints them before the card runs one (fake tensors: no FLOP, no kernel
launch, no device memory); an ERROR finding exits 2. ``--lint-only``
exits after the preflight. ``SDML_LINT_INJECT=<tag>`` seeds one ERROR
finding (the gate drill).

``--overlap ring`` runs the tensor-parallel sums and the expert dispatch
as the ring schedules of ``parallel/overlap.py``. ``--serve-tp T`` serves
the ``--serve-sim`` trace tensor-parallel over T model coordinates (T
divides the head count), coordinate m on card m mod n of the n visible
cards (``| serving: tp T on ...``), where the JAX CLI needs T devices.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Distributed Machine Learning (PyTorch/CUDA port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    # -- reference-compatible flags --
    p.add_argument('--rank', type=int, metavar='R', help="Number of rank")
    p.add_argument('--world_size', type=int, default=1, metavar='N',
                   help="Number of workers (processes)")
    p.add_argument('--interface', type=str, default="eth0", metavar='I',
                   help="Accepted for reference compatibility; unused")
    p.add_argument('--master_addr', type=str, default="localhost",
                   metavar='MA', help="Address of the coordinator (master)")
    p.add_argument('--master_port', type=str, default="29500", metavar='MP',
                   help="Port the coordinator is listening on")
    g = p.add_argument_group("framework options")
    g.add_argument('--device', type=str, default=None,
                   help="cuda (the default; raises without CUDA) or cpu")
    g.add_argument('--model', choices=("lenet", "mlp", "gpt"),
                   default="lenet",
                   help="model family (lenet = the reference's workload)")
    g.add_argument('--stages', type=int, default=None,
                   help="pipeline stages (default: 2 with two or more "
                        "cards or processes, else 1); mesh coordinate i "
                        "runs on card i mod n")
    g.add_argument('--microbatches', type=int, default=1,
                   help="GPipe/1F1B microbatches per batch (over two or "
                        "more stages)")
    g.add_argument('--schedule', choices=("gpipe", "1f1b"), default="gpipe",
                   help="pipeline schedule (the same on one stage)")
    g.add_argument('--dp', type=int, default=1,
                   help="data-parallel mesh width (batch must divide by "
                        "dp * microbatches)")
    g.add_argument('--tp', type=int, default=1,
                   help="tensor-parallel width: Megatron-shard every stage "
                        "over a model axis of this size (--model=mlp or "
                        "gpt)")
    g.add_argument('--overlap', choices=("none", "ring"), default="none",
                   help="collective schedule for the tensor-parallel sums "
                        "and the expert-parallel dispatch: none = one sum "
                        "or all-to-all; ring = the chunked ring schedules "
                        "of parallel/overlap.py, the same losses to float "
                        "tolerance")
    g.add_argument('--epochs', type=int, default=10)
    g.add_argument('--batch-size', type=int, default=60)
    g.add_argument('--lr', type=float, default=0.1)
    g.add_argument('--momentum', type=float, default=0.5)
    g.add_argument('--optimizer', choices=("sgd", "adamw"), default="sgd",
                   help="sgd = the reference's SGD(momentum); adamw = "
                        "torch-semantics decoupled weight decay")
    g.add_argument('--weight-decay', type=float, default=0.01,
                   help="weight decay for --optimizer adamw")
    g.add_argument('--lr-schedule',
                   choices=("constant", "cosine", "warmup-cosine", "step"),
                   default="constant",
                   help="learning-rate schedule over the whole run")
    g.add_argument('--warmup-steps', type=int, default=0,
                   help="linear-warmup steps for --lr-schedule warmup-cosine")
    g.add_argument('--lr-step-size', type=int, default=100,
                   help="steps between decays for --lr-schedule step")
    g.add_argument('--lr-gamma', type=float, default=0.1,
                   help="decay factor for --lr-schedule step")
    g.add_argument('--clip-norm', type=float, default=0.0,
                   help="clip gradients to this global L2 norm (0 = off)")
    g.add_argument('--zero1', action='store_true',
                   help="ZeRO-1: shard optimizer state over the data axis "
                        "(the identity at --dp 1)")
    g.add_argument('--data-root', type=str, default="data",
                   help="directory with MNIST IDX files (synthetic fallback "
                        "if absent)")
    g.add_argument('--seed', type=int, default=0)
    g.add_argument('--shuffle', action='store_true',
                   help="seeded per-epoch shuffle of the train set")
    g.add_argument('--mlp-dims', type=str, default="784,512,10",
                   help="comma-separated layer widths for --model=mlp")
    g.add_argument('--checkpoint-dir', type=str, default=None,
                   help="write a checkpoint (the JAX package's format) "
                        "after every epoch and auto-resume from it")
    g.add_argument('--no-resume', action='store_true',
                   help="with --checkpoint-dir: ignore an existing "
                        "checkpoint")
    g.add_argument('--async-checkpoint', action='store_true',
                   help="overlap the checkpoint file write with the next "
                        "epoch")
    g.add_argument('--eval-only', action='store_true',
                   help="evaluate the restored (or fresh) params and exit")
    g.add_argument('--experts', type=int, default=0,
                   help="for --model=gpt: replace each block's MLP with a "
                        "top-2-routed mixture of this many experts (0 = dense)")
    g.add_argument('--sp', type=int, default=1,
                   help="sequence-parallel width for --model=gpt: shards the "
                        "token axis over a 'seq' mesh axis (requires "
                        "--attn ring or ulysses)")
    g.add_argument('--ep', type=int, default=1,
                   help="expert-parallel width for --model=gpt with "
                        "--experts: shards expert weights over an 'expert' "
                        "mesh axis with all-to-all dispatch")
    g.add_argument('--generate', type=int, default=0, metavar="N",
                   help="for --model=gpt: after training, decode N tokens "
                        "with the KV-cache decoder and print them")
    g.add_argument('--serve-sim', type=int, default=0, metavar="N",
                   help="for --model=gpt: serve N simulated requests "
                        "(open-loop Poisson arrivals) through the "
                        "continuous-batching engine instead of training")
    g.add_argument('--serve-rate', type=float, default=8.0,
                   help="with --serve-sim: mean arrival rate (requests/s)")
    g.add_argument('--serve-slots', type=int, default=4,
                   help="with --serve-sim: concurrent decode slots")
    g.add_argument('--serve-max-new', type=int, default=16,
                   help="with --serve-sim: new tokens per request")
    g.add_argument('--serve-block-size', type=int, default=16,
                   help="with --serve-sim: positions per paged K/V block")
    g.add_argument('--serve-prefill-chunk', type=int, default=0,
                   help="with --serve-sim: prompt positions per prefill "
                        "chunk (0 = the whole prompt in one chunk)")
    g.add_argument('--serve-shared-prefix', type=int, default=0,
                   metavar="N", help="with --serve-sim: prepend one seeded "
                                     "N-token prefix to every prompt")
    g.add_argument('--serve-spec-k', type=int, default=0, metavar="K",
                   help="with --serve-sim: speculative decoding — a draft "
                        "of half the layers (fresh weights) proposes K "
                        "tokens per slot per tick, the target verifies "
                        "them in one batched step; 0 = plain decode, "
                        "K >= 2 speculates")
    g.add_argument('--serve-chaos', type=str, default=None, metavar='SPEC',
                   help="with --serve-sim: serve under a deterministic "
                        "fault schedule through the crash-restartable "
                        "serve supervisor, e.g. "
                        "'engine-crash@serve.tick=5' (sites serve.tick "
                        "and serve.admit)")
    g.add_argument('--serve-deadline-ms', type=float, default=0.0,
                   metavar='D',
                   help="with --serve-sim: per-request completion deadline "
                        "in ms, enforced by the serve supervisor (0 = no "
                        "deadline)")
    g.add_argument('--serve-max-restarts', type=int, default=3,
                   help="with --serve-chaos: engine-rebuild budget")
    g.add_argument('--serve-replicas', type=int, default=0, metavar='N',
                   help="with --serve-sim: serve through a fleet of N "
                        "supervised engine replicas behind a health-aware "
                        "router (serve/fleet.py) — prefix-cache-affinity "
                        "routing, per-replica journals "
                        "(journal-r<i>.jsonl), and journal-backed "
                        "cross-replica migration: killing a whole replica "
                        "(--serve-chaos 'replica-kill@fleet.tick=5') "
                        "re-admits its in-flight requests onto the "
                        "survivors from its journal alone. 0 = one engine")
    g.add_argument('--serve-route',
                   choices=("affinity", "least-loaded", "round-robin"),
                   default="affinity",
                   help="with --serve-replicas: routing policy — "
                        "affinity routes to the replica whose paged pool "
                        "already holds the prompt's registered prefix "
                        "blocks (least-loaded fallback); least-loaded "
                        "orders by queue depth then occupancy; "
                        "round-robin is the affinity-blind baseline")
    g.add_argument('--serve-autoscale', type=str, default=None,
                   metavar='MIN,MAX',
                   help="with --serve-replicas: the fleet autoscaler "
                        "between MIN and MAX replicas — scale-out on "
                        "sustained queue backlog, drain-then-retire on "
                        "idle (serve/fleet.py::AutoscalePolicy)")
    g.add_argument('--serve-prefill-replicas', type=int, default=0,
                   metavar='N',
                   help="with --serve-replicas: disaggregate the fleet — "
                        "the first N replicas form the prefill pool (new "
                        "requests board there only) and the rest the "
                        "decode pool; every request hands off at "
                        "end-of-prefill by the journal snap/adopt move. "
                        "Exclusive with --serve-autoscale")
    g.add_argument('--serve-tp', type=int, default=1,
                   help="tensor-parallel serving width: the K/V pool and "
                        "the blocks shard over this many model coordinates "
                        "(must divide n_heads; coordinate m on card m mod "
                        "n)")
    g.add_argument('--serve-host-blocks', type=int, default=0, metavar='N',
                   help="with --serve-sim: host-RAM offload tier of N "
                        "blocks per replica behind the paged KV pool — "
                        "LRU-evicted prefix blocks demote to host instead "
                        "of dying, and a router affinity hit on a "
                        "host-resident prefix starts the prefetch upload "
                        "at routing time (serve/slots.py)")
    g.add_argument('--serve-prefetch-ticks', type=int, default=1,
                   metavar='T',
                   help="with --serve-host-blocks: engine ticks one "
                        "host->device prefetch upload takes (boarding "
                        "blocks until the upload lands)")
    g.add_argument('--serve-adapters', type=int, default=0, metavar='N',
                   help="with --serve-sim: multi-tenant LoRA serving "
                        "(serve/adapters.py) — register N per-tenant "
                        "low-rank adapters (tenant-0..tenant-N-1) over "
                        "the shared base weights and split arrivals "
                        "evenly across them; each decode tick gathers "
                        "per-slot adapter rows from one device-resident "
                        "bank. With --serve-replicas the router prefers a "
                        "replica where the request's adapter is already "
                        "resident (adapter-affinity)")
    g.add_argument('--serve-adapter-rank', type=int, default=4,
                   metavar='R',
                   help="with --serve-adapters: the low-rank dimension r "
                        "of every adapter's A/B factors (bank memory "
                        "scales linearly with r; models/lora.py "
                        "bank_bytes)")
    g.add_argument('--serve-trace', action='store_true',
                   help="with --serve-sim/--scenario and --telemetry-dir: "
                        "request-scoped tracing (serve/tracing.py) — a "
                        "per-rid span timeline written as "
                        "serve_trace*.json (chrome://tracing / Perfetto) "
                        "plus a request_timeline*.jsonl the report CLI "
                        "reads (python -m ...telemetry.report)")
    g.add_argument('--text-corpus', default=None, metavar="PATH",
                   help="for --model=gpt: train on the bytes of this local "
                        "file (vocab 256) instead of the synthetic stream")
    g.add_argument('--attn', choices=("dense", "flash", "ring", "ulysses"),
                   default="dense",
                   help="attention for --model=gpt (flash = the CUDA "
                        "kernels K1-K3)")
    g.add_argument('--flash-blocks', type=str, default=None, metavar='Q,K',
                   help="with --attn flash: the config's block sizes")
    g.add_argument('--bf16', action='store_true',
                   help="bfloat16 compute (float32 master params and loss)")
    g.add_argument('--remat', action='store_true',
                   help="recompute each stage in the backward "
                        "(torch.utils.checkpoint; over two or more stages)")
    g.add_argument('--metrics-json', type=str, default=None, metavar='PATH',
                   help="append one JSON line of metrics per epoch")
    g.add_argument('--profile', type=str, default=None, metavar='DIR',
                   help="capture a torch.profiler Chrome trace of the whole "
                        "training run into DIR (host ops and CUDA kernels)")
    g.add_argument('--telemetry-dir', type=str, default=None, metavar='DIR',
                   help="structured run telemetry (telemetry/): when "
                        "training, per-epoch metrics.jsonl (step-latency "
                        "p50/p95, examples/sec and tokens/sec, live and "
                        "device memory, pipeline bubble fraction), "
                        "trace.json (Chrome-trace host spans for "
                        "feed/step/eval) and metrics.prom; with "
                        "--serve-sim/--scenario the serve record, journal "
                        "and post-mortem bundles; written into DIR")
    g.add_argument('--telemetry-every', type=int, default=1, metavar='N',
                   help="with --telemetry-dir: fence the device and sample "
                        "step latency every Nth step; 1 = exact per-step "
                        "latency, larger N keeps the host running ahead "
                        "and attributes each fenced window to its N steps")
    g.add_argument('--max-steps-per-epoch', type=int, default=None,
                   metavar='N', help="cap every training epoch at N batches")
    g.add_argument('--sentinel', action='store_true',
                   help="self-healing training (resilience/sentinel.py): "
                        "check every step's loss/grad-norm for NaN/Inf and "
                        "EWMA loss spikes, keep a bounded ring of host "
                        "snapshots, and on an anomaly roll back to the "
                        "newest pre-anomaly snapshot, quarantine the "
                        "offending batch (quarantine.jsonl under "
                        "--checkpoint-dir) and replay. Arms the numeric "
                        "fault sites nan-grad@train.grad, "
                        "corrupt-batch@data.batch, loss-spike@train.step "
                        "for --chaos drills")
    g.add_argument('--sentinel-window', type=int, default=16, metavar='W',
                   help="with --sentinel: EWMA horizon for the loss-spike "
                        "detector AND the escalation window")
    g.add_argument('--sentinel-snapshot-every', type=int, default=4,
                   metavar='K',
                   help="with --sentinel: steps between snapshot-ring "
                        "entries")
    g.add_argument('--chaos', type=str, default=None, metavar='SPEC',
                   help="train under a deterministic fault schedule with "
                        "the elastic checkpoint-restart supervisor, e.g. "
                        "'host-kill@train.step=6' (kinds host-kill, "
                        "slow-tick, ckpt-write-crash, wedged-device; the "
                        "numeric kinds with --sentinel). Requires "
                        "--checkpoint-dir; --model mlp or gpt")
    g.add_argument('--chaos-stages', type=str, default=None,
                   metavar='S1,S2', help="with --chaos: the stage-count "
                                         "ladder, largest first; each lost "
                                         "host steps one rung down")
    g.add_argument('--chaos-max-restarts', type=int, default=3,
                   help="with --chaos: recoverable-failure restart budget "
                        "before the run FAILS loudly")
    g.add_argument('--scenario', type=str, default=None, metavar='NAME',
                   help="run one SLO-gated serving scenario on the "
                        "virtual clock; exits nonzero unless every class "
                        "attains its SLOs and every request is accounted "
                        "for. NAME 'list' prints the catalog")
    g.add_argument('--dryrun', type=int, default=0, metavar='N',
                   help="smoke mode: train only N batches of one epoch, "
                        "then the normal eval")
    g.add_argument('--lint', action='store_true',
                   help="static-analysis preflight (analysis/): trace the "
                        "exact steps this run is about to execute and lint "
                        "them before the card runs one — train+eval steps "
                        "for a training run (permute deadlocks, unreduced "
                        "gradients, mesh-axis validity, dtype drift, "
                        "in-place buffer hazards); the whole serving-"
                        "program registry for --serve-sim (KV scatter "
                        "bounds, buffer flow through the tick, build memo, "
                        "HBM bytes/tick); abort on ERROR findings")
    g.add_argument('--lint-only', action='store_true',
                   help="run the --lint preflight and exit without "
                        "training/serving (exit 0 clean, 2 on ERROR "
                        "findings)")
    g.add_argument('--peer-timeout', type=float, default=60.0,
                   help="multi-process dead-peer watchdog: abort with a "
                        "nonzero exit if a peer crashes or stops "
                        "heartbeating for this many seconds (0 disables; "
                        "the reference hangs forever on a dead peer)")
    g.add_argument('--heartbeat-port', type=int, default=None,
                   help="TCP port for the dead-peer watchdog "
                        "(default: master_port + 1)")
    return p


def main(argv: list[str] | None = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.rank is None and args.world_size != 1:
        raise SystemExit("Must provide rank argument.")
    if args.world_size > 1:
        _refuse_one_process_paths(args)
        _check_serve_world(args)
    from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (
        bootstrap_distributed,
    )
    bootstrap_distributed(args.rank or 0, args.world_size, args.master_addr,
                          args.master_port)
    watchdog = None
    if args.world_size > 1 and args.peer_timeout > 0:
        from simple_distributed_machine_learning_tpu_torch.utils.failure import (  # noqa: E501
            spawn_watchdog,
        )
        hb_port = (args.heartbeat_port if args.heartbeat_port is not None
                   else int(args.master_port) + 1)
        # a SUBPROCESS, not a thread: a thread freezes when the main thread
        # blocks in a native collective holding the GIL (utils/failure.py)
        watchdog = spawn_watchdog(args.rank or 0, args.world_size,
                                  args.master_addr, hb_port,
                                  timeout=args.peer_timeout)
    try:
        _dispatch(args)
    except BaseException:
        # crash path: kill the monitor without the goodbye, so the peers
        # read this process as failed, and disarm its kill of this process
        if watchdog is not None:
            watchdog.abort()
        raise
    if watchdog is not None:
        watchdog.stop()                  # the goodbye: a clean exit


def _refuse_one_process_paths(args) -> None:
    """The path that runs in one process only, with the JAX CLI's text."""
    if args.chaos is not None:
        raise SystemExit(
            "--chaos supervises in-process (single-process elastic "
            "restart); multi-process peer loss is the watchdog's domain "
            "(--peer-timeout)")


def _check_serve_world(args) -> None:
    """``--serve-sim --serve-tp T`` over W processes, checked before the
    rendezvous (every process exits alike, none is taken down by a
    peer's watchdog first): the serving flags, then T against the heads,
    the world's devices (one per process, the JAX CLI's count and text)
    and the split of the mesh."""
    if args.serve_sim <= 0 or args.scenario is not None:
        return
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        GPTConfig,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (
        check_split,
    )
    _check_serve_args(args)
    tp, world = args.serve_tp, args.world_size
    heads = GPTConfig().n_heads
    if heads % tp:
        raise SystemExit(f"--serve-tp {tp} must divide the model's head "
                         f"count ({heads})")
    if tp > world:
        raise SystemExit(
            f"--serve-tp {tp} needs {tp} devices, have {world} (on CPU: "
            f"XLA_FLAGS=--xla_force_host_platform_device_count={tp})")
    if tp > 1:
        try:
            check_split(world, n_model=tp)
        except ValueError as e:
            raise SystemExit(str(e)) from None


def _dispatch(args) -> None:
    import torch

    from simple_distributed_machine_learning_tpu_torch._device import (
        resolve_device,
    )
    if args.dryrun < 0:
        raise SystemExit(f"--dryrun needs a non-negative step count, got "
                         f"{args.dryrun}")
    if args.tp < 1:
        raise SystemExit(f"--tp must be >= 1, got {args.tp}")
    if args.tp > 1 and args.model not in ("mlp", "gpt"):
        raise SystemExit("--tp is only supported with --model=mlp or gpt")
    if args.sp > 1 and args.model != "gpt":
        raise SystemExit("--sp is only supported with --model=gpt")
    if args.ep > 1 and (args.model != "gpt" or args.experts < 1):
        raise SystemExit("--ep needs --model=gpt with --experts > 0")
    if args.generate > 0 and args.model != "gpt":
        raise SystemExit("--generate is only supported with --model=gpt")
    if args.max_steps_per_epoch is not None and args.max_steps_per_epoch < 1:
        raise SystemExit(f"--max-steps-per-epoch must be >= 1, got "
                         f"{args.max_steps_per_epoch}")
    if args.sentinel_window < 2:
        raise SystemExit(f"--sentinel-window must be >= 2, got "
                         f"{args.sentinel_window}")
    if args.sentinel_snapshot_every < 1:
        raise SystemExit(f"--sentinel-snapshot-every must be >= 1, got "
                         f"{args.sentinel_snapshot_every}")
    device = resolve_device(args.device)
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 1
    n_stages = (args.stages if args.stages is not None
                else (2 if n_cards >= 2 or args.world_size > 1 else 1))
    if args.scenario is not None:
        _run_scenario(args, n_stages, device)
        return
    if args.chaos is not None:
        _run_chaos(args, n_stages, device)
        return
    if args.serve_sim > 0:
        if args.model != "gpt":
            raise SystemExit("--serve-sim is only supported with "
                             "--model=gpt")
        if args.experts > 0 or args.sp > 1 or args.tp > 1 or args.ep > 1:
            raise SystemExit(
                "--serve-sim serves a dense single-device build (the "
                "make_cached_decoder restrictions): drop "
                "--experts/--sp/--tp/--ep")
        _run_serve(args, n_stages, device)
        return
    if args.model == "gpt":
        _run_gpt(args, n_stages, device)
        return
    from simple_distributed_machine_learning_tpu_torch.data.mnist import (
        Dataset,
        load_mnist,
    )
    if args.model == "lenet":
        from simple_distributed_machine_learning_tpu_torch.models.lenet import (  # noqa: E501
            make_lenet_stages,
        )
        stages, wire_dim, out_dim = make_lenet_stages(args.seed, n_stages,
                                                      device)
    elif args.tp > 1:
        from simple_distributed_machine_learning_tpu_torch.parallel.tensor import (  # noqa: E501
            make_mlp_tp_stages,
        )
        dims = [int(d) for d in args.mlp_dims.split(",")]
        stages, wire_dim, out_dim = make_mlp_tp_stages(
            args.seed, dims, n_stages, args.tp, overlap=args.overlap,
            device=device)
    else:
        from simple_distributed_machine_learning_tpu_torch.models.mlp import (
            make_mlp_stages,
        )
        dims = [int(d) for d in args.mlp_dims.split(",")]
        stages, wire_dim, out_dim = make_mlp_stages(args.seed, dims,
                                                    n_stages, device)
    train_ds, test_ds = load_mnist(args.data_root)
    if args.model == "mlp":
        train_ds = Dataset(train_ds.x.reshape(len(train_ds.x), -1),
                           train_ds.y)
        test_ds = Dataset(test_ds.x.reshape(len(test_ds.x), -1), test_ds.y)
    _fit(args, _trainer(args, stages, wire_dim, out_dim, train_ds, test_ds,
                        device))


def _placement(device, n_coords: int, inner: int = 1) -> list:
    """Mesh coordinate i's device: the ``inner`` (model x seq x expert)
    coordinates of a replica's stage on one card, stage-and-replica group
    ``g = i // inner`` on card ``g mod n`` of the n visible cards on CUDA
    (groups share a card when there are fewer cards); every coordinate on
    the CPU with ``--device cpu``."""
    from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (
        visible_devices,
    )
    if device.type != "cuda":
        return [device] * n_coords
    cards = visible_devices()
    return [cards[(i // inner) % len(cards)] for i in range(n_coords)]


def _pipeline(args, stages, wire_dim, out_dim, device):
    """The run's ``Pipeline``: one stage on ``device``, or a ``--dp`` x
    ``len(stages)`` mesh over :func:`_placement`'s devices, whose
    placement process 0 prints (and, across processes, the wire)."""
    import torch

    from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (
        make_mesh,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (  # noqa: E501
        Pipeline,
    )
    n = len(stages)
    inner = args.tp * args.sp * args.ep
    wide = n > 1 or args.dp > 1 or inner > 1 or args.world_size > 1
    mesh = make_mesh(n_stages=n, n_data=args.dp, n_model=args.tp,
                     n_seq=args.sp, n_expert=args.ep,
                     devices=_placement(device, n * args.dp * inner,
                                        inner) if wide else None)
    if mesh is not None and mesh.rank == 0:
        if mesh.distributed:
            print(f"| distributed: {mesh.world_size} processes, gloo over "
                  f"the host, rank 0 on {mesh.device(0, 0)}")
        print(f"| pipeline: {n} stages"
              + (f" x {mesh.n_data} data replicas" if mesh.n_data > 1
                 else "")
              + (f" x {mesh.n_model} model shards" if mesh.n_model > 1
                 else "")
              + (f" x {mesh.n_seq} seq shards" if mesh.n_seq > 1 else "")
              + (f" x {mesh.n_expert} expert shards" if mesh.n_expert > 1
                 else "")
              + " on " + ", ".join(str(d) for d in mesh.coord_devices))
    return Pipeline(stages, mesh, wire_dim, out_dim,
                    n_microbatches=args.microbatches,
                    compute_dtype=torch.bfloat16 if args.bf16 else None,
                    remat=args.remat, schedule=args.schedule,
                    overlap=args.overlap,
                    device=device if mesh is None else None)


def _trainer(args, stages, wire_dim, out_dim, train_ds, test_ds, device):
    from simple_distributed_machine_learning_tpu_torch.train.trainer import (
        Trainer,
    )
    return Trainer(_pipeline(args, stages, wire_dim, out_dim, device),
                   train_ds, test_ds, _train_config(args),
                   opt=_make_opt(args, _total_steps(args, train_ds)),
                   telemetry=_telemetry(args))


def _telemetry(args):
    if not args.telemetry_dir:
        return None
    if args.telemetry_every < 1:
        raise SystemExit(f"--telemetry-every must be >= 1, got "
                         f"{args.telemetry_every}")
    from simple_distributed_machine_learning_tpu_torch.telemetry import (
        Telemetry,
    )
    return Telemetry(args.telemetry_dir, every=args.telemetry_every)


def _train_config(args):
    from simple_distributed_machine_learning_tpu_torch.train.trainer import (
        TrainConfig,
    )
    return TrainConfig(
        # --dryrun N: N batches of one epoch; --max-steps-per-epoch caps
        # every epoch without collapsing the run to one
        epochs=1 if args.dryrun else args.epochs,
        max_steps_per_epoch=args.dryrun or args.max_steps_per_epoch,
        batch_size=args.batch_size,
        learning_rate=args.lr, momentum=args.momentum,
        seed=args.seed, checkpoint_dir=args.checkpoint_dir,
        resume=not args.no_resume, zero1=args.zero1,
        async_checkpoint=args.async_checkpoint,
        shuffle=args.shuffle,
        metrics_json=args.metrics_json,
        sentinel=args.sentinel,
        sentinel_window=args.sentinel_window,
        sentinel_snapshot_every=args.sentinel_snapshot_every)


def _make_opt(args, total_steps: int):
    from simple_distributed_machine_learning_tpu_torch.train import (
        schedules,
    )
    from simple_distributed_machine_learning_tpu_torch.train.optimizer import (  # noqa: E501
        adamw,
        clip_by_global_norm,
        sgd,
    )
    if args.lr_schedule == "cosine":
        lr = schedules.cosine(args.lr, total_steps)
    elif args.lr_schedule == "warmup-cosine":
        lr = schedules.warmup_cosine(args.lr, args.warmup_steps, total_steps)
    elif args.lr_schedule == "step":
        lr = schedules.step_decay(args.lr, args.lr_step_size, args.lr_gamma)
    else:
        lr = args.lr
    opt = (adamw(lr, weight_decay=args.weight_decay)
           if args.optimizer == "adamw" else sgd(lr, args.momentum))
    if args.clip_norm > 0:
        opt = clip_by_global_norm(opt, args.clip_norm)
    return opt


def _total_steps(args, train_ds) -> int:
    """The LR-schedule horizon: the steps the run will execute."""
    per_epoch = max(1, -(-len(train_ds.x) // args.batch_size))
    if args.max_steps_per_epoch is not None:
        per_epoch = min(per_epoch, args.max_steps_per_epoch)
    return args.epochs * per_epoch


def _fit(args, trainer) -> None:
    if args.lint or args.lint_only:
        # the preflight gate: lint the EXACT steps this trainer is about
        # to execute (same pipeline, optimizer, in-place updates and batch
        # shapes) — fake tensors: no FLOP, no launch, no device memory
        from simple_distributed_machine_learning_tpu_torch.analysis.preflight import (  # noqa: E501
            lint_trainer,
        )
        from simple_distributed_machine_learning_tpu_torch.analysis.programs import (  # noqa: E501
            _injected_findings,
        )
        report = lint_trainer(trainer)
        report.findings.extend(_injected_findings())
        trainer._print(report.format(costs=True))
        if not report.ok():
            raise SystemExit(2)
        trainer._print("| --lint: preflight clean")
        if args.lint_only:
            return
    if args.eval_only:
        if args.checkpoint_dir and trainer.start_epoch == 1:
            trainer._print("| --eval-only: no checkpoint found, evaluating "
                           "fresh-initialized params")
        trainer.evaluate()
        if trainer.telemetry is not None:
            trainer.telemetry.close()    # eval spans -> trace.json
        return
    # graceful preemption: SIGTERM/SIGINT finish the in-flight step, write
    # a synchronous checkpoint with the mid-epoch data cursor, and exit 0
    import signal

    def _on_signal(signum, frame):
        trainer.request_stop(signum)

    old_handlers = {}
    try:
        for s in (signal.SIGTERM, signal.SIGINT):
            old_handlers[s] = signal.signal(s, _on_signal)
    except ValueError:
        old_handlers = {}              # not the main thread: no handlers
    try:
        if args.profile:
            from simple_distributed_machine_learning_tpu_torch.utils.profiler import (  # noqa: E501
                trace,
            )
            with trace(args.profile):
                trainer.fit()
        else:
            trainer.fit()
    finally:
        for s, h in old_handlers.items():
            signal.signal(s, h)
    stats = trainer.sentinel_stats()
    if stats is not None:
        trainer._print(
            f"| sentinel: absorbed {stats['anomalies']} anomal"
            f"{'y' if stats['anomalies'] == 1 else 'ies'} "
            f"({stats['rollbacks']} rollback(s), "
            f"{stats['quarantined_batches']} quarantined batch(es), "
            f"ring {stats['snapshot_ring_bytes']} bytes)")
    if trainer.preempted:
        trainer._print(
            "| train: graceful shutdown complete — "
            + ("resume with the same --checkpoint-dir to continue "
               "bit-exact" if trainer.preempt_persisted
               else "no --checkpoint-dir was configured, so the "
               "interrupted progress was NOT persisted"))


def _gpt_setup(args):
    """The GPT run's config (vocab 128, or 256 with --text-corpus; the
    --attn and --flash-blocks choices) and its train and test sets: a
    synthetic Markov stream (one chain, disjoint train/test sequences) or
    the bytes of --text-corpus, as float token ids."""
    import numpy as np

    from simple_distributed_machine_learning_tpu_torch.data.mnist import (
        Dataset,
    )
    from simple_distributed_machine_learning_tpu_torch.data.text import (
        byte_corpus,
        synthetic_tokens,
    )
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        GPTConfig,
    )
    fb = {}
    if args.flash_blocks:
        if args.attn != "flash":
            raise SystemExit("--flash-blocks needs --attn flash")
        try:
            bq, bk = (int(v) for v in args.flash_blocks.split(","))
        except ValueError:
            raise SystemExit(
                f"--flash-blocks expects Q,K integers, got "
                f"{args.flash_blocks!r}") from None
        fb = {"flash_block_q": bq, "flash_block_k": bk}
    cfg = GPTConfig(vocab=256 if args.text_corpus else 128,
                    n_experts=args.experts,
                    moe_top_k=min(2, max(1, args.experts)),
                    attn_impl=args.attn, n_seq=args.sp,
                    n_expert_parallel=args.ep,
                    n_tensor_parallel=args.tp, overlap=args.overlap, **fb)

    def as_ds(x, y):
        return Dataset(x.astype(np.float32), y)

    if args.text_corpus:
        tr, te = byte_corpus(args.text_corpus, cfg.seq_len)
        return cfg, as_ds(*tr), as_ds(*te)
    all_data = synthetic_tokens(7000, cfg.seq_len, cfg.vocab, seed=args.seed)
    return (cfg, as_ds(all_data.x[:6000], all_data.y[:6000]),
            as_ds(all_data.x[6000:], all_data.y[6000:]))


def _run_gpt(args, n_stages: int, device) -> None:
    """--model gpt: the tiny GPT on a synthetic Markov token stream (or
    the bytes of --text-corpus), same trainer and console surface."""
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        make_gpt_stages,
    )
    cfg, train_ds, test_ds = _gpt_setup(args)
    stages, wire_dim, out_shape = make_gpt_stages(args.seed, cfg, n_stages,
                                                  device)
    trainer = _trainer(args, stages, wire_dim, out_shape, train_ds, test_ds,
                       device)
    _fit(args, trainer)
    if args.generate > 0:
        _print_sample(args, trainer, cfg, test_ds)


def _print_sample(args, trainer, cfg, test_ds) -> None:
    """--generate N: decode N tokens from the trained model with the
    KV-cache decoder, straight from the live stage modules
    (``decoder_from_pipeline``); over two or more stages stage by stage
    (``models/pp_decode.py``; across processes over replica 0's ring), one
    prompt. A one-stage run of several processes skips, with the JAX CLI's
    line."""
    import numpy as np
    import torch

    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        decoder_from_pipeline,
    )
    from simple_distributed_machine_learning_tpu_torch.models.pp_decode import (  # noqa: E501
        make_pp_decoder,
    )
    n_new = min(args.generate, cfg.seq_len - 1)
    t0 = max(1, min(cfg.seq_len - n_new, 16))
    prompt = np.asarray(test_ds.x[:1, :t0], np.int32)
    pipe = trainer.pipe
    cache_dtype = torch.bfloat16 if args.bf16 else None
    if cfg.n_experts > 0 or cfg.n_seq > 1 or cfg.n_tensor_parallel > 1:
        trainer._print("| --generate: skipped (MoE/seq-/tensor-parallel "
                       "builds decode via models.make_decoder)")
        return
    if pipe.n_stages == 1 and args.world_size > 1:
        trainer._print("| --generate: skipped (single-stage multi-process "
                       "run; decode from a checkpoint instead)")
        return
    if pipe.n_stages >= 2:
        dec = make_pp_decoder(pipe, cfg, t0, n_new, cache_dtype=cache_dtype)
    else:
        dec = decoder_from_pipeline(pipe, cfg, t0, n_new,
                                    cache_dtype=cache_dtype)
    toks = _decode_timed(args, trainer, dec, prompt, n_new)
    if toks is None:
        return                           # not on replica 0's first stage
    toks = toks[0]
    if args.text_corpus:
        text = bytes(int(t) for t in toks).decode("latin-1")
        trainer._print(f"| sample ({t0}-byte prompt + {n_new} generated):\n"
                       f"{text!r}")
    else:
        trainer._print(f"| sample tokens (prompt {t0} + {n_new} generated): "
                       f"{toks.tolist()}")


def _decode_timed(args, trainer, dec, prompt, n_new):
    """Run the --generate decode; with --telemetry-dir attached, route its
    timing through a telemetry StepTimer (``decode_time_ms``) so decode
    latency and tokens/sec land in metrics.jsonl (and the Prometheus
    exposition) instead of being print-only. The first call is the
    compile window (StepTimer splits it out); a second decode with a
    different key measures the steady latency — distinct inputs, so a
    cached result cannot fake the number. Returns the first decode's
    tokens on the host."""
    import os
    import time

    from simple_distributed_machine_learning_tpu_torch.ops.random import (
        fold_in,
        key_data,
    )

    def run(seed):
        out = dec(trainer.params, prompt, key_data(seed))
        return None if out is None else out.cpu().numpy()

    tele = trainer.telemetry
    if tele is None:
        return run(args.seed)
    from simple_distributed_machine_learning_tpu_torch.telemetry.registry import (  # noqa: E501
        append_jsonl,
    )
    from simple_distributed_machine_learning_tpu_torch.telemetry.timer import (  # noqa: E501
        StepTimer,
    )
    timer = StepTimer(registry=tele.registry, name="decode_time_ms")
    b, n_tok = prompt.shape[0], prompt.shape[0] * n_new
    t0 = time.perf_counter()
    toks = run(args.seed)
    timer.record_window(time.perf_counter() - t0, steps=1)   # compile window
    t0 = time.perf_counter()
    run(fold_in(args.seed, 1))                               # a fence
    timer.record_window(time.perf_counter() - t0, steps=1, tokens=n_tok)
    if tele._is_main():
        rec = {"kind": "decode", "batch": int(b), "n_new": int(n_new),
               **timer.summary()}
        append_jsonl(os.path.join(tele.outdir, "metrics.jsonl"), rec)
        tele.flush()                     # decode series -> metrics.prom
    return toks


# prompt-length buckets of the simulated serving workload
GPT_SERVE_PROMPTS = (4, 8, 12)


def _check_serve_args(args) -> None:
    for flag, value, low in (("--serve-slots", args.serve_slots, 1),
                             ("--serve-max-new", args.serve_max_new, 1),
                             ("--serve-block-size", args.serve_block_size,
                              1)):
        if value < low:
            raise SystemExit(f"{flag} must be >= {low}, got {value}")
    if args.serve_prefill_chunk < 0:
        raise SystemExit(f"--serve-prefill-chunk must be >= 1 (or 0 for "
                         f"whole-prompt chunks), got "
                         f"{args.serve_prefill_chunk}")
    if args.serve_shared_prefix < 0:
        raise SystemExit(f"--serve-shared-prefix must be >= 0, got "
                         f"{args.serve_shared_prefix}")
    if args.serve_tp < 1:
        raise SystemExit(f"--serve-tp must be >= 1, got {args.serve_tp}")
    if args.serve_spec_k == 1 or args.serve_spec_k < 0:
        raise SystemExit(f"--serve-spec-k must be 0 (plain decode) or "
                         f">= 2, got {args.serve_spec_k}")
    if args.serve_deadline_ms < 0:
        raise SystemExit(f"--serve-deadline-ms must be >= 0 (0 = none), "
                         f"got {args.serve_deadline_ms}")
    if args.serve_max_restarts < 0:
        raise SystemExit(f"--serve-max-restarts must be >= 0, got "
                         f"{args.serve_max_restarts}")
    if args.serve_replicas < 0:
        raise SystemExit(f"--serve-replicas must be >= 0 (0 = single "
                         f"engine), got {args.serve_replicas}")
    if args.serve_route != "affinity" and not args.serve_replicas:
        raise SystemExit("--serve-route needs --serve-replicas (a single "
                         "engine has nothing to route between)")
    if args.serve_host_blocks < 0:
        raise SystemExit(f"--serve-host-blocks must be >= 0 (0 = no host "
                         f"tier), got {args.serve_host_blocks}")
    if args.serve_adapters < 0:
        raise SystemExit(f"--serve-adapters must be >= 0 (0 = base model "
                         f"only), got {args.serve_adapters}")
    if args.serve_adapters and args.serve_adapter_rank < 1:
        raise SystemExit(f"--serve-adapter-rank must be >= 1, got "
                         f"{args.serve_adapter_rank}")
    if args.serve_prefetch_ticks < 1:
        raise SystemExit(f"--serve-prefetch-ticks must be >= 1, got "
                         f"{args.serve_prefetch_ticks}")


def _fleet_autoscale(args):
    """The parsed ``--serve-autoscale`` policy (None without one), after
    the fleet flags' validation, in the JAX CLI's words."""
    autoscale = None
    if args.serve_autoscale:
        if not args.serve_replicas:
            raise SystemExit("--serve-autoscale needs --serve-replicas")
        from simple_distributed_machine_learning_tpu_torch.serve import (
            AutoscalePolicy,
        )
        try:
            lo, hi = (int(v) for v in args.serve_autoscale.split(","))
            autoscale = AutoscalePolicy(min_replicas=lo, max_replicas=hi)
        except ValueError as e:
            raise SystemExit(f"bad --serve-autoscale (expected MIN,MAX "
                             f"integers): {e}") from None
        if not lo <= args.serve_replicas <= hi:
            raise SystemExit(
                f"--serve-replicas {args.serve_replicas} outside the "
                f"--serve-autoscale bounds [{lo}, {hi}]")
    if args.serve_prefill_replicas:
        if not args.serve_replicas:
            raise SystemExit("--serve-prefill-replicas needs "
                             "--serve-replicas (pools split a fleet)")
        if not 0 < args.serve_prefill_replicas < args.serve_replicas:
            raise SystemExit(
                f"--serve-prefill-replicas must leave at least one decode "
                f"replica (0 < N < {args.serve_replicas}), got "
                f"{args.serve_prefill_replicas}")
        if args.serve_autoscale:
            raise SystemExit("--serve-prefill-replicas and "
                             "--serve-autoscale are mutually exclusive "
                             "(the autoscaler assumes one symmetric pool)")
    return autoscale


def _serve_plan(args):
    """The parsed ``--serve-chaos`` schedule (None without one)."""
    if not args.serve_chaos:
        return None
    from simple_distributed_machine_learning_tpu_torch.resilience import (
        faults,
    )
    try:
        plan = faults.FaultPlan.parse(args.serve_chaos)
    except ValueError as e:
        raise SystemExit(f"bad --serve-chaos spec: {e}") from None
    if not args.serve_replicas and any(
            s.site == "fleet.tick" for s in plan.specs):
        # only a fleet probes fleet.tick: the fault would never fire
        raise SystemExit(
            "--serve-chaos at site fleet.tick needs --serve-replicas "
            "(a single engine never probes the fleet site, so the "
            "fault would never fire)")
    return plan


def _run_chaos(args, n_stages: int, device) -> None:
    """--chaos SPEC: training under a deterministic fault schedule with the
    elastic checkpoint-restart supervisor (resilience/supervisor.py).

    The supervisor rebuilds the trainer from scratch after every
    recoverable failure — nothing in-memory survives an attempt — restoring
    the latest checksum-valid checkpoint from the store in
    --checkpoint-dir, repacked onto the surviving stage count of the
    --chaos-stages ladder. Exits 0 only when training ran to completion
    within the restart budget and the schedule fired.
    """
    import dataclasses

    from simple_distributed_machine_learning_tpu_torch.resilience import (
        CheckpointStore,
        RestartPolicy,
        faults,
        make_elastic_trainer,
        supervise,
    )

    if args.model not in ("mlp", "gpt"):
        raise SystemExit(
            "--chaos supports --model mlp or gpt (the contiguous-split "
            "families repack_checkpoint can rewrite across stage counts; "
            "lenet's conv|fc split is a structural rename)")
    if args.experts > 0 or args.sp > 1 or args.tp > 1 or args.ep > 1 \
            or args.serve_sim > 0:
        raise SystemExit(
            "--chaos drills the pipeline-parallel training path: drop "
            "--experts/--sp/--tp/--ep/--serve-sim")
    if not args.checkpoint_dir:
        raise SystemExit("--chaos needs --checkpoint-dir (the supervisor "
                         "restores from its checkpoint store)")
    if args.chaos_max_restarts < 0:
        raise SystemExit(f"--chaos-max-restarts must be >= 0, got "
                         f"{args.chaos_max_restarts}")
    try:
        plan = faults.FaultPlan.parse(args.chaos)
    except ValueError as e:
        raise SystemExit(f"bad --chaos spec: {e}") from None
    numeric = sorted({s.kind for s in plan.specs
                      if s.kind in faults.SENTINEL_KINDS})
    if numeric and not args.sentinel:
        # without the sentinel a numeric fault's standard effect is a
        # raised NumericFault the supervisor treats as a real bug
        raise SystemExit(
            f"--chaos plan contains sentinel-interpreted kinds "
            f"({', '.join(numeric)}): add --sentinel so the trainer "
            f"absorbs them")
    if args.chaos_stages:
        try:
            topologies = [int(s) for s in args.chaos_stages.split(",")]
        except ValueError:
            raise SystemExit(f"--chaos-stages expects a comma list of "
                             f"stage counts, got {args.chaos_stages!r}"
                             ) from None
        if any(t < 1 for t in topologies):
            raise SystemExit(f"--chaos-stages entries must be >= 1, got "
                             f"{topologies}")
    else:
        topologies = [n_stages]

    if args.model == "gpt":
        from simple_distributed_machine_learning_tpu_torch.models.gpt import (
            make_gpt_stages,
        )
        cfg, train_ds, test_ds = _gpt_setup(args)

        def build_pipe(n):
            return _pipeline(args, *make_gpt_stages(args.seed, cfg, n,
                                                    device), device)
    else:
        from simple_distributed_machine_learning_tpu_torch.data.mnist import (
            Dataset,
            load_mnist,
        )
        from simple_distributed_machine_learning_tpu_torch.models.mlp import (
            make_mlp_stages,
        )
        dims = [int(d) for d in args.mlp_dims.split(",")]
        tr, te = load_mnist(args.data_root)
        train_ds = Dataset(tr.x.reshape(len(tr.x), -1), tr.y)
        test_ds = Dataset(te.x.reshape(len(te.x), -1), te.y)

        def build_pipe(n):
            return _pipeline(args, *make_mlp_stages(args.seed, dims, n,
                                                    device), device)

    store = CheckpointStore(args.checkpoint_dir, keep=5)
    # the store owns persistence: the Trainer's own state.npz path stays off
    config = dataclasses.replace(_train_config(args), checkpoint_dir=None)
    total = _total_steps(args, train_ds)

    def build_trainer(n):
        return make_elastic_trainer(
            build_pipe, n, store, train_ds, test_ds, config,
            opt_factory=lambda pipe: _make_opt(args, total))

    faults.install(plan)
    try:
        report = supervise(
            build_trainer, topologies,
            policy=RestartPolicy(max_restarts=args.chaos_max_restarts))
    finally:
        faults.uninstall()
    print(f"| chaos: completed after {report['restarts']} restart(s); "
          f"attempts: "
          + " -> ".join(f"{a['n_stages']}st/{a['outcome']}"
                        f"{'(' + a['fault'] + ')' if 'fault' in a else ''}"
                        for a in report["attempts"])
          + f"; faults fired: {plan.stats()['total_fired']}")
    if args.sentinel:
        tot = {"anomalies": 0, "rollbacks": 0}
        quarantined = 0
        for a in report["attempts"]:
            s = a.get("sentinel") or {}
            tot["anomalies"] += s.get("anomalies", 0)
            tot["rollbacks"] += s.get("rollbacks", 0)
            # the journal is cumulative across attempts (loaded from disk):
            # the last attempt's count is the total
            quarantined = s.get("quarantined_batches", quarantined)
        print(f"| chaos: sentinel absorbed {tot['anomalies']} anomal"
              f"{'y' if tot['anomalies'] == 1 else 'ies'} "
              f"({tot['rollbacks']} rollback(s), {quarantined} "
              f"quarantined batch(es))")
    if plan.stats()["total_fired"] == 0:
        # a chaos drill whose schedule never fired proves nothing
        raise SystemExit(
            "--chaos plan never fired (scheduled step beyond the run?) — "
            "the drill is vacuous; fix the schedule")


def _lint_serve_gate(args, stages, serve_cfg, mesh, draft_stages,
                     draft_cfg, device) -> None:
    """The serve-path preflight gate: trace and lint the EXACT programs
    the ticks will run (block/position contracts through the
    scatter-bounds pass, in-place buffer flow through the composite tick,
    the build memo and retrace policy against the simulator's prompt
    buckets, the HBM bytes per tick with the K4 nodes' rows reconciled),
    then the fleet protocol's bounded model check — exit 2 on an ERROR.
    The solo-parity decoder no tick runs is ``--serve``'s to lint."""
    from simple_distributed_machine_learning_tpu_torch.analysis.programs import (  # noqa: E501
        ServeSpec,
        lint_serve,
    )
    from simple_distributed_machine_learning_tpu_torch.analysis.protocol import (  # noqa: E501
        check_protocol,
    )
    buckets = tuple(args.serve_shared_prefix + p for p in GPT_SERVE_PROMPTS)
    report = lint_serve(stages, ServeSpec(
        serve_cfg, n_slots=args.serve_slots, kv_layout="paged",
        block_size=args.serve_block_size,
        prefill_chunk=(args.serve_prefill_chunk or None),
        prompt_lens=buckets, spec_k=args.serve_spec_k,
        draft_cfg=draft_cfg, attn_kernel="fused",
        host_cache_blocks=args.serve_host_blocks,
        prefetch_ticks=args.serve_prefetch_ticks,
        # the engine's AdapterStore sizes the bank n_slots + 1 (row 0 =
        # the zero base row): the linted layouts are the EXACT programs
        n_adapters=(args.serve_slots + 1 if args.serve_adapters else 0),
        adapter_rank=(args.serve_adapter_rank if args.serve_adapters
                      else 0)),
        mesh=mesh, draft_stages=draft_stages, device=device, anchor=False)
    print(report.format(costs=True))
    if not report.ok():
        raise SystemExit(2)
    proto = check_protocol()
    print(f"| serve --lint protocol: {proto.verdict}")
    if not proto.ok():
        print(proto.format(costs=False))
        raise SystemExit(2)
    print("| serve --lint: preflight clean")


def _rank_device(args, device):
    """This process's card for serving: card ``rank mod n`` of the n
    visible cards over several processes (``_placement``'s rule, one
    coordinate per process), ``device`` itself otherwise."""
    if args.world_size > 1 and device.type == "cuda":
        return _placement(device, args.world_size)[args.rank or 0]
    return device


def _serve_mesh(args, device):
    """The ``--serve-tp T`` serving mesh: one process's T model
    coordinates, coordinate m on card m mod n (where the JAX CLI needs T
    devices); over W processes (:func:`_check_serve_world` passed), one
    mesh across them, each process owning T / W coordinates on card
    ``rank mod n``. Prints the placement."""
    from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (
        make_mesh,
    )
    tp, world = args.serve_tp, args.world_size
    mesh = make_mesh(1, n_model=tp, devices=_placement(
        device, tp, tp // world if world > 1 else 1))
    print(f"| serving: tp {tp} on "
          + ", ".join(str(d) for d in mesh.coord_devices)
          + (f" ({world} processes, {tp // world} coordinate(s) each, "
             f"sums over the host)" if mesh.distributed else ""))
    return mesh


def _run_serve(args, n_stages: int, device) -> None:
    """--serve-sim N: continuous-batching inference over a simulated
    open-loop Poisson trace. Params come from --checkpoint-dir when a
    checkpoint exists, otherwise fresh weights from --seed; nothing
    trains. The engine attends through the paged-attention kernel
    (``attn_kernel="fused"``; on the CPU, its plain version), where the
    JAX CLI keeps its engine's default gather-then-dense path: greedy
    streams are equal either way. With --serve-replicas the trace runs
    through a fleet of supervised replicas; otherwise, with --serve-chaos
    or --serve-deadline-ms, behind one serve supervisor. --serve-trace
    records the request timelines; --serve-host-blocks adds the host
    offload tier and --serve-adapters N serves N LoRA tenants. Exits 1
    unless every submitted request completed or was structurally shed."""
    import dataclasses
    import os
    import signal
    import tempfile

    import torch

    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        GPTConfig,
        make_gpt_stages,
    )
    from simple_distributed_machine_learning_tpu_torch.ops.random import (
        fold_in,
    )
    from simple_distributed_machine_learning_tpu_torch.resilience import (
        faults,
    )
    from simple_distributed_machine_learning_tpu_torch.models import lora
    from simple_distributed_machine_learning_tpu_torch.serve import (
        AdapterStore,
        InferenceEngine,
        ServeFleet,
        ServeMetrics,
        ServeSupervisor,
        ServeTrace,
        SimConfig,
        TrafficClass,
        engine_factory,
        simulate,
    )
    _check_serve_args(args)
    autoscale = _fleet_autoscale(args)
    serve_plan = _serve_plan(args)
    fleet_mode = args.serve_replicas > 0
    supervised = (not fleet_mode
                  and bool(args.serve_chaos or args.serve_deadline_ms))
    cfg = GPTConfig(vocab=256 if args.text_corpus else 128)
    if cfg.n_heads % args.serve_tp:
        raise SystemExit(f"--serve-tp {args.serve_tp} must divide the "
                         f"model's head count ({cfg.n_heads})")
    longest = args.serve_shared_prefix + max(GPT_SERVE_PROMPTS)
    if longest + 1 > cfg.seq_len:
        raise SystemExit(
            f"--serve-shared-prefix {args.serve_shared_prefix} leaves no "
            f"room to generate: prefix + longest simulated prompt "
            f"({max(GPT_SERVE_PROMPTS)}) + 1 token must fit seq_len "
            f"{cfg.seq_len}")
    device = _rank_device(args, device)
    serve_cfg, mesh = cfg, None
    if args.serve_tp > 1:
        serve_cfg = dataclasses.replace(cfg, n_tensor_parallel=args.serve_tp)
        mesh = _serve_mesh(args, device)
    # the model at --stages (a checkpoint written at that count restores
    # onto it); the engine serves its merged stages
    stages, wire_dim, out_shape = make_gpt_stages(args.seed, cfg, n_stages,
                                                  device)
    draft_stages = draft_cfg = None
    if args.serve_spec_k:
        # the draft: the same config at half the layers, fresh weights
        # from a derived seed — an untrained draft costs acceptance rate,
        # never correctness
        draft_cfg = dataclasses.replace(cfg,
                                        n_layers=max(1, cfg.n_layers // 2))
        draft_stages = make_gpt_stages(fold_in(args.seed, 1), draft_cfg, 1,
                                       device)[0]
    if args.lint or args.lint_only:
        _lint_serve_gate(args, stages, serve_cfg, mesh, draft_stages,
                         draft_cfg, device)
        if args.lint_only:
            return
    params = None
    ckpt = (os.path.join(args.checkpoint_dir, "state.npz")
            if args.checkpoint_dir else None)
    if ckpt and os.path.exists(ckpt):
        from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (  # noqa: E501
            Mesh,
        )
        from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (  # noqa: E501
            Pipeline,
        )
        from simple_distributed_machine_learning_tpu_torch.train.checkpoint import (  # noqa: E501
            restore_checkpoint,
        )
        # the training layout the checkpoint packs, every stage in this
        # process (each process of a launch reads the whole file): a stage
        # mesh of its own, apart from the serving mesh
        stage_mesh = (Mesh((device,) * n_stages) if n_stages > 1
                      else None)
        pipe = Pipeline(stages, stage_mesh, wire_dim, out_shape,
                        device=None if stage_mesh else device)
        st = restore_checkpoint(ckpt, pipe=pipe)
        params = st["params"]
        print(f"| serve: restored params from {ckpt} (step {st['step']})")
    else:
        print("| serve: fresh-initialized params"
              + (f" (no checkpoint at {ckpt})" if ckpt else ""))
    metrics = ServeMetrics(outdir=args.telemetry_dir)
    if args.serve_trace and not args.telemetry_dir:
        raise SystemExit("--serve-trace needs --telemetry-dir (the trace "
                         "artifacts land next to metrics.jsonl)")
    # the journals and the request timeline: two processes appending to
    # one file corrupt it, so past rank 0 they go to a temporary directory
    tmpdir = None
    log_dir = args.telemetry_dir
    if log_dir and (args.rank or 0) > 0:
        tmpdir = tempfile.TemporaryDirectory(prefix="sdml-serve-")
        log_dir = tmpdir.name
    trace = ServeTrace(outdir=log_dir) if args.serve_trace else None
    engine_kw = dict(
        params=params, n_slots=args.serve_slots,
        block_size=args.serve_block_size,
        prefill_chunk=args.serve_prefill_chunk or None,
        host_cache_blocks=args.serve_host_blocks,
        prefetch_ticks=args.serve_prefetch_ticks,
        attn_kernel="fused", metrics=metrics, mesh=mesh,
        draft_stages=draft_stages, draft_cfg=draft_cfg,
        spec_k=args.serve_spec_k, device=device)
    if args.serve_adapters:
        if fleet_mode or supervised:
            # the engine factory builds (and rebuilds, after a crash) each
            # engine's AdapterStore over one shared host dict
            engine_kw["adapter_rank"] = args.serve_adapter_rank
        else:
            engine_kw["adapters"] = AdapterStore(
                serve_cfg, args.serve_adapter_rank, args.serve_slots,
                device=device)
    if fleet_mode:
        if log_dir:
            journal_dir = log_dir
        else:
            tmpdir = tempfile.TemporaryDirectory(prefix="sdml-fleet-")
            journal_dir = tmpdir.name
        engine = ServeFleet(
            engine_factory(stages, serve_cfg, **engine_kw), journal_dir,
            n_replicas=args.serve_replicas,
            prefill_replicas=args.serve_prefill_replicas,
            route=args.serve_route,
            metrics=metrics, autoscale=autoscale,
            max_restarts=args.serve_max_restarts,
            default_deadline_s=(args.serve_deadline_ms / 1e3
                                if args.serve_deadline_ms else None),
            trace=trace, postmortem_dir=args.telemetry_dir or None)
        print(f"| serve: fleet of {args.serve_replicas} replica(s), "
              f"route {args.serve_route} (journals "
              f"{journal_dir}/journal-r*.jsonl"
              + (f", disaggregated {args.serve_prefill_replicas} prefill "
                 f"+ {args.serve_replicas - args.serve_prefill_replicas} "
                 f"decode" if args.serve_prefill_replicas else "")
              + (f", autoscale [{autoscale.min_replicas}, "
                 f"{autoscale.max_replicas}]" if autoscale else "")
              + (f", chaos {args.serve_chaos!r}" if args.serve_chaos
                 else "") + ")")
    elif supervised:
        if log_dir:
            journal_path = os.path.join(log_dir, "journal.jsonl")
            if os.path.exists(journal_path):
                os.unlink(journal_path)        # each --serve-sim run is fresh
        else:
            tmpdir = tempfile.TemporaryDirectory(prefix="sdml-serve-")
            journal_path = os.path.join(tmpdir.name, "journal.jsonl")
        engine = ServeSupervisor(
            engine_factory(stages, serve_cfg, **engine_kw), journal_path,
            metrics=metrics, max_restarts=args.serve_max_restarts,
            default_deadline_s=(args.serve_deadline_ms / 1e3
                                if args.serve_deadline_ms else None),
            trace=trace, postmortem_dir=args.telemetry_dir or None)
        print(f"| serve: supervised (journal {journal_path}"
              + (f", chaos {args.serve_chaos!r}" if args.serve_chaos
                 else "")
              + (f", deadline {args.serve_deadline_ms:g} ms"
                 if args.serve_deadline_ms else "") + ")")
    else:
        engine = InferenceEngine(stages, serve_cfg, trace=trace,
                                 **engine_kw)
    if args.serve_adapters:
        # seeded per-tenant weights, registered on the serving target
        # (engine, supervisor or fleet: one call shape); bank rows upload
        # at each replica's admission ticks
        for k in range(args.serve_adapters):
            engine.register_adapter(f"tenant-{k}", lora.init_lora_adapter(
                torch.Generator().manual_seed(fold_in(args.seed, 7000 + k)),
                serve_cfg, args.serve_adapter_rank, device=device))
        print(f"| serve: {args.serve_adapters} LoRA tenant(s) rank "
              f"{args.serve_adapter_rank} over shared base weights")
    max_new = min(args.serve_max_new, cfg.seq_len - longest)
    if max_new < args.serve_max_new:
        print(f"| serve: --serve-max-new {args.serve_max_new} clamped to "
              f"{max_new} (seq_len {cfg.seq_len} minus the longest "
              f"{longest}-token simulated prompt)")
    sim = SimConfig(n_requests=args.serve_sim, rate=args.serve_rate,
                    seed=args.seed, prompt_lens=GPT_SERVE_PROMPTS,
                    max_new_tokens=max_new,
                    shared_prefix_len=args.serve_shared_prefix,
                    # arrivals split evenly across the tenants, each
                    # request decoding under its own adapter
                    classes=tuple(
                        TrafficClass(name=f"tenant-{k}",
                                     adapter=f"tenant-{k}")
                        for k in range(args.serve_adapters)))
    # graceful shutdown: SIGTERM/SIGINT stop admission, drain in-flight
    # requests, flush metrics and journal, exit 0
    stop = {"sig": None}

    def _on_signal(signum, frame):
        stop["sig"] = signum

    old_handlers = {}
    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            old_handlers[sig] = signal.signal(sig, _on_signal)
    except ValueError:
        old_handlers = {}              # not the main thread: no handlers
    if serve_plan is not None:
        faults.install(serve_plan)
    try:
        report = simulate(engine, sim,
                          should_stop=lambda: stop["sig"] is not None)
    finally:
        if serve_plan is not None:
            faults.uninstall()
        for sig, h in old_handlers.items():
            signal.signal(sig, h)
        if supervised or fleet_mode:
            engine.close()             # journal(s) flushed + closed
        if trace is not None:
            trace.close()              # chrome trace + timeline flushed
    s = metrics.summary()
    print(f"| serve: {report['completed']}/{report['n_requests']} requests "
          f"completed, {s['tokens_generated']} tokens, "
          f"{s['tokens_per_sec']} tok/s, "
          f"ttft p50/p95 {s['ttft_ms_p50']}/{s['ttft_ms_p95']} ms, "
          f"tpot p50/p95 {s['tpot_ms_p50']}/{s['tpot_ms_p95']} ms, "
          f"occupancy {s['slot_occupancy_mean']}")
    if fleet_mode:
        print(f"| serve: fleet {engine.n_alive} alive "
              f"({engine.n_in_rotation} in rotation), "
              f"{engine.replica_losses} replica loss(es), "
              f"{engine.migrations} migration(s), "
              f"{s.get('route_affinity_hits', 0)} affinity hit(s), "
              f"{s.get('fleet_scale_outs', 0)} scale-out(s), "
              f"{s.get('fleet_retired', 0)} retired, "
              f"{s.get('restarts', 0)} in-place restart(s), "
              f"journals {s.get('journal_bytes', 0)} bytes")
        if args.serve_prefill_replicas:
            print(f"| serve: disaggregated — {engine.handoffs} "
                  f"prefill->decode handoff(s), pools "
                  + ", ".join(
                      f"{p}[{b['replicas']} replica(s), queue "
                      f"{b['queue_depth']}, {b['slots_active']} active]"
                      for p, b in sorted((s.get("pools") or {}).items())))
        if args.serve_host_blocks:
            print(f"| serve: host tier {s.get('host_blocks', 0)} block(s) "
                  f"resident ({s.get('host_bytes_resident', 0)} bytes), "
                  f"{s.get('host_demotes', 0)} demote(s), "
                  f"{s.get('host_promotes', 0)} promote(s), prefetch "
                  f"{s.get('host_prefetch_hits', 0)} hit(s)/"
                  f"{s.get('host_prefetch_misses', 0)} miss(es), "
                  f"{s.get('host_transfer_bytes', 0)} bytes transferred")
    if supervised:
        print(f"| serve: supervisor {engine.state}, "
              f"{s.get('restarts', 0)} restart(s), "
              f"{s.get('recovered_requests', 0)} recovered, "
              f"{report['shed']} shed {s.get('shed_by_reason', {})}, "
              f"journal {s.get('journal_bytes', 0)} bytes")
        if engine.postmortems:
            print(f"| serve: {len(engine.postmortems)} post-mortem "
                  f"bundle(s): "
                  f"{[os.path.basename(p) for p in engine.postmortems]}")
    if args.serve_adapters:
        print(f"| serve: adapters — "
              f"{s.get('adapter_resident_bytes', 0)} bank bytes "
              f"resident, {s.get('adapter_swaps', 0)} bank upload(s), "
              f"{s.get('route_adapter_affinity_hits', 0)} "
              f"adapter-affinity hit(s), per-tenant completed "
              f"{s.get('per_adapter_completed', {})}")
    if "kv_drift_bytes" in s:
        print(f"| serve: kv drift {s['kv_drift_bytes']} bytes vs the "
              f"analyzer model (predicted {s['kv_bytes_predicted']})")
    if trace is not None:
        print(f"| serve: trace {trace.n_events} events -> "
              f"{trace.trace_file} + {trace.timeline_file}")
    if report["stopped"]:
        print(f"| serve: graceful shutdown on signal {stop['sig']} — "
              f"admission stopped, {report['submitted']} submitted "
              f"request(s) drained, metrics/journal flushed")
    if "blocks_total" in s:
        print(f"| serve: paged pool {s['blocks_in_use']}/"
              f"{s['blocks_total']} blocks in use ({s['blocks_cached']} "
              f"cached), {s['kv_bytes_resident']} KV bytes resident, "
              f"{s['prefix_hit_blocks']} prefix-share hits, "
              f"{s['cow_copies']} CoW copies, "
              f"prefill chunk p50/p95 {s['prefill_chunk_ms_p50']}/"
              f"{s['prefill_chunk_ms_p95']} ms")
    if args.serve_tp > 1 or args.serve_spec_k:
        spec = (f", spec_k {s.get('spec_k', 0)} accept_rate "
                f"{s.get('spec_accept_rate')} "
                f"({s.get('spec_accepted_tokens', 0)}/"
                f"{s.get('spec_proposed_tokens', 0)} draft tokens)"
                if args.serve_spec_k else "")
        print(f"| serve: tp {args.serve_tp}{spec}")
    if args.telemetry_dir:
        metrics.emit(extra={"rate": sim.rate, "n_slots": args.serve_slots,
                            "block_size": args.serve_block_size,
                            "shared_prefix": args.serve_shared_prefix,
                            "completed": report["completed"]})
    if tmpdir is not None:
        tmpdir.cleanup()
    # success = every SUBMITTED request accounted for: completed, or (a
    # deadline run) structurally shed; a graceful shutdown judges only
    # what was admitted before the signal
    expected = (report["submitted"] if report["stopped"]
                else report["n_requests"])
    if report["completed"] + report["shed"] != expected:
        raise SystemExit(1)


def _run_scenario(args, n_stages: int, device) -> None:
    """--scenario NAME: one SLO-gated serving scenario
    (``resilience/scenarios.py``) on a fresh GPT build, attending through
    the paged-attention kernel (traced with --serve-trace); exits nonzero
    unless every gated class attains its targets and every request is
    accounted for."""
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        GPTConfig,
        make_gpt_stages,
    )
    from simple_distributed_machine_learning_tpu_torch.resilience.scenarios import (  # noqa: E501
        SCENARIOS,
        run_scenario,
    )
    if args.scenario == "list":
        for sc in SCENARIOS.values():
            print(f"| {sc.name}: {sc.description}")
        return
    if args.scenario not in SCENARIOS:
        raise SystemExit(
            f"unknown --scenario {args.scenario!r}; available: "
            f"{', '.join(sorted(SCENARIOS))} (or 'list')")
    if args.serve_sim > 0:
        raise SystemExit("--scenario runs alone (drop --serve-sim/--chaos)")
    cfg = GPTConfig()
    device = _rank_device(args, device)
    stages = make_gpt_stages(args.seed, cfg, n_stages, device)[0]
    report = run_scenario(args.scenario, stages, cfg,
                          outdir=args.telemetry_dir, device=device,
                          trace=bool(args.serve_trace), attn_kernel="fused")
    print(f"| scenario {report['scenario']} ({report['scheduler']}"
          + (", supervised" if report.get("supervised") else "") + "): "
          f"{report['completed']}/{report['n_requests']} completed, "
          f"{report['shed']} shed, "
          f"{report.get('preemptions', 0)} preemptions, "
          + (f"{report['restarts']} restart(s), "
             if report.get("supervised") else "")
          + f"faults fired: "
          f"{report.get('faults', {}).get('total_fired', 0)}")
    fl = report.get("fleet")
    if fl:
        print(f"| scenario: fleet {fl['replicas']} replica(s) "
              f"(route {fl['route']}): {fl['replica_losses']} loss(es), "
              f"{fl['migrations']} migration(s), "
              f"{fl['affinity_hits']} affinity hit(s), "
              f"{fl['scale_outs']} scale-out(s), {fl['retired']} retired")
        for ev in fl["replica_log"]:
            print(f"| scenario:   fleet {ev['event']} replica "
                  f"{ev['replica']} @tick {ev['tick']} "
                  f"(t={ev['t']:g}, {ev['alive']} alive)")
    for cls, att in sorted(report["slo"].items()):
        parts = []
        if "ttft_attainment" in att:
            a = att["ttft_attainment"]
            parts.append(f"ttft p95 {att['ttft_ms_p95']} vms vs SLO "
                         f"{att['ttft_slo_ms']} "
                         f"({'-' if a is None else round(a, 3)})")
        if "tpot_attainment" in att:
            a = att["tpot_attainment"]
            parts.append(f"tpot p95 {att['tpot_ms_p95']} vms vs SLO "
                         f"{att['tpot_slo_ms']} "
                         f"({'-' if a is None else round(a, 3)})")
        print(f"| scenario:   {cls} "
              f"[{'OK' if att['ok'] else 'VIOLATED'}] " + "; ".join(parts))
    sa = report.get("slo_alerts")
    if sa:
        for tr in sa["transitions"]:
            print(f"| scenario:   alert {tr['alert']} {tr['from']} -> "
                  f"{tr['to']} @tick {tr['tick']} (burn fast/slow "
                  f"{tr.get('burn_fast', 0)}/{tr.get('burn_slow', 0)})")
        if not sa["transitions"]:
            print("| scenario:   alerts: no burn-rate transitions "
                  "(error budget never breached)")
    att_blk = report.get("attribution")
    if att_blk:
        print(f"| scenario: attribution {att_blk['requests']} request(s) "
              f"folded, {att_blk['recovered']} recovered, max drift "
              f"{att_blk['max_abs_drift_ms']} ms")
        for a in att_blk["top_slow"]:
            comps = " ".join(f"{c}={v}"
                             for c, v in a["components_ms"].items())
            print(f"| scenario:   slow rid {a['rid']} ({a['cls']}) ttft "
                  f"{a['ttft_ms']} vms: {comps}"
                  + (" [recovered]" if a.get("recovered") else ""))
    if report.get("postmortem_bundles"):
        print(f"| scenario: {report['postmortem_bundles']} post-mortem "
              f"bundle(s) under {args.telemetry_dir}")
    if report.get("trace_events"):
        print(f"| scenario: trace {report['trace_events']} events"
              + (f" under {args.telemetry_dir}" if args.telemetry_dir
                 else " (in-memory; add --telemetry-dir to keep them)"))
    print(f"| scenario: SLO {'ATTAINED' if report['slo_ok'] else 'MISSED'}")
    if not report["slo_ok"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
