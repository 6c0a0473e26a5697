"""Reference-compatible training CLI (port of ``cli.py``'s training half).

    python -m simple_distributed_machine_learning_tpu_torch.cli --rank 0 \\
        --model lenet [--device cpu]

trains the reference's LeNet on MNIST (or its synthetic stand-in) on one
card, with the reference's console output and the JAX CLI's flags and
defaults. ``--model mlp`` trains the MLP of ``--mlp-dims``; ``--model
gpt`` the tiny GPT on a synthetic Markov stream (or ``--text-corpus``),
with ``--attn flash`` through the hand-written flash kernels and
``--generate N`` through the port's ``make_cached_decoder``.

One flag is the port's own: ``--device`` (default CUDA; the run raises
without it unless ``--device cpu`` asks for the CPU). Every other flag of
the JAX parser is accepted; a flag whose path is not ported exits, when
set, with one line naming its ROADMAP item (the serve flags, scenarios,
chaos, the sentinel, telemetry and profiling, the linter, and every
parallel axis: ``--stages`` above 1, ``--dp/--tp/--sp/--ep/--experts``,
``--world_size`` above 1). ``--microbatches`` is accepted and does not
split the batch, as on the JAX package's one-device mesh.
"""

from __future__ import annotations

import argparse

from simple_distributed_machine_learning_tpu_torch import _roadmap


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Distributed Machine Learning (PyTorch/CUDA port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    # -- reference-compatible flags --
    p.add_argument('--rank', type=int, metavar='R', help="Number of rank")
    p.add_argument('--world_size', type=int, default=1, metavar='N',
                   help="Number of workers (processes); one is ported")
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
                   help="pipeline stages (1 on one card; more: ROADMAP "
                        "item 6)")
    g.add_argument('--microbatches', type=int, default=1,
                   help="accepted; one card does not split the batch")
    g.add_argument('--schedule', choices=("gpipe", "1f1b"), default="gpipe",
                   help="pipeline schedule (the same on one stage)")
    g.add_argument('--dp', type=int, default=1,
                   help="data-parallel width (> 1: ROADMAP item 6)")
    g.add_argument('--tp', type=int, default=1,
                   help="tensor-parallel width (> 1: ROADMAP item 6)")
    g.add_argument('--overlap', choices=("none", "ring"), default="none",
                   help="collective schedule (ring: ROADMAP item 6)")
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
                   help="ZeRO-1 (the identity on one card)")
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
                   help="MoE experts for --model=gpt (ROADMAP item 6)")
    g.add_argument('--sp', type=int, default=1,
                   help="sequence-parallel width (ROADMAP item 6)")
    g.add_argument('--ep', type=int, default=1,
                   help="expert-parallel width (ROADMAP item 6)")
    g.add_argument('--generate', type=int, default=0, metavar="N",
                   help="for --model=gpt: after training, decode N tokens "
                        "with the KV-cache decoder and print them")
    for flag, typ, default in (
            ('--serve-sim', int, 0), ('--serve-rate', float, 8.0),
            ('--serve-slots', int, 4), ('--serve-max-new', int, 16),
            ('--serve-block-size', int, 16),
            ('--serve-prefill-chunk', int, 0),
            ('--serve-shared-prefix', int, 0), ('--serve-tp', int, 1),
            ('--serve-spec-k', int, 0), ('--serve-chaos', str, None),
            ('--serve-deadline-ms', float, 0.0),
            ('--serve-max-restarts', int, 3),
            ('--serve-replicas', int, 0), ('--serve-autoscale', str, None),
            ('--serve-prefill-replicas', int, 0),
            ('--serve-host-blocks', int, 0),
            ('--serve-prefetch-ticks', int, 1),
            ('--serve-adapters', int, 0), ('--serve-adapter-rank', int, 4)):
        g.add_argument(flag, type=typ, default=default,
                       help="serving (ROADMAP items 4-5)")
    g.add_argument('--serve-route',
                   choices=("affinity", "least-loaded", "round-robin"),
                   default="affinity", help="serving (ROADMAP item 4)")
    g.add_argument('--serve-trace', action='store_true',
                   help="serving (ROADMAP item 4)")
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
                   help="activation recomputation (ROADMAP item 6)")
    g.add_argument('--metrics-json', type=str, default=None, metavar='PATH',
                   help="append one JSON line of metrics per epoch")
    g.add_argument('--profile', type=str, default=None, metavar='DIR',
                   help="profiler trace (ROADMAP item 6)")
    g.add_argument('--telemetry-dir', type=str, default=None, metavar='DIR',
                   help="run telemetry (ROADMAP item 6)")
    g.add_argument('--telemetry-every', type=int, default=1, metavar='N',
                   help="run telemetry (ROADMAP item 6)")
    g.add_argument('--max-steps-per-epoch', type=int, default=None,
                   metavar='N', help="cap every training epoch at N batches")
    g.add_argument('--sentinel', action='store_true',
                   help="self-healing training (ROADMAP item 6)")
    g.add_argument('--sentinel-window', type=int, default=16, metavar='W',
                   help="self-healing training (ROADMAP item 6)")
    g.add_argument('--sentinel-snapshot-every', type=int, default=4,
                   metavar='K', help="self-healing training (ROADMAP item 6)")
    g.add_argument('--chaos', type=str, default=None, metavar='SPEC',
                   help="fault-injection drill (ROADMAP item 4)")
    g.add_argument('--chaos-stages', type=str, default=None,
                   metavar='S1,S2', help="fault-injection drill (ROADMAP "
                                         "item 4)")
    g.add_argument('--chaos-max-restarts', type=int, default=3,
                   help="fault-injection drill (ROADMAP item 4)")
    g.add_argument('--scenario', type=str, default=None, metavar='NAME',
                   help="SLO-gated serving scenario (ROADMAP item 4)")
    g.add_argument('--dryrun', type=int, default=0, metavar='N',
                   help="smoke mode: train only N batches of one epoch, "
                        "then the normal eval")
    g.add_argument('--lint', action='store_true',
                   help="static-analysis preflight (ROADMAP item 7)")
    g.add_argument('--lint-only', action='store_true',
                   help="static-analysis preflight (ROADMAP item 7)")
    g.add_argument('--peer-timeout', type=float, default=60.0,
                   help="multi-process watchdog (ROADMAP item 6)")
    g.add_argument('--heartbeat-port', type=int, default=None,
                   help="multi-process watchdog (ROADMAP item 6)")
    return p


_SERVE_EXTENSION_FLAGS = {"serve_tp", "serve_spec_k", "serve_host_blocks",
                          "serve_prefetch_ticks", "serve_adapters",
                          "serve_adapter_rank"}
# flags whose paths are not ported: set to anything but the default, each
# exits naming its ROADMAP item
_UNPORTED = ({"scenario": _roadmap.SERVE_ROBUSTNESS,
              "chaos": _roadmap.SERVE_ROBUSTNESS,
              "chaos_stages": _roadmap.SERVE_ROBUSTNESS,
              "chaos_max_restarts": _roadmap.SERVE_ROBUSTNESS,
              "lint": _roadmap.ANALYSIS, "lint_only": _roadmap.ANALYSIS}
             | {k: _roadmap.PARALLEL_AXES for k in (
                 "world_size", "dp", "tp", "sp", "ep", "experts", "overlap",
                 "remat", "sentinel", "sentinel_window",
                 "sentinel_snapshot_every", "telemetry_dir",
                 "telemetry_every", "profile", "peer_timeout",
                 "heartbeat_port")})


def _refuse_unported(parser: argparse.ArgumentParser, args) -> None:
    for dest, value in vars(args).items():
        if dest.startswith("serve_"):
            item = (_roadmap.SERVE_EXTENSIONS
                    if dest in _SERVE_EXTENSION_FLAGS
                    else _roadmap.SERVE_ROBUSTNESS)
        else:
            item = _UNPORTED.get(dest)
        if item is not None and value != parser.get_default(dest):
            flag = "--" + (dest if dest == "world_size"
                           else dest.replace("_", "-"))
            raise SystemExit(str(_roadmap.not_ported(
                f"{flag} {value}", item)))
    if args.stages is not None and args.stages != 1:
        raise SystemExit(str(_roadmap.not_ported(
            f"--stages {args.stages} (a pipeline over several cards)",
            _roadmap.PARALLEL_AXES)))


def main(argv: list[str] | None = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.rank is None and args.world_size != 1:
        raise SystemExit("Must provide rank argument.")
    _refuse_unported(parser, args)
    from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (
        bootstrap_distributed,
    )
    bootstrap_distributed(args.rank or 0, args.world_size, args.master_addr,
                          args.master_port)
    _dispatch(args)


def _dispatch(args) -> None:
    from simple_distributed_machine_learning_tpu_torch._device import (
        resolve_device,
    )
    if args.dryrun < 0:
        raise SystemExit(f"--dryrun needs a non-negative step count, got "
                         f"{args.dryrun}")
    if args.generate > 0 and args.model != "gpt":
        raise SystemExit("--generate is only supported with --model=gpt")
    if args.max_steps_per_epoch is not None and args.max_steps_per_epoch < 1:
        raise SystemExit(f"--max-steps-per-epoch must be >= 1, got "
                         f"{args.max_steps_per_epoch}")
    device = resolve_device(args.device)
    if args.model == "gpt":
        _run_gpt(args, device)
        return
    from simple_distributed_machine_learning_tpu_torch.data.mnist import (
        Dataset,
        load_mnist,
    )
    if args.model == "lenet":
        from simple_distributed_machine_learning_tpu_torch.models.lenet import (  # noqa: E501
            make_lenet_stages,
        )
        stages, wire_dim, out_dim = make_lenet_stages(args.seed, 1, device)
    else:
        from simple_distributed_machine_learning_tpu_torch.models.mlp import (
            make_mlp_stages,
        )
        dims = [int(d) for d in args.mlp_dims.split(",")]
        stages, wire_dim, out_dim = make_mlp_stages(args.seed, dims, 1,
                                                    device)
    train_ds, test_ds = load_mnist(args.data_root)
    if args.model == "mlp":
        train_ds = Dataset(train_ds.x.reshape(len(train_ds.x), -1),
                           train_ds.y)
        test_ds = Dataset(test_ds.x.reshape(len(test_ds.x), -1), test_ds.y)
    _fit(args, _trainer(args, stages, wire_dim, out_dim, train_ds, test_ds,
                        device))


def _trainer(args, stages, wire_dim, out_dim, train_ds, test_ds, device):
    import torch

    from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (
        make_mesh,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (  # noqa: E501
        Pipeline,
    )
    from simple_distributed_machine_learning_tpu_torch.train.trainer import (
        Trainer,
    )
    pipe = Pipeline(stages, make_mesh(n_stages=1, n_data=args.dp), wire_dim,
                    out_dim, n_microbatches=args.microbatches,
                    compute_dtype=torch.bfloat16 if args.bf16 else None,
                    schedule=args.schedule, device=device)
    return Trainer(pipe, train_ds, test_ds, _train_config(args),
                   opt=_make_opt(args, _total_steps(args, train_ds)))


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
        metrics_json=args.metrics_json)


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
    if args.eval_only:
        if args.checkpoint_dir and trainer.start_epoch == 1:
            trainer._print("| --eval-only: no checkpoint found, evaluating "
                           "fresh-initialized params")
        trainer.evaluate()
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
        trainer.fit()
    finally:
        for s, h in old_handlers.items():
            signal.signal(s, h)
    if trainer.preempted:
        trainer._print(
            "| train: graceful shutdown complete — "
            + ("resume with the same --checkpoint-dir to continue "
               "bit-exact" if trainer.preempt_persisted
               else "no --checkpoint-dir was configured, so the "
               "interrupted progress was NOT persisted"))


def _run_gpt(args, device) -> None:
    """--model gpt: the tiny GPT on a synthetic Markov token stream (or
    the bytes of --text-corpus), same trainer and console surface."""
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
        make_gpt_stages,
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
                    attn_impl=args.attn, **fb)
    stages, wire_dim, out_shape = make_gpt_stages(args.seed, cfg, 1, device)

    def as_ds(x, y):
        return Dataset(x.astype(np.float32), y)

    if args.text_corpus:
        tr, te = byte_corpus(args.text_corpus, cfg.seq_len)
        train_ds, test_ds = as_ds(*tr), as_ds(*te)
    else:
        # one Markov chain, disjoint train/test sequences
        all_data = synthetic_tokens(7000, cfg.seq_len, cfg.vocab,
                                    seed=args.seed)
        train_ds = as_ds(all_data.x[:6000], all_data.y[:6000])
        test_ds = as_ds(all_data.x[6000:], all_data.y[6000:])
    trainer = _trainer(args, stages, wire_dim, out_shape, train_ds, test_ds,
                       device)
    _fit(args, trainer)
    if args.generate > 0:
        _print_sample(args, trainer, cfg, test_ds)


def _print_sample(args, trainer, cfg, test_ds) -> None:
    """--generate N: decode N tokens from the trained model with the
    KV-cache decoder, straight from the live stage modules."""
    import numpy as np
    import torch

    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        make_cached_decoder,
    )
    from simple_distributed_machine_learning_tpu_torch.ops.random import (
        key_data,
    )
    n_new = min(args.generate, cfg.seq_len - 1)
    t0 = max(1, min(cfg.seq_len - n_new, 16))
    prompt = np.asarray(test_ds.x[:1, :t0], np.int32)
    dec = make_cached_decoder(trainer.pipe.stages, cfg, t0, n_new,
                              cache_dtype=torch.bfloat16 if args.bf16
                              else None, device=trainer.pipe.device)
    toks = dec(trainer.params, prompt, key_data(args.seed))[0].cpu().numpy()
    if args.text_corpus:
        text = bytes(int(t) for t in toks).decode("latin-1")
        trainer._print(f"| sample ({t0}-byte prompt + {n_new} generated):\n"
                       f"{text!r}")
    else:
        trainer._print(f"| sample tokens (prompt {t0} + {n_new} generated): "
                       f"{toks.tolist()}")


if __name__ == "__main__":
    main()
