"""Preflight glue: lint the exact step a launch is about to execute (port
of ``analysis/preflight.py``).

``cli.py --lint`` calls into here. Everything is abstract (fake tensors
made without copying a buffer) — a preflight never allocates device
memory, runs a FLOP or launches a kernel, so gating a launch on it costs
trace time only.

Also home of :func:`validate_tp_overlap`, which checks a
tensor-parallel/overlap spec before the model is built, so an invalid
combination (a width that does not divide the heads, a chunk count that
does not divide the model axis) exits with one clear message instead of
a stack trace — the JAX function's checks and texts word for word.
"""

from __future__ import annotations

from simple_distributed_machine_learning_tpu_torch.analysis import (
    Report,
    analyze,
)


def validate_tp_overlap(tp: int, overlap: str, n_devices: int | None = None,
                        cfg=None, batch: int | None = None, n_micro: int = 1,
                        ) -> tuple[list[str], list[str]]:
    """Validate a tensor-parallel/overlap spec BEFORE building the model.

    Returns ``(errors, warnings)``: errors make the combo untraceable or
    wrong (exit with the message); warnings mean the ring schedule silently
    degrades to the monolithic collective (``ring_psum``'s divisibility
    fallback) — the run is correct but measures nothing new.

    ``cfg`` is a ``GPTConfig``-shaped object (``d_model``/``n_heads``/
    ``mlp_ratio``/``seq_len``/``attn_impl``/``n_experts`` attributes);
    ``batch``/``n_micro`` let the token-axis chunking of the scattered MLP
    (``matmul_reducescatter`` rows) be checked too.
    """
    errors: list[str] = []
    warnings: list[str] = []
    if tp < 1:
        errors.append(f"--tp must be >= 1, got {tp}")
        return errors, warnings
    if overlap not in ("none", "ring", None):
        errors.append(f"--overlap must be none|ring, got {overlap!r}")
    if overlap == "ring" and tp < 2:
        errors.append("--overlap ring needs --tp >= 2 (there is no "
                      "collective to schedule on an unsharded row)")
    if n_devices is not None and tp > n_devices:
        errors.append(f"--tp {tp} needs {tp} devices, have {n_devices}")
    if cfg is not None and tp > 1:
        heads = getattr(cfg, "n_heads", None)
        d_model = getattr(cfg, "d_model", None)
        ratio = getattr(cfg, "mlp_ratio", 4)
        if heads is not None and heads % tp:
            errors.append(
                f"--tp {tp} does not divide n_heads={heads}: attention "
                f"shards by head, so heads per shard must be integral")
        if d_model is not None and (ratio * d_model) % tp:
            errors.append(
                f"--tp {tp} does not divide the MLP hidden width "
                f"{ratio}*{d_model}={ratio * d_model}: the column-parallel "
                f"chunk count must divide the model axis")
        if getattr(cfg, "attn_impl", "dense") not in ("dense", None) and tp > 1:
            errors.append(
                f"--tp shards attention by head with dense local math; "
                f"attn={getattr(cfg, 'attn_impl', None)!r} is not "
                f"composable with it")
        if getattr(cfg, "n_experts", 0) and tp > 1:
            errors.append("--tp cannot combine with MoE experts (a stage is "
                          "tensor- OR expert-sharded, not both)")
        if overlap == "ring":
            if d_model is not None and d_model % tp:
                warnings.append(
                    f"ring overlap: d_model={d_model} not divisible by "
                    f"tp={tp} — the attention projection's ring_psum falls "
                    f"back to the monolithic psum (correct, no overlap)")
            seq_len = getattr(cfg, "seq_len", None)
            if batch is not None and seq_len is not None:
                tokens = (batch // max(1, n_micro)) * seq_len
                if tokens % tp:
                    warnings.append(
                        f"ring overlap: {tokens} tokens per microbatch not "
                        f"divisible by tp={tp} — the scattered MLP falls "
                        f"back to allgather + monolithic psum")
    return errors, warnings


def lint_step(fn, *args, mesh=None, name: str = "step") -> Report:
    """Analyze ``fn`` on (abstract) example args against ``mesh``."""
    from simple_distributed_machine_learning_tpu_torch.analysis.trace import (
        abstractify,
    )
    return analyze(fn, *[abstractify(a) for a in args], mesh=mesh, name=name)


def abstract_batch(pipe, batch: int, in_shape, targets=None):
    """Fake ``(x, targets)`` of one step's batch: ``x`` ``[batch,
    *in_shape]`` (f32, or token ids in ``[0, vocab)`` for a token model)
    and int64 targets in ``[0, out_dim)`` shaped ``[batch,
    *pipe.out_shape[:-1]]``."""
    import torch

    from simple_distributed_machine_learning_tpu_torch.analysis.bounds import (
        spec,
    )
    out_dim = pipe.out_shape[-1]
    tshape = (batch,) + tuple(pipe.out_shape[:-1]) if targets is None \
        else (batch,) + tuple(targets)
    t = spec(tshape, torch.int64, 0, out_dim - 1)
    in_shape = tuple(in_shape)
    if len(tshape) > 1:                 # a token model: x holds token ids
        x = spec((batch,) + in_shape, torch.int64, 0, out_dim - 1)
    else:
        x = spec((batch,) + in_shape, torch.float32)
    return x, t


def lint_trainer(trainer, batch_size: int | None = None) -> Report:
    """Lint the EXACT train + eval steps a ``Trainer`` is about to run:
    same pipeline, optimizer, in-place updates and batch shapes (this
    process's rows of the global batch). Trace-only: no kernel launches,
    no device memory."""
    import torch

    from simple_distributed_machine_learning_tpu_torch.analysis.bounds import (
        spec,
    )
    from simple_distributed_machine_learning_tpu_torch.analysis.trace import (
        abstractify,
    )
    pipe = trainer.pipe
    mesh = pipe.mesh
    B = int(batch_size or trainer.config.batch_size)
    if mesh is not None:
        B = B * len(mesh.replicas) // mesh.n_data
    xs, ys = trainer.train_ds.x, trainer.train_ds.y
    x_dtype = torch.int64 if not torch.as_tensor(xs[:1]).is_floating_point() \
        else torch.float32
    out_dim = pipe.out_shape[-1]
    x = spec((B,) + tuple(xs.shape[1:]), x_dtype,
             *((0, out_dim - 1) if x_dtype == torch.int64 else ()))
    t = spec((B,) + tuple(ys.shape[1:]), torch.int64, 0, out_dim - 1)
    params = abstractify(trainer.params)
    state = abstractify(trainer.opt_state)
    report = analyze(trainer._train_step, params, state, x, t, 0,
                     mesh=mesh, name="train_step")
    report.extend(analyze(trainer._eval_step, params, x, t, 0, B,
                          mesh=mesh, name="eval_step"))
    report.name = "train_step + eval_step"
    return report


def _topology(n_devices: int, dev):
    """``(mesh, stages, wire, out, in_dim, tag)`` of the dryrun's GPipe
    mesh: the JAX selection (``__graft_entry__.dryrun_multichip``) over
    ``n_devices`` coordinates sharing ``dev``."""
    from simple_distributed_machine_learning_tpu_torch.models.mlp import (
        make_mlp_stages,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (
        make_mesh,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel.tensor import (
        make_mlp_tp_stages,
    )
    if n_devices % 8 == 0:
        n_stages, n_model = 2, 2
        n_data = n_devices // (n_stages * n_model)
        stages, wire, out = make_mlp_tp_stages(0, [16, 16, 16, 16, 10],
                                               n_stages, n_model, device=dev)
    else:
        n_stages = 4 if n_devices % 4 == 0 else (
            2 if n_devices % 2 == 0 else 1)
        n_model = 1
        n_data = n_devices // n_stages
        stages, wire, out = make_mlp_stages(0, [16] * n_stages + [10],
                                            n_stages, device=dev)
    mesh = make_mesh(n_stages, n_data=n_data, n_model=n_model,
                     devices=[dev] * n_devices)
    tag = f"{n_devices}dev dp={n_data} pp={n_stages} tp={n_model}"
    return mesh, stages, wire, out, tag


def dryrun_reports(n_devices: int, device=None) -> list[Report]:
    """Analyze the steps of a dryrun over ``n_devices`` coordinates (the
    JAX ``dryrun_multichip`` topology; here they share ``device``, None =
    ``"cuda"``, as in the multi-stage runs on one card): the GPipe train
    step on the dp x pp x tp split, the eval metrics, the ZeRO-1 + AdamW
    step when the mesh has a data axis, and the 1F1B step (with a
    warmup-cosine SGD clipped by the global norm) where two stages fit.
    One Report per step — the CI lint gate requires every one clean."""
    from simple_distributed_machine_learning_tpu_torch._device import (
        resolve_device,
    )
    from simple_distributed_machine_learning_tpu_torch.analysis.trace import (
        abstractify,
    )
    from simple_distributed_machine_learning_tpu_torch.models.mlp import (
        make_mlp_stages,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (
        make_mesh,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (  # noqa: E501
        Pipeline,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel.tensor import (
        make_mlp_tp_stages,
    )
    from simple_distributed_machine_learning_tpu_torch.train import schedules
    from simple_distributed_machine_learning_tpu_torch.train.optimizer import (
        adamw,
        clip_by_global_norm,
        sgd,
        shard_opt_state_zero1,
    )
    from simple_distributed_machine_learning_tpu_torch.train.step import (
        make_train_step,
    )
    if n_devices < 1:
        raise SystemExit(f"analysis --dryrun {n_devices}: need at least one "
                         f"coordinate")
    dev = resolve_device(device)
    mesh, stages, wire, out, tag = _topology(n_devices, dev)
    n_micro = 2
    pipe = Pipeline(stages, mesh, wire, out, n_microbatches=n_micro)
    live = pipe.init_params()
    params = abstractify(live)
    opt = sgd(0.1, momentum=0.5)
    state = abstractify(opt.init(live))
    batch = 2 * n_micro * mesh.n_data
    x, t = abstract_batch(pipe, batch, (16,))
    reports = [
        analyze(make_train_step(pipe, opt), params, state, x, t, 0,
                mesh=mesh, name=f"train_step[{tag}]"),
        analyze(pipe.eval_metrics, params, x, t, 0, mesh=mesh,
                name=f"eval_metrics[{tag}]"),
    ]

    if mesh.n_data > 1:
        opt_a = adamw(1e-3)
        st_a = abstractify(shard_opt_state_zero1(opt_a.init(live), mesh,
                                                 pipe, params=live))
        reports.append(analyze(make_train_step(pipe, opt_a), params, st_a,
                               x, t, 0, mesh=mesh,
                               name=f"zero1_adamw_step[{tag}]"))

    if n_devices % 2 == 0:
        fb_stages = 2
        if n_devices % 8 == 0:
            fb_model = 2
            fstages, fwire, fout = make_mlp_tp_stages(
                0, [16, 16, 16, 16, 10], fb_stages, fb_model, device=dev)
        else:
            fb_model = 1
            fstages, fwire, fout = make_mlp_stages(0, [16, 16, 10],
                                                   fb_stages, device=dev)
        fb_data = n_devices // (fb_stages * fb_model)
        fmesh = make_mesh(fb_stages, n_data=fb_data, n_model=fb_model,
                          devices=[dev] * n_devices)
        fpipe = Pipeline(fstages, fmesh, fwire, fout, n_microbatches=2,
                         schedule="1f1b")
        fopt = clip_by_global_norm(
            sgd(schedules.warmup_cosine(0.1, 2, 20), 0.5), 1.0)
        flive = fpipe.init_params()
        fx, ft = abstract_batch(fpipe, 4 * fb_data, (16,))
        reports.append(analyze(
            make_train_step(fpipe, fopt), abstractify(flive),
            abstractify(fopt.init(flive)), fx, ft, 0, mesh=fmesh,
            name=f"1f1b_step[{n_devices}dev dp={fb_data} pp={fb_stages} "
                 f"tp={fb_model}]"))
    return reports


def format_reports(reports: list[Report], costs: bool = False) -> str:
    return "\n".join(r.format(costs=costs) for r in reports)


def all_ok(reports: list[Report], fail_on: str = "error") -> bool:
    return all(r.ok(fail_on) for r in reports)
