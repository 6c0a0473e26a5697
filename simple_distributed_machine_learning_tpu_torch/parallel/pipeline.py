"""The ``Stage`` container and the ``Pipeline`` engine (port of
``parallel/pipeline.py`` and, for 1F1B, ``parallel/onefb.py``).

One stage, one replica and no mesh is the JAX package's trivial-mesh path
(``_trivial_mesh``): the stage IS the fused model, and loss, gradients and
eval metrics run through ``_fused_logits`` / ``_fused_loss`` with no
microbatching. Anything wider runs over a mesh (``parallel/mesh.py::
make_mesh``) of ``n_data`` replicas of ``n_stages`` stages of ``n_model``
x ``n_seq`` x ``n_expert`` coordinates, each process driving the
coordinates it owns, as each JAX process drives its devices:

- replica ``d``'s stage ``s`` runs on ``mesh.device(d, s)``; this process
  keeps one copy of each stage it owns (on ``mesh.devices[s]``), which a
  replica on another device reads through a differentiable copy;
- the batch a process passes is the rows of its own replicas
  (``data/sharding.py::host_rows``), ``B / n_data`` per replica, each
  split into ``n_microbatches`` microbatches; replica ``d``'s microbatch
  ``m`` is the batch's microbatch ``d * M + m``;
- a hop between two coordinates of one process is ``Tensor.to`` (a no-op
  when they share a card), carrying the stage's output as it is, where
  the JAX wire is f32 padded to ``wire_dim`` (the f32 round trip of a
  bf16 value is exact, so both compute the same numbers); a hop between
  processes is a host-staged gloo send of the output and, with dropout,
  of the generator state the next stage starts from;
- GPipe runs every microbatch through the process's stages, then one
  backward per replica: autograd does not cross a process, so a stage
  that sends its output keeps it and later calls ``torch.autograd.grad``
  with the cotangent the next process sends back, and a stage that
  received its input sends that input's gradient to the previous process
  (``remat`` recomputes each stage inside ``torch.utils.checkpoint``);
  ``schedule="1f1b"`` interleaves forwards and backwards
  (``parallel/onefb.py``), its memory bounded by the stage count;
- the loss is the global weighted mean, ``sum(w·nll)`` over ``sum(w)``
  (JAX ``pipeline.py:628-648``): the denominator is summed over the last
  stage's data group before the schedule starts, and the loss reaches
  every process; gradients are summed over the process's own replicas,
  then over the stage's data group, so every replica holds the global
  gradient;
- tensor parallelism: a stage with ``shards`` runs, per replica, the
  process's own shards of it together (``parallel/tensor.py::Shards``):
  each sharded product per shard, the row-parallel products summed over
  the model coordinates, so every coordinate returns the same activation;
  a stage without ``shards`` on a model mesh runs once per process,
  replicated, as the JAX package runs it redundantly;
- sequence parallelism: on a seq mesh the token axis is cut in
  ``n_seq`` chunks; a stage takes this process's chunks together
  (``parallel/sequence.py::SeqShards``), each chunk hops to its own
  coordinate's process, and the loss, its counts and the gradients sum
  over the seq coordinates as over the data axis (the gradient group);
- expert parallelism: a stage with ``expert_shards`` runs, per replica,
  the process's expert shards together (``Shards`` on the expert axis),
  its replicated compute once and its experts' all-to-alls across the
  coordinates; the objective is replicated over them, as over the model
  axis;
- auxiliary losses (``Stage.apply`` returning ``(y, aux)``): summed over
  stages, averaged over microbatches, replicas and seq chunks, unweighted
  by the sample weights, added to the objective of the stage that made
  them and to the reported loss;
- dropout: each microbatch draws one stream, seeded from the key (the key
  itself for the batch's microbatch 0, ``ops.random.fold_in(key, g)`` for
  microbatch ``g`` after it), stage after stage: a stage's generator
  starts at the state the previous stage left, handed over with the hop.
  So one microbatch draws the fused path's masks, GPipe and 1F1B draw the
  same ones, one process or several, and a recompute replays them from
  the saved state. On a seq mesh each chunk draws a stream of its own,
  folded from the microbatch's with its seq index.

Parameters stay in the stage's ``nn.Module`` container (``models/gpt.py::
GPT``, or the MLP's and LeNet's ``_tree.ParamTree`` lists and dicts): a
training step passes the :class:`StageParams` list of per-stage modules
where the JAX package passes its packed ``[S, M, E, P]`` buffer, and the
optimizers update the modules' tensors in place on their devices. The
packed layout (``metas``) is still what a checkpoint writes
(``train/checkpoint.py``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint as _checkpoint

from simple_distributed_machine_learning_tpu_torch._device import (
    resolve_device,
)
from simple_distributed_machine_learning_tpu_torch.analysis import (
    trace as _trace,
)
from simple_distributed_machine_learning_tpu_torch.ops.losses import nll_loss
from simple_distributed_machine_learning_tpu_torch.ops.random import fold_in
from simple_distributed_machine_learning_tpu_torch.parallel import (
    mesh as mesh_lib,
)
from simple_distributed_machine_learning_tpu_torch.parallel.sequence import (
    SeqShards,
    seq_shards,
)
from simple_distributed_machine_learning_tpu_torch.parallel.staging import (
    stage_meta,
)
from simple_distributed_machine_learning_tpu_torch.parallel.overlap import (  # noqa: F401,E501 - re-exported
    OVERLAP_CHOICES,
    check_overlap,
)
from simple_distributed_machine_learning_tpu_torch.parallel.tensor import (
    Shards,
)


@dataclasses.dataclass(frozen=True)
class Stage:
    """One pipeline stage.

    ``apply(params, x, key=None, deterministic=True) -> y`` runs the stage
    on real activations: ``x`` has per-sample shape ``in_shape`` (token ids
    for the first stage); the last stage returns log-probabilities.
    ``params`` is the stage's ``nn.Module`` parameter container, which
    indexes like the JAX stage tree (``_tree.Tree``); ``key`` is a
    ``torch.Generator`` for dropout. ``apply`` may return ``(y, aux)``:
    ``aux`` is a scalar auxiliary loss (the MoE load-balancing term,
    already scaled by its weight) that the engine adds to the objective,
    summed over stages and averaged over microbatches and the data and
    seq coordinates.

    On a mesh with a seq axis the token axis (axis 0 of ``in_shape``, a
    per-chunk size) is sharded: ``x`` is this process's chunks as
    ``parallel/sequence.py::SeqShards``, ``key`` one generator per chunk,
    and ``y`` the chunks' outputs in the same form.

    ``shards``: optional per-model-shard params for tensor parallelism — a
    tuple of ``n_model`` containers with identical leaf shapes. ``apply``
    then receives this process's shards as ``parallel/tensor.py::Shards``
    and must return the same (replicated) activation on every model
    coordinate, closing each sharded group with its sum. Without
    ``shards`` on a mesh with ``n_model > 1`` the stage is replicated.

    ``expert_shards``: likewise per expert coordinate for expert
    parallelism (``n_expert`` containers, typically the expert weights
    split ``E / n_expert`` ways and the rest replicated); ``apply`` gets
    this process's expert shards as ``Shards`` on the expert axis (with
    the axis's ``view``), runs its own collectives over that axis and
    returns the same activation on every expert coordinate. Mutually
    exclusive with ``shards``.
    """
    apply: Callable[..., Any]
    params: Any
    in_shape: tuple[int, ...]
    shards: tuple | None = None
    expert_shards: tuple | None = None

    @property
    def shard_trees(self) -> tuple | None:
        """The stage's per-coordinate trees on its sharded axis."""
        return self.shards if self.shards is not None \
            else self.expert_shards


class StageParams(list):
    """The per-stage parameter modules a step updates, one entry per stage:
    None for a stage this process does not own. ``mesh`` is the mesh they
    live on (None: the one-card mesh), which the optimizer's global norm,
    ZeRO-1 and the checkpoint gather read."""

    def __init__(self, modules, mesh=None) -> None:
        super().__init__(modules)
        self.mesh = mesh


def param_leaves(params) -> list[torch.Tensor]:
    """The trainable tensors of ``params`` — a list of stage modules (None
    for a stage another process owns), one module, or a sequence of
    tensors — in a fixed order: the order of gradients and
    optimizer-state entries."""
    if isinstance(params, nn.Module):
        return list(params.parameters())
    leaves: list[torch.Tensor] = []
    for p in params:
        if p is not None:
            leaves.extend([p] if isinstance(p, torch.Tensor)
                          else param_leaves(p))
    return leaves


def param_units(params) -> list[tuple[int, int | None, Any]]:
    """``(s, m, module)`` for each parameter module of a list of stages,
    in :func:`param_leaves` order: each held shard of a sharded stage
    (``m`` its model coordinate), the module of any other stage (``m``
    None)."""
    out = []
    for s, p in enumerate(params):
        if isinstance(p, Shards):
            out.extend((s, m, x) for m, x in enumerate(p) if x is not None)
        elif p is not None:
            out.append((s, None, p))
    return out


def _cast_tree(module, dtype: torch.dtype | None, device=None):
    """A stage module as a tree of dicts and lists of its tensors cast to
    ``dtype`` and moved to ``device`` — differentiable casts, so gradients
    reach the f32 master tensors (the JAX package's ``tree.map(astype)``
    around the apply)."""
    if isinstance(module, torch.Tensor):
        return module.to(device=device, dtype=dtype)
    if isinstance(module, Shards):
        return Shards([_cast_tree(m, dtype, device) for m in module],
                      module.group, module.axis, module.view)
    if isinstance(module, (nn.ModuleList, list)):
        return [_cast_tree(m, dtype, device) for m in module]
    if isinstance(module, dict):
        return {k: _cast_tree(v, dtype, device) for k, v in module.items()}
    out = {k: v.to(device=device, dtype=dtype)
           for k, v in module._parameters.items()}
    out.update({k: _cast_tree(m, dtype, device)
                for k, m in module._modules.items()})
    return out


def _generator(key, device: torch.device) -> torch.Generator | None:
    """An int seed or a ``torch.Generator`` (or None: torch's default
    generator) as the dropout generator on ``device``."""
    if key is None or isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=device).manual_seed(int(key))


class Pipeline:
    """The pipeline engine.

    Keeps the JAX signature as far as it means something here: ``mesh`` is
    None (one stage on ``device``, None = ``"cuda"``) or a mesh
    (``parallel/mesh.py::make_mesh``), whose devices the coordinates are
    placed on; ``wire_dim`` is accepted as the stage builders return it
    (the hop needs no wire) and ``out_dim`` is the per-sample output shape
    (``(T, V)`` for a language model; on a seq mesh it must be per token,
    and the engine checks its token axis divides); ``n_microbatches``
    splits each replica's rows over a mesh and, as on the JAX package's
    trivial mesh, not on one coordinate; ``remat`` recomputes each stage in
    the backward over a mesh (GPipe) and, as there, nothing on one
    coordinate; ``schedule`` is ``"gpipe"`` or ``"1f1b"``, the same on one
    stage; ``overlap`` (``"none"``, the JAX default, or ``"ring"``) is the
    JAX knob of the engine's own collectives: the backward sums of a
    stage stored replicated over the model or expert axis. Under the
    port's Megatron accounting every process computes such a stage's full
    gradient itself, so the engine has no such sum to chunk and ``"ring"``
    trains the same bits as ``"none"``; a stage's internal collectives
    (TP pairs, TP GPT blocks, the EP dispatch) take their schedule from
    the model build (``GPTConfig.overlap``, ``make_mlp_tp_stages(...,
    overlap=)``), and 1F1B ignores the knob, as the JAX 1F1B does.
    ``compute_dtype`` casts the parameters and float activations to that
    dtype around each stage apply; master parameters and the loss stay
    f32. Token ids (the input of a stage that holds the ``embed`` table)
    are not cast: a bf16 cast rounds ids above 256. This departs from the
    JAX package, which casts its float token wire, so that its
    ``gpt_bf16`` row trains on rounded ids;
    ``tests/test_torch_gpt_train.py`` pins the difference.

    Attributes for telemetry and callers: ``n_stages``, ``n_microbatches``,
    ``schedule``, ``devices`` (one per stage: where this process keeps
    it), ``device`` (the first stage's, where a batch's inputs go) and
    ``out_device`` (the last stage's, where its targets and the loss
    live).
    """

    def __init__(self, stages: Sequence[Stage], mesh=None,
                 wire_dim: int | None = None,
                 out_dim: int | tuple[int, ...] | None = None,
                 n_microbatches: int = 1, compute_dtype=None,
                 remat: bool = False, schedule: str = "gpipe",
                 overlap: str = "none", device=None):
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown schedule {schedule!r}")
        self.overlap = check_overlap(overlap)
        self.stages = list(stages)
        if mesh is None:
            devices = [resolve_device(device)]
        else:
            devices = list(mesh.devices)
            if device is not None and resolve_device(device) != devices[0]:
                raise ValueError(
                    f"device={device!r} differs from the mesh's first "
                    f"device {devices[0]}: a mesh places the stages itself")
        if len(self.stages) != len(devices):
            raise ValueError(f"{len(self.stages)} stages but mesh stage axis "
                             f"is {len(devices)}")
        if int(n_microbatches) < 1:
            raise ValueError(f"n_microbatches must be >= 1, got "
                             f"{n_microbatches}")
        self.mesh = mesh
        axes = {} if mesh is None else mesh.shape
        self.n_model = axes.get(mesh_lib.MODEL_AXIS, 1)
        self.n_seq = axes.get(mesh_lib.SEQ_AXIS, 1)
        self.n_expert = axes.get(mesh_lib.EXPERT_AXIS, 1)
        for stage in self.stages:
            if stage.shards is not None and stage.expert_shards is not None:
                raise ValueError(
                    "a stage cannot be both tensor- (shards) and expert- "
                    "(expert_shards) sharded")
            if stage.shards is not None and len(stage.shards) != self.n_model:
                raise ValueError(
                    f"stage has {len(stage.shards)} model shards, mesh model "
                    f"axis is {self.n_model}")
            if (stage.expert_shards is not None
                    and len(stage.expert_shards) != self.n_expert):
                raise ValueError(
                    f"stage has {len(stage.expert_shards)} expert shards, "
                    f"mesh expert axis is {self.n_expert}")
        self.out_shape = (None if out_dim is None
                          else (int(out_dim),) if isinstance(out_dim, int)
                          else tuple(int(d) for d in out_dim))
        if self.n_seq > 1:
            if self.out_shape is None or len(self.out_shape) < 2:
                raise ValueError(
                    "sequence parallelism (mesh seq axis > 1) requires a "
                    "per-token output shape like (T, V); got "
                    f"out_dim={out_dim!r}")
            if self.out_shape[0] % self.n_seq:
                raise ValueError(
                    f"token axis {self.out_shape[0]} not divisible by "
                    f"seq axis size {self.n_seq}")
        # a mesh wider than one coordinate of one process runs replica by
        # replica, stage by stage; the trivial one runs the fused stage
        self._staged = mesh is not None and (
            len(mesh.coord_devices) > 1 or mesh.distributed)
        self.devices = devices
        self.device = devices[0]
        self.out_device = devices[-1]
        self.compute_dtype = compute_dtype
        self.remat = bool(remat)
        # the schedule model's inputs (telemetry/bubble.py)
        self.schedule = schedule
        self.n_stages = len(devices)
        self.n_microbatches = int(n_microbatches)
        # the master copy stays on the host, as the JAX package keeps its
        # initial buffer: init_params() survives any number of in-place
        # steps on the copies it hands out
        self._params0 = [copy.deepcopy(s.params).cpu()
                         if s.shard_trees is None
                         else [copy.deepcopy(p).cpu() for p in s.shard_trees]
                         for s in self.stages]
        # the packed [S, n_model, n_expert, P] layout of a checkpoint's
        # params; shard 0's layout stands for a sharded stage
        self.metas = []
        for s, p in enumerate(self._params0):
            metas = [stage_meta(x) for x in (p if isinstance(p, list)
                                             else [p])]
            if any(m.shapes != metas[0].shapes for m in metas):
                raise ValueError(
                    f"stage {s}: model/expert shards have differing leaf "
                    f"shapes — sharded params must split evenly")
            self.metas.append(metas[0])

    def _axis_of(self, s: int) -> str:
        """The mesh axis stage ``s``'s shards lie on."""
        return (mesh_lib.EXPERT_AXIS
                if self.stages[s].expert_shards is not None
                else mesh_lib.MODEL_AXIS)

    def init_params(self) -> StageParams:
        """A fresh copy of the initial per-stage parameter modules, each on
        its stage's device (None for a stage another process owns) — what
        a train step updates in place. A sharded stage's entry is
        :class:`~.tensor.Shards` of its shard modules on its axis (None
        for a shard another process owns)."""
        own = (range(self.n_stages) if self.mesh is None
               else self.mesh.stages)
        out = []
        for s, (p, d) in enumerate(zip(self._params0, self.devices)):
            if s not in own:
                out.append(None)
            elif isinstance(p, list):
                axis = self._axis_of(s)
                mine = (range(len(p)) if self.mesh is None
                        else self.mesh.expert_shards
                        if axis == mesh_lib.EXPERT_AXIS
                        else self.mesh.shards)
                out.append(Shards([copy.deepcopy(x).to(d) if m in mine
                                   else None for m, x in enumerate(p)],
                                  axis=axis))
            else:
                out.append(copy.deepcopy(p).to(d))
        return StageParams(out, self.mesh)

    # ---- forward/loss -------------------------------------------------------

    def _on(self, x, dtype=None, device=None) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        return t.to(device=self.device if device is None else device,
                    dtype=dtype)

    def _run_stage(self, s: int, p, h, gen, deterministic):
        """Stage ``s``'s apply on activations ``h`` (``[b, ...]``, or a
        :class:`~.sequence.SeqShards` of chunks) with its params ``p``,
        cast to ``compute_dtype`` around it: ``(y, aux)``, aux None when
        the stage returns none."""
        stage = self.stages[s]

        def shaped(c):
            c = c.reshape((c.shape[0],) + tuple(stage.in_shape))
            if cast and c.is_floating_point():
                c = c.to(self.compute_dtype)
            return c

        cast = self.compute_dtype is not None
        if cast:
            p = _cast_tree(p, self.compute_dtype)
            cast = "embed" not in (p[0] if isinstance(p, Shards) else p)
        h = h.map(shaped) if isinstance(h, SeqShards) else shaped(h)
        out = stage.apply(p, h, gen, deterministic)
        return out if isinstance(out, tuple) else (out, None)

    def _fused_out(self, params, x, key, deterministic):
        """``(log-probs, aux)`` of the fused stage, f32; aux None when the
        stage returns none (the JAX ``_fused_logits``)."""
        y, aux = self._run_stage(0, params[0], self._on(x),
                                 _generator(key, self.device), deterministic)
        return y.float(), (None if aux is None else aux.float())

    def _fused_logits(self, params, x, key, deterministic) -> torch.Tensor:
        """f32 log-probs from the fused stage."""
        return self._fused_out(params, x, key, deterministic)[0]

    def _fused_loss(self, params, x, targets, key, deterministic, weights):
        logp, aux = self._fused_out(params, x, key, deterministic)
        num, den, _ = _weighted_nll_sums(
            logp, self._on(targets, torch.long),
            None if weights is None else self._on(weights))
        loss = num / torch.clamp_min(den, 1e-12)
        return (loss if aux is None else loss + aux), logp

    # ---- a mesh: replicas of several stages, over one process or several ------

    def _replica_batches(self, x, targets, weights):
        """This process's rows split per replica: ``{d: (xm, tm, wm)}``,
        each ``[M, b, ...]`` — inputs on replica ``d``'s first owned
        stage's device, targets and weights (ones by default) on its last
        stage's (None where this process does not own the stage), the
        whole token axis (a seq chunk's slice is taken where it is used) —
        and the microbatch size ``b``."""
        mesh, M = self.mesh, self.n_microbatches
        reps = mesh.replicas
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        n = x.shape[0]
        if n % (len(reps) * M):
            raise ValueError(
                f"batch {n * mesh.n_data // len(reps)} not divisible by "
                f"microbatches*data = {M * mesh.n_data}")
        per, b = n // len(reps), n // (len(reps) * M)
        tgt = torch.as_tensor(targets)
        w = (torch.ones((n,), dtype=torch.float32) if weights is None
             else torch.as_tensor(weights))
        in0 = tuple(self.stages[0].in_shape)
        in0 = (in0[0] * self.n_seq,) + in0[1:]
        out = {}
        for k, d in enumerate(reps):
            rows = slice(k * per, (k + 1) * per)
            first = mesh.stage_range(d)[0]
            xm = (x[rows].to(mesh.device(d, 0)).reshape((M, b) + in0)
                  if first == 0 else None)
            tm = wm = None
            if mesh.owns(d, self.n_stages - 1):
                last = mesh.device(d, self.n_stages - 1)
                tm = tgt[rows].to(device=last, dtype=torch.long).reshape(
                    (M, b) + tuple(tgt.shape[1:]))
                wm = w[rows].to(device=last, dtype=torch.float32).reshape(
                    M, b)
            # replica d's own rows: seeded with the data axis for the
            # program linter's replication analysis
            _trace.note_vary([xm, tm, wm], mesh_lib.DATA_AXIS)
            out[d] = (xm, tm, wm)
        return out, b

    def _last_sum(self, values: list[torch.Tensor], seq: bool = True
                  ) -> torch.Tensor | None:
        """The sum over the batch's replicas (and, with ``seq``, its seq
        chunks) of one last-stage quantity, given this process's own
        values: summed here, then over the last stage's gradient group
        (``seq``) or data group. None on a process that owns no last
        stage."""
        if not values:
            return None
        total = values[0]
        for v in values[1:]:
            total = total + v
        S = self.n_stages - 1
        axes = ((mesh_lib.DATA_AXIS, mesh_lib.SEQ_AXIS) if seq
                else (mesh_lib.DATA_AXIS,))
        group = (self.mesh.grad_group(S) if seq
                 else self.mesh.data_group(S))
        if group is None:
            _trace.note_collective("psum", axes, len(values), values,
                                   [total], site="Pipeline._last_sum")
            return total
        return mesh_lib.all_reduce(total, group, axes=axes)

    def _to_every_rank(self, values: torch.Tensor | None,
                       size: int) -> torch.Tensor:
        """A last-stage result (``size`` f64 values, exact for f32 sums and
        counts) on every process: broadcast from replica 0's last
        stage."""
        mesh = self.mesh
        if not mesh.distributed:
            return values
        if values is None:
            values = torch.zeros(size, dtype=torch.float64,
                                 device=self.device)
        return mesh_lib.broadcast(values, self._loss_rank())

    def _loss_rank(self) -> int:
        return self.mesh.owner(0, self.n_stages - 1, 0, 0, 0)

    def _stream_seed(self, key, deterministic: bool) -> int | None:
        """The dropout streams' seed for one call (None when deterministic):
        an int key is it; a generator (None: torch's default CPU one) draws
        it, on its own device — on replica 0's first process, which sends
        it to the others."""
        if deterministic:
            return None
        if key is None or isinstance(key, torch.Generator):
            dev = "cpu" if key is None else key.device
            seed = torch.randint(0, 2 ** 62, (1,), generator=key, device=dev)
            if self.mesh is not None and self.mesh.distributed:
                seed = mesh_lib.broadcast(seed.cpu(), 0)
            # a program trace has no value to read: any seed traces the
            # same program
            return 0 if _trace.active() else int(seed.item())
        return int(key)

    def _stream_start(self, seed: int | None, g: int, device,
                      chunks=None):
        """The batch's microbatch ``g``'s dropout stream as a generator
        state on ``device`` (None when deterministic); with ``chunks``
        (the seq coordinates of a seq-sharded stage) one state per chunk,
        each its own stream folded from the microbatch's."""
        if seed is None:
            return None
        base = seed if g == 0 else fold_in(seed, g)
        if chunks is None:
            return _gen_state(base, device)
        return [_gen_state(fold_in(base, q), device) for q in chunks]

    def _stage_call(self, s: int, p, h, rng, deterministic,
                    remat: bool = False):
        """Stage ``s`` on ``h`` (on its coordinate's device) with its
        dropout generator at state ``rng`` (None: no dropout; a list: one
        per seq chunk): ``(y, rng_after, aux)``, ``rng_after`` the state
        the next stage starts from, aux None when the stage returns none.
        Under ``remat`` the apply runs inside ``torch.utils.checkpoint``;
        its recompute restarts the generators at ``rng``, so the masks
        repeat."""
        after: list = []

        def run(hh):
            gen = None
            if rng is not None:
                dev = (hh[0] if isinstance(hh, SeqShards) else hh).device
                gen = ([_gen_at(r, dev) for r in rng]
                       if isinstance(rng, list) else _gen_at(rng, dev))
            y = self._run_stage(s, p, hh, gen, deterministic)
            if gen is not None and not after:
                after.append([g.get_state() for g in gen]
                             if isinstance(gen, list) else gen.get_state())
            return y

        y, aux = (_checkpoint(run, h, use_reentrant=False) if remat
                  else run(h))
        return y, (after[0] if after else None), aux

    def _replica_params(self, params, d: int, s: int):
        """Stage ``s``'s parameters where replica ``d`` runs it: this
        process's copy, or a differentiable copy on another device; for a
        sharded stage the process's shards on their axis, with the axis's
        group and view."""
        dev = self.mesh.device(d, s)
        p = params[s]
        if isinstance(p, Shards):
            view = self.mesh.view(d, s, p.axis)
            p = Shards([p[i] for i in view.owned], view.group, p.axis, view)
            if _trace.active():
                # each shard is its coordinate's own: seeded with the axis
                for shard in p:
                    _trace.note_vary(list(shard.parameters()), p.axis)
        return p if dev == self.devices[s] else _cast_tree(p, None, dev)

    def _seq_input(self, d: int, xm_m: torch.Tensor):
        """Replica ``d``'s stage-0 input of one microbatch: the whole
        tensor, or on a seq mesh this process's chunks of it."""
        if self.n_seq == 1:
            return xm_m
        view = self.mesh.view(d, 0, mesh_lib.SEQ_AXIS)
        return seq_shards(xm_m, self.n_seq, view)

    def _chunks_of(self, d: int):
        """Replica ``d``'s seq coordinates this process holds (None without
        a seq axis)."""
        if self.n_seq == 1:
            return None
        return list(self.mesh.seq_range(d, 0))

    def _to(self, h, dev):
        return h.map(lambda c: c.to(dev)) if isinstance(h, SeqShards) \
            else h.to(dev)

    def _hop(self, h, dev, offset: int = 1, backward: bool = False):
        """A stage hop within the process: ``h`` (an activation, a list of
        cotangents, or seq chunks) onto the next stage's device, noted as
        a permute over the stage axis for the program linter — with its
        backward twin when autograd carries the cotangent back
        (``backward``)."""
        cots = isinstance(h, list) and not isinstance(h, SeqShards)
        out = [c.to(dev) for c in h] if cots else self._to(h, dev)
        if _trace.active():
            ins = h if cots else _chunks(h)
            outs = out if cots else _chunks(out)
            for i, o in zip(ins, outs):
                _trace.note_collective("ppermute", mesh_lib.STAGE_AXIS,
                                       self.n_stages, [i], [o],
                                       site="Pipeline._hop", offset=offset)
                if backward:
                    _trace.note_collective(
                        "ppermute", mesh_lib.STAGE_AXIS, self.n_stages,
                        [i], [], site="Pipeline._hop (backward)",
                        offset=-offset)
        return out

    def _token_slices(self, t: torch.Tensor, h) -> list:
        """``t`` (``[b, T, ...]`` targets) per output chunk of ``h``."""
        if not isinstance(h, SeqShards):
            return [t]
        tl = t.shape[1] // self.n_seq
        return [t[:, q * tl:(q + 1) * tl] for q in h.view.owned]

    # the wire between processes: a stage's output (and the dropout state
    # the next stage starts from) forward, its gradient back; tags keep the
    # three streams apart, pair order keeps microbatches in order (and a
    # seq-sharded stage's chunks, each to the process of its coordinate)
    _TAG_ACT, _TAG_RNG, _TAG_COT = 1, 2, 3

    def _wire_dtype(self) -> torch.dtype:
        return self.compute_dtype or torch.float32

    def _send_act(self, d: int, s: int, y, rng, pending: list) -> list:
        """Stage ``s``'s output of replica ``d`` to the process of stage
        ``s + 1`` (each seq chunk to its coordinate's); returns the sent
        tensors with their seq coordinates."""
        sent = []
        qs = y.view.owned if isinstance(y, SeqShards) else [None]
        ys = list(y) if isinstance(y, SeqShards) else [y]
        rngs = rng if isinstance(rng, list) else [rng]
        for q, c, r in zip(qs, ys, rngs):
            dst = self.mesh.owner(d, s + 1, q=q)
            if c.dtype != self._wire_dtype():
                raise TypeError(f"stage {s} returned {c.dtype}, the wire "
                                f"carries {self._wire_dtype()}")
            pending.append(mesh_lib.send(c, dst, self._TAG_ACT))
            if r is not None:
                pending.append(mesh_lib.send(r, dst, self._TAG_RNG))
            sent.append((c, q))
        return sent

    def _recv_act(self, d: int, s: int, b: int, stream: bool):
        """Replica ``d``'s input of stage ``s`` (from the process of stage
        ``s - 1``; on a seq mesh this process's chunks, each from its
        coordinate's) and its dropout state (None without dropout)."""
        dev = self.mesh.device(d, s)
        qs = (list(self.mesh.seq_range(d, s)) if self.n_seq > 1
              else [None])
        hs, rngs = [], []
        for q in qs:
            src = self.mesh.owner(d, s - 1, q=q)
            hs.append(mesh_lib.recv((b,) + tuple(self.stages[s].in_shape),
                                    self._wire_dtype(), src, dev,
                                    self._TAG_ACT))
            if stream:
                local = torch.Generator(device=dev).get_state()
                state = mesh_lib.recv((local.numel(),), torch.uint8, src,
                                      "cpu", self._TAG_RNG)
                # a program trace receives no bytes: the generator takes
                # a valid state of its own (the draws are not traced)
                rngs.append(local if _trace.active() else state)
        if self.n_seq == 1:
            return hs[0], (rngs[0] if stream else None)
        view = self.mesh.view(d, s, mesh_lib.SEQ_AXIS)
        return SeqShards(hs, view), (rngs if stream else None)

    def _inputs(self, h) -> list:
        """A received input's tensors with their seq coordinates."""
        if isinstance(h, SeqShards):
            return list(zip(h, h.view.owned))
        return [(h, None)]

    def _send_cot(self, d: int, s: int, g, pending: list, q=None) -> None:
        """The gradient of stage ``s``'s input (seq chunk ``q``) back to
        stage ``s - 1``'s process."""
        pending.append(mesh_lib.send(g, self.mesh.owner(d, s - 1, q=q),
                                     self._TAG_COT))

    def _recv_cot(self, d: int, s: int, like: torch.Tensor,
                  q=None) -> torch.Tensor:
        """The gradient of stage ``s``'s output (seq chunk ``q``), from
        stage ``s + 1``'s process."""
        return mesh_lib.recv(like.shape, like.dtype,
                             self.mesh.owner(d, s + 1, q=q), like.device,
                             self._TAG_COT)

    def _reduce_grads(self, params, per_replica: list[list]) -> list:
        """Per-stage gradients (each replica's list aligned with
        ``param_leaves([params[s]])``) summed over this process's replicas,
        then over each stage's gradient group (its data and seq
        coordinates): the global gradient, in :func:`param_leaves`
        order."""
        out = []
        for s, p in enumerate(params):
            if p is None:
                continue
            rows = [r[s] for r in per_replica if r[s] is not None]
            grads = rows[0]
            for r in rows[1:]:
                grads = [a + b for a, b in zip(grads, r)]
            axes = (mesh_lib.DATA_AXIS, mesh_lib.SEQ_AXIS)
            for i, g in enumerate(grads):
                _trace.note_collective("psum", axes, len(rows),
                                       [r[i] for r in rows], [g],
                                       site="Pipeline._reduce_grads")
            if isinstance(p, Shards) and _trace.active():
                _claim_replicated(s, p, grads)
            group = self.mesh.grad_group(s)
            if group is not None and grads:
                flat = mesh_lib.all_reduce(
                    torch.cat([g.reshape(-1) for g in grads]), group,
                    axes=axes)
                grads = [f.view_as(g) for f, g in zip(
                    flat.split([g.numel() for g in grads]), grads)]
            out.extend(grads)
        return out

    def _den(self, reps: dict) -> torch.Tensor | None:
        """The batch's weight sum broadcast over tokens: the loss's
        denominator, on each process that owns a last stage."""
        vals = []
        for d, (_, tm, wm) in reps.items():
            if tm is not None:
                tok = tm[0, 0].numel() if tm.dim() > 2 else 1
                vals.append(wm.sum() * tok)
        return self._last_sum(vals, seq=False)

    @property
    def _aux_scale(self) -> float:
        """The objective's weight of one stage's aux of one microbatch on
        one replica and seq chunk: the mean over microbatches, the data
        and the seq coordinates."""
        return 1.0 / (self.n_microbatches * self.mesh.n_data * self.n_seq)

    def _staged_pass(self, params, x, targets, key, deterministic, weights,
                     mode: str):
        """GPipe over this process's coordinates, replica after replica,
        microbatch after microbatch. ``mode``: ``"loss"`` (the scalar
        loss), ``"grads"`` (the loss and the global gradients),
        ``"logits"`` (the loss and the f32 log-probs of this process's
        last-stage replicas — their seq chunks concatenated on the token
        axis — None without one) or ``"metrics"`` (``sum(w·nll)``,
        ``sum(w)`` and the exact correct count, folded per microbatch);
        only ``"logits"`` keeps the log-probs past their microbatch. Every
        result but the log-probs reaches every process."""
        mesh, S, M = self.mesh, self.n_stages, self.n_microbatches
        reps, b = self._replica_batches(x, targets, weights)
        seed = self._stream_seed(key, deterministic)
        den = self._den(reps)
        remat = self.remat and torch.is_grad_enabled()
        nums, dens, hits, logps, grads, auxes = [], [], [], [], [], []
        pending: list = []
        for d, (xm, tm, wm) in reps.items():
            stages = mesh.stage_range(d)
            last = stages[-1] == S - 1
            p = {s: self._replica_params(params, d, s) for s in stages}
            num = torch.zeros((), dtype=torch.float32,
                              device=mesh.device(d, S - 1))
            correct = torch.zeros((), dtype=torch.int64, device=num.device)
            aux = None
            ins, outs = [], []
            for m in range(M):
                if stages[0] == 0:
                    h = self._seq_input(d, xm[m])
                    rng = self._stream_start(seed, d * M + m,
                                             mesh.device(d, 0),
                                             self._chunks_of(d))
                else:
                    h, rng = self._recv_act(d, stages[0], b,
                                            seed is not None)
                    for c, q in self._inputs(h):
                        c.requires_grad_(mode == "grads")
                        ins.append((c, q))
                for s in stages:
                    h_s = (self._to(h, mesh.device(d, s)) if s == stages[0]
                           else self._hop(h, mesh.device(d, s),
                                          backward=mode == "grads"))
                    h, rng, a = self._stage_call(
                        s, p[s], h_s, rng, deterministic, remat)
                    if a is not None:
                        a = a.float().to(num.device) * self._aux_scale
                        aux = a if aux is None else aux + a
                if not last:
                    outs.extend(self._send_act(d, stages[-1], h, rng,
                                               pending))
                    continue
                chunks = list(h) if isinstance(h, SeqShards) else [h]
                lps = []
                for c, t in zip(chunks, self._token_slices(tm[m], h)):
                    logp = c.float()
                    n, _, wb = _weighted_nll_sums(logp, t, wm[m])
                    num = num + n
                    if mode == "metrics":
                        correct = correct + ((logp.argmax(-1) == t)
                                             & (wb > 0)).sum()
                    lps.append(logp)
                if mode == "logits":
                    logps.append(torch.cat(lps, 1) if len(lps) > 1
                                 else lps[0])
            if last:
                nums.append(num)
                if mode == "metrics":
                    dens.append(wm.sum() * (tm[0, 0].numel()
                                            if tm.dim() > 2 else 1))
                    hits.append(correct)
            if aux is not None:
                auxes.append(aux)
            if mode == "grads":
                grads.append(self._backward(params, d, stages, num, den,
                                            ins, outs, pending, aux))
        mesh_lib.wait_all(pending)
        if mode == "metrics":
            num, den_m, hit = (self._last_sum(nums),
                               self._last_sum(dens, seq=False),
                               self._last_sum(hits))
            vals = (None if num is None else torch.stack(
                [num.double(), den_m.double(), hit.double()]))
            vals = self._to_every_rank(vals, 3)
            return vals[0].float(), vals[1].float(), vals[2].long()
        loss = self._loss(nums, den, auxes)
        if mode == "grads":
            return loss, self._reduce_grads(params, grads)
        if mode == "logits":
            return loss, torch.cat(logps) if logps else None
        return loss

    def _loss(self, nums: list, den, auxes: list | None = None
              ) -> torch.Tensor:
        """The global loss on every process, from this process's
        last-stage replicas' numerators and its aux terms (already
        weighted by :attr:`_aux_scale`, summed over the processes whose
        model and expert coordinates are 0: the others hold copies)."""
        num = self._last_sum(nums)
        loss = None if num is None else (num / torch.clamp_min(den, 1e-12))
        aux = None
        for a in auxes or []:
            a = a.detach()
            aux = a if aux is None else aux + a
        if not self.mesh.distributed:
            return loss if aux is None else loss + aux.to(loss.device)
        vals = torch.zeros(2, dtype=torch.float64)
        if self.mesh.rank == self._loss_rank():
            vals[0] = loss.detach().double().cpu()
        if aux is not None and self.mesh.primary:
            vals[1] = aux.double().cpu()
        vals = mesh_lib.all_reduce(vals)
        if not _trace.active() and not bool(vals[1]):
            return vals[0].float().to(self.device)
        return (vals[0].float() + vals[1].float()).to(self.device)

    def _backward(self, params, d, stages, num, den, ins, outs, pending,
                  aux=None):
        """Replica ``d``'s gradients of its stages (``[s] -> list``, None
        for a stage it does not run), from the loss on the last stage or
        the cotangents the next process sends back, with the aux terms of
        its stages; the gradients of received inputs go back to the
        previous process."""
        S = self.n_stages
        if stages[-1] == S - 1:
            obj = num / torch.clamp_min(den, 1e-12)
            objs, cots = [obj if aux is None else obj + aux], [None]
        else:
            objs = [y for y, _ in outs]
            cots = [self._recv_cot(d, stages[-1], y, q) for y, q in outs]
            if aux is not None:
                objs.append(aux)
                cots.append(None)
        leaves = [param_leaves([params[s]]) for s in stages]
        wrt = [t for ls in leaves for t in ls] + [h for h, _ in ins]
        got = list(torch.autograd.grad(objs, wrt, cots, allow_unused=True))
        for i, (h, q) in enumerate(ins):
            g = got[len(got) - len(ins) + i]
            self._send_cot(d, stages[0], g if g is not None
                           else torch.zeros_like(h), pending, q)
        out: list = [None] * S
        k = 0
        for s, ls in zip(stages, leaves):
            out[s] = [g if g is not None else torch.zeros_like(t)
                      for g, t in zip(got[k:k + len(ls)], ls)]
            k += len(ls)
        return out

    # ---- the contract ---------------------------------------------------------

    def loss_and_logits(self, params, x, targets, key=None,
                        deterministic: bool = False, weights=None):
        """Weighted-mean NLL loss (plus any stage's aux term) + per-example
        log-probs for a batch: ``loss = sum(w·nll) / sum(w) + aux`` with
        ``weights`` ``[B]`` (a 0/1 validity mask for a padded ragged
        batch) broadcast over tokens; the weights scale the NLL term only,
        as in the JAX package (the MoE load-balancing term counts every
        routed token). Over a mesh the log-probs are this process's
        last-stage replicas' rows (None on a process without a last
        stage)."""
        if self._staged:
            return self._staged_pass(params, x, targets, key, deterministic,
                                     weights, "logits")
        return self._fused_loss(params, x, targets, key, deterministic,
                                weights)

    def loss(self, params, x, targets, key=None, deterministic: bool = False,
             weights=None) -> torch.Tensor:
        """Scalar loss only — the training path (over a mesh no log-probs
        outlive their microbatch)."""
        if self._staged:
            return self._staged_pass(params, x, targets, key, deterministic,
                                     weights, "loss")
        return self._fused_loss(params, x, targets, key, deterministic,
                                weights)[0]

    def loss_and_grads(self, params, x, targets, key=None,
                       deterministic: bool = False, weights=None
                       ) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """Scalar loss + the global gradients, one per :func:`param_leaves`
        entry of ``params`` (this process's stages). ``schedule="1f1b"``
        over two or more stages runs ``parallel/onefb.py``: the same loss
        and gradients, activation memory bounded by the stage count
        instead of the microbatches."""
        if self.schedule == "1f1b" and self.n_stages > 1:
            from simple_distributed_machine_learning_tpu_torch.parallel.onefb import (  # noqa: E501
                onefb_loss_and_grads,
            )
            return onefb_loss_and_grads(self, params, x, targets, key,
                                        deterministic, weights)
        if self._staged:
            loss, grads = self._staged_pass(params, x, targets, key,
                                            deterministic, weights, "grads")
            return loss.detach(), grads
        leaves = param_leaves(params)
        loss = self.loss(params, x, targets, key, deterministic, weights)
        return loss.detach(), list(torch.autograd.grad(loss, leaves))

    @torch.no_grad()
    def eval_metrics(self, params, x, targets, key=None, weights=None):
        """``(sum_nll, sum_weight, correct)``: weighted sums over the batch
        with ``weights`` broadcast over tokens, and the exact integer count
        of ``argmax == target`` among nonzero-weight entries, on every
        process. Always deterministic (dropout off)."""
        if self._staged:
            return self._staged_pass(params, x, targets, key, True, weights,
                                     "metrics")
        logp = self._fused_logits(params, x, key, True)
        tgt = self._on(targets, torch.long)
        num, den, wb = _weighted_nll_sums(
            logp, tgt, None if weights is None else self._on(weights))
        hit = (logp.argmax(-1) == tgt) & (wb > 0)
        return num, den, hit.sum()


def _claim_replicated(s: int, shards: Shards, grads: list) -> None:
    """Claim the gradients of stage ``s``'s replicated leaves (``grads``
    aligned with ``param_leaves([shards])``) replicated over the axis the
    stage is sharded on, for a program trace: every shard's copy of such a
    leaf must take the same gradient, or the copies drift apart. The
    sharded leaves (``tensor.is_sharded_leaf``, ``expert.is_expert_leaf``)
    are each coordinate's own and stay unclaimed."""
    from simple_distributed_machine_learning_tpu_torch.parallel.expert import (
        is_expert_leaf,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel.tensor import (
        is_sharded_leaf,
    )
    split = (is_expert_leaf if shards.axis == mesh_lib.EXPERT_AXIS
             else is_sharded_leaf)
    names = [(m, n) for m, shard in enumerate(shards) if shard is not None
             for n, _ in shard.named_parameters()]
    for g, (m, n) in zip(grads, names):
        if not split(n.split(".")):
            _trace.note_claim(g, shards.axis,
                              f"the gradient of replicated leaf '{n}' of "
                              f"stage {s}, shard {m}")


def _gen_state(seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen.get_state()


def _gen_at(state, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.set_state(state)
    return gen


def _weighted_nll_sums(logp, targets, weights):
    """``(sum(w·nll), sum(w), wb)`` with per-sample ``weights`` (or ones)
    broadcast over token axes — shared by the loss and eval paths."""
    nll = nll_loss(logp, targets, "none")
    w = (torch.ones((logp.shape[0],), dtype=torch.float32,
                    device=logp.device) if weights is None
         else weights.float())
    wb = w.reshape(w.shape + (1,) * (nll.dim() - 1)).expand(nll.shape)
    return (nll * wb).sum(), wb.sum(), wb


def fused_reference(stages: Sequence[Stage]) -> Callable:
    """Single-device composition of the stages: ``apply(stage_params, x,
    key=None, deterministic=False)`` (ground truth for parity tests)."""
    def apply(stage_params, x, key=None, deterministic: bool = False):
        h = x
        for stage, params in zip(stages, stage_params):
            h = h.reshape((h.shape[0],) + tuple(stage.in_shape))
            h = stage.apply(params, h, key, deterministic)
            if isinstance(h, tuple):        # (y, aux): ground truth drops aux
                h = h[0]
        return h
    return apply


def _chunks(h) -> list:
    """The tensors of a hop: an activation, or its seq chunks."""
    return list(h) if isinstance(h, SeqShards) else [h]
