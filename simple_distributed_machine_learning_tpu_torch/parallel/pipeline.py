"""The ``Stage`` container and the ``Pipeline`` engine (port of
``parallel/pipeline.py`` and, for 1F1B, ``parallel/onefb.py``).

One stage and no mesh is the JAX package's trivial-mesh path
(``_trivial_mesh``): the stage IS the fused model, and loss, gradients and
eval metrics run through ``_fused_logits`` / ``_fused_loss`` with no
microbatching. Several stages run over a stage mesh
(``parallel/mesh.py::make_mesh``), one process driving them all, as one
JAX controller drives its stage axis:

- stage ``s``'s parameters live on ``mesh.devices[s]``; the hop is
  ``out.to(mesh.devices[s + 1])`` (a no-op when two stages share a card),
  carrying the stage's output as it is, where the JAX wire is f32 padded
  to ``wire_dim`` (the f32 round trip of a bf16 value is exact, so both
  compute the same numbers);
- the batch splits into ``n_microbatches`` microbatches; GPipe runs every
  microbatch through every stage and differentiates the sum with autograd,
  so all microbatches' residuals live until the backward (``remat``
  recomputes each stage inside ``torch.utils.checkpoint`` instead);
  ``schedule="1f1b"`` interleaves forwards and backwards
  (``parallel/onefb.py``), its memory bounded by the stage count;
- the loss is the whole batch's weighted mean: each microbatch's
  ``sum(w·nll)`` over the batch's ``sum(w)``, known before the schedule
  starts;
- dropout: each microbatch draws one stream, seeded from the key (the key
  itself for microbatch 0, ``ops.random.fold_in(key, m)`` after it), stage
  after stage: a stage's generator starts at the state the previous stage
  left, handed over with the hop. So one microbatch draws the fused path's
  masks, GPipe and 1F1B draw the same ones, and a recompute replays them
  from the saved state.

Parameters stay in the stage's ``nn.Module`` container (``models/gpt.py::
GPT``, or the MLP's and LeNet's ``_tree.ParamTree`` lists and dicts): a
training step passes the list of per-stage modules where the JAX package
passes its packed ``[S, M, E, P]`` buffer, and the optimizers update the
modules' tensors in place on their devices. The packed layout (``metas``)
is still what a checkpoint writes (``train/checkpoint.py``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint as _checkpoint

from simple_distributed_machine_learning_tpu_torch import _roadmap
from simple_distributed_machine_learning_tpu_torch._device import (
    resolve_device,
)
from simple_distributed_machine_learning_tpu_torch.ops.losses import nll_loss
from simple_distributed_machine_learning_tpu_torch.ops.random import fold_in
from simple_distributed_machine_learning_tpu_torch.parallel.staging import (
    stage_meta,
)

#: the collective schedules of the JAX package's ``parallel/overlap.py``
OVERLAP_CHOICES = ("none", "ring")


def check_overlap(overlap: str) -> str:
    if overlap not in OVERLAP_CHOICES:
        raise ValueError(
            f"overlap must be one of {OVERLAP_CHOICES}, got {overlap!r}")
    return overlap


@dataclasses.dataclass(frozen=True)
class Stage:
    """One pipeline stage.

    ``apply(params, x, key=None, deterministic=True) -> y`` runs the stage
    on real activations: ``x`` has per-sample shape ``in_shape`` (token ids
    for the first stage); the last stage returns log-probabilities.
    ``params`` is the stage's ``nn.Module`` parameter container, which
    indexes like the JAX stage tree (``_tree.Tree``); ``key`` is a
    ``torch.Generator`` for dropout. The JAX
    package's ``shards``/``expert_shards`` (tensor and expert parallelism)
    wait for the slices that port those axes.
    """
    apply: Callable[..., Any]
    params: Any
    in_shape: tuple[int, ...]


def param_leaves(params) -> list[torch.Tensor]:
    """The trainable tensors of ``params`` — a list of stage modules, one
    module, or a sequence of tensors — in a fixed order: the order of
    gradients and optimizer-state entries."""
    if isinstance(params, nn.Module):
        return list(params.parameters())
    leaves: list[torch.Tensor] = []
    for p in params:
        leaves.extend([p] if isinstance(p, torch.Tensor) else param_leaves(p))
    return leaves


def _cast_tree(module, dtype: torch.dtype):
    """A stage module as a tree of dicts and lists of its tensors cast to
    ``dtype`` — differentiable casts, so gradients reach the f32 master
    tensors (the JAX package's ``tree.map(astype)`` around the apply)."""
    if isinstance(module, torch.Tensor):
        return module.to(dtype)
    if isinstance(module, nn.ModuleList):
        return [_cast_tree(m, dtype) for m in module]
    out = {k: v.to(dtype) for k, v in module._parameters.items()}
    out.update({k: _cast_tree(m, dtype) for k, m in module._modules.items()})
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
    None (one stage on ``device``, None = ``"cuda"``) or a stage mesh
    (``parallel/mesh.py::make_mesh``), whose devices the stages are placed
    on; ``wire_dim`` and ``out_dim`` are accepted as the stage builders
    return them (the hop needs no wire); ``n_microbatches`` splits the
    batch over several stages and, as on the JAX package's trivial mesh,
    not on one; ``remat`` recomputes each stage in the backward over
    several stages (GPipe) and, as there, nothing on one; ``schedule`` is
    ``"gpipe"`` or ``"1f1b"``, the same on one stage; ``overlap`` is
    ``"none"`` (the JAX default), and ``"ring"``, the chunked ring that
    replaces the collectives of a sharded mesh, waits for ROADMAP item 6.
    ``compute_dtype`` casts the parameters and float activations to that
    dtype around each stage apply; master parameters and the loss stay
    f32. Token ids (the input of a stage that holds the ``embed`` table)
    are not cast: a bf16 cast rounds ids above 256. This departs from the
    JAX package, which casts its float token wire, so that its
    ``gpt_bf16`` row trains on rounded ids;
    ``tests/test_torch_gpt_train.py`` pins the difference.

    Attributes for telemetry and callers: ``n_stages``, ``n_microbatches``,
    ``schedule``, ``devices`` (one per stage), ``device`` (the first
    stage's, where a batch's inputs go) and ``out_device`` (the last
    stage's, where its targets and the loss live).
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
        if overlap == "ring":
            raise _roadmap.not_ported("Pipeline(overlap='ring')",
                                      _roadmap.PARALLEL_AXES)
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
        self._params0 = [copy.deepcopy(s.params).cpu() for s in self.stages]
        # the packed [S, 1, 1, P] layout of a checkpoint's params
        self.metas = [stage_meta(p) for p in self._params0]

    def init_params(self) -> list[nn.Module]:
        """A fresh copy of the initial per-stage parameter modules, each on
        its stage's device — what a train step updates in place."""
        return [copy.deepcopy(p).to(d)
                for p, d in zip(self._params0, self.devices)]

    # ---- forward/loss -------------------------------------------------------

    def _on(self, x, dtype=None, device=None) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        return t.to(device=self.device if device is None else device,
                    dtype=dtype)

    def _run_stage(self, s: int, p, h: torch.Tensor, gen, deterministic):
        """Stage ``s``'s apply on activations ``h`` (``[b, ...]``) with its
        params ``p``, cast to ``compute_dtype`` around it."""
        stage = self.stages[s]
        h = h.reshape((h.shape[0],) + tuple(stage.in_shape))
        if self.compute_dtype is not None:
            p = _cast_tree(p, self.compute_dtype)
            if h.is_floating_point() and "embed" not in p:
                h = h.to(self.compute_dtype)
        return stage.apply(p, h, gen, deterministic)

    def _fused_logits(self, params, x, key, deterministic) -> torch.Tensor:
        """f32 log-probs from the fused stage. (The port has no MoE blocks,
        so no stage returns the JAX contract's ``(y, aux)`` pair.)"""
        return self._run_stage(0, params[0], self._on(x),
                               _generator(key, self.device),
                               deterministic).float()

    def _fused_loss(self, params, x, targets, key, deterministic, weights):
        logp = self._fused_logits(params, x, key, deterministic)
        num, den, _ = _weighted_nll_sums(
            logp, self._on(targets, torch.long),
            None if weights is None else self._on(weights))
        return num / torch.clamp_min(den, 1e-12), logp

    # ---- several stages -------------------------------------------------------

    def _microbatches(self, x, targets, weights):
        """The batch split into ``[M, b, ...]`` microbatches: inputs on the
        first stage's device, targets and weights (ones by default) on the
        last's; and the whole batch's weight sum broadcast over tokens,
        the loss's denominator."""
        M = self.n_microbatches
        x = self._on(x)
        B = x.shape[0]
        if B % M:
            raise ValueError(
                f"batch {B} not divisible by microbatches*data = {M}")
        xm = x.reshape((M, B // M) + tuple(self.stages[0].in_shape))
        tgt = self._on(targets, torch.long, self.out_device)
        w = (torch.ones((B,), dtype=torch.float32, device=self.out_device)
             if weights is None
             else self._on(weights, torch.float32, self.out_device))
        den = w.sum() * (tgt[0].numel() if tgt.dim() > 1 else 1)
        return (xm, tgt.reshape((M, B // M) + tuple(tgt.shape[1:])),
                w.reshape(M, B // M), den)

    def _stream_seed(self, key, deterministic: bool) -> int | None:
        """The dropout streams' seed for one call (None when deterministic):
        an int key is it; a generator (None: torch's default CPU one) draws
        it, on its own device."""
        if deterministic:
            return None
        if key is None or isinstance(key, torch.Generator):
            dev = "cpu" if key is None else key.device
            return int(torch.randint(0, 2 ** 62, (1,), generator=key,
                                     device=dev).item())
        return int(key)

    def _stream_start(self, seed: int | None, m: int):
        """Microbatch ``m``'s dropout stream as a generator state on the
        first stage's device (None when deterministic)."""
        if seed is None:
            return None
        g = torch.Generator(device=self.device)
        g.manual_seed(seed if m == 0 else fold_in(seed, m))
        return g.get_state()

    def _stage_call(self, s: int, p, h: torch.Tensor, rng, deterministic,
                    remat: bool = False):
        """Stage ``s`` on ``h`` with its dropout generator at state ``rng``
        (None: no dropout): ``(y, rng_after)``, the state the next stage
        starts from. Under ``remat`` the apply runs inside
        ``torch.utils.checkpoint``; its recompute restarts the generator
        at ``rng``, so the masks repeat."""
        after: list = []

        def run(hh):
            gen = None
            if rng is not None:
                gen = torch.Generator(device=self.devices[s])
                gen.set_state(rng)
            y = self._run_stage(s, p, hh, gen, deterministic)
            if gen is not None and not after:
                after.append(gen.get_state())
            return y

        y = (_checkpoint(run, h, use_reentrant=False) if remat else run(h))
        return y, (after[0] if after else None)

    def _staged_pass(self, params, x, targets, key, deterministic, weights,
                     mode: str):
        """GPipe over the stages, microbatch after microbatch. ``mode``:
        ``"loss"`` (the scalar loss), ``"logits"`` (the loss and the
        ``[B, ...]`` f32 log-probs) or ``"metrics"`` (``sum(w·nll)``,
        ``sum(w)`` and the exact correct count, folded per microbatch);
        only ``"logits"`` keeps the log-probs past their microbatch."""
        xm, tm, wm, den = self._microbatches(x, targets, weights)
        seed = self._stream_seed(key, deterministic)
        remat = self.remat and torch.is_grad_enabled()
        num = torch.zeros((), dtype=torch.float32, device=self.out_device)
        correct = torch.zeros((), dtype=torch.int64, device=self.out_device)
        logps = []
        for m in range(self.n_microbatches):
            h, rng = xm[m], self._stream_start(seed, m)
            for s in range(self.n_stages):
                h, rng = self._stage_call(s, params[s],
                                          h.to(self.devices[s]), rng,
                                          deterministic, remat)
            logp = h.float()
            n, _, wb = _weighted_nll_sums(logp, tm[m], wm[m])
            num = num + n
            if mode == "metrics":
                correct = correct + ((logp.argmax(-1) == tm[m])
                                     & (wb > 0)).sum()
            elif mode == "logits":
                logps.append(logp)
        if mode == "metrics":
            return num, den, correct
        loss = num / torch.clamp_min(den, 1e-12)
        if mode == "logits":
            return loss, torch.cat(logps)
        return loss

    # ---- the contract ---------------------------------------------------------

    def loss_and_logits(self, params, x, targets, key=None,
                        deterministic: bool = False, weights=None):
        """Weighted-mean NLL loss + per-example log-probs for a batch:
        ``loss = sum(w·nll) / sum(w)`` with ``weights`` ``[B]`` (a 0/1
        validity mask for a padded ragged batch) broadcast over tokens."""
        if self.n_stages > 1:
            return self._staged_pass(params, x, targets, key, deterministic,
                                     weights, "logits")
        return self._fused_loss(params, x, targets, key, deterministic,
                                weights)

    def loss(self, params, x, targets, key=None, deterministic: bool = False,
             weights=None) -> torch.Tensor:
        """Scalar loss only — the training path (over several stages no
        log-probs outlive their microbatch)."""
        if self.n_stages > 1:
            return self._staged_pass(params, x, targets, key, deterministic,
                                     weights, "loss")
        return self._fused_loss(params, x, targets, key, deterministic,
                                weights)[0]

    def loss_and_grads(self, params, x, targets, key=None,
                       deterministic: bool = False, weights=None
                       ) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """Scalar loss + gradients, one per :func:`param_leaves` entry.
        ``schedule="1f1b"`` over several stages runs
        ``parallel/onefb.py``: the same loss and gradients, activation
        memory bounded by the stage count instead of the microbatches."""
        if self.schedule == "1f1b" and self.n_stages > 1:
            from simple_distributed_machine_learning_tpu_torch.parallel.onefb import (  # noqa: E501
                onefb_loss_and_grads,
            )
            return onefb_loss_and_grads(self, params, x, targets, key,
                                        deterministic, weights)
        leaves = param_leaves(params)
        loss = self.loss(params, x, targets, key, deterministic, weights)
        return loss.detach(), list(torch.autograd.grad(loss, leaves))

    @torch.no_grad()
    def eval_metrics(self, params, x, targets, key=None, weights=None):
        """``(sum_nll, sum_weight, correct)``: weighted sums over the batch
        with ``weights`` broadcast over tokens, and the exact integer count
        of ``argmax == target`` among nonzero-weight entries. Always
        deterministic (dropout off)."""
        if self.n_stages > 1:
            return self._staged_pass(params, x, targets, key, True, weights,
                                     "metrics")
        logp = self._fused_logits(params, x, key, True)
        tgt = self._on(targets, torch.long)
        num, den, wb = _weighted_nll_sums(
            logp, tgt, None if weights is None else self._on(weights))
        hit = (logp.argmax(-1) == tgt) & (wb > 0)
        return num, den, hit.sum()


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
        return h
    return apply
