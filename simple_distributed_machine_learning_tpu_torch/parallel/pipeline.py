"""The ``Stage`` container and the one-card ``Pipeline`` (port of
``parallel/pipeline.py``).

On one device the JAX package's ``Pipeline`` takes its trivial-mesh path
(``_trivial_mesh``): the one stage IS the fused model, and loss, gradients
and eval metrics run through ``_fused_logits`` / ``_fused_loss`` with no
microbatching and no wire. That path is what this module ports. Several
stages (GPipe over a mesh, 1F1B) wait for ROADMAP item 6 and raise.

Parameters stay in the stage's ``nn.Module`` container (``models/gpt.py::
GPT``, or the MLP's and LeNet's ``_tree.ParamTree`` lists and dicts): a
training step passes the list of per-stage modules where the JAX package
passes its packed ``[S, M, E, P]`` buffer. That buffer exists to shard
stages over a mesh; on one card there is nothing to shard, and the
optimizers update the modules' tensors in place. The packed layout
(``metas``) is still what a checkpoint writes (``train/checkpoint.py``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Sequence

import torch
from torch import nn

from simple_distributed_machine_learning_tpu_torch import _roadmap
from simple_distributed_machine_learning_tpu_torch._device import (
    resolve_device,
)
from simple_distributed_machine_learning_tpu_torch.ops.losses import nll_loss
from simple_distributed_machine_learning_tpu_torch.parallel.staging import (
    stage_meta,
)


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
    """The pipeline engine on one card.

    Keeps the JAX signature as far as it means something here: ``mesh``
    must be None (one card: ``parallel/mesh.py::make_mesh`` returns it); ``wire_dim`` and ``out_dim`` are accepted as
    ``make_gpt_stages`` returns them; ``n_microbatches`` is accepted and, as on
    the JAX package's trivial mesh, does not split the batch; ``remat`` is
    accepted and, as there, recomputes nothing; ``schedule`` is
    ``"gpipe"`` or ``"1f1b"``, the same on one stage.
    ``compute_dtype`` casts the parameters and float activations to that
    dtype around the stage apply; master parameters and the loss stay f32.
    Token ids (the input of a stage that holds the ``embed`` table) are
    not cast: a bf16 cast rounds ids above 256. This departs
    from the JAX package, which casts its float token wire, so that its
    ``gpt_bf16`` row trains on rounded ids;
    ``tests/test_torch_gpt_train.py`` pins the difference. ``device``
    (None = ``"cuda"``) is where the parameters and every batch live.
    """

    def __init__(self, stages: Sequence[Stage], mesh=None,
                 wire_dim: int | None = None,
                 out_dim: int | tuple[int, ...] | None = None,
                 n_microbatches: int = 1, compute_dtype=None,
                 remat: bool = False, schedule: str = "gpipe", device=None):
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown schedule {schedule!r}")
        self.stages = list(stages)
        if len(self.stages) != 1:
            raise _roadmap.not_ported(
                f"Pipeline over {len(self.stages)} stages (GPipe/1F1B over "
                f"a mesh)", _roadmap.PARALLEL_AXES)
        if mesh is not None:
            raise _roadmap.not_ported(f"Pipeline on the mesh {mesh!r}",
                                      _roadmap.PARALLEL_AXES)
        if int(n_microbatches) < 1:
            raise ValueError(f"n_microbatches must be >= 1, got "
                             f"{n_microbatches}")
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        # the master copy stays on the host, as the JAX package keeps its
        # initial buffer: init_params() survives any number of in-place
        # steps on the copies it hands out
        self._params0 = [copy.deepcopy(s.params).cpu() for s in self.stages]
        # the packed [S, 1, 1, P] layout of a checkpoint's params
        self.metas = [stage_meta(p) for p in self._params0]

    def init_params(self) -> list[nn.Module]:
        """A fresh copy of the initial per-stage parameter modules on the
        device — what a train step updates in place."""
        return [copy.deepcopy(p).to(self.device) for p in self._params0]

    # ---- forward/loss -------------------------------------------------------

    def _on(self, x, dtype=None) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        return t.to(device=self.device, dtype=dtype)

    def _fused_logits(self, params, x, key, deterministic) -> torch.Tensor:
        """f32 log-probs from the fused stage. (The port has no MoE blocks,
        so no stage returns the JAX contract's ``(y, aux)`` pair.)"""
        stage = self.stages[0]
        p = params[0]
        xs = self._on(x)
        xs = xs.reshape((xs.shape[0],) + tuple(stage.in_shape))
        if self.compute_dtype is not None:
            p = _cast_tree(p, self.compute_dtype)
            if xs.is_floating_point() and "embed" not in p:
                xs = xs.to(self.compute_dtype)
        return stage.apply(p, xs, _generator(key, self.device),
                           deterministic).float()

    def _fused_loss(self, params, x, targets, key, deterministic, weights):
        logp = self._fused_logits(params, x, key, deterministic)
        num, den, _ = _weighted_nll_sums(
            logp, self._on(targets, torch.long),
            None if weights is None else self._on(weights))
        return num / torch.clamp_min(den, 1e-12), logp

    def loss_and_logits(self, params, x, targets, key=None,
                        deterministic: bool = False, weights=None):
        """Weighted-mean NLL loss + per-example log-probs for a batch:
        ``loss = sum(w·nll) / sum(w)`` with ``weights`` ``[B]`` (a 0/1
        validity mask for a padded ragged batch) broadcast over tokens."""
        return self._fused_loss(params, x, targets, key, deterministic,
                                weights)

    def loss(self, params, x, targets, key=None, deterministic: bool = False,
             weights=None) -> torch.Tensor:
        """Scalar loss only — the training path."""
        return self._fused_loss(params, x, targets, key, deterministic,
                                weights)[0]

    def loss_and_grads(self, params, x, targets, key=None,
                       deterministic: bool = False, weights=None
                       ) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """Scalar loss + gradients, one per :func:`param_leaves` entry."""
        leaves = param_leaves(params)
        loss = self.loss(params, x, targets, key, deterministic, weights)
        return loss.detach(), list(torch.autograd.grad(loss, leaves))

    @torch.no_grad()
    def eval_metrics(self, params, x, targets, key=None, weights=None):
        """``(sum_nll, sum_weight, correct)``: weighted sums over the batch
        with ``weights`` broadcast over tokens, and the exact integer count
        of ``argmax == target`` among nonzero-weight entries. Always
        deterministic (dropout off)."""
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
