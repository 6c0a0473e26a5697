"""Checkpoint / resume in the JAX package's file format (port of
``train/checkpoint.py``): a checkpoint written by either package restores
in the other.

One ``.npz`` holds the whole training state, written atomically (a temp
file, then ``os.replace``) with a human-readable ``.meta.json`` sidecar:

- ``params``: the packed ``[S, M, E, P]`` f32 buffer over S stages, M
  model shards and E expert shards, each stage's leaves in
  ``jax.tree.flatten`` order (``parallel/staging.py``): row ``[s, m, e]``
  is model shard ``m``'s tree of a tensor-parallel stage (in every
  ``e``), expert shard ``e``'s of an expert-parallel one (in every
  ``m``), and a copy of the stage's tree in every row of an unsharded
  one, as the JAX buffer stores it;
- ``opt_<i>``: the optimizer state's leaves in ``jax.tree.flatten`` order
  of the JAX package's state;
- ``_meta_json``: ``step``, ``n_opt_leaves`` and ``extra``.

The port's optimizer state is per tensor (``train/optimizer.py``); the
JAX package's is per packed buffer. They map one to one: a list of
per-tensor buffers (momentum, an Adam moment) is one buffer-shaped leaf,
packed like the params; an int step counter (AdamW's step, a schedule's
count) is an int32 scalar leaf; a tuple is structure. So sgd with
momentum writes one leaf, momentum 0 none, AdamW ``(step, m, v)`` three,
and a schedule's ``(count, buf)`` a counter and a buffer.

Cross-topology resume: a checkpoint packed at one stage count re-packs
for another (:func:`repack_checkpoint`, or ``restore_checkpoint(...,
src_pipe=...)``) for the MLP and GPT families, whose stages are a
contiguous split — the "trained on a pod, continue on one card" case. The
source is described by its stage metas alone (a list of
:class:`~..parallel.staging.StageMeta`, e.g. from the port's own
``make_mlp_stages(..., n_stages=2)`` trees, with a one-wide model axis)
or by a ``Pipeline``, so no second ``Pipeline`` is needed; the model axes
must match. A restore places each stage's tensors on its stage's device.

Across processes a save is a collective every process calls (JAX
``checkpoint.py:103-120, 143-160``): each process hands its share — the
rows of the stages whose replica-0 coordinate it owns, and its ZeRO-1
slices (``train/optimizer.py::Zero1State``) — to process 0 (``gather_object``
on the caller's thread, so it never races a step's collectives), and only
process 0 writes. A restore reads the file on every process and puts back
the rows and slices that process holds, so the file stays the one-process
layout and crosses between the packages and between process counts.
"""

from __future__ import annotations

import copy
import json
import os
import tempfile
import threading
from typing import Any, Sequence

import numpy as np
import torch

from simple_distributed_machine_learning_tpu_torch._tree import tree_leaves
from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (
    param_leaves,
    param_units,
)
from simple_distributed_machine_learning_tpu_torch.parallel.staging import (
    StageMeta,
    contiguous_split,
    flatten_row,
    stage_meta,
    unpack_stage_params,
)
from simple_distributed_machine_learning_tpu_torch.resilience.faults import (
    maybe_fire,
)
from simple_distributed_machine_learning_tpu_torch.train.optimizer import (
    Zero1State,
)


class CheckpointCorruptError(ValueError):
    """A checkpoint file failed to load (truncated or corrupt): raised with
    the offending path instead of a raw zipfile/KeyError traceback."""


# -- the packed layout ---------------------------------------------------------

def _metas(layout) -> list[StageMeta]:
    """A ``Pipeline`` (its ``metas``) or a sequence of ``StageMeta``."""
    return list(layout.metas if hasattr(layout, "metas") else layout)


def _n_model(layout) -> int:
    """The model axis of a layout: a ``Pipeline``'s, 1 for bare metas."""
    return int(getattr(layout, "n_model", 1))


def _n_expert(layout) -> int:
    """The expert axis of a layout: a ``Pipeline``'s, 1 for bare metas."""
    return int(getattr(layout, "n_expert", 1))


def _shape(metas: Sequence[StageMeta], n_model: int = 1, n_expert: int = 1
           ) -> tuple[int, int, int, int]:
    return (len(metas), n_model, n_expert,
            max((m.total for m in metas), default=0))


def _layout_shape(layout) -> tuple[int, int, int, int]:
    return _shape(_metas(layout), _n_model(layout), _n_expert(layout))


def _axes(params) -> dict:
    """Per sharded stage of a ``StageParams``, the mesh axis its shards
    lie on (``"model"`` or ``"expert"``)."""
    return {s: p.axis for s, p in enumerate(params)
            if getattr(p, "axis", None) is not None
            and isinstance(p, list)}


def _read_row(axis: str | None, m: int | None) -> tuple[int, int]:
    """The ``(model, expert)`` row a module reads back: its shard's on
    its axis, row ``[0, 0]`` for an unsharded stage."""
    if m is None:
        return 0, 0
    return (0, m) if axis == "expert" else (m, 0)


def _jax_order(params) -> list[list[int]]:
    """Per stage, the indices into ``param_leaves(params)`` (the
    optimizer's order) of its leaves in ``jax.tree.flatten`` order (a
    sharded stage's held shards one after another)."""
    out: list[list[int]] = [[] for _ in params]
    for _, s, _, idx in _units(params):
        out[s].extend(idx)
    return out


def _units(params) -> list[tuple]:
    """``(key, s, m, idx)`` per held module (``parallel/pipeline.py::
    param_units``): ``key`` is ``s`` for an unsharded stage (``m`` None)
    and ``(s, m)`` for shard ``m``; ``idx`` the indices into
    ``param_leaves(params)`` of its leaves in ``jax.tree.flatten``
    order."""
    pos = {id(t): i for i, t in enumerate(param_leaves(params))}
    return [(s if m is None else (s, m), s, m,
             [pos[id(t)] for t in tree_leaves(module)])
            for s, m, module in param_units(params)]


def unit_coords(key) -> tuple[int, int | None]:
    """A ZeRO-1 range's key as ``(stage, shard on the stage's axis or
    None)``."""
    return (key, None) if isinstance(key, int) else key


def _unpack(arr: np.ndarray, like: Sequence[torch.Tensor], order,
            axes: dict) -> list[torch.Tensor]:
    """A packed ``[S, M, E, width]`` buffer -> new tensors shaped, typed
    and placed like ``like`` (in ``param_leaves`` order): a shard from its
    row on its axis (``axes``, :func:`_axes`), an unsharded stage from
    ``[s, 0, 0]``."""
    out: list[Any] = [None] * len(like)
    for _, s, m, idx in order:
        mi, ei = _read_row(axes.get(s), m)
        row, off = torch.from_numpy(np.asarray(arr[s, mi, ei])), 0
        for i in idx:
            n = like[i].numel()
            out[i] = row[off:off + n].reshape(like[i].shape).to(
                device=like[i].device, dtype=like[i].dtype)
            off += n
    return out


def _opt_leaves(state, pack, pack_shards=None) -> list:
    """The port's optimizer state -> the JAX state's leaves, in
    ``jax.tree.flatten`` order: ``pack(list)`` of each per-tensor list (a
    ZeRO-1 state's slice lists through ``pack_shards``), an int32 array
    of each step counter."""
    if isinstance(state, Zero1State):
        return _opt_leaves(state.inner, pack_shards, pack_shards)
    if isinstance(state, tuple):
        return [leaf for s in state
                for leaf in _opt_leaves(s, pack, pack_shards)]
    if isinstance(state, list):
        return [pack(state)]
    if isinstance(state, (int, np.integer)):
        return [np.asarray(state, np.int32)]
    raise TypeError(f"unknown optimizer state entry {type(state).__name__}")


def _opt_state(like, leaves, unpack):
    """The inverse of :func:`_opt_leaves` over the structure of ``like``
    (e.g. ``opt.init(params)``), consuming ``leaves`` in order; a ZeRO-1
    ``like`` comes back as a ZeRO-1 state with this process's slices."""
    if isinstance(like, Zero1State):
        def slices(arr, shards):
            out = []
            for (key, (lo, hi)), t in zip(like.ranges.items(), shards):
                s, m = unit_coords(key)
                mi, ei = _read_row(like.axes.get(s), m)
                out.append(torch.from_numpy(np.array(
                    arr[s, mi, ei, lo:hi])).to(device=t.device,
                                               dtype=t.dtype))
            return out

        z = copy.copy(like)
        z.inner = _opt_state(like.inner, leaves, slices)
        return z
    if isinstance(like, tuple):
        return tuple(_opt_state(s, leaves, unpack) for s in like)
    leaf = leaves.pop(0)
    if isinstance(like, list):
        return unpack(leaf, like)
    if np.ndim(leaf) != 0:
        raise ValueError(f"expected a scalar step counter, got an array "
                         f"of shape {np.shape(leaf)}")
    return int(leaf)


def _n_opt_leaves(like) -> int:
    if isinstance(like, Zero1State):
        return _n_opt_leaves(like.inner)
    if isinstance(like, tuple):
        return sum(_n_opt_leaves(s) for s in like)
    return 1


# -- writing -------------------------------------------------------------------

def _gather_state(params, opt_state: Any, step: int,
                  extra: dict | None) -> tuple[dict | None, dict]:
    """Device -> host copy of the full training state in the file's
    layout: ``(arrays, meta)`` on process 0, ``(None, meta)`` on the
    others. A collective across processes (every process calls it)."""
    mesh = getattr(params, "mesh", None)
    distributed = mesh is not None and mesh.distributed
    order = _units(params)
    n_model = 1 if mesh is None else mesh.n_model
    n_expert = 1 if mesh is None else mesh.n_expert
    axes = _axes(params)
    leaves = param_leaves(params)
    pieces: list = []          # (buffer, stage, rows, first, values)
    totals = {key: sum(leaves[i].numel() for i in idx)
              for key, _, _, idx in order}

    def rows(s, m):
        """The ``(model, expert)`` rows a module fills: its shard's on its
        axis (every row of the other), or every row of an unsharded stage
        (the JAX buffer stores it replicated)."""
        ms, es = range(n_model), range(n_expert)
        if m is not None:
            if axes.get(s) == "expert":
                es = (m,)
            else:
                ms = (m,)
        return [(mi, ei) for mi in ms for ei in es]

    def first(s, m) -> bool:
        """Whether this process packs the module: the owner of its
        replica 0, seq chunk 0 and shard (coordinate 0 when
        unsharded)."""
        if not distributed:
            return True
        mi, ei = _read_row(axes.get(s), m)
        return mesh.owns(0, s, mi, 0, ei)

    n_bufs = 0

    def pack(per_tensor) -> int:
        """A replicated buffer: each module's row from the process of its
        replica 0 (model coordinate 0 for an unsharded stage). Returns the
        buffer's index."""
        nonlocal n_bufs
        n_bufs += 1
        for key, s, m, idx in order:
            if first(s, m):
                pieces.append((n_bufs - 1, s, rows(s, m), 0, flatten_row(
                    [per_tensor[i] for i in idx], totals[key]).numpy()))
        return n_bufs - 1

    def pack_shards(shards) -> int:
        """A ZeRO-1 buffer: every process's slices."""
        nonlocal n_bufs
        n_bufs += 1
        for (key, (lo, _)), t in zip(opt_state.ranges.items(), shards):
            s, m = unit_coords(key)
            pieces.append((n_bufs - 1, s, rows(s, m), lo,
                           t.detach().float().cpu().numpy()))
        return n_bufs - 1

    packed_params = pack(leaves)
    opt = _opt_leaves(opt_state, pack, pack_shards)
    meta = {"step": int(step), "n_opt_leaves": len(opt),
            "extra": extra or {}}
    if distributed:
        every = [None] * mesh.world_size if mesh.rank == 0 else None
        torch.distributed.gather_object((pieces, totals), every, dst=0)
        if mesh.rank != 0:
            return None, meta
        pieces = [p for ps, _ in every for p in ps]
        totals = {s: t for _, ts in every for s, t in ts.items()}
    width = max(totals.values(), default=0)
    out = [np.zeros((len(params), n_model, n_expert, width), np.float32)
           for _ in range(n_bufs)]
    for k, s, rs, lo, vals in pieces:
        for mi, ei in rs:
            out[k][s, mi, ei, lo:lo + len(vals)] = vals
    # a buffer comes back as its index, a step counter as an int32 array
    arrays = {"params": out[packed_params]}
    for i, leaf in enumerate(opt):
        arrays[f"opt_{i}"] = out[leaf] if isinstance(leaf, int) else leaf
    return arrays, meta


def _write_npz(path: str, arrays: dict, meta: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = dict(arrays)
    arrays["_meta_json"] = np.frombuffer(json.dumps(meta).encode(),
                                         dtype=np.uint8)
    # a unique temp name: two in-flight async saves to one path each write
    # their own file, and the atomic replace keeps whichever finished last
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)),
                               prefix=os.path.basename(path) + ".tmp.",
                               suffix=".npz")
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        # fault site: ckpt-write-crash truncates the temp and raises here,
        # after the bytes and before the rename, so the committed
        # checkpoint survives the crash
        maybe_fire("ckpt.write", path=path, tmp=tmp)
        os.replace(tmp, path)        # atomic: the old checkpoint stays whole
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)


def save_checkpoint(path: str, params, opt_state: Any, step: int,
                    extra: dict | None = None) -> None:
    """Write training state to ``path`` (one .npz, atomically replaced).
    ``params`` is the list of stage modules a train step updates; the
    metadata travels inside the .npz, the ``.meta.json`` sidecar is a
    copy for people and is not read on restore. Across processes every
    process calls it; only process 0 writes."""
    arrays, meta = _gather_state(params, opt_state, step, extra)
    if arrays is not None:
        _write_npz(path, arrays, meta)


class AsyncSave:
    """Handle for an in-flight async checkpoint write."""

    def __init__(self, thread: threading.Thread | None = None):
        self._thread = thread
        self._error: BaseException | None = None

    def wait(self, timeout: float | None = None) -> None:
        """Block until the write completes; re-raise any write error."""
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError("checkpoint write still in flight")
        if self._error is not None:
            raise self._error

    @property
    def done(self) -> bool:
        return self._thread is None or not self._thread.is_alive()


def save_checkpoint_async(path: str, params, opt_state: Any, step: int,
                          extra: dict | None = None) -> AsyncSave:
    """Like :func:`save_checkpoint`, but the FILE WRITE runs on a
    background thread: the device -> host copy happens before this
    returns, so training may update the parameters in place at once. Call
    ``.wait()`` on the handle before depending on the file. Across
    processes the gather stays on the caller's thread (a collective must
    not race a step's) and only process 0 starts a writer."""
    arrays, meta = _gather_state(params, opt_state, step, extra)
    handle = AsyncSave()
    if arrays is None:
        return handle

    def write():
        try:
            _write_npz(path, arrays, meta)
        except BaseException as e:  # noqa: BLE001 - surfaced via wait()
            handle._error = e

    handle._thread = threading.Thread(target=write, name="ckpt-write",
                                      daemon=True)
    handle._thread.start()
    return handle


# -- reading -------------------------------------------------------------------

def _load_npz(path: str) -> tuple[dict, dict]:
    """``(arrays, meta)`` from a checkpoint, with every truncation or
    corruption turned into :class:`CheckpointCorruptError` naming the
    path."""
    import zipfile

    try:
        with np.load(path) as z:
            meta = json.loads(bytes(z["_meta_json"]).decode())
            arrays = {k: z[k] for k in z.files if k != "_meta_json"}
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, KeyError, EOFError, OSError, ValueError,
            json.JSONDecodeError) as e:
        raise CheckpointCorruptError(
            f"checkpoint {path} is truncated or corrupt "
            f"({type(e).__name__}: {e}) — it cannot be restored; delete it "
            f"and restore an earlier checkpoint") from e
    return arrays, meta


def repack_stage_trees(trees: list, n_stages_new: int) -> list:
    """Re-split per-stage param trees (plain dicts and lists) to a new
    contiguous stage count — the JAX package's rule: all lists (the MLP
    family) concatenate and re-split; all dicts with a ``"blocks"`` list
    (the GPT family) re-split their blocks, the first stage's other keys
    (``embed``) going to the new first stage and ``head`` to the new last.
    Anything else (LeNet's conv|fc vs fused trees) raises."""
    if all(isinstance(t, list) for t in trees):
        return contiguous_split([u for t in trees for u in t], n_stages_new)
    if all(isinstance(t, dict) and "blocks" in t for t in trees):
        for i, t in enumerate(trees[1:-1], start=1):
            if set(t) != {"blocks"}:
                raise ValueError(
                    f"stage {i} carries non-block keys {sorted(set(t))} — "
                    f"only the first (embed) and last (head) stages may")
        if len(trees) > 1:
            first = {k: v for k, v in trees[0].items() if k != "blocks"}
            last = {k: v for k, v in trees[-1].items() if k != "blocks"}
        else:
            first = {k: v for k, v in trees[0].items()
                     if k not in ("blocks", "head")}
            last = {k: v for k, v in trees[0].items() if k == "head"}
        split = contiguous_split([b for t in trees for b in t["blocks"]],
                                 n_stages_new)
        out = []
        for s, bs in enumerate(split):
            t = {"blocks": bs}
            if s == 0:
                t.update(first)
            if s == n_stages_new - 1:
                t.update(last)
            out.append(t)
        return out
    raise ValueError(
        "stages are not a contiguous split of a unit sequence (expected all "
        "lists, or all dicts with a 'blocks' list); this topology cannot be "
        "re-packed — rebuild and retrain, or restore at the original stage "
        "count")


def split_layout(layout, n_stages: int) -> list[StageMeta]:
    """The packed layout of the same model split into ``n_stages``
    contiguous stages (``layout``: a ``Pipeline`` or a list of
    ``StageMeta``): the stage metas a run of it at ``n_stages`` writes,
    without building that run's ``Pipeline``."""
    metas = _metas(layout)
    trees = [unpack_stage_params(torch.zeros(m.total), m) for m in metas]
    return [stage_meta(t) for t in repack_stage_trees(trees, n_stages)]


def _check_model_axes(src, dst) -> None:
    if (_n_model(src), _n_expert(src)) != (_n_model(dst), _n_expert(dst)):
        raise ValueError(
            f"model/expert axes must match to repack: source "
            f"{_n_model(src)}x{_n_expert(src)}, target "
            f"{_n_model(dst)}x{_n_expert(dst)}")


def repack_packed_buffer(arr: np.ndarray, src, dst) -> np.ndarray:
    """Re-split a packed ``[S_src, M, E, P_src]`` buffer (params, momentum,
    Adam moments) into ``dst``'s ``[S_dst, M, E, P_dst]`` layout, each
    model and expert row on its own. ``src`` and ``dst`` are each a ``Pipeline`` or a
    list of ``StageMeta`` (a one-wide model axis); same model, another
    contiguous stage split, the same model axis."""
    _check_model_axes(src, dst)
    src_m, dst_m = _metas(src), _metas(dst)
    arr = np.asarray(arr)
    if tuple(arr.shape) != _layout_shape(src):
        raise ValueError(
            f"buffer {tuple(arr.shape)} does not match the source packed "
            f"layout {_layout_shape(src)}")
    out_shape = _layout_shape(dst)
    out = np.zeros(out_shape, np.float32)
    for mi, ei in np.ndindex(*out_shape[1:3]):
        trees = [unpack_stage_params(
            torch.from_numpy(arr[s, mi, ei].copy()), m)
            for s, m in enumerate(src_m)]
        for s, t in enumerate(repack_stage_trees(trees, len(dst_m))):
            leaves = tree_leaves(t)
            shapes = tuple(tuple(leaf.shape) for leaf in leaves)
            if shapes != dst_m[s].shapes:
                raise ValueError(
                    f"re-split stage {s} leaf shapes {shapes} do not match "
                    f"the target's {dst_m[s].shapes} — source and target "
                    f"must build the same model")
            out[s, mi, ei] = flatten_row(leaves, out_shape[-1]).numpy()
    return out


def repack_checkpoint(path_in: str, path_out: str, src, dst) -> None:
    """Rewrite a checkpoint written at ``src``'s stage layout into
    ``dst``'s (params and every buffer-shaped optimizer leaf; scalar
    leaves pass through). ``src``/``dst``: a ``Pipeline`` or a list of
    ``StageMeta``."""
    _check_model_axes(src, dst)
    arrays, meta = _load_npz(path_in)
    src_shape = _layout_shape(src)
    for k in list(arrays):
        if k == "params" or (k.startswith("opt_")
                             and tuple(arrays[k].shape) == src_shape):
            arrays[k] = repack_packed_buffer(arrays[k], src, dst)
    _write_npz(path_out, arrays, meta)


def restore_checkpoint(path: str, pipe=None, opt_treedef_like: Any = None,
                       src_pipe=None) -> dict:
    """Load state. With ``pipe``, ``params`` comes back as a fresh list of
    stage modules on the pipeline's device (``pipe.init_params()`` with
    the checkpoint's values); without it, as the raw packed array.
    ``opt_treedef_like`` (e.g. ``opt.init(params)``; needs ``pipe``)
    gives the optimizer state's structure, and the state comes back in
    it, its tensors placed like the template's. ``src_pipe``: the layout
    the checkpoint was WRITTEN at (a ``Pipeline`` or a list of
    ``StageMeta``) when its stage count differs from ``pipe``'s."""
    arrays, meta = _load_npz(path)
    try:
        packed = arrays["params"]
        opt = [arrays[f"opt_{i}"] for i in range(meta["n_opt_leaves"])]
    except KeyError as e:
        raise CheckpointCorruptError(
            f"checkpoint {path} is missing array {e.args[0]!r} — truncated "
            f"or not a training checkpoint") from e
    out = {"params": packed, "opt_state": opt, "step": meta["step"],
           "extra": meta["extra"]}
    if pipe is None:
        if opt_treedef_like is not None:
            raise ValueError("restoring the optimizer state needs the "
                             "pipeline (pipe=) for its parameter layout")
        return out
    want = _layout_shape(pipe)
    if tuple(packed.shape) != want and src_pipe is not None:
        src_shape = _layout_shape(src_pipe)
        packed = repack_packed_buffer(packed, src_pipe, pipe)
        opt = [repack_packed_buffer(leaf, src_pipe, pipe)
               if tuple(leaf.shape) == src_shape else leaf for leaf in opt]
    if tuple(packed.shape) != want:
        raise ValueError(
            f"checkpoint {path} does not match the model: packed param "
            f"buffer is {tuple(packed.shape)}, model expects {want} "
            f"(different model/topology config? pass src_pipe= to re-pack "
            f"a contiguous-split model across stage counts)")
    params = pipe.init_params()
    order = _units(params)
    axes = _axes(params)
    leaves = param_leaves(params)
    with torch.no_grad():
        for t, v in zip(leaves, _unpack(packed, leaves, order, axes)):
            t.copy_(v)
    out["params"] = params
    if opt_treedef_like is not None:
        if len(opt) != _n_opt_leaves(opt_treedef_like):
            raise ValueError(
                f"checkpoint {path} holds {len(opt)} optimizer leaves, the "
                f"optimizer expects {_n_opt_leaves(opt_treedef_like)} "
                f"(another optimizer or schedule?)")

        def unpack(arr, like):
            if tuple(np.shape(arr)) != want:
                raise ValueError(
                    f"checkpoint {path}: optimizer buffer "
                    f"{tuple(np.shape(arr))} does not match the packed "
                    f"layout {want}")
            return _unpack(arr, like, order, axes)

        out["opt_state"] = _opt_state(opt_treedef_like, list(opt), unpack)
    return out
