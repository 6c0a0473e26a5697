"""Sequence (context) parallelism: the seq-sharded activation and
Ulysses all-to-all attention (port of ``parallel/sequence.py``).

A stage on a mesh with ``n_seq > 1`` runs on its token axis in chunks:
chunk ``i`` of ``n_seq`` holds the global positions ``[i*T_local,
(i+1)*T_local)``. A process passes its seq coordinates' chunks together as
:class:`SeqShards`, with the axis's view (``parallel/mesh.py::
AxisView``), as it passes its model coordinates' parameters as
``tensor.Shards``; everything but attention runs chunk by chunk. Two
attentions mix the chunks:

- ring attention (``ops/attention.py::ring_attention``): K/V blocks
  rotate around the seq ring, ``n_seq - 1`` hops;
- Ulysses (:func:`ulysses_attention`): one all-to-all scatters the heads
  and gathers the sequence, plain causal attention runs on the whole
  sequence over ``n_heads / n_seq`` heads, and the reverse all-to-all
  restores the chunks. Within a process the all-to-all is a reshuffle of
  the chunks; across processes gloo's ``all_to_all_single`` through the
  host (``parallel/mesh.py::all_to_all``).

Both equal the dense ``causal_attention`` on the gathered sequence to
float tolerance.
"""

from __future__ import annotations

import torch

from simple_distributed_machine_learning_tpu_torch.analysis import (
    trace as _trace,
)
from simple_distributed_machine_learning_tpu_torch.ops.attention import (
    SEQ_AXIS,
    causal_attention_core,
)
from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (
    AxisView,
    all_to_all,
)


class SeqShards(list):
    """This process's seq chunks of one activation, in seq order, and
    ``view``, the seq axis as the process sees it (its ``owned`` are the
    chunks' indices)."""

    def __init__(self, chunks, view: AxisView) -> None:
        super().__init__(chunks)
        if len(self) != len(view.owned):
            raise ValueError(f"{len(self)} chunks for the seq coordinates "
                             f"{list(view.owned)}")
        self.view = view

    def map(self, fn) -> "SeqShards":
        """``fn`` on every chunk."""
        return SeqShards([fn(c) for c in self], self.view)


def seq_shards(x: torch.Tensor, n_seq: int, view: AxisView | None = None
               ) -> SeqShards:
    """The chunks of ``x`` (``[B, T, ...]``) that ``view``'s owned
    coordinates hold (None: every one of ``n_seq``, in this process)."""
    view = AxisView.local(SEQ_AXIS, n_seq) if view is None else view
    if x.shape[1] % n_seq:
        raise ValueError(f"token axis {x.shape[1]} not divisible by the "
                         f"seq axis size {n_seq}")
    t = x.shape[1] // n_seq
    chunks = [x[:, i * t:(i + 1) * t] for i in view.owned]
    # each chunk is its seq coordinate's own, for the program linter
    _trace.note_vary(chunks, SEQ_AXIS)
    return SeqShards(chunks, view)


def ulysses_attention(params, x: SeqShards, n_heads: int,
                      axis: str = SEQ_AXIS) -> SeqShards:
    """Causal MHA with the sequence sharded over the seq axis: ``x`` is
    this process's chunks (``[B, T_local, D]`` each) and the result its
    chunks' outputs. The axis size must divide ``n_heads`` (each
    coordinate ends up owning ``n_heads / axis_size`` whole heads).

    Project each chunk to q/k/v ``[B, T_local, H, Dh]``; the all-to-all
    scatters the head axis and gathers the sequence, giving each
    coordinate the FULL sequence for ``H/s`` heads; plain causal attention
    runs there (causality is exact, no mask crosses coordinates); the
    reverse all-to-all restores the chunks for the output projection."""
    view = x.view
    if view.name != axis:
        raise ValueError(f"ulysses_attention over axis {axis!r} got "
                         f"chunks of axis {view.name!r}")
    s = view.size
    if n_heads % s:
        raise ValueError(f"{n_heads} heads not divisible by axis size {s}")
    b, t_loc, d = x[0].shape
    dh = d // n_heads

    def qkv(c):
        return torch.stack([(c @ params[w]).reshape(b, t_loc, n_heads, dh)
                            for w in ("wq", "wk", "wv")])

    # [3, B, T_loc, H, Dh] -> [3, B, T_loc*s, H/s, Dh]: split the heads
    # across the axis, concatenate the sequence chunks in order
    full = all_to_all([qkv(c) for c in x], view, split_dim=3, concat_dim=2)
    outs = []
    for a in full:
        q, k, v = (t.permute(0, 2, 1, 3) for t in a)    # [B, H/s, T, Dh]
        outs.append(causal_attention_core(q, k, v).permute(0, 2, 1, 3))
    # reverse: gather heads, scatter sequence -> [B, T_loc, H, Dh]
    back = all_to_all(outs, view, split_dim=1, concat_dim=2)
    return SeqShards([o.reshape(b, t_loc, d) @ params["wo"] for o in back],
                     view)
