"""Stage-sharded KV-cache decoding (port of ``models/pp_decode.py``).

``make_pp_decoder(pipe, cfg, ...)`` returns ``decode(params, prompt,
key_data=None)`` over a ``Pipeline``'s stages as they train: each stage
keeps a KV cache for its own blocks only, on its own device, and the
hidden state of one token relays stage to stage over the same hop the
trainer uses (``Tensor.to(device)``); the sampled token goes back from
the last stage to the first. Nothing is gathered onto one device: a model
that trains at S stages decodes at S stages, from the live parameters.

The loop is ``models/gpt.py::make_cached_decoder``'s own
(``_relay_decode``, there over one stage): the same math and key stream
(one split per sampled token, none for greedy), so the tokens equal the
one-device cached decoder's. Stages may hold different block counts
(``contiguous_split``): each cache has its own stage's depth, where the
JAX package pads every stage to the deepest because one SPMD program runs
on every device. Attention is the dense cache attention of the cached
decoder; no hand kernel runs here (the JAX module reaches no
``pallas_call``).

Across processes (``parallel/mesh.py``) replica 0's ring decodes through
the same loop: each process runs the stages of replica 0 it owns against
its own caches, and the hops that leave the process go over the
host-staged wire (:class:`_RingWire`): the hidden state to the next
process, each sampled token from the last stage's process back to the
first's. The tokens come back on the processes of the first and last
stage (None elsewhere), equal to one process's.
"""

from __future__ import annotations

import torch

from simple_distributed_machine_learning_tpu_torch.models.gpt import (
    GPTConfig,
    _check_cache_quantization,
    _check_sampling_args,
    _relay_decode,
    _validate_decode_build,
)
from simple_distributed_machine_learning_tpu_torch.parallel import (
    mesh as mesh_lib,
)


def make_pp_decoder(pipe, cfg: GPTConfig, prompt_len: int, n_new: int,
                    temperature: float = 0.0, top_k: int | None = None,
                    top_p: float | None = None, cache_dtype=None):
    """Build ``decode(params, prompt, key_data=None) -> int32 [B,
    prompt_len + n_new]`` (on the last stage's device; across processes on
    the first or last stage's, None on the others). ``params`` is the
    pipeline's per-stage modules (the live training state); ``prompt``
    ``[B, prompt_len]`` int tokens; ``key_data`` as the cached decoder's.
    ``cache_dtype``: f32 (None) or bf16, as ``make_cached_decoder``."""
    _check_sampling_args(temperature, top_k, top_p, cfg.vocab)
    _check_cache_quantization(cache_dtype, "make_pp_decoder", paged=False)
    total = _validate_decode_build(pipe.stages, cfg, prompt_len, n_new,
                                   "make_pp_decoder")
    trees = [s.params for s in pipe.stages]
    if not ("embed" in trees[0] and "head" in trees[-1]):
        raise ValueError("stage 0 must own 'embed' and the last stage "
                         "'head' (the make_gpt_stages layout)")
    sampling = (temperature, top_k, top_p)

    @torch.no_grad()
    def decode(params, prompt, key_data=None):
        if prompt.shape[1] != prompt_len:
            raise ValueError(
                f"prompt length {prompt.shape[1]} != built {prompt_len}")
        mesh, S = pipe.mesh, pipe.n_stages
        mine, devs, wire = range(S), pipe.devices, None
        if mesh is not None and mesh.distributed:
            mine = mesh.stage_range(0)
            if not mine:
                return None
            devs = [mesh.device(0, s) for s in mine]
            wire = _RingWire(mesh, mine, S)
        return _relay_decode(params[0]["embed"] if mine[0] == 0 else None,
                             [params[s]["blocks"] for s in mine],
                             params[S - 1]["head"] if mine[-1] == S - 1
                             else None, devs, prompt, key_data, cfg,
                             prompt_len, total, cache_dtype, sampling, wire)

    return decode


_TAG_HIDDEN, _TAG_TOKEN = 11, 12


class _RingWire:
    """The hops of replica 0's ring that leave this process: the hidden
    state in from the previous stage's process and out to the next's, and
    each sampled token from the last stage's process back to the
    first's (``_relay_decode``'s ``wire``)."""

    def __init__(self, mesh, mine: range, n_stages: int) -> None:
        self.mesh = mesh
        self.prev = mesh.owner(0, mine[0] - 1) if mine[0] > 0 else None
        self.next = (mesh.owner(0, mine[-1] + 1)
                     if mine[-1] < n_stages - 1 else None)
        self.first, self.last = mesh.owner(0, 0), mesh.owner(0, n_stages - 1)
        self.pending: list = []

    def recv_hidden(self, shape, device) -> torch.Tensor:
        return mesh_lib.recv(shape, torch.float32, self.prev, device,
                             _TAG_HIDDEN)

    def send_hidden(self, h: torch.Tensor) -> None:
        self.pending.append(mesh_lib.send(h.float(), self.next, _TAG_HIDDEN))

    def token(self, tok, b: int, device):
        """The last stage's ``tok`` sent on to the first's process; there
        the token received; None on a process that holds neither."""
        if tok is not None:
            if self.first != self.mesh.rank:
                self.pending.append(mesh_lib.send(tok.long(), self.first,
                                                  _TAG_TOKEN))
            return tok
        if self.mesh.rank == self.first:
            return mesh_lib.recv((b,), torch.int64, self.last, device,
                                 _TAG_TOKEN).to(torch.int32)
        return None

    def close(self) -> None:
        mesh_lib.wait_all(self.pending)
