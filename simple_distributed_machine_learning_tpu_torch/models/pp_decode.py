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


def make_pp_decoder(pipe, cfg: GPTConfig, prompt_len: int, n_new: int,
                    temperature: float = 0.0, top_k: int | None = None,
                    top_p: float | None = None, cache_dtype=None):
    """Build ``decode(params, prompt, key_data=None) -> int32 [B,
    prompt_len + n_new]`` (on the last stage's device). ``params`` is the
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
        return _relay_decode(params[0]["embed"],
                             [p["blocks"] for p in params],
                             params[-1]["head"], pipe.devices, prompt,
                             key_data, cfg, prompt_len, total, cache_dtype,
                             sampling)

    return decode
