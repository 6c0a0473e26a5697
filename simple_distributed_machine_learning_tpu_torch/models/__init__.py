"""Models (port of ``models/``): the GPT, its training forward and its
serving decode programs."""

from simple_distributed_machine_learning_tpu_torch.models.gpt import (  # noqa: F401
    GPT,
    GPTConfig,
    make_cached_decoder,
    make_gpt_stages,
    make_paged_block_copy,
    make_paged_decode_step,
    make_paged_prefill_chunk,
)
