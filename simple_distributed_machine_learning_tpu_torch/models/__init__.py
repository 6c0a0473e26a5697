"""Models (port of ``models/``): the GPT (its training forward and its
serving decode programs), its beam-search decoder (``beam``), its
stage-sharded decoder (``pp_decode``), its LoRA adapters (``lora``), the
MLP and LeNet."""

from simple_distributed_machine_learning_tpu_torch.models.beam import (  # noqa: F401
    make_beam_decoder,
)
from simple_distributed_machine_learning_tpu_torch.models.gpt import (  # noqa: F401
    GPT,
    GPTConfig,
    decoder_from_pipeline,
    generate,
    make_cached_decoder,
    make_decoder,
    make_gpt_stages,
    make_paged_block_copy,
    make_paged_decode_step,
    make_paged_prefill_chunk,
    make_slot_decode_step,
    make_slot_prefill,
)
from simple_distributed_machine_learning_tpu_torch.models.lenet import (  # noqa: F401
    make_lenet_stages,
)
from simple_distributed_machine_learning_tpu_torch.models.mlp import (  # noqa: F401
    make_mlp_stages,
)
from simple_distributed_machine_learning_tpu_torch.models.pp_decode import (  # noqa: F401
    make_pp_decoder,
)
