"""Plain tensor ops and the hand-written Hopper kernels (port of ``ops/``).

``layers``, ``losses``, ``attention`` are plain torch functions over
explicit params; ``paged_attention`` wraps the CUDA kernel in
``csrc/paged_attention.cu`` beside its plain version; ``random`` is the
counter-based generator the serving sampler draws from.
"""

from simple_distributed_machine_learning_tpu_torch.ops.layers import (  # noqa: F401
    embedding_init,
    embedding_lookup,
    layer_norm,
    layer_norm_init,
    linear,
    linear_init,
)
from simple_distributed_machine_learning_tpu_torch.ops.losses import (  # noqa: F401
    log_softmax,
)
from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (  # noqa: F401
    paged_attention,
    paged_attention_reference,
    paged_flash_decode,
)
