"""Plain tensor ops and the hand-written Hopper kernels (port of ``ops/``).

``layers``, ``losses``, ``attention`` are plain torch functions over
explicit params; ``paged_attention`` wraps the CUDA kernel in
``csrc/paged_attention.cu`` and ``flash_attention`` the three training
kernels in ``csrc/flash_attention.cu``, each beside its plain version;
``random`` is the counter-based generator the serving sampler draws from.
"""

from simple_distributed_machine_learning_tpu_torch.ops.attention import (  # noqa: F401
    causal_attention,
    causal_attention_core,
)
# the function ``flash_attention`` is not re-exported here: it would shadow
# the module ``ops.flash_attention`` of the same name
from simple_distributed_machine_learning_tpu_torch.ops.flash_attention import (  # noqa: F401
    flash_backward_reference,
    flash_dkv,
    flash_dq,
    flash_forward,
    flash_forward_reference,
    flash_mha,
)
from simple_distributed_machine_learning_tpu_torch.ops.layers import (  # noqa: F401
    dropout,
    embedding_init,
    embedding_lookup,
    layer_norm,
    layer_norm_init,
    linear,
    linear_init,
)
from simple_distributed_machine_learning_tpu_torch.ops.losses import (  # noqa: F401
    log_softmax,
    nll_loss,
)
from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (  # noqa: F401
    paged_attention,
    paged_attention_reference,
    paged_flash_decode,
)
