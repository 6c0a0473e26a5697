"""Data (port of ``data/``): MNIST (IDX files or the seeded synthetic
set) and the LM token streams. Pure numpy, as in the JAX package, whose
modules these copy: the port imports nothing of it."""

from simple_distributed_machine_learning_tpu_torch.data.mnist import (  # noqa: F401
    Batch,
    Dataset,
    batches,
    load_idx_mnist,
    load_mnist,
    prefetch_batches,
    synthetic_mnist,
)
from simple_distributed_machine_learning_tpu_torch.data.text import (  # noqa: F401
    LMData,
    byte_corpus,
    synthetic_tokens,
)
