"""Training (port of ``train/``): optimizers, schedules, the train and eval
steps. The JAX package's trainer, checkpointing, ZeRO-1 and ``from_optax``
wait for ROADMAP Queue A item 3."""

from simple_distributed_machine_learning_tpu_torch.train.optimizer import (  # noqa: F401
    Optimizer,
    adamw,
    clip_by_global_norm,
    sgd,
)
from simple_distributed_machine_learning_tpu_torch.train.schedules import (  # noqa: F401
    constant,
    cosine,
    step_decay,
    warmup_cosine,
)
from simple_distributed_machine_learning_tpu_torch.train.step import (  # noqa: F401
    make_eval_step,
    make_scanned_train_step,
    make_train_step,
)
