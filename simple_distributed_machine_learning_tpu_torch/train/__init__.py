"""Training (port of ``train/``): optimizers, schedules, the train and eval
steps, checkpoints that cross-restore with the JAX package, and the
reference-style ``Trainer``."""

from simple_distributed_machine_learning_tpu_torch.train.checkpoint import (  # noqa: F401
    AsyncSave,
    CheckpointCorruptError,
    repack_checkpoint,
    repack_packed_buffer,
    repack_stage_trees,
    restore_checkpoint,
    save_checkpoint,
    save_checkpoint_async,
)
from simple_distributed_machine_learning_tpu_torch.train.optimizer import (  # noqa: F401
    Optimizer,
    Zero1State,
    adamw,
    clip_by_global_norm,
    global_grad_norm,
    sgd,
    shard_opt_state_zero1,
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
from simple_distributed_machine_learning_tpu_torch.train.trainer import (  # noqa: F401
    TrainConfig,
    Trainer,
)
