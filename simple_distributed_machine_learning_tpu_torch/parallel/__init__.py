"""Parallelism (port of ``parallel/``): the stage split rule, the packed
stage buffer and wire codec, the data x stage x model x seq x expert mesh
with its axis collectives and the multi-process bootstrap, ``Stage``, the
``Pipeline`` (one fused stage, or GPipe over a mesh, in one process or
several), the 1F1B schedule, tensor parallelism (``tensor``: Megatron
pairs and the model sums), the overlapped collectives (``overlap``: the
ring schedules of the model axis's sums and gathers), sequence parallelism (``sequence``: seq chunks
and Ulysses; ring attention is ``ops/attention.py``'s) and experts
(``expert``: the MoE FFN and its all-to-all dispatch)."""

from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    bootstrap_distributed,
    make_mesh,
)
from simple_distributed_machine_learning_tpu_torch.parallel.onefb import (  # noqa: F401
    onefb_loss_and_grads,
)
from simple_distributed_machine_learning_tpu_torch.parallel.overlap import (  # noqa: F401
    allgather_matmul,
    matmul_reducescatter,
    ring_all_gather,
    ring_psum,
    ring_reduce_scatter,
)
from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (  # noqa: F401
    Pipeline,
    Stage,
    StageParams,
    fused_reference,
    param_leaves,
    param_units,
)
from simple_distributed_machine_learning_tpu_torch.parallel.sequence import (  # noqa: F401
    SeqShards,
    ulysses_attention,
)
from simple_distributed_machine_learning_tpu_torch.parallel.staging import (  # noqa: F401
    StageMeta,
    contiguous_split,
    pack_stage_params,
    unpack_stage_params,
    wire_decode,
    wire_encode,
)
from simple_distributed_machine_learning_tpu_torch.parallel.tensor import (  # noqa: F401
    Shards,
    make_mlp_tp_stages,
    tp_pair_apply,
    tp_pair_init,
)
