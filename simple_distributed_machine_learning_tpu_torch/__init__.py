"""simple_distributed_machine_learning_tpu_torch — the PyTorch/CUDA port.

The second package beside ``simple_distributed_machine_learning_tpu`` (the
JAX reference). Its subpackages mirror the reference's paths, so the port
of ``X`` is ``X`` under this root:

``ops``        plain tensor functions (layers, losses, dense attention) and
               the hand-written Hopper kernels (``ops/csrc``)
``models``     the GPT as ``nn.Module`` parameter trees, its training
               forward (dense or flash attention) and the serving decode
               programs (cached decoder, paged prefill/decode, beam
               search); the MLP and LeNet
``parallel``   the stage split rule, the packed stage buffer and wire
               codec, the one-card mesh, ``Stage`` and ``Pipeline``
``train``      optimizers, schedules, the train and eval steps,
               checkpoints in the JAX package's format, the ``Trainer``
``data``       MNIST (IDX files or the synthetic set) and token streams
``serve``      continuous-batching serving over the paged KV pool
``telemetry``  the metric registry the serving metrics write through
``analysis``   the serve-protocol model checker (stdlib)
``utils``      the throughput meter
``cli``        the reference's training CLI

The port imports ``torch`` and ``numpy`` only — never ``jax`` and nothing
of the JAX package — so it installs and runs on a GPU machine without JAX.
Entry points take ``device=None``, which means ``"cuda"``; without CUDA
they raise unless the caller asks for ``device="cpu"``.

Float policy: float32 products run in full float32 on the card. TF32 would
keep about three decimal digits, and greedy decoding through the paged
kernel is held token-for-token against the gather-then-dense path, which
needs full-precision logits on both sides. cuDNN (LeNet's convs) picks
deterministic algorithms only, so a run resumed from a checkpoint equals
the uninterrupted one on the card as on the CPU.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False

__version__ = "0.1.0"
