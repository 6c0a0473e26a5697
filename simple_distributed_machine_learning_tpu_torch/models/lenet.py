"""LeNet with the reference's conv|fc split (port of ``models/lenet.py``).

Stage 0: conv(1->10, k5) -> maxpool2 -> relu; conv(10->20, k5) ->
dropout2d -> maxpool2 -> relu -> flatten to 320. Stage 1: fc(320->50) ->
relu -> dropout -> fc(50->10) -> log_softmax. Activations are NHWC and the
flatten runs in (H, W, C) order — the JAX package's layout, not torch's
(C, H, W) — so the fc1 weights mean the same features in both packages.

``n_stages=1`` gives the fused tree ``{"conv": {...}, "fc": {...}}``, the
one-card model. Within one step the fused apply draws ``dropout2d`` and
then ``dropout`` from the one generator it is given; JAX splits its key
instead, so the two packages' masks differ by design.
"""

from __future__ import annotations

from simple_distributed_machine_learning_tpu_torch._device import (
    resolve_device,
)
from simple_distributed_machine_learning_tpu_torch._tree import to_module
from simple_distributed_machine_learning_tpu_torch.ops.layers import (
    conv2d,
    conv2d_init,
    dropout,
    dropout2d,
    init_generator,
    linear,
    linear_init,
    max_pool2d,
    relu,
)
from simple_distributed_machine_learning_tpu_torch.ops.losses import (
    log_softmax,
)
from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (
    Stage,
)

IN_SHAPE = (28, 28, 1)   # NHWC per-sample
FEATURES = 320           # 20 channels * 4 * 4 after two conv/pool blocks
N_CLASSES = 10


def _conv_apply(params, x, key=None, deterministic=True):
    h = relu(max_pool2d(conv2d(params["conv1"], x), 2))
    h = conv2d(params["conv2"], h)
    h = dropout2d(key, h, rate=0.5, deterministic=deterministic)
    h = relu(max_pool2d(h, 2))
    return h.reshape(h.shape[0], FEATURES)        # (H, W, C) order


def _fc_apply(params, x, key=None, deterministic=True):
    h = relu(linear(params["fc1"], x))
    h = dropout(key, h, rate=0.5, deterministic=deterministic)
    return log_softmax(linear(params["fc2"], h))


def _fused_apply(params, x, key=None, deterministic=True):
    h = _conv_apply(params["conv"], x, key, deterministic)
    return _fc_apply(params["fc"], h, key, deterministic)


def make_lenet_stages(seed, n_stages: int = 2, device=None
                      ) -> tuple[list[Stage], int, int]:
    """Build LeNet as pipeline stages on ``device`` (None = ``"cuda"``):
    ``n_stages=2`` (the default, as in JAX) the reference's conv|fc
    split, 1 the fused model.
    Returns ``(stages, wire_dim, out_dim)``."""
    dev = resolve_device(device)
    gen = init_generator(seed)
    conv = {"conv1": conv2d_init(gen, 1, 10, 5),
            "conv2": conv2d_init(gen, 10, 20, 5)}
    fc = {"fc1": linear_init(gen, FEATURES, 50),
          "fc2": linear_init(gen, 50, N_CLASSES)}
    wire_dim = max(28 * 28 * 1, FEATURES, N_CLASSES)
    if n_stages == 2:
        stages = [Stage(_conv_apply, to_module(conv).to(dev), IN_SHAPE),
                  Stage(_fc_apply, to_module(fc).to(dev), (FEATURES,))]
    elif n_stages == 1:
        stages = [Stage(_fused_apply,
                        to_module({"conv": conv, "fc": fc}).to(dev),
                        IN_SHAPE)]
    else:
        raise ValueError(f"LeNet supports 1 or 2 stages, got {n_stages}")
    return stages, wire_dim, N_CLASSES
