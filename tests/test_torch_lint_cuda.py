"""The program linter on the card: a trace launches nothing.

A traced program's kernels are graph nodes (``sdml::`` custom ops whose
fake implementations give the outputs' shapes): tracing the flash GPT's
train step and the fused paged serving programs on fake CUDA tensors
leaves every launch counter as it was and allocates nothing (the
allocator's peak across the trace is its start), while the same programs
on real tensors launch each kernel.

These tests import torch and the port only, so they run on a GPU machine
without JAX; the repo's ``tests/conftest.py`` sets JAX up, so skip it there:

    python -m pytest --noconftest -m cuda tests/test_torch_*_cuda.py

Without a card every test here skips.
"""

import gc

import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu_torch.analysis import (
    analyze,
    spec,
)
from simple_distributed_machine_learning_tpu_torch.analysis.trace import (
    abstractify,
)
from simple_distributed_machine_learning_tpu_torch.models.gpt import (
    GPTConfig,
    make_gpt_stages,
)
from simple_distributed_machine_learning_tpu_torch.ops import (
    flash_attention as fa,
)
from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (  # noqa: E501
    paged_attention,
)

CFG = dict(vocab=64, seq_len=64, d_model=64, n_heads=4, n_layers=2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels launch on the card")
    return torch.device("cuda")


def _counts():
    return (fa.flash_forward.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches, paged_attention.launches)


@pytest.mark.cuda
def test_training_trace_launches_nothing(cuda_device):
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        Pipeline,
    )
    from simple_distributed_machine_learning_tpu_torch.train import (
        adamw,
        make_train_step,
    )
    cfg = GPTConfig(**CFG, attn_impl="flash")
    stages, wd, od = make_gpt_stages(0, cfg, 1, device=cuda_device)
    pipe = Pipeline(stages, None, wd, od, compute_dtype=torch.bfloat16,
                    device=cuda_device)
    opt = adamw(1e-3)
    params = pipe.init_params()
    state = opt.init(params)
    step = make_train_step(pipe, opt)
    args = (abstractify(params), abstractify(state),
            spec((4, 64), torch.int64, 0, 63),
            spec((4, 64), torch.int64, 0, 63), 0)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before, mem = _counts(), torch.cuda.memory_allocated()
    report = analyze(step, *args)
    torch.cuda.synchronize()
    assert _counts() == before
    # nothing allocated: the allocator's peak across the trace is its start
    assert torch.cuda.max_memory_allocated() == mem
    assert report.ok(fail_on="warning"), report.format()
    # the same step on real tensors launches K1-K3, one per layer each
    x = torch.randint(0, 64, (4, 64), device=cuda_device)
    step(params, state, x, x, 0)
    torch.cuda.synchronize()
    after = _counts()
    assert [a - b for a, b in zip(after[:3], before[:3])] == [2, 2, 2]


@pytest.mark.cuda
def test_serving_lint_launches_nothing(cuda_device):
    from simple_distributed_machine_learning_tpu_torch.serve import (
        InferenceEngine,
    )
    cfg = GPTConfig(**CFG)
    stages = make_gpt_stages(0, cfg, 1, device=cuda_device)[0]
    torch.cuda.synchronize()
    k4 = paged_attention.launches
    engine = InferenceEngine(stages, cfg, n_slots=4, block_size=16,
                             attn_kernel="fused", lint=True,
                             device=cuda_device)
    torch.cuda.synchronize()
    assert paged_attention.launches == k4
    h = engine.submit(np.arange(8, dtype=np.int32), max_new_tokens=4,
                      seed=1)
    engine.drain()
    assert len(h.tokens) == 4
    assert paged_attention.launches > k4
