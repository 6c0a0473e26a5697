"""Tensor parallelism on the card: the GPT at ``n_tensor_parallel`` 2 and
4 on ``[cuda:0] * M`` against its tp = 1 self, f32 and bf16, with the
flash kernels out of the path (tensor parallelism shards attention by
head and runs the dense core on each shard's heads, as the JAX package
does).

These tests import torch and the port only, so they run on a GPU machine
without JAX; the repo's ``tests/conftest.py`` sets JAX up, so skip it there:

    python -m pytest --noconftest -m cuda tests/test_torch_*_cuda.py

Without a card every test here skips. Tolerance: f32 loss within 1e-5
relative and gradients within 1e-4 (the row-parallel sums add the hidden
width in another order than one cuBLAS product); bf16 losses within 2e-2
over 5 AdamW steps.
"""

import pytest
import torch

from simple_distributed_machine_learning_tpu_torch import train
from simple_distributed_machine_learning_tpu_torch.models import gpt
from simple_distributed_machine_learning_tpu_torch.ops import (
    flash_attention as fa,
)
from simple_distributed_machine_learning_tpu_torch.parallel import (
    Pipeline,
    make_mesh,
)

CFG = dict(vocab=64, seq_len=64, d_model=64, n_heads=4, n_layers=4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the model runs on the card")
    return torch.device("cuda", 0)


def _pipe(dev, tp, S=1, dtype=None):
    stages, wd, od = gpt.make_gpt_stages(
        0, gpt.GPTConfig(**CFG, n_tensor_parallel=tp), S, device=dev)
    mesh = (make_mesh(S, n_model=tp, devices=[dev] * (S * tp))
            if tp > 1 or S > 1 else None)
    return Pipeline(stages, mesh, wd, od, n_microbatches=2 if S > 1 else 1,
                    compute_dtype=dtype,
                    device=dev if mesh is None else None)


def _batch(dev):
    gen = torch.Generator().manual_seed(3)
    x = torch.randint(0, 64, (8, 64), generator=gen).float()
    t = torch.randint(0, 64, (8, 64), generator=gen)
    return x.to(dev), t.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("tp,S", [(2, 1), (4, 1), (2, 2)])
def test_tp_on_one_card_equals_tp1(cuda_device, tp, S):
    x, t = _batch(cuda_device)
    one = _pipe(cuda_device, 1, S)
    l1, g1 = one.loss_and_grads(one.init_params(), x, t, deterministic=True)
    pipe = _pipe(cuda_device, tp, S)
    params = pipe.init_params()
    fa.flash_forward.launches = 0
    lt, gt = pipe.loss_and_grads(params, x, t, deterministic=True)
    assert fa.flash_forward.launches == 0
    assert float(lt) == pytest.approx(float(l1), rel=1e-5)
    n1 = train.global_grad_norm(g1, one.init_params())
    nt = train.global_grad_norm(gt, params)
    assert float(nt) == pytest.approx(float(n1), rel=1e-4)


@pytest.mark.cuda
def test_bf16_tp2_trains_like_tp1(cuda_device):
    x, t = _batch(cuda_device)
    out = []
    for tp in (1, 2):
        pipe = _pipe(cuda_device, tp, dtype=torch.bfloat16)
        opt = train.adamw(1e-3)
        params = pipe.init_params()
        state, step = opt.init(params), train.make_train_step(pipe, opt)
        losses = []
        for i in range(5):
            params, state, loss = step(params, state, x, t, i)
            losses.append(float(loss))
        out.append(losses)
    assert out[1] == pytest.approx(out[0], rel=2e-2)
    assert out[1][-1] < out[1][0]
