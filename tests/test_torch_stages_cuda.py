"""The pipeline over several stages on the card: a flash GPT at S = 2 on
``[cuda:0, cuda:0]`` against its one-stage self, and the flash kernels'
launches per step under GPipe, 1F1B and remat.

These tests import torch and the port only, so they run on a GPU machine
without JAX; the repo's ``tests/conftest.py`` sets JAX up, so skip it there:

    python -m pytest --noconftest -m cuda tests/test_torch_*_cuda.py

Without a card every test here skips. Tolerance: f32, loss and gradients
within 1e-4 relative (cuBLAS and the flash kernels sum the microbatches'
rows in other orders than one batch's).
"""

import pytest
import torch

from simple_distributed_machine_learning_tpu_torch.models import gpt
from simple_distributed_machine_learning_tpu_torch.ops import (
    flash_attention as fa,
)
from simple_distributed_machine_learning_tpu_torch.parallel import (
    Pipeline,
    make_mesh,
)

CFG = dict(vocab=64, seq_len=64, d_model=64, n_heads=2, n_layers=4,
           attn_impl="flash", flash_block_q=64, flash_block_k=64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernels run on the card")
    return torch.device("cuda", 0)


def _pipe(dev, S, M=1, **kw):
    stages, wd, od = gpt.make_gpt_stages(0, gpt.GPTConfig(**CFG), S,
                                         device=dev)
    mesh = make_mesh(S, devices=[dev] * S) if S > 1 else None
    return Pipeline(stages, mesh, wd, od, n_microbatches=M,
                    device=dev if mesh is None else None, **kw)


def _batch(dev):
    gen = torch.Generator().manual_seed(3)
    x = torch.randint(0, 64, (8, 64), generator=gen).float()
    t = torch.randint(0, 64, (8, 64), generator=gen)
    return x.to(dev), t.to(dev)


def _flat(pipe, x, t):
    loss, grads = pipe.loss_and_grads(pipe.init_params(), x, t,
                                      deterministic=True)
    return float(loss), torch.cat([g.reshape(-1) for g in grads])


@pytest.mark.cuda
def test_two_stages_on_one_card_equal_one_stage(cuda_device):
    x, t = _batch(cuda_device)
    l1, g1 = _flat(_pipe(cuda_device, 1), x, t)
    for M, sched in ((1, "gpipe"), (4, "gpipe"), (4, "1f1b")):
        ls, gs = _flat(_pipe(cuda_device, 2, M, schedule=sched), x, t)
        assert ls == pytest.approx(l1, rel=1e-4)
        assert float((gs - g1).norm() / g1.norm()) < 1e-4, (M, sched)


@pytest.mark.cuda
@pytest.mark.parametrize("kw,k1", [
    (dict(), 1), (dict(schedule="1f1b"), 1.5), (dict(remat=True), 2)])
def test_flash_launches_per_step(cuda_device, kw, k1):
    """Per step at S = 2, M = 4 (n_layers = 4): K2 = K3 = 16, one per
    layer per microbatch; K1 16 under GPipe, 32 under remat (the
    recompute), 24 under 1F1B (the first stage's blocks recompute in the
    backward tick; the last stage keeps its one graph)."""
    pipe = _pipe(cuda_device, 2, 4, **kw)
    x, t = _batch(cuda_device)
    params = pipe.init_params()
    fa.flash_forward.launches = fa.flash_dq.launches = 0
    fa.flash_dkv.launches = 0
    pipe.loss_and_grads(params, x, t, deterministic=True)
    per = CFG["n_layers"] * 4
    assert (fa.flash_forward.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == (int(k1 * per), per, per)
