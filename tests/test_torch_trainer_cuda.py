"""The reference's main path on the card: LeNet's deterministic SGD
trajectory against the port's CPU path, and a resumed Trainer run equal to
the uninterrupted one, bit for bit.

These tests import torch and the port only, so they run on a GPU machine
without JAX; the repo's ``tests/conftest.py`` sets JAX up, so skip it there:

    python -m pytest --noconftest -m cuda tests/test_torch_*_cuda.py

Without a card every test here skips. The trajectory tolerance is
``rel=1e-4*(i+1)+1e-5`` at step i, the budget ``tests/test_torch_parity.py``
gives the JAX package against raw torch: cuDNN and cuBLAS sum in other
orders than the CPU, and the differences compound through SGD.
"""

import dataclasses

import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu_torch.data.mnist import (
    Dataset,
    batches,
    synthetic_mnist,
)
from simple_distributed_machine_learning_tpu_torch.models import lenet
from simple_distributed_machine_learning_tpu_torch.models import mlp
from simple_distributed_machine_learning_tpu_torch.parallel import Pipeline
from simple_distributed_machine_learning_tpu_torch.train import (
    TrainConfig,
    Trainer,
    sgd,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: this is the card's training path")
    return torch.device("cuda")


def _lenet_losses(device, feed, conv_apply=None):
    stages, wire_dim, out_dim = lenet.make_lenet_stages(0, 1, device)
    if conv_apply is not None:
        def fused(params, x, key=None, deterministic=True):
            h = conv_apply(params["conv"], x, key, deterministic)
            return lenet._fc_apply(params["fc"], h, key, deterministic)
        stages = [dataclasses.replace(stages[0], apply=fused)]
    pipe = Pipeline(stages, None, wire_dim, out_dim, device=device)
    opt = sgd(0.1, 0.5)
    params = pipe.init_params()
    state = opt.init(params)
    losses = []
    for b in feed:
        loss, grads = pipe.loss_and_grads(params, b.x, b.y,
                                          deterministic=True)
        params, state = opt.update(grads, state, params)
        losses.append(float(loss))
    return losses


def _chw_conv_apply(params, x, key=None, deterministic=True):
    """A known-wrong conv stage: the (C, H, W) flatten of torch's layout."""
    h = lenet.relu(lenet.max_pool2d(lenet.conv2d(params["conv1"], x), 2))
    h = lenet.relu(lenet.max_pool2d(lenet.conv2d(params["conv2"], h), 2))
    return h.permute(0, 3, 1, 2).reshape(h.shape[0], lenet.FEATURES)


@pytest.mark.cuda
def test_lenet_card_trajectory_matches_the_cpu_path(cuda_device):
    feed = list(batches(synthetic_mnist(1200, 10)[0], 60))
    cpu = _lenet_losses("cpu", feed)
    card = _lenet_losses(cuda_device, feed)
    for i, (a, b) in enumerate(zip(card, cpu)):
        assert a == pytest.approx(b, rel=1e-4 * (i + 1) + 1e-5), (i, card,
                                                                   cpu)
    wrong = _lenet_losses(cuda_device, feed, _chw_conv_apply)
    assert any(a != pytest.approx(b, rel=1e-4 * (i + 1) + 1e-5)
               for i, (a, b) in enumerate(zip(wrong, cpu)))


def _trainer(model, device, ckpt, epochs):
    train, test = synthetic_mnist(600, 120, seed=1)
    if model == "mlp":
        stages, wd, od = mlp.make_mlp_stages(0, [784, 512, 10], 1, device)
        train = Dataset(train.x.reshape(len(train.x), -1), train.y)
        test = Dataset(test.x.reshape(len(test.x), -1), test.y)
    else:
        stages, wd, od = lenet.make_lenet_stages(0, 1, device)
    return Trainer(Pipeline(stages, None, wd, od, device=device), train,
                   test, TrainConfig(epochs=epochs, checkpoint_dir=ckpt,
                                     print_throughput=False))


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["mlp", "lenet"])
def test_resume_is_bit_exact_on_the_card(cuda_device, tmp_path, model):
    straight = _trainer(model, cuda_device, None, 2)
    straight.fit()
    _trainer(model, cuda_device, str(tmp_path), 1).fit()
    resumed = _trainer(model, cuda_device, str(tmp_path), 2)
    assert resumed.start_epoch == 2
    resumed.fit()
    for a, b in zip(resumed.params[0].parameters(),
                    straight.params[0].parameters()):
        assert a.is_cuda and torch.equal(a, b)
    for a, b in zip(resumed.opt_state, straight.opt_state):
        assert torch.equal(a, b)
    assert np.isfinite(straight.evaluate()[0])


@pytest.mark.cuda
def test_gather_of_bad_token_ids_on_the_card_equals_the_cpu(cuda_device):
    """NaN, overflowed and out-of-range float token ids reach no CUDA
    gather out of range (no device-side assert): the card's lookup and
    table gradient equal the CPU's, and the card keeps working."""
    from simple_distributed_machine_learning_tpu_torch.ops import layers
    wire = torch.tensor([1.0, float("nan"), 3e30, -1e30, 6.0, -1.0, -7.0,
                         2.7, 5.0])
    table = torch.randn(6, 4, generator=torch.Generator().manual_seed(0))
    ct = torch.randn(9, 4, generator=torch.Generator().manual_seed(1))
    outs = []
    for dev in ("cpu", cuda_device):
        t = table.detach().clone().to(dev).requires_grad_(True)
        out = layers.embedding_lookup(t, layers.token_ids(wire.to(dev)))
        out.backward(ct.to(dev))
        outs.append((out.detach().cpu(), t.grad.cpu()))
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(outs[0][0]), torch.isnan(outs[1][0]))
    assert torch.equal(torch.nan_to_num(outs[0][0]),
                       torch.nan_to_num(outs[1][0]))
    assert torch.equal(outs[0][1], outs[1][1])
    assert (torch.ones(2, device=cuda_device) * 2).sum().item() == 4.0
