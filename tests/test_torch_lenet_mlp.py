"""The port's LeNet and MLP against the JAX package's, on one device.

The JAX side builds ``Pipeline`` on ``make_mesh(n_stages=1, n_data=1)``,
whose loss and gradients run through its fused single-device path; the
port's weights are the JAX weights carried across with
``interop.params_from_numpy``. Tolerances, each with its reason:

- fused LeNet log-probs within 2e-5: two convs, two pools and two matmuls
  in f32, summed in another order;
- the deterministic LeNet SGD trajectory (dropout off, lr 0.1, momentum
  0.5, 10 steps) within ``rel=1e-4*(i+1)+1e-5`` at step i, the budget
  ``tests/test_torch_parity.py`` gives the JAX package against raw torch:
  the f32 rounding differences compound through the trajectory;
- MLP per-step losses within 1e-5 relative: matmuls only.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu import make_mesh
from simple_distributed_machine_learning_tpu.models import lenet as jlenet
from simple_distributed_machine_learning_tpu.models import mlp as jmlp
from simple_distributed_machine_learning_tpu.parallel.pipeline import (
    Pipeline as JaxPipeline,
)
from simple_distributed_machine_learning_tpu.train import optimizer as jopt
from simple_distributed_machine_learning_tpu.train import step as jstep
from simple_distributed_machine_learning_tpu_torch import train as ttrain
from simple_distributed_machine_learning_tpu_torch._tree import (
    tree_leaves,
    to_numpy,
)
from simple_distributed_machine_learning_tpu_torch.interop import (
    params_from_numpy,
    params_to_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import lenet as tlenet
from simple_distributed_machine_learning_tpu_torch.models import mlp as tmlp
from simple_distributed_machine_learning_tpu_torch.parallel import Pipeline

N_STEPS, BATCH = 10, 16


def _carry(jstages, tstages):
    """The port's stages with the JAX stages' weights."""
    nparams = jax.tree.map(np.asarray, [s.params for s in jstages])
    return [dataclasses.replace(t, params=p) for t, p in
            zip(tstages, params_from_numpy(nparams, "cpu"))]


def _lenet_pair():
    jst, wd, od = jlenet.make_lenet_stages(jax.random.key(0), 1)
    jpipe = JaxPipeline(jst, make_mesh(n_stages=1, n_data=1), wd, od)
    tst, twd, tod = tlenet.make_lenet_stages(0, 1, device="cpu")
    assert (twd, tod) == (wd, od)
    return jst, jpipe, Pipeline(_carry(jst, tst), None, twd, tod,
                                device="cpu")


def _mlp_pair(dims):
    jst, wd, od = jmlp.make_mlp_stages(jax.random.key(0), dims, 1)
    jpipe = JaxPipeline(jst, make_mesh(n_stages=1, n_data=1), wd, od)
    tst, twd, tod = tmlp.make_mlp_stages(0, dims, 1, device="cpu")
    assert (twd, tod) == (wd, od)
    return jpipe, Pipeline(_carry(jst, tst), None, twd, tod, device="cpu")


def _images(seed, n=N_STEPS):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(size=(n, BATCH, 28, 28, 1)).astype(np.float32)
    ys = rng.integers(0, 10, size=(n, BATCH)).astype(np.int32)
    return xs, ys


@pytest.mark.parametrize("n_stages", [1, 2])
def test_lenet_trees_have_the_jax_structure_and_bounds(n_stages):
    jst = jlenet.make_lenet_stages(jax.random.key(0), n_stages)[0]
    tst = tlenet.make_lenet_stages(0, n_stages, device="cpu")[0]
    for js, ts in zip(jst, tst):
        assert ts.in_shape == js.in_shape
        jtree = jax.tree.map(lambda a: np.asarray(a).shape, js.params)
        ttree = jax.tree.map(lambda a: a.shape, to_numpy(ts.params))
        assert ttree == jtree
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                to_numpy(ts.params)):
            layer = path[-2].key
            fan_in = {"conv1": 25, "conv2": 250, "fc1": 320, "fc2": 50}[layer]
            assert np.abs(leaf).max() <= 1.0 / math.sqrt(fan_in)


@pytest.mark.parametrize("dims,n_stages", [([784, 64, 10], 1),
                                           ([784, 64, 32, 10], 2),
                                           ([20, 16, 16, 16, 10], 3)])
def test_mlp_trees_have_the_jax_split_and_bounds(dims, n_stages):
    jst, jwd, jod = jmlp.make_mlp_stages(jax.random.key(0), dims, n_stages)
    tst, twd, tod = tmlp.make_mlp_stages(0, dims, n_stages, device="cpu")
    assert (twd, tod) == (jwd, jod)
    for js, ts in zip(jst, tst):
        assert ts.in_shape == js.in_shape
        assert (jax.tree.map(lambda a: a.shape, to_numpy(ts.params))
                == jax.tree.map(lambda a: np.asarray(a).shape, js.params))
        for layer in to_numpy(ts.params):
            bound = 1.0 / math.sqrt(layer["w"].shape[0])
            assert max(np.abs(layer["w"]).max(), np.abs(layer["b"]).max()) \
                <= bound


def test_fused_lenet_log_probs_match_jax():
    jst, jpipe, tpipe = _lenet_pair()
    xs, _ = _images(1, 1)
    jlogp = jst[0].apply(jst[0].params, jnp.asarray(xs[0]), jax.random.key(0),
                         True)
    tlogp = tpipe._fused_logits(tpipe.init_params(), torch.from_numpy(xs[0]),
                                None, True)
    np.testing.assert_allclose(tlogp.detach().numpy(), np.asarray(jlogp),
                               rtol=2e-5,
                               atol=2e-5)


def _chw_flatten_conv_apply(params, x, key=None, deterministic=True):
    """A known-wrong LeNet conv stage: torch's (C, H, W) flatten order
    where the JAX layout flattens (H, W, C)."""
    h = tlenet.relu(tlenet.max_pool2d(tlenet.conv2d(params["conv1"], x), 2))
    h = tlenet.conv2d(params["conv2"], h)
    h = tlenet.relu(tlenet.max_pool2d(h, 2))
    return h.permute(0, 3, 1, 2).reshape(h.shape[0], tlenet.FEATURES)


def _lenet_trajectory(tpipe, xs, ys, conv_apply=None):
    if conv_apply is not None:
        def fused(params, x, key=None, deterministic=True):
            h = conv_apply(params["conv"], x, key, deterministic)
            return tlenet._fc_apply(params["fc"], h, key, deterministic)
        tpipe.stages[0] = dataclasses.replace(tpipe.stages[0], apply=fused)
    opt = ttrain.sgd(0.1, 0.5)
    params = tpipe.init_params()
    state = opt.init(params)
    losses = []
    for i in range(len(xs)):
        loss, grads = tpipe.loss_and_grads(params, torch.from_numpy(xs[i]),
                                           torch.from_numpy(ys[i]), None,
                                           deterministic=True)
        params, state = opt.update(grads, state, params)
        losses.append(float(loss))
    return losses


def test_deterministic_lenet_sgd_trajectory_matches_jax():
    _, jpipe, tpipe = _lenet_pair()
    xs, ys = _images(2)
    opt = jopt.sgd(0.1, 0.5)
    buf = jpipe.init_params()
    state = opt.init(buf)

    @jax.jit
    def step(buf, state, x, t):
        loss, grads = jpipe.loss_and_grads(buf, x, t, jax.random.key(0),
                                           deterministic=True)
        buf, state = opt.update(grads, state, buf)
        return buf, state, loss

    jl = []
    for i in range(N_STEPS):
        buf, state, loss = step(buf, state, xs[i], ys[i])
        jl.append(float(loss))
    tl = _lenet_trajectory(tpipe, xs, ys)
    for i, (a, b) in enumerate(zip(tl, jl)):
        assert a == pytest.approx(b, rel=1e-4 * (i + 1) + 1e-5), (i, tl, jl)
    # the negative control: a (C, H, W) flatten feeds fc1 the wrong
    # features and lands outside the same budget at once
    _, _, wpipe = _lenet_pair()
    wl = _lenet_trajectory(wpipe, xs, ys, _chw_flatten_conv_apply)
    assert any(a != pytest.approx(b, rel=1e-4 * (i + 1) + 1e-5)
               for i, (a, b) in enumerate(zip(wl, jl)))


def test_lenet_dropout_draws_from_the_step_generator():
    """Training-mode LeNet: the same generator seed draws the same
    dropout2d and dropout masks, another seed other masks; eval ignores
    the key."""
    _, _, tpipe = _lenet_pair()
    params = tpipe.init_params()
    x, y = (torch.from_numpy(a[0]) for a in _images(3, 1))
    torch.set_grad_enabled(False)
    try:
        _check_dropout_keys(tpipe, params, x, y)
    finally:
        torch.set_grad_enabled(True)


def _check_dropout_keys(tpipe, params, x, y):
    a = float(tpipe.loss(params, x, y, 7))
    assert a == float(tpipe.loss(params, x, y, 7))
    assert a != float(tpipe.loss(params, x, y, 8))
    det = float(tpipe.loss(params, x, y, None, deterministic=True))
    assert det == float(tpipe.loss(params, x, y, 9, deterministic=True))
    assert det != a


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_mlp_training_matches_jax(opt_name):
    jpipe, tpipe = _mlp_pair([784, 64, 32, 10])
    rng = np.random.default_rng(4)
    xs = rng.uniform(size=(N_STEPS, BATCH, 784)).astype(np.float32)
    ys = rng.integers(0, 10, size=(N_STEPS, BATCH)).astype(np.int32)
    jo = jopt.sgd(0.1, 0.5) if opt_name == "sgd" else jopt.adamw(1e-3)
    to = ttrain.sgd(0.1, 0.5) if opt_name == "sgd" else ttrain.adamw(1e-3)
    buf = jpipe.init_params()
    state = jo.init(buf)
    jfn = jstep.make_train_step(jpipe, jo)
    params = tpipe.init_params()
    tstate = to.init(params)
    tfn = ttrain.make_train_step(tpipe, to)
    for i in range(N_STEPS):
        buf, state, jloss = jfn(buf, state, jnp.asarray(xs[i]),
                                jnp.asarray(ys[i]), jax.random.key(i))
        params, tstate, tloss = tfn(params, tstate, torch.from_numpy(xs[i]),
                                    torch.from_numpy(ys[i]), i)
        assert float(tloss) == pytest.approx(float(jloss), rel=1e-5), i
    ref = jax.tree.leaves(jax.tree.map(np.asarray, jpipe.unpack(buf)))
    got = jax.tree.leaves(params_to_numpy(params))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_param_leaves_follow_the_jax_order_for_mlp_and_lenet():
    """The MLP's and LeNet's containers register their tensors in
    ``jax.tree.flatten`` order, so the optimizer's per-tensor order is the
    packed buffer's order too."""
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        param_leaves,
    )
    for stages in (tlenet.make_lenet_stages(0, 1, device="cpu")[0],
                   tmlp.make_mlp_stages(0, [8, 6, 4], 1, device="cpu")[0]):
        p = stages[0].params
        assert [id(t) for t in param_leaves([p])] == \
            [id(t) for t in tree_leaves(p)]


@pytest.mark.parametrize("builder", ["lenet", "mlp"])
def test_two_stage_pipeline_raises_naming_item_6(builder):
    """Two stages need a stage mesh of two; on one with a data axis they
    name item 6 (the data axis is item 6c)."""
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        make_mesh,
    )
    stages = (tlenet.make_lenet_stages(0, 2, device="cpu") if builder ==
              "lenet" else tmlp.make_mlp_stages(0, [8, 6, 4], 2,
                                                device="cpu"))[0]
    with pytest.raises(ValueError, match="2 stages but mesh stage axis"):
        Pipeline(stages, None, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="item 6, remaining parallel axes"):
        Pipeline(stages, make_mesh(2, n_data=2, devices=["cpu"] * 4))
    assert Pipeline(stages, make_mesh(2, devices=["cpu"] * 2)).n_stages == 2


@pytest.mark.parametrize("overlap", ["none", "ring", "all"])
def test_pipeline_overlap_keyword_follows_the_jax_signature(overlap):
    """``overlap`` as the JAX ``Pipeline`` takes it: ``"none"`` (its
    default) runs, ``"ring"`` names item 6, anything else is the JAX
    ``check_overlap`` error, word for word."""
    stages, wd, od = tmlp.make_mlp_stages(0, [8, 6, 4], 1, device="cpu")
    if overlap == "none":
        pipe = Pipeline(stages, None, wd, od, overlap="none", device="cpu")
        assert pipe.overlap == "none"
        return
    if overlap == "ring":
        with pytest.raises(NotImplementedError,
                           match="item 6, remaining parallel axes"):
            Pipeline(stages, None, wd, od, overlap="ring", device="cpu")
        return
    from simple_distributed_machine_learning_tpu.parallel.overlap import (
        check_overlap,
    )
    with pytest.raises(ValueError) as jax_err:
        check_overlap(overlap)
    with pytest.raises(ValueError) as port_err:
        Pipeline(stages, None, wd, od, overlap=overlap, device="cpu")
    assert str(port_err.value) == str(jax_err.value)


def test_lenet_rejects_three_stages():
    with pytest.raises(ValueError, match="1 or 2 stages"):
        tlenet.make_lenet_stages(0, 3, device="cpu")


@pytest.mark.parametrize("model", ["mlp", "lenet"])
def test_bf16_compute_matches_jax(model):
    """``compute_dtype=bfloat16`` casts the parameters and the float inputs
    of the MLP and LeNet, as the JAX package does (its ``mlp2_bf16`` row).
    Losses within 2^-8 relative, one bf16 rounding of the log-probs'
    inputs, over 3 SGD steps with dropout off."""
    if model == "mlp":
        jst, wd, od = jmlp.make_mlp_stages(jax.random.key(0), [784, 64, 10],
                                           1)
        tst = tmlp.make_mlp_stages(0, [784, 64, 10], 1, device="cpu")[0]
        xs, ys = _images(5, 3)
        xs = xs.reshape(3, BATCH, 784)
    else:
        jst, wd, od = jlenet.make_lenet_stages(jax.random.key(0), 1)
        tst = tlenet.make_lenet_stages(0, 1, device="cpu")[0]
        xs, ys = _images(5, 3)
    jpipe = JaxPipeline(jst, make_mesh(n_stages=1, n_data=1), wd, od,
                        compute_dtype=jnp.bfloat16)
    tpipe = Pipeline(_carry(jst, tst), None, wd, od,
                     compute_dtype=torch.bfloat16, device="cpu")
    jo, to = jopt.sgd(0.1, 0.5), ttrain.sgd(0.1, 0.5)
    buf = jpipe.init_params()
    state = jo.init(buf)

    @jax.jit
    def jfn(buf, state, x, t):
        loss, grads = jpipe.loss_and_grads(buf, x, t, jax.random.key(0),
                                           deterministic=True)
        return (*jo.update(grads, state, buf), loss)

    params = tpipe.init_params()
    tstate = to.init(params)
    for i in range(3):
        buf, state, jloss = jfn(buf, state, xs[i], ys[i])
        tloss, grads = tpipe.loss_and_grads(params, torch.from_numpy(xs[i]),
                                            torch.from_numpy(ys[i]),
                                            deterministic=True)
        params, tstate = to.update(grads, tstate, params)
        assert float(tloss) == pytest.approx(float(jloss), rel=2.0 ** -8), i
    assert next(params[0].parameters()).dtype == torch.float32
