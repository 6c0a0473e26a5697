"""Tensor parallelism (``parallel/tensor.py``) against the JAX package's
and against the dense model, on the CPU.

- The column -> row pair: forward against JAX ``tp_pair_apply`` under
  ``shard_map`` (the green pin ``test_tp_pair_matches_dense``) and against
  the dense pair; gradients against the dense pair (the JAX pin
  ``test_tp_pair_grads_match_dense`` is red on this tree), at tp 2 and 4.
- The MLP pipeline of pairs on a ``(data, stage, model)`` mesh in one
  process: log-probs against the JAX TP pipeline (its green
  ``test_tp_pipeline_matches_dense``), and the identities behind the red
  JAX pins held against the dense model: the SGD trajectory, the full
  2 x 2 x 2 mesh, replicated stages on a model mesh, model replicas bit
  for bit.

Weights cross from the JAX builders as numpy trees (``interop``).
Tolerance: f32 ``rtol 1e-5`` (the row-parallel sums add the hidden width
in another order than one matmul).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu.parallel import (
    tensor as jtensor,
)
from simple_distributed_machine_learning_tpu.parallel.compat import (
    shard_map,
)
from simple_distributed_machine_learning_tpu.parallel.mesh import (
    make_mesh as jmake_mesh,
)
from simple_distributed_machine_learning_tpu.parallel.pipeline import (
    Pipeline as JPipeline,
)
from simple_distributed_machine_learning_tpu_torch import train as ttrain
from simple_distributed_machine_learning_tpu_torch.interop import (
    params_from_numpy,
    shards_from_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import mlp as tmlp
from simple_distributed_machine_learning_tpu_torch.parallel import (
    Pipeline,
    make_mesh,
    param_leaves,
)
from simple_distributed_machine_learning_tpu_torch.parallel import (
    tensor as ttensor,
)

F32 = dict(rtol=1e-5, atol=1e-6)
DIMS = [8, 16, 12, 16, 10]          # 2 stages x (column -> row) pair


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float32,
                        requires_grad=grad)


def _dense_of(shards):
    """The dense pair ``(w1, b1, w2, b2)`` of per-shard trees."""
    return (torch.cat([s["w1"]["w"] for s in shards], 1),
            torch.cat([s["w1"]["b"] for s in shards], 0),
            torch.cat([s["w2"]["w"] for s in shards], 0),
            shards[0]["w2"]["b"])


def _dense_pair(d, x):
    w1, b1, w2, b2 = d
    return torch.relu(x @ w1 + b1) @ w2 + b2


@pytest.mark.parametrize("mp", [2, 4])
def test_tp_pair_forward_matches_jax_and_dense(mp):
    d_in, d_h, d_out = 8, 32, 6
    jshards = jtensor.tp_pair_init(jax.random.key(0), d_in, d_h, d_out, mp)
    x = np.random.default_rng(1).standard_normal((5, d_in)).astype(
        np.float32)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:mp]), ("model",))
    f = jax.jit(shard_map(
        lambda p, xx: jtensor.tp_pair_apply(
            jax.tree.map(lambda a: a[0], p), xx, axis="model"),
        mesh=mesh, in_specs=(jax.sharding.PartitionSpec("model"),
                             jax.sharding.PartitionSpec()),
        out_specs=jax.sharding.PartitionSpec()))
    want = np.asarray(f(jtensor.stack_tp_shards(jshards), jnp.asarray(x)))
    shards = jax.tree.map(_t, jshards)
    got = ttensor.tp_pair_apply(shards, torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, **F32)
    np.testing.assert_allclose(
        got.detach().numpy(),
        _dense_pair(_dense_of(shards), torch.from_numpy(x)).numpy(), **F32)


@pytest.mark.parametrize("mp", [2, 4])
def test_tp_pair_grads_match_dense(mp):
    """Every shard's slices of the dense gradient, the replicated bias's
    full gradient on every shard, and the input's gradient."""
    d_in, d_h, d_out = 8, 16, 4
    jshards = jtensor.tp_pair_init(jax.random.key(2), d_in, d_h, d_out, mp)
    shards = jax.tree.map(lambda a: _t(a, True), jshards)
    x = np.random.default_rng(3).standard_normal((3, d_in)).astype(
        np.float32)
    xt = torch.tensor(x, requires_grad=True)
    (ttensor.tp_pair_apply(shards, xt) ** 2).sum().backward()
    dense = [t.detach().clone().requires_grad_(True)
             for t in _dense_of(shards)]
    xd = torch.tensor(x, requires_grad=True)
    (_dense_pair(dense, xd) ** 2).sum().backward()
    h = d_h // mp
    for i, s in enumerate(shards):
        np.testing.assert_allclose(s["w1"]["w"].grad,
                                   dense[0].grad[:, i * h:(i + 1) * h], **F32)
        np.testing.assert_allclose(s["w1"]["b"].grad,
                                   dense[1].grad[i * h:(i + 1) * h], **F32)
        np.testing.assert_allclose(s["w2"]["w"].grad,
                                   dense[2].grad[i * h:(i + 1) * h], **F32)
        np.testing.assert_allclose(s["w2"]["b"].grad, dense[3].grad, **F32)
    np.testing.assert_allclose(xt.grad, xd.grad, **F32)


def test_tp_pair_init_slices_one_dense_init():
    from simple_distributed_machine_learning_tpu_torch.ops.layers import (
        init_generator,
        linear_init,
    )
    shards = ttensor.tp_pair_init(7, 6, 8, 3, 4)
    gen = init_generator(7)
    w1, w2 = linear_init(gen, 6, 8), linear_init(gen, 8, 3)
    got = _dense_of(shards)
    for a, b in zip(got, (w1["w"], w1["b"], w2["w"], w2["b"])):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="not divisible"):
        ttensor.tp_pair_init(0, 6, 10, 3, 4)


def test_grad_sync_model_sum_and_tie_in_one_process():
    """In one process: grad_sync is the identity both ways (the shards
    sum their input gradients themselves), the model sum is the local
    sum, and a tie hands every copy the full gradient."""
    x = torch.randn(3, requires_grad=True)
    assert ttensor.grad_sync(x) is x
    a, b = torch.randn(3, requires_grad=True), torch.randn(3,
                                                           requires_grad=True)
    assert torch.equal(ttensor.model_sum([a, b]), a + b)
    c = torch.randn(3, requires_grad=True)
    copies = [c, c.detach().clone().requires_grad_(True)]
    (ttensor.tie(copies) * torch.arange(3.0)).sum().backward()
    for t in copies:
        assert torch.equal(t.grad, torch.arange(3.0))
    # the ring's summing backward runs across processes; here too the
    # shards add their gradients themselves
    assert ttensor.grad_sync(x, None, "ring") is x


# ---- the MLP pipeline of pairs ----------------------------------------------

def _tp_pipe(mp, n_data=1, M=2, key=0, **kw):
    """The JAX TP stages and the port's pipeline on their weights."""
    jst, wd, od = jtensor.make_mlp_tp_stages(jax.random.key(key), DIMS, 2,
                                             mp)
    tst = ttensor.make_mlp_tp_stages(0, DIMS, 2, mp, device="cpu")[0]
    tst = [dataclasses.replace(t, params=sh[0], shards=sh) for t, sh in zip(
        tst, (shards_from_numpy(jax.tree.map(np.asarray, list(s.shards)),
                                "cpu") for s in jst))]
    mesh = make_mesh(2, n_data=n_data, n_model=mp,
                     devices=["cpu"] * (2 * n_data * mp))
    return jst, Pipeline(tst, mesh, wd, od, n_microbatches=M, **kw)


def _dense_pipe(jst, M=2, n_data=1):
    """The dense MLP of the same weights, two layers a stage."""
    dims = DIMS
    tst, wd, od = tmlp.make_mlp_stages(0, dims, 2, device="cpu")
    trees = []
    for s in jst:
        sh = jax.tree.map(np.asarray, list(s.shards))
        w1 = np.concatenate([t["w1"]["w"] for t in sh], 1)
        b1 = np.concatenate([t["w1"]["b"] for t in sh], 0)
        w2 = np.concatenate([t["w2"]["w"] for t in sh], 0)
        trees.append([{"w": w1, "b": b1}, {"w": w2, "b": sh[0]["w2"]["b"]}])
    tst = [dataclasses.replace(t, params=p)
           for t, p in zip(tst, params_from_numpy(trees, "cpu"))]
    mesh = make_mesh(2, n_data=n_data, devices=["cpu"] * (2 * n_data))
    return Pipeline(tst, mesh, wd, od, n_microbatches=M)


def _batch(batch=8, seed=1):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((batch, DIMS[0])).astype(
        np.float32)), torch.from_numpy(rng.integers(0, DIMS[-1], (batch,))))


def _gathered(pipe, params):
    """Per stage, the dense ``(w1, b1, w2, b2)`` of the shards."""
    return [_dense_of([{k: dict(m[k].named_parameters()) for k in ("w1",
                                                                   "w2")}
                       for m in sh]) for sh in params]


def test_tp_mlp_pipeline_logprobs_match_jax():
    """The green JAX pin ``test_tp_pipeline_matches_dense``'s problem
    (tp 2, two stages, two microbatches) on the port: the same log-probs
    and loss."""
    jst, pipe = _tp_pipe(2)
    x, y = _batch()
    jpipe = JPipeline(jst, jmake_mesh(n_stages=2, n_data=1, n_model=2),
                      max(DIMS[::2]), DIMS[-1], n_microbatches=2)
    jl, jlogp = jpipe.loss_and_logits(jpipe.init_params(),
                                      jnp.asarray(x.numpy()),
                                      jnp.asarray(y.numpy()),
                                      jax.random.key(0), deterministic=True)
    with torch.no_grad():
        tl, tlogp = pipe.loss_and_logits(pipe.init_params(), x, y, 0,
                                         deterministic=True)
    np.testing.assert_allclose(tlogp.numpy(), np.asarray(jlogp), **F32)
    np.testing.assert_allclose(float(tl), float(jl), **F32)


@pytest.mark.parametrize("mp,n_data", [(2, 2), (4, 1)])
def test_tp_pipeline_sgd_trajectory_matches_dense(mp, n_data):
    """The identity behind the red JAX pin of the same name: SGD(momentum)
    on the data x stage x model pipeline tracks the dense model step for
    step, and the gathered shards end on the dense parameters."""
    jst, pipe = _tp_pipe(mp, n_data=n_data)
    dense = _dense_pipe(jst, n_data=n_data)
    x, y = _batch()
    opt = ttrain.sgd(0.2, momentum=0.5)
    step_t = ttrain.make_train_step(pipe, opt)
    step_d = ttrain.make_train_step(dense, opt)
    pt, pd = pipe.init_params(), dense.init_params()
    st, sd = opt.init(pt), opt.init(pd)
    lt, ld = [], []
    for i in range(10):
        pt, st, a = step_t(pt, st, x, y, i)
        pd, sd, b = step_d(pd, sd, x, y, i)
        lt.append(float(a))
        ld.append(float(b))
    np.testing.assert_allclose(lt, ld, **F32)
    assert lt[-1] < lt[0]
    for got, want in zip(_gathered(pipe, pt), pd):
        for g, w in zip(got, [p for layer in want for p in
                              (layer["w"], layer["b"])]):
            np.testing.assert_allclose(g.detach().numpy(),
                                       w.detach().numpy(), rtol=1e-5,
                                       atol=1e-5)


def test_full_3d_mesh_all_axes_active():
    """(data 2, stage 2, model 2) in one process: the mesh's shape, one
    step's loss and gradients equal to the dense model's, everything
    finite."""
    jst, pipe = _tp_pipe(2, n_data=2)
    assert pipe.mesh.shape == {"data": 2, "stage": 2, "model": 2, "seq": 1,
                               "expert": 1}
    dense = _dense_pipe(jst, n_data=2)
    x, y = _batch()
    lt, gt = pipe.loss_and_grads(pipe.init_params(), x, y, 0)
    ld, gd = dense.loss_and_grads(dense.init_params(), x, y, 0)
    np.testing.assert_allclose(float(lt), float(ld), **F32)
    assert all(torch.isfinite(g).all() for g in gt)
    norm_t = ttrain.global_grad_norm(gt, pipe.init_params())
    norm_d = ttrain.global_grad_norm(gd, dense.init_params())
    np.testing.assert_allclose(float(norm_t), float(norm_d), **F32)


def test_replicated_stages_on_model_mesh_match():
    """Stages without shards on a model mesh (the JAX pin of the same
    name): the same SGD trajectory as on a one-wide model axis, bit for
    bit (they run once per process)."""
    def run(n_model):
        st, wd, od = tmlp.make_mlp_stages(0, [16, 32, 10], 2, device="cpu")
        pipe = Pipeline(st, make_mesh(2, n_model=n_model,
                                      devices=["cpu"] * (2 * n_model)),
                        wd, od, n_microbatches=2)
        opt = ttrain.sgd(0.2, momentum=0.5)
        params = pipe.init_params()
        state, step = opt.init(params), ttrain.make_train_step(pipe, opt)
        rng = np.random.default_rng(1)
        x = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
        y = torch.from_numpy(rng.integers(0, 10, (8,)))
        out = []
        for i in range(6):
            params, state, loss = step(params, state, x, y, i)
            out.append(float(loss))
        return out

    assert run(2) == run(1)


def test_model_replicas_stay_bit_identical():
    """The replicated leaves stored per shard (each pair's output bias)
    are equal bit for bit after 5 AdamW steps with clipping."""
    _, pipe = _tp_pipe(4, n_data=1)
    x, y = _batch()
    opt = ttrain.clip_by_global_norm(ttrain.adamw(1e-2), 0.5)
    params = pipe.init_params()
    state, step = opt.init(params), ttrain.make_train_step(pipe, opt)
    for i in range(5):
        params, state, _ = step(params, state, x, y, i)
    for sh in params:
        b = [m["w2"]["b"] for m in sh]
        assert all(torch.equal(b[0], t) for t in b[1:])
    assert len(param_leaves(params)) == 2 * 4 * 4


def test_stage_shard_checks_are_the_jax_ones():
    jst, pipe = _tp_pipe(2)
    st = list(pipe.stages)
    with pytest.raises(ValueError, match="stage has 2 model shards, mesh "
                                         "model axis is 4"):
        Pipeline(st, make_mesh(2, n_model=4, devices=["cpu"] * 8))
    bad = dataclasses.replace(st[0], shards=(st[0].shards[0], st[1].shards[0]))
    with pytest.raises(ValueError, match="differing leaf shapes"):
        Pipeline([bad, st[1]], make_mesh(2, n_model=2, devices=["cpu"] * 4))
    with pytest.raises(ValueError, match="need exactly 4 layers"):
        ttensor.make_mlp_tp_stages(0, [8, 16, 10], 2, 2, device="cpu")


# ---- the preflight validator ------------------------------------------------

def _cfg(**kw):
    import types
    return types.SimpleNamespace(**kw)


@pytest.mark.parametrize("args,kw", [
    ((0, "none"), {}),
    ((3, "ring"), dict(n_devices=2)),
    ((2, "diagonal"), {}),
    ((1, "ring"), {}),
    ((4, "ring"), dict(cfg=_cfg(d_model=30, n_heads=6, mlp_ratio=4,
                                seq_len=10, attn_impl="flash",
                                n_experts=2), batch=6, n_micro=2)),
    ((2, "ring"), dict(cfg=_cfg(d_model=32, n_heads=4, seq_len=9),
                       batch=3)),
    ((2, "none"), dict(cfg=_cfg(d_model=32, n_heads=4, mlp_ratio=4,
                                seq_len=8, attn_impl="dense"), batch=8)),
])
def test_validate_tp_overlap_equals_jax(monkeypatch, args, kw):
    """The pure validator, word for word. The JAX module's other half
    imports ``abstractify``, which this tree's jax lacks, so the name is
    patched in for the import."""
    import importlib
    import sys

    from simple_distributed_machine_learning_tpu import analysis
    from simple_distributed_machine_learning_tpu_torch.analysis.preflight import (  # noqa: E501
        validate_tp_overlap,
    )
    monkeypatch.setattr(analysis, "abstractify", lambda x: x, raising=False)
    name = "simple_distributed_machine_learning_tpu.analysis.preflight"
    try:
        jpre = importlib.import_module(name)
        want = jpre.validate_tp_overlap(*args, **kw)
    finally:
        sys.modules.pop(name, None)
    assert validate_tp_overlap(*args, **kw) == want
