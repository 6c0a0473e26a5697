"""Checkpoints that cross between the packages: the port writes and reads
the JAX package's ``state.npz`` format.

The pack order must be ``jax.tree.flatten``'s (dict keys sorted, lists by
index), not ``nn.Module`` registration order: the GPT's ``Linear``
registers ``w`` before ``b`` and its ``Block`` ``ln1, attn, ...``, and a
LayerNorm's ``scale`` and ``bias`` share a shape, so a wrong order swaps
them with no error. The trees here carry random values in every leaf, so
any swap shows.

Tolerances: a run resumed in the other package continues within 1e-5
relative per-step loss of the writer's own continuation (the same f32
arithmetic summed in another order); parameters within 1e-5 (SGD) and 1e-4
(AdamW, which divides by each entry's own running RMS).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu import make_mesh
from simple_distributed_machine_learning_tpu.models import gpt as jgpt
from simple_distributed_machine_learning_tpu.models import lenet as jlenet
from simple_distributed_machine_learning_tpu.models import mlp as jmlp
from simple_distributed_machine_learning_tpu.parallel import staging as jstaging
from simple_distributed_machine_learning_tpu.parallel.pipeline import (
    Pipeline as JaxPipeline,
)
from simple_distributed_machine_learning_tpu.train import checkpoint as jck
from simple_distributed_machine_learning_tpu.train import optimizer as jopt
from simple_distributed_machine_learning_tpu.train import schedules as jsched
from simple_distributed_machine_learning_tpu.train import step as jstep
from simple_distributed_machine_learning_tpu_torch import train as ttrain
from simple_distributed_machine_learning_tpu_torch.interop import (
    params_from_numpy,
    params_to_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.models import lenet as tlenet
from simple_distributed_machine_learning_tpu_torch.models import mlp as tmlp
from simple_distributed_machine_learning_tpu_torch.parallel import (
    Pipeline,
    staging as tstaging,
)
from simple_distributed_machine_learning_tpu_torch.train import (
    checkpoint as tck,
)
from simple_distributed_machine_learning_tpu_torch.train import (
    schedules as tsched,
)

DIMS = [24, 16, 12, 10]
BATCH, N_STEPS = 8, 3


def _randomised(tree, seed):
    """``tree`` (JAX arrays) with every leaf replaced by distinct random
    numpy values."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: rng.normal(size=np.shape(a)).astype(np.float32), tree)


def _model_trees(name):
    """Per-stage numpy trees of one model, randomised, and the port's
    stages (for their apply functions and shapes)."""
    if name == "mlp":
        jst = jmlp.make_mlp_stages(jax.random.key(0), DIMS, 1)[0]
        tst = tmlp.make_mlp_stages(0, DIMS, 1, device="cpu")[0]
    elif name == "lenet":
        jst = jlenet.make_lenet_stages(jax.random.key(0), 1)[0]
        tst = tlenet.make_lenet_stages(0, 1, device="cpu")[0]
    else:
        cfg = dict(vocab=32, seq_len=8, d_model=16, n_heads=2, n_layers=2)
        jst = jgpt.make_gpt_stages(jax.random.key(0), jgpt.GPTConfig(**cfg),
                                   1)[0]
        tst = tgpt.make_gpt_stages(0, tgpt.GPTConfig(**cfg), 1,
                                   device="cpu")[0]
    trees = [_randomised(s.params, i) for i, s in enumerate(jst)]
    return trees, tst


@pytest.mark.parametrize("name", ["mlp", "lenet", "gpt"])
def test_pack_order_is_jax_tree_flatten(name):
    trees, _ = _model_trees(name)
    modules = params_from_numpy(trees, "cpu")
    jbuf, jmetas = jstaging.pack_stage_params(trees)
    tbuf, tmetas = tstaging.pack_stage_params(modules)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    for tm, jm in zip(tmetas, jmetas):
        assert (tm.shapes, tm.sizes, tm.total) == (jm.shapes, jm.sizes,
                                                   jm.total)
    # the plain numpy trees pack the same way, and a row unpacks to them
    np.testing.assert_array_equal(
        tstaging.pack_stage_params(trees)[0].numpy(), tbuf.numpy())
    back = tstaging.unpack_stage_params(tbuf[0], tmetas[0])
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, back)),
                    jax.tree.leaves(trees[0])):
        np.testing.assert_array_equal(a, b)


def test_gpt_layer_norm_scale_and_bias_survive_the_crossing(tmp_path):
    """A port-written GPT checkpoint restores in the JAX package with every
    leaf in place, LayerNorm scale and bias included."""
    trees, tst = _model_trees("gpt")
    jst = jgpt.make_gpt_stages(jax.random.key(0), jgpt.GPTConfig(
        vocab=32, seq_len=8, d_model=16, n_heads=2, n_layers=2), 1)[0]
    modules = params_from_numpy(trees, "cpu")
    ln = modules[0]["blocks"][0]["ln1"]
    assert not torch.equal(ln["scale"], ln["bias"])
    path = str(tmp_path / "gpt.npz")
    tck.save_checkpoint(path, modules, (), step=0)
    jpipe = JaxPipeline(jst, make_mesh(n_stages=1, n_data=1), 16, (8, 32))
    ck = jck.restore_checkpoint(path, pipe=jpipe)
    got = jax.tree.map(np.asarray, jpipe.unpack(ck["params"]))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(trees)):
        np.testing.assert_array_equal(a, b)
    # and back: the JAX-written file restores into the port's modules
    jpath = str(tmp_path / "jgpt.npz")
    jck.save_checkpoint(jpath, ck["params"], (), step=0)
    tpipe = Pipeline([dataclasses.replace(tst[0], params=modules[0])], None,
                     device="cpu")
    restored = tck.restore_checkpoint(jpath, pipe=tpipe)["params"]
    for a, b in zip(jax.tree.leaves(params_to_numpy(restored)),
                    jax.tree.leaves(trees)):
        np.testing.assert_array_equal(a, b)


# -- resume across the packages ----------------------------------------------

def _opts(name):
    """(JAX optimizer, port optimizer) of one kind, built alike."""
    if name == "sgd_momentum":
        return jopt.sgd(0.1, 0.5), ttrain.sgd(0.1, 0.5)
    if name == "sgd_scheduled":
        return (jopt.sgd(jsched.step_decay(0.1, 2, 0.5)),
                ttrain.sgd(tsched.step_decay(0.1, 2, 0.5)))
    return (jopt.adamw(jsched.warmup_cosine(1e-2, 2, 6)),
            ttrain.adamw(tsched.warmup_cosine(1e-2, 2, 6)))


def _pipes(n_stages_jax=1):
    jst, wd, od = jmlp.make_mlp_stages(jax.random.key(0), DIMS, n_stages_jax)
    jpipe = JaxPipeline(jst, make_mesh(n_stages=n_stages_jax, n_data=1), wd,
                        od)
    j1 = jmlp.make_mlp_stages(jax.random.key(0), DIMS, 1)[0]
    tst = tmlp.make_mlp_stages(0, DIMS, 1, device="cpu")[0]
    nparams = jax.tree.map(np.asarray, [s.params for s in j1])
    tst = [dataclasses.replace(tst[0],
                               params=params_from_numpy(nparams, "cpu")[0])]
    return jpipe, Pipeline(tst, None, wd, od, device="cpu")


def _batches():
    rng = np.random.default_rng(7)
    xs = rng.normal(size=(2 * N_STEPS, BATCH, DIMS[0])).astype(np.float32)
    ys = rng.integers(0, 10, size=(2 * N_STEPS, BATCH)).astype(np.int32)
    return xs, ys


def _jax_steps(jpipe, jo, buf, state, xs, ys, steps):
    fn = jstep.make_train_step(jpipe, jo)
    losses = []
    for i in steps:
        buf, state, loss = fn(buf, state, jnp.asarray(xs[i]),
                              jnp.asarray(ys[i]), jax.random.key(i))
        losses.append(float(loss))
    return buf, state, losses


def _port_steps(tpipe, to, params, state, xs, ys, steps):
    fn = ttrain.make_train_step(tpipe, to)
    losses = []
    for i in steps:
        params, state, loss = fn(params, state, torch.from_numpy(xs[i]),
                                 torch.from_numpy(ys[i]), i)
        losses.append(float(loss))
    return params, state, losses


def _compare(jpipe, buf, params, jl, tl, opt_name):
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    ref = jax.tree.leaves(jax.tree.map(np.asarray, jpipe.unpack(buf)))
    got = jax.tree.leaves(params_to_numpy(params))
    atol = 1e-4 if opt_name == "adamw_scheduled" else 1e-5
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol)


OPT_LEAVES = {"sgd_momentum": 1, "sgd_scheduled": 1, "adamw_scheduled": 3}


@pytest.mark.parametrize("opt_name", list(OPT_LEAVES))
def test_jax_checkpoint_resumes_in_the_port(tmp_path, opt_name):
    jpipe, tpipe = _pipes()
    jo, to = _opts(opt_name)
    xs, ys = _batches()
    buf = jpipe.init_params()
    buf, state, _ = _jax_steps(jpipe, jo, buf, jo.init(buf), xs, ys,
                               range(N_STEPS))
    path = str(tmp_path / "state.npz")
    jck.save_checkpoint(path, buf, state, N_STEPS, extra={"epoch": 1})
    buf, state, jl = _jax_steps(jpipe, jo, buf, state, xs, ys,
                                range(N_STEPS, 2 * N_STEPS))
    ck = tck.restore_checkpoint(path, pipe=tpipe,
                                opt_treedef_like=to.init(tpipe.init_params()))
    assert ck["step"] == N_STEPS and ck["extra"] == {"epoch": 1}
    params, tstate, tl = _port_steps(tpipe, to, ck["params"],
                                     ck["opt_state"], xs, ys,
                                     range(N_STEPS, 2 * N_STEPS))
    _compare(jpipe, buf, params, jl, tl, opt_name)


@pytest.mark.parametrize("opt_name", list(OPT_LEAVES))
def test_port_checkpoint_resumes_in_jax(tmp_path, opt_name):
    jpipe, tpipe = _pipes()
    jo, to = _opts(opt_name)
    xs, ys = _batches()
    params = tpipe.init_params()
    params, state, _ = _port_steps(tpipe, to, params, to.init(params), xs,
                                   ys, range(N_STEPS))
    path = str(tmp_path / "state.npz")
    tck.save_checkpoint(path, params, state, N_STEPS, extra={"epoch": 1})
    with np.load(path) as z:
        assert sorted(z.files) == sorted(
            ["params", "_meta_json"]
            + [f"opt_{i}" for i in range(OPT_LEAVES[opt_name])])
        assert z["params"].shape == (1, 1, 1, jpipe._buf0.shape[-1])
    params, state, tl = _port_steps(tpipe, to, params, state, xs, ys,
                                    range(N_STEPS, 2 * N_STEPS))
    ck = jck.restore_checkpoint(path, pipe=jpipe,
                                opt_treedef_like=jo.init(jpipe.init_params()))
    assert ck["step"] == N_STEPS
    buf, _, jl = _jax_steps(jpipe, jo, ck["params"], ck["opt_state"], xs, ys,
                            range(N_STEPS, 2 * N_STEPS))
    _compare(jpipe, buf, params, jl, tl, opt_name)


def test_sgd_without_momentum_writes_no_optimizer_leaf(tmp_path):
    _, tpipe = _pipes()
    opt = ttrain.sgd(0.1)
    params = tpipe.init_params()
    path = str(tmp_path / "s.npz")
    tck.save_checkpoint(path, params, opt.init(params), 5)
    ck = tck.restore_checkpoint(path, pipe=tpipe,
                                opt_treedef_like=opt.init(params))
    assert ck["opt_state"] == () and ck["step"] == 5
    with np.load(path) as z:
        assert not [k for k in z.files if k.startswith("opt_")]


def test_two_stage_jax_checkpoint_repacks_onto_the_port(tmp_path):
    """Train on two stages in the JAX package, continue on one card in the
    port: the port re-splits the packed params and momentum by the 2-stage
    trees' metas alone, and continues as the JAX package's own 2 -> 1
    repack does."""
    jpipe2, tpipe = _pipes(n_stages_jax=2)
    jo, to = _opts("sgd_momentum")
    xs, ys = _batches()
    buf = jpipe2.init_params()
    buf, state, _ = _jax_steps(jpipe2, jo, buf, jo.init(buf), xs, ys,
                               range(N_STEPS))
    path = str(tmp_path / "state.npz")
    jck.save_checkpoint(path, buf, state, N_STEPS)
    src = [tstaging.stage_meta(s.params) for s in
           tmlp.make_mlp_stages(0, DIMS, 2, device="cpu")[0]]
    ck = tck.restore_checkpoint(path, pipe=tpipe,
                                opt_treedef_like=to.init(tpipe.init_params()),
                                src_pipe=src)
    params, _, tl = _port_steps(tpipe, to, ck["params"], ck["opt_state"], xs,
                                ys, range(N_STEPS, 2 * N_STEPS))
    jpipe1, _ = _pipes()
    jck1 = jck.restore_checkpoint(path, pipe=jpipe1,
                                  opt_treedef_like=jo.init(
                                      jpipe1.init_params()),
                                  src_pipe=jpipe2)
    buf1, _, jl = _jax_steps(jpipe1, jo, jck1["params"], jck1["opt_state"],
                             xs, ys, range(N_STEPS, 2 * N_STEPS))
    _compare(jpipe1, buf1, params, jl, tl, "sgd_momentum")
    # the file-to-file repack gives the same 1-stage checkpoint as the JAX
    # package's repack_checkpoint
    out, jout = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    tck.repack_checkpoint(path, out, src, tpipe)
    jck.repack_checkpoint(path, jout, jpipe2, jpipe1)
    with np.load(out) as a, np.load(jout) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_repack_stage_trees_matches_jax_and_rejects_lenet():
    trees, _ = _model_trees("gpt")
    ours = tck.repack_stage_trees(trees, 2)
    ref = jck.repack_stage_trees(trees, 2)
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    lenet2 = [s.params for s in jlenet.make_lenet_stages(jax.random.key(0),
                                                         2)[0]]
    with pytest.raises(ValueError, match="cannot be re-packed"):
        tck.repack_stage_trees(jax.tree.map(np.asarray, lenet2), 1)


def _saved(tmp_path):
    _, tpipe = _pipes()
    opt = ttrain.sgd(0.1, 0.5)
    params = tpipe.init_params()
    path = str(tmp_path / "state.npz")
    tck.save_checkpoint(path, params, opt.init(params), 1)
    return tpipe, opt, params, path


def test_truncated_checkpoint_raises_corrupt_error(tmp_path):
    tpipe, opt, params, path = _saved(tmp_path)
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])
    with pytest.raises(tck.CheckpointCorruptError, match="truncated"):
        tck.restore_checkpoint(path, pipe=tpipe)
    # an npz that is not a training checkpoint names the missing array
    np.savez(path, params=np.zeros((1, 1, 1, 3), np.float32),
             _meta_json=np.frombuffer(b'{"step": 0, "n_opt_leaves": 1, '
                                      b'"extra": {}}', np.uint8))
    with pytest.raises(tck.CheckpointCorruptError, match="opt_0"):
        tck.restore_checkpoint(path)


def test_wrong_shape_raises_value_error(tmp_path):
    _, _, _, path = _saved(tmp_path)
    other = Pipeline(tmlp.make_mlp_stages(0, [24, 8, 10], 1, device="cpu")[0],
                     None, device="cpu")
    with pytest.raises(ValueError, match="does not match the model"):
        tck.restore_checkpoint(path, pipe=other)
    tpipe, opt, params, _ = _saved(tmp_path)
    with pytest.raises(ValueError, match="optimizer leaves"):
        tck.restore_checkpoint(path, pipe=tpipe,
                               opt_treedef_like=ttrain.adamw(1e-3).init(
                                   params))


def test_async_save_round_trips_bit_exact(tmp_path):
    tpipe, opt, params, _ = _saved(tmp_path)
    state = opt.init(params)
    xs, ys = _batches()
    params, state, _ = _port_steps(tpipe, opt, params, state, xs, ys,
                                   range(2))
    path = str(tmp_path / "async.npz")
    handle = tck.save_checkpoint_async(path, params, state, 2,
                                       extra={"epoch": 3})
    # the gather happened before the call returned: training may go on
    params2, _, _ = _port_steps(tpipe, opt, params, state, xs, ys, range(2, 3))
    handle.wait()
    assert handle.done and os.path.exists(path + ".meta.json")
    ck = tck.restore_checkpoint(path, pipe=tpipe,
                                opt_treedef_like=opt.init(params))
    assert ck["extra"] == {"epoch": 3} and ck["step"] == 2
    with np.load(path) as z:
        assert z["params"].dtype == np.float32
    # the restored tensors are the ones saved, not the later in-place update
    assert not all(torch.equal(a, b) for a, b in zip(
        ck["params"][0].parameters(), params2[0].parameters()))


def test_async_save_surfaces_a_write_error(tmp_path):
    tpipe, opt, params, _ = _saved(tmp_path)
    blocker = tmp_path / "file"
    blocker.write_text("x")
    handle = tck.save_checkpoint_async(str(blocker / "state.npz"), params,
                                       opt.init(params), 0)
    with pytest.raises(OSError):
        handle.wait()


@pytest.mark.parametrize("shape,wire_dim", [((4, 28, 28, 1), 784),
                                            ((4, 320), 784), ((3, 10), 10)])
def test_wire_codec_matches_jax(shape, wire_dim):
    x = np.random.default_rng(8).normal(size=shape).astype(np.float32)
    wire = tstaging.wire_encode(torch.from_numpy(x), wire_dim)
    np.testing.assert_array_equal(
        wire.numpy(), np.asarray(jstaging.wire_encode(jnp.asarray(x),
                                                      wire_dim)))
    np.testing.assert_array_equal(
        tstaging.wire_decode(wire, shape[1:]).numpy(), x)
    with pytest.raises(ValueError, match="exceeds wire_dim"):
        tstaging.wire_encode(torch.from_numpy(x), int(np.prod(shape[1:])) - 1)
