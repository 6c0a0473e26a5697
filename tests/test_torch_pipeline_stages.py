"""The port's ``Pipeline`` over several stages against the JAX package's
``Pipeline(make_mesh(n_stages=S, n_data=1))`` from the same weights.

The JAX side runs on ``tests/conftest.py``'s 8 virtual CPU devices, one
stage each; the port runs every stage on the CPU
(``make_mesh(S, devices=["cpu"] * S)``), its flash kernels through their
plain versions. Weights cross as numpy trees (``interop``); the port's
gradients are packed into the JAX ``[S, 1, 1, P]`` buffer to compare.
Each JAX program is compiled once per module (``_jax_fn``).

Tolerances: f32 loss and gradients within ``rtol 1e-5, atol 1e-6`` (the
same f32 arithmetic, summed over microbatches in another order); remat
against no remat within JAX's ``rtol 1e-6, atol 1e-7``
(``tests/test_mixed_precision.py``); a 5-step SGD trajectory within 1e-5
relative per-step loss and 1e-5 per parameter.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu import make_mesh as jmake_mesh
from simple_distributed_machine_learning_tpu.models import gpt as jgpt
from simple_distributed_machine_learning_tpu.models import lenet as jlenet
from simple_distributed_machine_learning_tpu.models import mlp as jmlp
from simple_distributed_machine_learning_tpu.parallel.pipeline import (
    Pipeline as JPipeline,
)
from simple_distributed_machine_learning_tpu.train import checkpoint as jck
from simple_distributed_machine_learning_tpu.train import optimizer as jopt
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
    Mesh,
    Pipeline,
    fused_reference,
    make_mesh,
    param_leaves,
)
from simple_distributed_machine_learning_tpu_torch.train import (
    checkpoint as tck,
)

MLP_DIMS = [16, 32, 32, 32, 10]
GPT = dict(vocab=32, seq_len=16, d_model=32, n_heads=2, n_layers=4)
BATCH = 8
F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread while this module runs: its models are
    tiny, and under a multi-process test run more threads only contend
    for the same cores. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _builders(model, attn="dense", **cfg_kw):
    """``(jax_builder(S), port_builder(S))`` of one model."""
    if model == "mlp":
        return (lambda S: jmlp.make_mlp_stages(jax.random.key(0), MLP_DIMS,
                                               S),
                lambda S: tmlp.make_mlp_stages(0, MLP_DIMS, S, device="cpu"))
    if model == "lenet":
        return (lambda S: jlenet.make_lenet_stages(jax.random.key(0), S),
                lambda S: tlenet.make_lenet_stages(0, S, device="cpu"))
    kw = {**GPT, "attn_impl": attn, "flash_block_q": 8, "flash_block_k": 8,
          **cfg_kw}
    return (lambda S: jgpt.make_gpt_stages(jax.random.key(0),
                                           jgpt.GPTConfig(**kw), S),
            lambda S: tgpt.make_gpt_stages(0, tgpt.GPTConfig(**kw), S,
                                           device="cpu"))


def _pair(model, S, M, schedule="gpipe", remat=False, attn="dense",
          **cfg_kw):
    """The JAX pipeline and the port's on its weights: ``(jpipe, tpipe)``."""
    jb, tb = _builders(model, attn, **cfg_kw)
    jst, wd, od = jb(S)
    jpipe = JPipeline(jst, jmake_mesh(n_stages=S, n_data=1,
                                      devices=jax.devices()[:S]), wd, od,
                      n_microbatches=M, schedule=schedule)
    tst, twd, tod = tb(S)
    nparams = jax.tree.map(np.asarray, [s.params for s in jst])
    tst = [dataclasses.replace(s, params=p)
           for s, p in zip(tst, params_from_numpy(nparams, "cpu"))]
    mesh = make_mesh(S, devices=["cpu"] * S) if S > 1 else None
    tpipe = Pipeline(tst, mesh, twd, tod, n_microbatches=M,
                     schedule=schedule, remat=remat,
                     device="cpu" if mesh is None else None)
    return jpipe, tpipe


def _batch(model, seed=0, batch=BATCH):
    rng = np.random.default_rng(seed)
    if model == "mlp":
        x = rng.standard_normal((batch, MLP_DIMS[0])).astype(np.float32)
        t = rng.integers(0, 10, (batch,)).astype(np.int32)
    elif model == "lenet":
        x = rng.standard_normal((batch, 28, 28, 1)).astype(np.float32)
        t = rng.integers(0, 10, (batch,)).astype(np.int32)
    else:
        x = rng.integers(0, GPT["vocab"], (batch, GPT["seq_len"])).astype(
            np.float32)
        t = rng.integers(0, GPT["vocab"], (batch, GPT["seq_len"])).astype(
            np.int32)
    return x, t


_JAX_FNS: dict = {}


def _jax_fn(key, jpipe, kind):
    """A jitted JAX function, compiled once per module for ``key``."""
    if key not in _JAX_FNS:
        if kind == "grads":
            fn = jax.jit(lambda b, x, t, w: jpipe.loss_and_grads(
                b, x, t, jax.random.key(0), True, w))
        else:
            fn = jax.jit(lambda b, x, t, w: jpipe.eval_metrics(
                b, x, t, jax.random.key(0), w))
        _JAX_FNS[key] = (jpipe, fn)
    return _JAX_FNS[key]


def _port_grads(tpipe, x, t, w=None, key=None, deterministic=True):
    params = tpipe.init_params()
    loss, grads = tpipe.loss_and_grads(
        params, torch.from_numpy(x), torch.from_numpy(t), key,
        deterministic, None if w is None else torch.from_numpy(w))
    width = max(m.total for m in tpipe.metas)
    return float(loss), tck._pack(grads, tck._jax_order(params), width)


def _jax_grads(model, S, M, x, t, w=None):
    key = (model, S, M, "grads")
    jpipe = _JAX_FNS[key][0] if key in _JAX_FNS else _pair(model, S, M)[0]
    jpipe, fn = _jax_fn(key, jpipe, "grads")
    w = np.ones((x.shape[0],), np.float32) if w is None else w
    loss, g = fn(jpipe.init_params(), jnp.asarray(x), jnp.asarray(t),
                 jnp.asarray(w))
    return float(loss), np.asarray(g)


CASES = ([("mlp", S, M) for S in (2, 4) for M in (1, 2, 4)]
         + [("gpt", 2, 1), ("gpt", 2, 4), ("gpt", 4, 2)])


@pytest.mark.parametrize("model,S,M", CASES,
                         ids=[f"{m}-S{s}-M{n}" for m, s, n in CASES])
def test_loss_and_grads_match_jax(model, S, M):
    x, t = _batch(model)
    jl, jg = _jax_grads(model, S, M, x, t)
    tl, tg = _port_grads(_pair(model, S, M)[1], x, t)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tg.shape == jg.shape == (S, 1, 1, jg.shape[-1])
    np.testing.assert_allclose(tg, jg, **F32)


@pytest.mark.parametrize("model,S,M", [("mlp", 2, 2), ("gpt", 2, 4)])
def test_weighted_padding_matches_jax(model, S, M):
    """A 0/1 validity mask: padded rows weigh nothing in the loss or its
    gradients, the mean's denominator is the whole batch's weight sum."""
    x, t = _batch(model, seed=1)
    w = np.array([1, 1, 0, 1, 1, 0, 0, 1], np.float32)
    jl, jg = _jax_grads(model, S, M, x, t, w)
    tl, tg = _port_grads(_pair(model, S, M)[1], x, t, w)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, **F32)
    # the padded rows' contents do not matter
    x2 = x.copy()
    x2[w == 0] = 7.0
    np.testing.assert_allclose(_port_grads(_pair(model, S, M)[1], x2, t,
                                           w)[1], tg, **F32)


@pytest.mark.parametrize("model", ["mlp", "gpt"])
def test_loss_only_equals_loss_and_logits(model):
    """The training mode keeps no log-probs; its loss is the logits mode's,
    whose log-probs equal the fused composition of the stages."""
    _, tpipe = _pair(model, 2, 4)
    x, t = map(torch.from_numpy, _batch(model, seed=2))
    params = tpipe.init_params()
    with torch.no_grad():
        loss = tpipe.loss(params, x, t, deterministic=True)
        loss2, logp = tpipe.loss_and_logits(params, x, t,
                                            deterministic=True)
        ref = fused_reference(tpipe.stages)(params, x, deterministic=True)
    assert float(loss) == float(loss2)
    np.testing.assert_allclose(logp.numpy(), ref.numpy(), **F32)


def test_eval_metrics_match_jax():
    jpipe, tpipe = _pair("mlp", 2, 2)
    _, fn = _jax_fn(("mlp", 2, 2, "eval"), jpipe, "eval")
    x, t = _batch("mlp", seed=3)
    w = np.array([1, 1, 1, 0, 1, 1, 1, 0], np.float32)
    jn, jd, jc = fn(jpipe.init_params(), jnp.asarray(x), jnp.asarray(t),
                    jnp.asarray(w))
    tn, td, tc = tpipe.eval_metrics(tpipe.init_params(), torch.from_numpy(x),
                                    torch.from_numpy(t),
                                    weights=torch.from_numpy(w))
    np.testing.assert_allclose([float(tn), float(td)],
                               [float(jn), float(jd)], rtol=1e-5)
    assert int(tc) == int(jc) and tc.dtype == torch.int64


def test_sgd_trajectory_matches_jax():
    """Five SGD(momentum) steps through both packages' train steps."""
    jpipe, tpipe = _pair("mlp", 2, 2)
    jo, to = jopt.sgd(0.1, momentum=0.5), ttrain.sgd(0.1, momentum=0.5)
    buf = jpipe.init_params()
    state = jo.init(buf)
    jfn = jstep.make_train_step(jpipe, jo)
    params = tpipe.init_params()
    tstate = to.init(params)
    tfn = ttrain.make_train_step(tpipe, to)
    jl, tl = [], []
    for i in range(5):
        x, t = _batch("mlp", seed=10 + i)
        buf, state, loss = jfn(buf, state, jnp.asarray(x), jnp.asarray(t),
                               jax.random.key(i))
        jl.append(float(loss))
        params, tstate, loss = tfn(params, tstate, torch.from_numpy(x),
                                   torch.from_numpy(t), i)
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    ref = jax.tree.leaves(jax.tree.map(np.asarray, jpipe.unpack(buf)))
    got = jax.tree.leaves(params_to_numpy(params))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_lenet_conv_fc_matches_jax():
    """The reference's own topology: LeNet's conv half on stage 0, its fc
    half on stage 1 (deterministic: the two packages' dropout bits differ
    by design)."""
    x, t = _batch("lenet", seed=4)
    jl, jg = _jax_grads("lenet", 2, 2, x, t)
    tl, tg = _port_grads(_pair("lenet", 2, 2)[1], x, t)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, **F32)


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_remat_equals_no_remat(attn):
    """``remat=True`` recomputes each stage inside ``torch.utils.
    checkpoint`` (the flash forward's l and m saved again on the
    recompute): the same loss and gradients, dropout masks included."""
    x, t = _batch("gpt", seed=5)
    base = _pair("gpt", 2, 2, attn=attn, dropout_rate=0.2)[1]
    rem = _pair("gpt", 2, 2, remat=True, attn=attn, dropout_rate=0.2)[1]
    for key, det in ((None, True), (11, False)):
        l0, g0 = _port_grads(base, x, t, key=key, deterministic=det)
        l1, g1 = _port_grads(rem, x, t, key=key, deterministic=det)
        np.testing.assert_allclose(l1, l0, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(g1, g0, rtol=1e-6, atol=1e-7)


def test_dropout_trains_and_eval_is_deterministic():
    """JAX's ``test_dropout_trains_and_eval_is_deterministic`` at S = 2:
    training draws masks from the key (another key, another loss; the same
    key, the same loss), the loss falls, and eval ignores dropout."""
    _, tpipe = _pair("gpt", 2, 2, dropout_rate=0.3)
    x, t = map(torch.from_numpy, _batch("gpt", seed=6))
    params = tpipe.init_params()
    with torch.no_grad():
        a = float(tpipe.loss(params, x, t, key=1))
        assert a == float(tpipe.loss(params, x, t, key=1))
        assert a != float(tpipe.loss(params, x, t, key=2))
        assert a != float(tpipe.loss(params, x, t, deterministic=True))
    e0 = [float(v) for v in tpipe.eval_metrics(params, x, t, key=3)]
    assert e0 == [float(v) for v in tpipe.eval_metrics(params, x, t, key=4)]
    opt = ttrain.sgd(0.5, momentum=0.9)
    step = ttrain.make_train_step(tpipe, opt)
    state = opt.init(params)
    for i in range(10):
        params, state, _ = step(params, state, x, t, i)
    e1 = [float(v) for v in tpipe.eval_metrics(params, x, t)]
    assert e1[0] < e0[0]


def _flat_grads(tpipe, x, t, key=None, deterministic=True):
    """Loss and the gradients in ``param_leaves`` order, concatenated (the
    same order at any stage count: the stages split the fused model's
    modules contiguously)."""
    params = tpipe.init_params()
    loss, grads = tpipe.loss_and_grads(params, torch.from_numpy(x),
                                       torch.from_numpy(t), key,
                                       deterministic)
    return float(loss), torch.cat([g.reshape(-1) for g in grads]).numpy()


def test_stages_equal_the_fused_model():
    """Over 2 and 4 stages, at any microbatch count, the port's flash GPT
    gives its one-stage loss and gradients; one microbatch also draws the
    fused model's dropout masks (the stream crosses the stages)."""
    x, t = _batch("gpt", seed=7)
    _, one = _pair("gpt", 1, 1, attn="flash", dropout_rate=0.2)
    l1, g1 = _flat_grads(one, x, t)
    for S, M in ((2, 1), (4, 4)):
        _, many = _pair("gpt", S, M, attn="flash", dropout_rate=0.2)
        ls, gs = _flat_grads(many, x, t)
        np.testing.assert_allclose(ls, l1, rtol=1e-5)
        np.testing.assert_allclose(gs, g1, **F32)
    _, two = _pair("gpt", 2, 1, attn="flash", dropout_rate=0.2)
    ld, gd = _flat_grads(two, x, t, key=9, deterministic=False)
    l1d, g1d = _flat_grads(one, x, t, key=9, deterministic=False)
    assert ld != ls
    np.testing.assert_allclose(ld, l1d, rtol=1e-6)
    np.testing.assert_allclose(gd, g1d, **F32)


def test_each_stage_lives_on_its_mesh_device():
    _, tpipe = _pair("mlp", 4, 1)
    assert isinstance(tpipe.mesh, Mesh) and tpipe.mesh.shape["stage"] == 4
    assert tpipe.devices == [torch.device("cpu")] * 4
    assert (tpipe.device, tpipe.out_device) == (torch.device("cpu"),) * 2
    assert (tpipe.n_stages, tpipe.n_microbatches, tpipe.schedule) == (
        4, 1, "gpipe")
    params = tpipe.init_params()
    assert len(params) == 4
    assert all(p.device.type == "cpu" for m in params
               for p in m.parameters())


def test_validation_errors():
    jb, tb = _builders("mlp")
    tst, wd, od = tb(2)
    pipe = Pipeline(tst, make_mesh(2, devices=["cpu"] * 2), wd, od,
                    n_microbatches=3)
    x, t = map(torch.from_numpy, _batch("mlp"))
    with pytest.raises(ValueError,
                       match="batch 8 not divisible by microbatches\\*data "
                             "= 3"):
        pipe.loss(pipe.init_params(), x, t)
    jpipe = JPipeline(jb(2)[0], jmake_mesh(n_stages=2, n_data=1,
                                           devices=jax.devices()[:2]), wd, od,
                      n_microbatches=3)
    with pytest.raises(ValueError, match="not divisible by microbatches"):
        jpipe.loss(jpipe.init_params(), jnp.asarray(x.numpy()),
                   jnp.asarray(t.numpy()), jax.random.key(0))
    with pytest.raises(ValueError,
                       match="2 stages but mesh stage axis is 4"):
        Pipeline(tst, make_mesh(4, devices=["cpu"] * 4), wd, od)
    with pytest.raises(ValueError, match="2 stages but mesh stage axis "
                                         "is 1"):
        Pipeline(tst, None, wd, od, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="item 6, remaining parallel axes"):
        make_mesh(2, n_data=2, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="needs 3 devices, have 2"):
        make_mesh(3, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="1F1B needs >= 2"):
        from simple_distributed_machine_learning_tpu_torch.parallel import (
            onefb_loss_and_grads,
        )
        one = Pipeline(tb(1)[0], None, wd, od, device="cpu")
        onefb_loss_and_grads(one, one.init_params(), x, t)


def test_bf16_token_ids_stay_exact_over_two_stages():
    """The departure ``test_torch_gpt_train.py::
    test_bf16_token_ids_are_rounded_only_by_jax`` pins on one stage holds
    over two: the first stage embeds the exact ids under a bf16
    ``compute_dtype`` (float ids embed as integer ids), and the two-stage
    loss is the one-stage loss on those ids within bf16's 2^-8."""
    kw = dict(vocab=512, seq_len=16, d_model=32, n_heads=2, n_layers=2)
    stages, wd, od = tgpt.make_gpt_stages(0, tgpt.GPTConfig(**kw), 2,
                                          device="cpu")
    two = Pipeline(stages, make_mesh(2, devices=["cpu"] * 2), wd, od,
                   compute_dtype=torch.bfloat16)
    stages1 = tgpt.make_gpt_stages(0, tgpt.GPTConfig(**kw), 1,
                                   device="cpu")[0]
    one = Pipeline(stages1, None, wd, od, compute_dtype=torch.bfloat16,
                   device="cpu")
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.integers(257, 512, (4, 16)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 512, (4, 16)))
    with torch.no_grad():
        lf, logp_f = two.loss_and_logits(two.init_params(), x, t,
                                         deterministic=True)
        _, logp_i = two.loss_and_logits(two.init_params(), x.long(), t,
                                        deterministic=True)
        l1 = one.loss(one.init_params(), x, t, deterministic=True)
    assert torch.equal(logp_f, logp_i)
    np.testing.assert_allclose(float(lf), float(l1), rtol=2.0 ** -8)


def test_optimizers_clip_across_stage_devices():
    """``clip_by_global_norm`` over two stages' gradients: one norm over
    both, the scale applied on each stage's device — the one-stage
    update's parameters."""
    x, t = _batch("mlp", seed=8)
    out = []
    for S in (1, 2):
        _, tpipe = _pair("mlp", S, 1)
        opt = ttrain.clip_by_global_norm(ttrain.adamw(1e-2), 0.05)
        params = tpipe.init_params()
        state = opt.init(params)
        step = ttrain.make_train_step(tpipe, opt, with_grad_norm=True)
        for _ in range(2):
            params, state, loss, gnorm = step(params, state,
                                              torch.from_numpy(x),
                                              torch.from_numpy(t))
        out.append((float(gnorm), np.concatenate(
            [p.detach().reshape(-1).numpy()
             for p in param_leaves(params)])))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-5)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("port_stages", [2, 1])
def test_jax_two_stage_checkpoint_restores_in_the_port(tmp_path,
                                                       port_stages):
    """A JAX S = 2 ``state.npz`` (params and momentum after 2 steps)
    restores into the port at S = 2 and, repacked, at S = 1; the port's
    next step equals the JAX run's next step; a port checkpoint written
    at S = 2 restores back into the JAX pipeline."""
    jpipe, tpipe2 = _pair("mlp", 2, 1)
    jo, to = jopt.sgd(0.1, momentum=0.5), ttrain.sgd(0.1, momentum=0.5)
    buf = jpipe.init_params()
    state = jo.init(buf)
    jfn = jstep.make_train_step(jpipe, jo)
    for i in range(3):
        x, t = _batch("mlp", seed=20 + i)
        buf, state, jloss = jfn(buf, state, jnp.asarray(x), jnp.asarray(t),
                                jax.random.key(i))
        if i == 1:
            jck.save_checkpoint(str(tmp_path / "state.npz"), buf, state, 2)
    tpipe = tpipe2 if port_stages == 2 else _pair("mlp", 1, 1)[1]
    params = tpipe.init_params()
    st = tck.restore_checkpoint(
        str(tmp_path / "state.npz"), pipe=tpipe,
        opt_treedef_like=to.init(params),
        src_pipe=None if port_stages == 2 else tck.split_layout(tpipe, 2))
    assert st["step"] == 2
    params, tstate, tloss = ttrain.make_train_step(tpipe, to)(
        st["params"], st["opt_state"], torch.from_numpy(x),
        torch.from_numpy(t), 2)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    ref = jax.tree.leaves(jax.tree.map(np.asarray, jpipe.unpack(buf)))
    got = np.concatenate([a.reshape(-1) for a in jax.tree.leaves(
        params_to_numpy(params))])
    np.testing.assert_allclose(got, np.concatenate(
        [a.reshape(-1) for a in ref]), rtol=1e-5, atol=1e-6)
    if port_stages == 1:
        return
    tck.save_checkpoint(str(tmp_path / "port.npz"), params, tstate, 3)
    back = jck.restore_checkpoint(str(tmp_path / "port.npz"), pipe=jpipe,
                                  opt_treedef_like=state)
    np.testing.assert_allclose(np.asarray(back["params"]), np.asarray(buf),
                               rtol=1e-5, atol=1e-6)
    assert back["step"] == 3


def test_trainer_over_two_stages_records_the_bubble_and_resumes(tmp_path):
    """The Trainer at S = 2, M = 2 under 1F1B: each epoch record carries
    the JAX bubble model's fraction, and a checkpoint written at 2 stages
    resumes there and evaluates to the trained run's numbers."""
    import json

    from simple_distributed_machine_learning_tpu.telemetry.bubble import (
        schedule_bubble_fraction,
    )
    from simple_distributed_machine_learning_tpu_torch.data.mnist import (
        Dataset,
    )
    from simple_distributed_machine_learning_tpu_torch.telemetry import (
        Telemetry,
    )
    rng = np.random.default_rng(9)
    ds = Dataset(rng.standard_normal((40, MLP_DIMS[0])).astype(np.float32),
                 rng.integers(0, 10, (40,)).astype(np.int32))

    def trainer(**kw):
        _, tpipe = _pair("mlp", 2, 2, schedule="1f1b")
        cfg = ttrain.TrainConfig(epochs=1, batch_size=8,
                                 print_throughput=False,
                                 checkpoint_dir=str(tmp_path / "ck"))
        return ttrain.Trainer(tpipe, ds, ds, cfg, **kw)

    t = trainer(telemetry=Telemetry(str(tmp_path / "tele")))
    t.fit()
    [rec] = [json.loads(ln) for ln in open(tmp_path / "tele" /
                                           "metrics.jsonl")]
    assert (rec["n_stages"], rec["n_microbatches"], rec["schedule"]) == (
        2, 2, "1f1b")
    assert rec["bubble_fraction"] == round(
        schedule_bubble_fraction(2, 2, "1f1b"), 4) > 0
    resumed = trainer()
    assert resumed.start_epoch == 2 and resumed._step_count == 5
    assert resumed.evaluate() == t.evaluate()
