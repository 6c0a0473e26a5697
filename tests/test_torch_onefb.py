"""The port's 1F1B schedule (``parallel/onefb.py``) against its own GPipe
and against the JAX package's 1F1B (``parallel/onefb.py``) from the same
weights.

The JAX side runs on ``tests/conftest.py``'s 8 virtual CPU devices; the
port runs every stage on the CPU. Tolerances: JAX's own for 1F1B against
GPipe, ``rtol 5e-4, atol 2e-6`` (``tests/test_onefb.py``): the schedule
sums each gradient over microbatches in another order; a 5-step SGD
trajectory within 5e-4 relative per-step loss.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu import make_mesh as jmake_mesh
from simple_distributed_machine_learning_tpu.models import gpt as jgpt
from simple_distributed_machine_learning_tpu.models import mlp as jmlp
from simple_distributed_machine_learning_tpu.parallel.pipeline import (
    Pipeline as JPipeline,
)
from simple_distributed_machine_learning_tpu.train import optimizer as jopt
from simple_distributed_machine_learning_tpu.train import step as jstep
from simple_distributed_machine_learning_tpu_torch import train as ttrain
from simple_distributed_machine_learning_tpu_torch.interop import (
    params_from_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.models import mlp as tmlp
from simple_distributed_machine_learning_tpu_torch.parallel import (
    Pipeline,
    make_mesh,
    onefb_loss_and_grads,
)
from simple_distributed_machine_learning_tpu_torch.parallel.staging import (
    flatten_row,
)
from simple_distributed_machine_learning_tpu_torch.train import (
    checkpoint as tck,
)

MLP_DIMS = [16, 32, 32, 32, 10]
GPT = dict(vocab=32, seq_len=16, d_model=32, n_heads=2, n_layers=4,
           flash_block_q=8, flash_block_k=8)
ONEFB = dict(rtol=5e-4, atol=2e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread while this module runs: its models are
    tiny, and under a multi-process test run more threads only contend
    for the same cores. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stages(model, S, **cfg_kw):
    """``(jax stages, port stages on the JAX weights, wire_dim, out_dim)``."""
    if model == "mlp":
        jst, wd, od = jmlp.make_mlp_stages(jax.random.key(0), MLP_DIMS, S)
        tst = tmlp.make_mlp_stages(0, MLP_DIMS, S, device="cpu")[0]
    else:
        kw = {**GPT, **cfg_kw}
        jst, wd, od = jgpt.make_gpt_stages(
            jax.random.key(0),
            jgpt.GPTConfig(**{k: v for k, v in kw.items()
                              if k != "attn_impl"}), S)
        tst = tgpt.make_gpt_stages(0, tgpt.GPTConfig(**kw), S,
                                   device="cpu")[0]
    nparams = jax.tree.map(np.asarray, [s.params for s in jst])
    tst = [dataclasses.replace(s, params=p)
           for s, p in zip(tst, params_from_numpy(nparams, "cpu"))]
    return jst, tst, wd, od


def _port(model, S, M, schedule, **cfg_kw):
    _, tst, wd, od = _stages(model, S, **cfg_kw)
    return Pipeline(tst, make_mesh(S, devices=["cpu"] * S), wd, od,
                    n_microbatches=M, schedule=schedule)


def _batch(model, seed=0, batch=8):
    rng = np.random.default_rng(seed)
    if model == "mlp":
        return (rng.standard_normal((batch, MLP_DIMS[0])).astype(np.float32),
                rng.integers(0, 10, (batch,)).astype(np.int32))
    return (rng.integers(0, 32, (batch, 16)).astype(np.float32),
            rng.integers(0, 32, (batch, 16)).astype(np.int32))


def _port_grads(pipe, x, t, w=None, key=None, deterministic=True):
    params = pipe.init_params()
    loss, grads = pipe.loss_and_grads(
        params, torch.from_numpy(x), torch.from_numpy(t), key,
        deterministic, None if w is None else torch.from_numpy(w))
    width = max(m.total for m in pipe.metas)
    return float(loss), _packed(grads, params, width)


def _packed(grads, params, width):
    """Per-tensor gradients -> the JAX pipeline's packed ``[S, 1, 1,
    width]`` f32 gradient buffer (each stage's leaves in its order)."""
    rows = [flatten_row([grads[i] for i in idx], width)
            for idx in tck._jax_order(params)]
    return torch.stack(rows).reshape(len(rows), 1, 1, width).numpy()


@pytest.mark.parametrize("model,S,M,weighted", [
    ("gpt", 2, 4, False), ("mlp", 4, 4, True)])
def test_1f1b_matches_gpipe_and_jax_1f1b(model, S, M, weighted):
    x, t = _batch(model)
    w = (np.array([1, 0, 1, 1, 0, 1, 1, 1], np.float32) if weighted
         else np.ones((8,), np.float32))
    jst, _, wd, od = _stages(model, S)
    jpipe = JPipeline(jst, jmake_mesh(n_stages=S, n_data=1,
                                      devices=jax.devices()[:S]), wd, od,
                      n_microbatches=M, schedule="1f1b")
    jl, jg = jax.jit(lambda b, x, t, w: jpipe.loss_and_grads(
        b, x, t, jax.random.key(0), True, w))(
        jpipe.init_params(), jnp.asarray(x), jnp.asarray(t), jnp.asarray(w))
    ol, og = _port_grads(_port(model, S, M, "1f1b"), x, t, w)
    gl, gg = _port_grads(_port(model, S, M, "gpipe"), x, t, w)
    np.testing.assert_allclose(ol, gl, rtol=5e-4)
    np.testing.assert_allclose(og, gg, **ONEFB)
    np.testing.assert_allclose(ol, float(jl), rtol=5e-4)
    np.testing.assert_allclose(og, np.asarray(jg), **ONEFB)


def test_1f1b_flash_recompute_matches_gpipe():
    """The flash blocks' backward tick recomputes K1 (saving l and m again)
    before K2 and K3 read them: the gradients are GPipe's."""
    x, t = _batch("gpt", seed=1)
    ol, og = _port_grads(_port("gpt", 2, 4, "1f1b", attn_impl="flash"), x, t)
    gl, gg = _port_grads(_port("gpt", 2, 4, "gpipe", attn_impl="flash"), x,
                         t)
    np.testing.assert_allclose(ol, gl, rtol=5e-4)
    np.testing.assert_allclose(og, gg, **ONEFB)


def test_1f1b_matches_gpipe_with_dropout():
    """Dropout on: the backward tick replays each microbatch's stream from
    its saved state, so 1F1B draws GPipe's masks."""
    x, t = _batch("gpt", seed=2)
    kw = dict(dropout_rate=0.3)
    ol, og = _port_grads(_port("gpt", 2, 4, "1f1b", **kw), x, t, key=5,
                         deterministic=False)
    gl, gg = _port_grads(_port("gpt", 2, 4, "gpipe", **kw), x, t, key=5,
                         deterministic=False)
    dl, _ = _port_grads(_port("gpt", 2, 4, "gpipe", **kw), x, t)
    assert ol != dl
    np.testing.assert_allclose(ol, gl, rtol=5e-4)
    np.testing.assert_allclose(og, gg, **ONEFB)


def test_1f1b_sgd_trajectory_matches_gpipe_and_jax():
    jst, _, wd, od = _stages("mlp", 2)
    jpipe = JPipeline(jst, jmake_mesh(n_stages=2, n_data=1,
                                      devices=jax.devices()[:2]), wd, od,
                      n_microbatches=4, schedule="1f1b")
    jo = jopt.sgd(0.1, momentum=0.5)
    buf = jpipe.init_params()
    state = jo.init(buf)
    jfn = jstep.make_train_step(jpipe, jo)
    runs = {}
    for sched in ("1f1b", "gpipe"):
        pipe = _port("mlp", 2, 4, sched)
        opt = ttrain.sgd(0.1, momentum=0.5)
        params = pipe.init_params()
        st = opt.init(params)
        fn = ttrain.make_train_step(pipe, opt)
        losses = []
        for i in range(5):
            x, t = _batch("mlp", seed=10 + i)
            params, st, loss = fn(params, st, torch.from_numpy(x),
                                  torch.from_numpy(t), i)
            losses.append(float(loss))
        runs[sched] = losses
    jl = []
    for i in range(5):
        x, t = _batch("mlp", seed=10 + i)
        buf, state, loss = jfn(buf, state, jnp.asarray(x), jnp.asarray(t),
                               jax.random.key(i))
        jl.append(float(loss))
    np.testing.assert_allclose(runs["1f1b"], runs["gpipe"], rtol=5e-4)
    np.testing.assert_allclose(runs["1f1b"], jl, rtol=5e-4)
    assert runs["1f1b"][-1] < runs["1f1b"][0]


@pytest.mark.parametrize("S,Ms", [(2, (4, 32)), (3, (8, 32))])
def test_inputs_in_flight_are_bounded_by_the_stages(S, Ms):
    """The port's counterpart of ``test_1f1b_memory_flat_in_microbatches``
    (which reads XLA's memory analysis): no stage keeps more than 2S - 1
    microbatch inputs, the same at M = 4 (8) and M = 32."""
    x, t = _batch("mlp", batch=32)
    peaks = []
    for M in Ms:
        pipe = _port("mlp", S, M, "1f1b")
        onefb_loss_and_grads(pipe, pipe.init_params(), torch.from_numpy(x),
                             torch.from_numpy(t))
        peaks.append(pipe.onefb_inflight_peak)
    assert peaks == [2 * S - 1] * 2
