"""Sequence and expert parallelism through the port's ``Pipeline``
(``<port>/models/gpt.py``'s seq-sharded and MoE blocks) against the JAX
package:

- the GPT over 2 stages x 2 seq shards (``tests/test_gpt_sp.py``'s
  ``CFG``), ring and Ulysses, on the JAX weights: loss and logits equal to
  the JAX SP pipeline's; SGD trajectories equal to the dense pipeline's
  under GPipe, 1F1B and remat;
- the MoE GPT (``tests/test_expert_pipeline.py``'s ``CFG``) on the JAX
  weights: loss (with its aux term) and logits equal to the JAX dense-MoE
  pipeline's at ``n_expert_parallel`` 1 and 2, and the EP trajectory equal
  to the JAX dense-MoE trajectory — the identity the JAX pin
  ``test_ep_sgd_trajectory_matches_dense`` asserts (its EP half is red on
  this tree); EP beside a data axis; weights that scale the NLL only;
  1F1B carrying the aux term;
- the clip norm under expert shards against JAX's
  ``replication_weights()``, and an EP checkpoint across the packages;
- the mesh's process split, and two gloo processes through the CLI equal
  to one (the seq axis split between them, and the expert axis), one
  thread each, on free ports, killed in a ``finally``.

Tolerances: the JAX pins' own — losses ``rtol 2e-5, atol 2e-5``, logits
``rtol 2e-4, atol 2e-4``, trajectories ``rtol 5e-5, atol 5e-5``; parameters
after a few steps ``rtol 1e-5, atol 1e-5``.
"""

import dataclasses
import functools
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu.models import gpt as jgpt
from simple_distributed_machine_learning_tpu.parallel.mesh import (
    make_mesh as jmake_mesh,
)
from simple_distributed_machine_learning_tpu.parallel.pipeline import (
    Pipeline as JPipeline,
)
from simple_distributed_machine_learning_tpu.train import checkpoint as jck
from simple_distributed_machine_learning_tpu.train import optimizer as jopt
from simple_distributed_machine_learning_tpu.train.step import (
    make_train_step as jmake_train_step,
)
from simple_distributed_machine_learning_tpu_torch import train as ttrain
from simple_distributed_machine_learning_tpu_torch._tree import to_numpy
from simple_distributed_machine_learning_tpu_torch.interop import (
    params_from_numpy,
    shards_from_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.parallel import (
    Pipeline,
    make_mesh,
    param_leaves,
)
from simple_distributed_machine_learning_tpu_torch.parallel.staging import (
    flatten_row,
)
from simple_distributed_machine_learning_tpu_torch.train import (
    checkpoint as tck,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS = dict(rtol=2e-5, atol=2e-5)
LOGITS = dict(rtol=2e-4, atol=2e-4)
TRAJ = dict(rtol=5e-5, atol=5e-5)
PARAMS = dict(rtol=1e-5, atol=1e-5)
SP_CFG = dict(vocab=32, seq_len=16, d_model=32, n_heads=4, n_layers=2)
EP_CFG = dict(SP_CFG, n_heads=2, n_experts=4, moe_top_k=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed, batch):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 32, (batch, 16)).astype(np.float32),
            rng.integers(0, 32, (batch, 16)))


def _jax_pipe(cfg_kw, n_data=1, M=2, **mesh_kw):
    cfg = jgpt.GPTConfig(**cfg_kw)
    st, wd, od = jgpt.make_gpt_stages(jax.random.key(0), cfg, 2)
    mesh = jmake_mesh(n_stages=2, n_data=n_data, **mesh_kw)
    return JPipeline(st, mesh, wd, od, n_microbatches=M)


def _port_pipe(jpipe, cfg_kw, n_data=1, M=2, **kw):
    """The port's pipeline on the JAX pipeline's stage weights; with
    ``n_expert_parallel > 1`` and unsharded JAX stages (a dense-MoE build
    of one key: the JAX EP build slices the same init) the port's own
    expert slices of them."""
    cfg = tgpt.GPTConfig(**cfg_kw)
    st, wd, od = tgpt.make_gpt_stages(0, cfg, 2, device="cpu")
    out = []
    for t, j in zip(st, jpipe.stages):
        if j.expert_shards is not None:
            sh = shards_from_numpy(jax.tree.map(np.asarray,
                                                list(j.expert_shards)),
                                   "cpu")
        elif cfg.n_expert_parallel > 1:
            tree = jax.tree.map(lambda a: torch.tensor(np.asarray(a)),
                                j.params)
            sh = tuple(tgpt.GPT(**tgpt._slice_expert_shard(tree, e, cfg))
                       for e in range(cfg.n_expert_parallel))
        else:
            out.append(dataclasses.replace(t, params=params_from_numpy(
                [jax.tree.map(np.asarray, j.params)], "cpu")[0]))
            continue
        out.append(dataclasses.replace(t, params=sh[0], expert_shards=sh))
    n = 2 * n_data * cfg.n_seq * cfg.n_expert_parallel
    mesh = make_mesh(2, n_data=n_data, n_seq=cfg.n_seq,
                     n_expert=cfg.n_expert_parallel, devices=["cpu"] * n)
    return Pipeline(out, mesh, wd, od, n_microbatches=M, **kw)


def _train(pipe, n, x, y, opt=None):
    opt = opt or ttrain.sgd(0.1, momentum=0.5)
    params = pipe.init_params()
    state, step = opt.init(params), ttrain.make_train_step(pipe, opt)
    losses = []
    for i in range(n):
        params, state, loss = step(params, state, torch.tensor(x),
                                   torch.tensor(y), 10 + i)
        losses.append(float(loss))
    return losses, params


# ---- sequence parallelism -----------------------------------------------------

@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_gpt_sp_loss_and_logits_equal_the_jax_sp_pipeline(attn):
    kw = dict(SP_CFG, attn_impl=attn, n_seq=2)
    jpipe = _jax_pipe(kw, n_seq=2)
    x, y = _data(1, 4)
    jl, jlog = jpipe.loss_and_logits(jpipe.init_params(), jnp.asarray(x),
                                     jnp.asarray(y), jax.random.key(2),
                                     deterministic=True)
    pipe = _port_pipe(jpipe, kw)
    with torch.no_grad():
        tl, tlog = pipe.loss_and_logits(pipe.init_params(), torch.tensor(x),
                                        torch.tensor(y), 2,
                                        deterministic=True)
    np.testing.assert_allclose(float(tl), float(jl), **LOSS)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGITS)
    with torch.no_grad():
        num, den, hit = pipe.eval_metrics(pipe.init_params(),
                                          torch.tensor(x), torch.tensor(y))
    jn, jd, jh = jpipe.eval_metrics(jpipe.init_params(), jnp.asarray(x),
                                    jnp.asarray(y), jax.random.key(0))
    np.testing.assert_allclose([float(num), float(den)],
                               [float(jn), float(jd)], **LOSS)
    assert int(hit) == int(jh)


@pytest.mark.parametrize("attn,kw", [
    ("ring", {}), ("ulysses", {}), ("ring", dict(schedule="1f1b")),
    ("ulysses", dict(schedule="1f1b")), ("ring", dict(remat=True)),
    ("ring", dict(n_seq=4))])
def test_gpt_sp_sgd_trajectory_equals_dense(attn, kw):
    """Three SGD(momentum) steps with clipping: the seq-sharded run's
    losses and parameters are the dense pipeline's (the JAX pin
    ``test_gpt_sp_sgd_trajectory_matches_dense``), the first case also
    the JAX SP pipeline's losses."""
    kw = dict(kw)
    n_seq = kw.pop("n_seq", 2)
    cfg = dict(SP_CFG, attn_impl=attn, n_seq=n_seq)
    jpipe = _jax_pipe(cfg, n_seq=n_seq)
    x, y = _data(3, 4)
    opt = ttrain.clip_by_global_norm(ttrain.sgd(0.1, momentum=0.5), 0.5)
    ls, ps = _train(_port_pipe(jpipe, cfg, **kw), 3, x, y, opt)
    ld, pd = _train(_port_pipe(jpipe, SP_CFG, **kw), 3, x, y, opt)
    np.testing.assert_allclose(ls, ld, **TRAJ)
    for a, b in zip(ps, pd):
        jax.tree.map(lambda u, v: np.testing.assert_allclose(u, v, **PARAMS),
                     to_numpy(a), to_numpy(b))
    if kw or n_seq != 2 or attn != "ring":
        return
    step = jmake_train_step(jpipe, jopt.sgd(0.1, momentum=0.5))
    buf = jpipe.init_params()
    state = jopt.sgd(0.1, momentum=0.5).init(buf)
    want = []
    for i in range(3):
        buf, state, loss = step(buf, state, jnp.asarray(x), jnp.asarray(y),
                                jax.random.key(i))
        want.append(float(loss))
    got, _ = _train(_port_pipe(jpipe, cfg), 3, x, y)
    np.testing.assert_allclose(got, want, **TRAJ)


def test_sp_dropout_draws_a_stream_per_chunk_in_every_schedule():
    """With dropout each seq chunk draws its own stream (folded from the
    microbatch's with the chunk's index): GPipe, 1F1B and remat draw the
    same masks, and the chunks' masks differ."""
    cfg = dict(SP_CFG, attn_impl="ulysses", n_seq=2, dropout_rate=0.3)
    jpipe = _jax_pipe(dict(SP_CFG, attn_impl="ulysses", n_seq=2), n_seq=2)
    x, y = _data(4, 4)
    runs = [_train(_port_pipe(jpipe, cfg, **kw), 2, x, y)[0]
            for kw in ({}, dict(schedule="1f1b"), dict(remat=True))]
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-6)
    np.testing.assert_allclose(runs[2], runs[0], rtol=1e-6)
    pipe = _port_pipe(jpipe, cfg)
    a, b = pipe._stream_start(5, 1, "cpu", [0, 1])
    assert not torch.equal(a, b)


def test_sp_pipeline_refuses_a_classifier_output_with_the_jax_text():
    cfg = tgpt.GPTConfig(**SP_CFG, attn_impl="ring", n_seq=2)
    st, wd, _ = tgpt.make_gpt_stages(0, cfg, 2, device="cpu")
    jst, jwd, _ = jgpt.make_gpt_stages(
        jax.random.key(0), jgpt.GPTConfig(**SP_CFG, attn_impl="ring",
                                          n_seq=2), 2)
    for out_dim, text in ((10, "requires a per-token output shape"),
                          ((15, 32), "token axis 15 not divisible")):
        with pytest.raises(ValueError, match=text) as te:
            Pipeline(st, make_mesh(2, n_seq=2, devices=["cpu"] * 4), wd,
                     out_dim)
        with pytest.raises(ValueError, match=text) as je:
            JPipeline(jst, jmake_mesh(n_stages=2, n_data=1, n_seq=2), jwd,
                      out_dim)
        assert str(te.value) == str(je.value)


# ---- experts ----------------------------------------------------------------

@pytest.mark.parametrize("ep", [1, 2])
def test_moe_loss_aux_and_logits_equal_the_jax_dense_moe_pipeline(ep):
    jdense = _jax_pipe(EP_CFG)
    x, y = _data(1, 8)
    jl, jlog = jdense.loss_and_logits(jdense.init_params(), jnp.asarray(x),
                                      jnp.asarray(y), jax.random.key(2),
                                      deterministic=True)
    jpipe = _jax_pipe(dict(EP_CFG, n_expert_parallel=ep), n_expert=ep)
    pipe = _port_pipe(jpipe, dict(EP_CFG, n_expert_parallel=ep))
    with torch.no_grad():
        tl, tlog = pipe.loss_and_logits(pipe.init_params(), torch.tensor(x),
                                        torch.tensor(y), 2,
                                        deterministic=True)
    np.testing.assert_allclose(float(tl), float(jl), **LOSS)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGITS)
    # the aux term is in the loss: the NLL alone is another number
    num, den, _ = pipe.eval_metrics(pipe.init_params(), torch.tensor(x),
                                    torch.tensor(y))
    assert float(tl) - float(num / den) > 1e-3


@functools.lru_cache(maxsize=None)
def _jax_dense_moe_losses(M: int) -> tuple:
    """Three SGD(momentum) steps of the JAX dense-MoE pipeline."""
    jdense = _jax_pipe(EP_CFG, M=M)
    x, y = _data(3, 8)
    opt = jopt.sgd(0.1, momentum=0.5)
    step = jmake_train_step(jdense, opt)
    buf = jdense.init_params()
    state = opt.init(buf)
    want = []
    for i in range(3):
        buf, state, loss = step(buf, state, jnp.asarray(x), jnp.asarray(y),
                                jax.random.fold_in(jax.random.key(4), i))
        want.append(float(loss))
    return tuple(want)


@pytest.mark.parametrize("ep,kw", [(1, {}), (2, {}), (4, dict(M=1)),
                                   (2, dict(schedule="1f1b"))])
def test_ep_sgd_trajectory_equals_the_jax_dense_moe(ep, kw):
    """Three SGD(momentum) steps: gradients through the all-to-alls, the
    expert-sharded storage and the tied replicated leaves give the JAX
    dense-MoE pipeline's losses (``test_ep_sgd_trajectory_matches_dense``
    of the JAX package, whose EP half is red on this tree)."""
    kw = dict(kw)
    M = kw.pop("M", 2)
    x, y = _data(3, 8)
    got, _ = _train(_port_pipe(_jax_pipe(EP_CFG, M=M),
                               dict(EP_CFG, n_expert_parallel=ep), M=M,
                               **kw), 3, x, y)
    np.testing.assert_allclose(got, _jax_dense_moe_losses(M), **TRAJ)


def _gather_experts(shards) -> dict:
    """Per-expert-shard GPT stage modules -> the dense stage's tree."""
    trees = [to_numpy(m) for m in shards]
    out = trees[0]
    for i, b in enumerate(out["blocks"]):
        b["moe"]["experts"] = jax.tree.map(
            lambda *a: np.concatenate(a),
            *[t["blocks"][i]["moe"]["experts"] for t in trees])
    return out


def test_ep_beside_a_data_axis_equals_dense_moe():
    """dp 2 x pp 2 x ep 2 (``test_ep_composes_with_data_parallel``, red in
    the JAX package) and under 1F1B with clipping: two steps equal the
    dense MoE's at dp 2, losses and parameters."""
    jpipe = _jax_pipe(dict(EP_CFG, n_expert_parallel=2), n_data=2,
                      n_expert=2)
    jdense = _jax_pipe(EP_CFG, n_data=2)
    x, y = _data(5, 8)
    opt = ttrain.clip_by_global_norm(ttrain.sgd(0.1, momentum=0.5), 0.5)
    for kw in ({}, dict(schedule="1f1b")):
        le, pe = _train(_port_pipe(jpipe, dict(EP_CFG, n_expert_parallel=2),
                                   n_data=2, **kw), 2, x, y, opt)
        ld, pd = _train(_port_pipe(jdense, EP_CFG, n_data=2, **kw), 2, x, y,
                        opt)
        np.testing.assert_allclose(le, ld, **TRAJ)
        for sh, d in zip(pe, pd):
            jax.tree.map(lambda u, v: np.testing.assert_allclose(
                u, v, **PARAMS), _gather_experts(sh), to_numpy(d))


def test_weights_scale_the_nll_only():
    """``test_weighted_loss_applies_to_nll_only``: per-sample weights
    scale the NLL; the aux term stays unweighted, and the loss is the JAX
    dense-MoE pipeline's with the same weights."""
    jdense = _jax_pipe(EP_CFG, M=1)
    x, y = _data(8, 8)
    w = np.asarray([1.0, 1.0, 1.0, 0.5, 2.0, 0.0, 1.5, 1.0], np.float32)
    jl, _ = jdense.loss_and_logits(jdense.init_params(), jnp.asarray(x),
                                   jnp.asarray(y), jax.random.key(9),
                                   deterministic=True,
                                   weights=jnp.asarray(w))
    jpipe = _jax_pipe(dict(EP_CFG, n_expert_parallel=2), n_expert=2, M=1)
    pipe = _port_pipe(jpipe, dict(EP_CFG, n_expert_parallel=2), M=1)
    with torch.no_grad():
        losses = [float(pipe.loss(pipe.init_params(), torch.tensor(x),
                                  torch.tensor(y), 9, deterministic=True,
                                  weights=torch.tensor(w * c)))
                  for c in (1.0, 7.0)]
    np.testing.assert_allclose(losses[0], float(jl), **LOSS)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)


def test_fused_moe_stage_returns_its_aux():
    """One stage on no mesh (the fused path): the loss is the weighted
    NLL plus the stage's aux, and the gradients reach the router."""
    cfg = tgpt.GPTConfig(**EP_CFG)
    st, wd, od = tgpt.make_gpt_stages(0, cfg, 1, device="cpu")
    pipe = Pipeline(st, None, wd, od, device="cpu")
    x, y = _data(6, 4)
    params = pipe.init_params()
    loss, grads = pipe.loss_and_grads(params, torch.tensor(x),
                                      torch.tensor(y), deterministic=True)
    with torch.no_grad():
        _, aux = st[0].apply(params[0], torch.tensor(x))
        num, den, _ = pipe.eval_metrics(params, torch.tensor(x),
                                        torch.tensor(y))
    np.testing.assert_allclose(float(loss), float(num / den + aux),
                               rtol=1e-6)
    router = params[0]["blocks"][0]["moe"]["router"]
    i = [id(t) for t in param_leaves(params)].index(id(router))
    assert float(grads[i].abs().sum()) > 0


def test_ep_microbatch_must_split_over_the_expert_axis():
    """A microbatch of 2 sequences on 4 expert coordinates: the JAX
    text (JAX raises it building the stages, where it traces a batch of
    2; the port when it meets the batch)."""
    with pytest.raises(ValueError) as je:
        _jax_pipe(dict(EP_CFG, n_expert_parallel=4), n_expert=4)
    pipe = _port_pipe(_jax_pipe(EP_CFG), dict(EP_CFG, n_expert_parallel=4))
    x, y = _data(1, 4)
    with pytest.raises(ValueError) as te:
        pipe.loss(pipe.init_params(), torch.tensor(x), torch.tensor(y))
    assert str(te.value) == str(je.value).splitlines()[0] == (
        "microbatch of 2 sequences not divisible by n_expert_parallel=4")


# ---- the clip norm and the checkpoint -----------------------------------------

def test_clip_norm_against_jax_replication_weights_under_expert_shards():
    """JAX's ``replication_weights()`` weighs an expert-sharded stage's
    rows 1, so its replicated leaves (attention, norms, the router, embed,
    head) count once per expert shard; the port counts every parameter
    once — the dense MoE's norm — and squared it is JAX's less ``(D - 1)``
    times those leaves' squares (ROADMAP.md, Queue C)."""
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        param_units,
    )
    D = 2
    jpipe = _jax_pipe(dict(EP_CFG, n_expert_parallel=D), n_expert=D)
    pipe = _port_pipe(jpipe, dict(EP_CFG, n_expert_parallel=D))
    dense = _port_pipe(_jax_pipe(EP_CFG), EP_CFG)
    x, y = _data(2, 8)
    params = pipe.init_params()
    _, g = pipe.loss_and_grads(params, torch.tensor(x), torch.tensor(y), 0,
                               deterministic=True)
    ours = float(ttrain.global_grad_norm(g, params))
    _, gd = dense.loss_and_grads(dense.init_params(), torch.tensor(x),
                                 torch.tensor(y), 0, deterministic=True)
    np.testing.assert_allclose(
        ours, float(ttrain.global_grad_norm(gd, dense.init_params())),
        rtol=1e-5)
    width = max(m.total for m in pipe.metas)
    buf = np.zeros((2, 1, D, width), np.float32)
    replicated = 0.0
    for _, s, e, idx in tck._units(params):
        buf[s, 0, e] = flatten_row([g[i] for i in idx], width).numpy()
    k = 0
    for _, e, module in param_units(params):
        for name, _ in module.named_parameters():
            if e and "experts" not in name.split("."):
                replicated += float((g[k] ** 2).sum())
            k += 1
    assert replicated > 0
    weights = np.asarray(jpipe.replication_weights())
    assert np.all(weights == 1.0)
    inner = jopt.Optimizer(lambda p: (), lambda gg, st, p: (gg, st))
    clip = jopt.clip_by_global_norm(inner, 1e-3, jnp.asarray(weights))
    scaled, _ = clip.update(jnp.asarray(buf), (), None)
    j = np.argmax(np.abs(buf))
    jax_norm = 1e-3 / float(np.asarray(scaled).ravel()[j]
                            / buf.ravel()[j]) - 1e-6
    np.testing.assert_allclose(jax_norm ** 2, ours ** 2 + replicated,
                               rtol=1e-4)


def test_ep_checkpoint_crosses_packages_both_ways(tmp_path):
    """The port trains its EP MoE GPT 2 steps on the JAX weights and saves
    (``[2, 1, 2, P]``, ``E = n_expert``); the JAX EP pipeline restores it
    and computes the port's loss on it; JAX's own save of that state
    restores into the port bit for bit, shard by shard."""
    kw = dict(EP_CFG, n_expert_parallel=2)
    jpipe = _jax_pipe(kw, n_expert=2)
    pipe = _port_pipe(jpipe, kw)
    x, y = _data(4, 8)
    opt = ttrain.sgd(0.1, momentum=0.5)
    params = pipe.init_params()
    state, step = opt.init(params), ttrain.make_train_step(pipe, opt)
    for i in range(2):
        params, state, _ = step(params, state, torch.tensor(x),
                                torch.tensor(y), i)
    with torch.no_grad():
        want = float(pipe.loss(params, torch.tensor(x), torch.tensor(y), 0,
                               deterministic=True))
    port = str(tmp_path / "port.npz")
    tck.save_checkpoint(port, params, state, 2)
    assert np.load(port)["params"].shape[:3] == (2, 1, 2)
    jstate = jopt.sgd(0.1, momentum=0.5).init(jpipe.init_params())
    back = jck.restore_checkpoint(port, pipe=jpipe, opt_treedef_like=jstate)
    got = float(jpipe.loss(back["params"], jnp.asarray(x), jnp.asarray(y),
                           jax.random.key(0), deterministic=True))
    np.testing.assert_allclose(got, want, **LOSS)
    again = str(tmp_path / "jax.npz")
    jck.save_checkpoint(again, back["params"], back["opt_state"], 2)
    st = tck.restore_checkpoint(again, pipe=pipe,
                                opt_treedef_like=opt.init(pipe.init_params()))
    for sh, mine in zip(st["params"], params):
        for a, b in zip(sh, mine):
            jax.tree.map(np.testing.assert_array_equal, to_numpy(a),
                         to_numpy(b))
    for a, b in zip(st["opt_state"], state):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    z = ttrain.shard_opt_state_zero1(opt.init(params), pipe.mesh, pipe,
                                     params)
    assert z is not None


# ---- the mesh and the processes -------------------------------------------------

def test_mesh_five_axes_and_process_boxes(monkeypatch):
    """Coordinates number data-major in the JAX axis order; a process's
    block inside one (data, stage) must be a box of its model x seq x
    expert coordinates."""
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        mesh as tmesh,
    )
    mesh = make_mesh(2, n_seq=2, n_expert=2, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 1, "stage": 2, "model": 1, "seq": 2,
                          "expert": 2}
    assert mesh._index(0, 1, 0, 1, 0) == 6
    assert list(mesh.seq_range(0, 1)) == [0, 1]
    assert mesh.view(0, 0, "expert").group is None
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        make_mesh(2, n_seq=2, n_expert=2, devices=["cpu"] * 4)
    monkeypatch.setattr(tmesh, "process_count", lambda: 3)
    with pytest.raises(ValueError, match="do not form a box"):
        make_mesh(1, n_seq=2, n_expert=3, devices=["cpu"] * 6)
    monkeypatch.setattr(tmesh, "process_count", lambda: 2)
    monkeypatch.setattr(tmesh, "process_index", lambda: 1)
    monkeypatch.setattr(torch.distributed, "new_group", lambda ranks: ranks)
    two = make_mesh(1, n_seq=2, n_expert=3, devices=["cpu"] * 6)
    assert two._first == (0, 1, 0) and two.expert_shards == range(3)
    view = two.view(0, 0, "seq")
    assert view.ranks == (0, 1) and view.group == [0, 1]
    assert two.grad_group(0) == [0, 1] and two.data_group(0) is None
    assert two.view(0, 0, "expert").group is None and two.primary


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


CLI = [sys.executable, "-m",
       "simple_distributed_machine_learning_tpu_torch.cli", "--device", "cpu",
       "--data-root", "/nonexistent"]
ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")


def _console(out: str) -> list[str]:
    return [ln for ln in out.splitlines()
            if not ln.startswith(("| distributed:", "| epoch ",
                                  "| pipeline:"))]


def _ranks(extra, world=2):
    port, hb = _free_port(), _free_port()
    procs = [subprocess.Popen(
        CLI + ["--rank", str(r), "--world_size", str(world), "--master_addr",
               "localhost", "--master_port", str(port), "--heartbeat-port",
               str(hb)] + extra, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=ENV, cwd=REPO)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-2000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


@pytest.mark.parametrize("extra", [
    # the seq axis split over the two processes: ring hops over gloo
    ["--model", "gpt", "--dryrun", "2", "--stages", "1", "--sp", "2",
     "--attn", "ring", "--clip-norm", "1.0", "--batch-size", "8"],
    # the expert axis split over the two processes: gloo all-to-alls
    ["--model", "gpt", "--dryrun", "2", "--stages", "1", "--experts", "4",
     "--ep", "2", "--batch-size", "8"],
])
def test_two_gloo_processes_equal_one_process(extra):
    """``--sp 2`` and ``--experts 4 --ep 2`` over two processes print the
    one-process run's console; rank 1 prints nothing."""
    outs = _ranks(extra)
    one = subprocess.run(CLI + ["--rank", "0"] + extra, capture_output=True,
                         text=True, env=ENV, cwd=REPO, timeout=180)
    assert one.returncode == 0, one.stderr[-2000:]
    assert _console(outs[0]) == _console(one.stdout)
    assert any(ln.startswith("Test set:") for ln in _console(outs[0]))
    assert "| distributed: 2 processes" in outs[0]
    assert outs[1].strip() == ""


_ULYSSES_WORKER = """
import json, sys
import torch
from simple_distributed_machine_learning_tpu_torch import train
from simple_distributed_machine_learning_tpu_torch.models import gpt
from simple_distributed_machine_learning_tpu_torch.parallel import (
    Pipeline, bootstrap_distributed, make_mesh)
rank, port, world = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
torch.set_num_threads(1)
bootstrap_distributed(rank, world, "localhost", port)
cfg = gpt.GPTConfig(**json.loads(sys.argv[4]))
st, wd, od = gpt.make_gpt_stages(0, cfg, 2, device="cpu")
mesh = make_mesh(2, n_seq=cfg.n_seq, n_expert=cfg.n_expert_parallel,
                 devices=["cpu"] * (2 * cfg.n_seq * cfg.n_expert_parallel))
pipe = Pipeline(st, mesh, wd, od, n_microbatches=2, schedule=sys.argv[5])
g = torch.Generator().manual_seed(0)
x = torch.randint(0, cfg.vocab, (4, cfg.seq_len), generator=g).float()
y = torch.randint(0, cfg.vocab, (4, cfg.seq_len), generator=g)
opt = train.clip_by_global_norm(train.sgd(0.1, momentum=0.5), 0.5)
p = pipe.init_params()
s, step = opt.init(p), train.make_train_step(pipe, opt)
out = []
for i in range(2):
    p, s, loss = step(p, s, x, y, 3 + i)
    out.append(float(loss))
if world > 1:
    torch.distributed.destroy_process_group()
print(json.dumps(out))
"""


@pytest.mark.parametrize("cfg,schedule", [
    (dict(SP_CFG, attn_impl="ulysses", n_seq=2, dropout_rate=0.2), "1f1b"),
    (dict(SP_CFG, n_experts=4, n_expert_parallel=2, dropout_rate=0.2),
     "gpipe"),
])
def test_four_gloo_processes_equal_one(cfg, schedule):
    """2 stages x 2 seq (or expert) coordinates over four processes, one
    coordinate each, with dropout: the stage hops carry each chunk and
    its stream, Ulysses' all-to-alls and the EP exchange cross processes;
    the losses are the one-process run's."""
    import json
    port = _free_port()
    args = [json.dumps(cfg), schedule]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _ULYSSES_WORKER, str(r), str(port), "4"]
        + args, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=ENV, cwd=REPO) for r in range(4)]
    try:
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    one = subprocess.run([sys.executable, "-c", _ULYSSES_WORKER, "0",
                          str(_free_port()), "1"] + args,
                         capture_output=True, text=True, env=ENV, cwd=REPO,
                         timeout=180)
    assert one.returncode == 0, one.stderr[-2000:]
    want = json.loads(one.stdout.strip().splitlines()[-1])
    for got in outs:
        np.testing.assert_allclose(got, want, rtol=1e-6)
