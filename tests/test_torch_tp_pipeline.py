"""The tensor-parallel GPT (``models/gpt.py``'s TP blocks over
``Stage.shards``) through the port's ``Pipeline`` on a ``(data, stage,
model)`` mesh, against the JAX package and against the dense model.

- the JAX pin ``tests/test_overlap.py::test_gpt_tp_matches_dense_pipeline``:
  ``_gpt_losses(2, "none", n_steps=5, n_stages=2)`` equals
  ``_gpt_losses(1, ...)``. Its TP half is red on this tree (JAX's
  varying-manual-axes check fails in the TP backward), so the port's TP
  run on the JAX TP weights is held to the dense half, which runs;
- TP at 2 and 4 against the dense build of the same weights under GPipe,
  1F1B and ``remat``, with dropout (the masks are drawn on replicated
  activations in the dense block's order, so they are the dense run's);
- the clip norm: equal to the JAX ``replication_weights()`` norm where
  that norm counts each parameter once, and the port's departure where
  it counts a sharded stage's replicated leaves once per shard;
- a ``--tp 2`` checkpoint across the packages, both ways;
- the CLI: ``--tp`` refusals word for word the JAX CLI's, and two gloo
  processes equal to one (the model axis across processes, and whole
  model groups per process), one thread each, on free ports, killed in a
  ``finally``.

Tolerances: f32 losses ``rtol 1e-5, atol 1e-6``, parameters after a few
steps ``rtol 1e-5, atol 1e-5``.
"""

import dataclasses
import importlib.util
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
from simple_distributed_machine_learning_tpu_torch import train as ttrain
from simple_distributed_machine_learning_tpu_torch._tree import to_numpy
from simple_distributed_machine_learning_tpu_torch.interop import (
    shards_from_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt
from simple_distributed_machine_learning_tpu_torch.parallel import (
    Pipeline,
    make_mesh,
)
from simple_distributed_machine_learning_tpu_torch.parallel.staging import (
    flatten_row,
)
from simple_distributed_machine_learning_tpu_torch.train import (
    checkpoint as tck,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(rtol=1e-5, atol=1e-6)
# the JAX pin's model (tests/test_overlap.py::_gpt_losses)
PIN = dict(vocab=16, seq_len=8, d_model=16, n_heads=4, n_layers=2)
SMALL = dict(vocab=32, seq_len=8, d_model=32, n_heads=4, n_layers=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_overlap_tests():
    spec = importlib.util.spec_from_file_location(
        "_jax_overlap_tests", os.path.join(REPO, "tests", "test_overlap.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_from_jax(jst, cfg_kw, S, n_data=1, M=2, **kw):
    """The port's TP pipeline on the JAX stages' shards."""
    cfg = tgpt.GPTConfig(**cfg_kw)
    tst, wd, od = tgpt.make_gpt_stages(0, cfg, S, device="cpu")
    tst = [dataclasses.replace(t, params=sh[0], shards=sh) for t, sh in zip(
        tst, (shards_from_numpy(jax.tree.map(np.asarray, list(s.shards)),
                                "cpu") for s in jst))]
    mp = cfg.n_tensor_parallel
    mesh = make_mesh(S, n_data=n_data, n_model=mp,
                     devices=["cpu"] * (S * n_data * mp))
    return Pipeline(tst, mesh, wd, od, n_microbatches=M, **kw)


def _pin_batch():
    x = jax.random.randint(jax.random.key(1), (4, 8), 0, 16).astype(
        jnp.float32)
    y = jax.random.randint(jax.random.key(2), (4, 8), 0, 16)
    return x, y


def test_gpt_tp_losses_equal_the_jax_pin():
    """The port's ``_gpt_losses(2, "none", n_steps=5, n_stages=2)`` — the
    TP GPT on the JAX TP weights through the 2-stage engine, SGD(0.1,
    momentum 0.5), 2 microbatches — against the JAX dense run of the same
    weights (the JAX TP init slices the dense init of one key)."""
    want = _jax_overlap_tests()._gpt_losses(1, "none", n_steps=5,
                                            n_stages=2)
    jst = jgpt.make_gpt_stages(
        jax.random.key(0), jgpt.GPTConfig(**PIN, n_tensor_parallel=2), 2)[0]
    pipe = _port_from_jax(jst, dict(PIN, n_tensor_parallel=2), 2)
    x, y = _pin_batch()
    x, y = torch.tensor(np.asarray(x)), torch.tensor(np.asarray(y))
    opt = ttrain.sgd(0.1, momentum=0.5)
    params = pipe.init_params()
    state, step = opt.init(params), ttrain.make_train_step(pipe, opt)
    got = []
    for i in range(5):
        params, state, loss = step(params, state, x, y, i)
        got.append(float(loss))
    np.testing.assert_allclose(got, want, **F32)


# ---- TP against the dense build of the same weights -------------------------

def _gather(shards) -> dict:
    """Per-shard GPT stage modules -> the dense stage's numpy tree."""
    trees = [to_numpy(m) for m in shards]
    t0 = trees[0]
    out = {k: t0[k] for k in ("embed", "head") if k in t0}
    blocks = []
    for i in range(len(t0["blocks"])):
        bs = [t["blocks"][i] for t in trees]
        cat = np.concatenate
        blocks.append({
            "ln1": bs[0]["ln1"], "ln2": bs[0]["ln2"],
            "attn": {k: cat([b["attn"][k] for b in bs],
                            0 if k == "wo" else 1)
                     for k in ("wq", "wk", "wv", "wo")},
            "mlp_in": {k: cat([b["mlp_in"][k] for b in bs], -1)
                       for k in ("w", "b")},
            "mlp_out": {"w": cat([b["mlp_out"]["w"] for b in bs], 0),
                        "b": bs[0]["mlp_out"]["b"]}})
    out["blocks"] = blocks
    return out


def _pair(mp, S=2, n_data=1, M=2, dropout=0.0, **kw):
    """The port's TP pipeline and its dense twin, from one seed."""
    cfg_kw = dict(SMALL, dropout_rate=dropout)
    tp_st, wd, od = tgpt.make_gpt_stages(
        0, tgpt.GPTConfig(**cfg_kw, n_tensor_parallel=mp), S, device="cpu")
    d_st = tgpt.make_gpt_stages(0, tgpt.GPTConfig(**cfg_kw), S,
                                device="cpu")[0]
    tp = Pipeline(tp_st, make_mesh(S, n_data=n_data, n_model=mp,
                                   devices=["cpu"] * (S * n_data * mp)),
                  wd, od, n_microbatches=M, **kw)
    dense = Pipeline(d_st, make_mesh(S, n_data=n_data,
                                     devices=["cpu"] * (S * n_data)),
                     wd, od, n_microbatches=M, **kw)
    return tp, dense


def _batch(seed=0, batch=8):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 32, (batch, 8)).astype(
        np.float32)), torch.from_numpy(rng.integers(0, 32, (batch, 8))))


def _train(pipe, opt, n, x, y):
    params = pipe.init_params()
    state, step = opt.init(params), ttrain.make_train_step(pipe, opt)
    losses = []
    for i in range(n):
        params, state, loss = step(params, state, x, y, 10 + i)
        losses.append(float(loss))
    return losses, params


def test_tp_slices_recompose_the_dense_init():
    tp, dense = _pair(4)
    for sh, d in zip(tp.init_params(), dense.init_params()):
        got, want = _gather(sh), to_numpy(d)
        jax.tree.map(np.testing.assert_array_equal, got, want)


@pytest.mark.parametrize("mp,kw", [
    (2, {}), (4, {}), (2, dict(schedule="1f1b")), (2, dict(remat=True)),
    (2, dict(dropout=0.2)), (2, dict(dropout=0.2, schedule="1f1b"))])
def test_tp_trajectory_matches_dense(mp, kw):
    """3 SGD(momentum) steps with clipping: the losses and the gathered
    shards equal the dense run's; dropout draws the dense run's masks."""
    kw = dict(kw)
    tp, dense = _pair(mp, dropout=kw.pop("dropout", 0.0), **kw)
    x, y = _batch()
    opt = ttrain.clip_by_global_norm(ttrain.sgd(0.1, momentum=0.5), 0.5)
    lt, pt = _train(tp, opt, 3, x, y)
    ld, pd = _train(dense, opt, 3, x, y)
    np.testing.assert_allclose(lt, ld, **F32)
    for sh, d in zip(pt, pd):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a, b, rtol=1e-5, atol=1e-5), _gather(sh), to_numpy(d))


def test_full_3d_mesh_gpt_matches_dense():
    """dp x pp x tp = 2 x 2 x 2 in one process against the dense
    data x stage mesh: one step's loss and the global gradient norm."""
    tp, dense = _pair(2, n_data=2)
    x, y = _batch(1)
    lt, gt = tp.loss_and_grads(tp.init_params(), x, y, 3)
    ld, gd = dense.loss_and_grads(dense.init_params(), x, y, 3)
    np.testing.assert_allclose(float(lt), float(ld), **F32)
    np.testing.assert_allclose(
        float(ttrain.global_grad_norm(gt, tp.init_params())),
        float(ttrain.global_grad_norm(gd, dense.init_params())), **F32)


# ---- the clip norm against JAX's replication weights -----------------------

def _packed_grads(pipe, params, grads) -> np.ndarray:
    """Per-tensor gradients -> the JAX ``[S, M, 1, P]`` buffer (an
    unsharded stage's row repeated over the model axis, as JAX stores
    it)."""
    width = max(m.total for m in pipe.metas)
    out = np.zeros((pipe.n_stages, pipe.n_model, 1, width), np.float32)
    for _, s, m, idx in tck._units(params):
        row = flatten_row([grads[i] for i in idx], width).numpy()
        for mm in (range(pipe.n_model) if m is None else (m,)):
            out[s, mm, 0] = row
    return out


def _replication_weights(pipe) -> np.ndarray:
    """JAX ``Pipeline.replication_weights()`` for the port's pipeline:
    ``1 / n_model`` for a stage without shards, 1 for a sharded one."""
    w = np.ones((pipe.n_stages, pipe.n_model, 1, 1), np.float32)
    for s, stage in enumerate(pipe.stages):
        if stage.shards is None:
            w[s] = 1.0 / pipe.n_model
    return w


def _jax_clip_norm(buf, weights) -> float:
    """The norm JAX ``clip_by_global_norm(opt, max_norm, weights)``
    computes, read back from the scale it applies."""
    inner = jopt.Optimizer(lambda p: (), lambda g, s, p: (g, s))
    clip = jopt.clip_by_global_norm(inner, 1e-3, jnp.asarray(weights))
    scaled, _ = clip.update(jnp.asarray(buf), (), None)
    scale = float(np.asarray(scaled).ravel()[np.argmax(np.abs(buf))]
                  / buf.ravel()[np.argmax(np.abs(buf))])
    return 1e-3 / scale - 1e-6


def test_clip_norm_against_jax_replication_weights():
    """Unsharded stages on a model mesh: the port's norm is JAX's. A
    sharded stage: JAX counts its replicated leaves (norms,
    ``mlp_out.b``, embed, head) once per shard; the port counts them once
    — the dense model's norm (ROADMAP.md, Queue C)."""
    from simple_distributed_machine_learning_tpu_torch.models import mlp
    x, y = _batch(2)
    st, wd, od = mlp.make_mlp_stages(0, [16, 32, 10], 2, device="cpu")
    rep = Pipeline(st, make_mesh(2, n_model=2, devices=["cpu"] * 4), wd, od)
    gen = torch.Generator().manual_seed(0)
    xs = torch.randn(8, 16, generator=gen)
    params = rep.init_params()
    _, g = rep.loss_and_grads(params, xs, torch.randint(0, 10, (8,),
                                                        generator=gen), 0)
    np.testing.assert_allclose(
        float(ttrain.global_grad_norm(g, params)),
        _jax_clip_norm(_packed_grads(rep, params, g),
                       _replication_weights(rep)), rtol=1e-5)
    tp, dense = _pair(2)
    params = tp.init_params()
    _, g = tp.loss_and_grads(params, x, y, 0)
    ours = float(ttrain.global_grad_norm(g, params))
    _, gd = dense.loss_and_grads(dense.init_params(), x, y, 0)
    np.testing.assert_allclose(
        ours, float(ttrain.global_grad_norm(gd, dense.init_params())),
        **F32)
    jax_norm = _jax_clip_norm(_packed_grads(tp, params, g),
                              _replication_weights(tp))
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        param_units,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel.tensor import (  # noqa: E501
        is_sharded_leaf,
    )
    replicated, k = 0.0, 0
    for _, m, module in param_units(params):
        for name, _ in module.named_parameters():
            if m and not is_sharded_leaf(name.split(".")):
                replicated += float((g[k] ** 2).sum())
            k += 1
    assert replicated > 0
    np.testing.assert_allclose(jax_norm ** 2, ours ** 2 + replicated,
                               rtol=1e-4)


# ---- checkpoints across the packages ----------------------------------------

def test_tp_checkpoint_crosses_packages_both_ways(tmp_path):
    """The port trains its TP GPT 2 steps on the JAX TP weights and saves
    (``[2, 2, 1, P]``: params and momentum); the JAX TP pipeline restores
    it and computes the port's loss on it; JAX's own save of that state
    restores into the port bit for bit, shard by shard. (JAX cannot take
    the TP training step on this tree, so the port trains.)"""
    cfg = jgpt.GPTConfig(**PIN, n_tensor_parallel=2)
    jst, wd, od = jgpt.make_gpt_stages(jax.random.key(0), cfg, 2)
    jpipe = JPipeline(jst, jmake_mesh(n_stages=2, n_data=1, n_model=2),
                      wd, od, n_microbatches=2)
    pipe = _port_from_jax(jst, dict(PIN, n_tensor_parallel=2), 2)
    x, y = _pin_batch()
    xt, yt = torch.tensor(np.asarray(x)), torch.tensor(np.asarray(y))
    opt = ttrain.sgd(0.1, momentum=0.5)
    params = pipe.init_params()
    state, step = opt.init(params), ttrain.make_train_step(pipe, opt)
    for i in range(2):
        params, state, _ = step(params, state, xt, yt, i)
    with torch.no_grad():
        want = float(pipe.loss(params, xt, yt, 0, deterministic=True))
    port = str(tmp_path / "port.npz")
    tck.save_checkpoint(port, params, state, 2)
    jstate = jopt.sgd(0.1, momentum=0.5).init(jpipe.init_params())
    back = jck.restore_checkpoint(port, pipe=jpipe, opt_treedef_like=jstate)
    assert back["step"] == 2
    got = float(jpipe.loss(back["params"], x, y, jax.random.key(0),
                           deterministic=True))
    np.testing.assert_allclose(got, want, **F32)
    again = str(tmp_path / "jax.npz")
    jck.save_checkpoint(again, back["params"], back["opt_state"], 2)
    st = tck.restore_checkpoint(again, pipe=pipe,
                                opt_treedef_like=opt.init(pipe.init_params()))
    assert st["step"] == 2
    for sh, mine in zip(st["params"], params):
        for a, b in zip(sh, mine):
            jax.tree.map(np.testing.assert_array_equal, to_numpy(a),
                         to_numpy(b))
    for a, b in zip(st["opt_state"], state):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for s, sh in enumerate(st["params"]):
        for m, mod in enumerate(sh):
            jax.tree.map(np.testing.assert_array_equal, to_numpy(mod),
                         jax.tree.map(np.asarray,
                                      jpipe.unpack(back["params"])[s][m]))


def test_repack_refuses_mismatched_model_axes(tmp_path):
    tp, _ = _pair(2)
    one = tgpt.make_gpt_stages(0, tgpt.GPTConfig(**SMALL), 2,
                               device="cpu")[0]
    flat = Pipeline(one, make_mesh(2, devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="model/expert axes must match to "
                                         "repack: source 2x1, target 1x1"):
        tck.repack_checkpoint(str(tmp_path / "a.npz"), str(tmp_path / "b"),
                              tp, flat)
    with pytest.raises(ValueError, match="model/expert axes must match"):
        tck.repack_packed_buffer(np.zeros((2, 2, 1, 4)), tp, flat)


# ---- the CLI ----------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--model", "lenet", "--tp", "2"],
    ["--model", "gpt", "--tp", "2", "--serve-sim", "4"],
    ["--model", "mlp", "--tp", "2", "--chaos", "host-kill@train.step=6",
     "--checkpoint-dir", "CKPT"],
])
def test_cli_tp_refusals_are_the_jax_texts(argv, tmp_path):
    from simple_distributed_machine_learning_tpu import cli as jcli
    from simple_distributed_machine_learning_tpu_torch.cli import main
    argv = [str(tmp_path) if a == "CKPT" else a for a in argv]
    msgs = []
    for fn, extra in ((main, ["--device", "cpu"]), (jcli.main, [])):
        with pytest.raises(SystemExit) as e:
            fn(["--rank", "0", "--data-root", "/nonexistent"] + extra + argv)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "--tp" in msgs[0]


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


@pytest.mark.parametrize("extra,same_as", [
    # the model axis split over the two processes, its sums recomputed
    (["--model", "gpt", "--dryrun", "3", "--stages", "1", "--clip-norm",
      "1.0", "--remat"], ["--tp", "1"]),
    # whole model groups per process, a stage each, under 1F1B
    (["--model", "mlp", "--mlp-dims", "784,32,16,32,10", "--dryrun", "3",
      "--stages", "2", "--schedule", "1f1b", "--microbatches", "2"],
     ["--stages", "2", "--tp", "2"]),
])
def test_two_gloo_processes_at_tp2_equal_one_process(extra, same_as):
    """``--tp 2`` over two processes (GPipe with remat, and 1F1B) prints
    the one-process run's console (the first case against ``--tp 1``: TP
    is the dense model); rank 1 prints nothing."""
    outs = _ranks(extra + ["--tp", "2"])
    one = subprocess.run(CLI + ["--rank", "0"] + extra + same_as,
                         capture_output=True, text=True, env=ENV, cwd=REPO,
                         timeout=180)
    assert one.returncode == 0, one.stderr[-2000:]
    assert _console(outs[0]) == _console(one.stdout)
    assert any(ln.startswith("Test set:") for ln in _console(outs[0]))
    assert "| distributed: 2 processes" in outs[0]
    assert outs[1].strip() == ""


_DROPOUT_WORKER = """
import json, sys
import torch
from simple_distributed_machine_learning_tpu_torch import train
from simple_distributed_machine_learning_tpu_torch.models import gpt
from simple_distributed_machine_learning_tpu_torch.parallel import (
    Pipeline, bootstrap_distributed, make_mesh)
rank, port = int(sys.argv[1]), int(sys.argv[2])
torch.set_num_threads(1)
bootstrap_distributed(rank, 2, "localhost", port)
cfg = gpt.GPTConfig(**json.loads(sys.argv[3]))
st, wd, od = gpt.make_gpt_stages(0, cfg, 1, device="cpu")
pipe = Pipeline(st, make_mesh(1, n_model=2, devices=["cpu"] * 2), wd, od,
                n_microbatches=2)
gen = torch.Generator().manual_seed(4)
x = torch.randint(0, 32, (8, 8), generator=gen).float()
y = torch.randint(0, 32, (8, 8), generator=gen)
opt = train.sgd(0.1, momentum=0.5)
params = pipe.init_params()
state, step = opt.init(params), train.make_train_step(pipe, opt)
out = []
for i in range(3):
    params, state, loss = step(params, state, x, y, 7 + i)
    out.append(float(loss))
print(json.dumps(out))
"""


def test_dropout_masks_agree_across_processes():
    """The model axis split over two gloo processes with dropout 0.2: each
    process draws the replicated activations' masks from the same stream,
    so both report the one-process run's losses (which are the dense
    model's: ``test_tp_trajectory_matches_dense``)."""
    import json
    cfg = dict(SMALL, n_layers=2, dropout_rate=0.2)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DROPOUT_WORKER, str(r), str(port),
         json.dumps(dict(cfg, n_tensor_parallel=2))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ENV,
        cwd=REPO) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    st, wd, od = tgpt.make_gpt_stages(
        0, tgpt.GPTConfig(**cfg, n_tensor_parallel=2), 1, device="cpu")
    pipe = Pipeline(st, make_mesh(1, n_model=2, devices=["cpu"] * 2), wd, od,
                    n_microbatches=2)
    gen = torch.Generator().manual_seed(4)
    x = torch.randint(0, 32, (8, 8), generator=gen).float()
    y = torch.randint(0, 32, (8, 8), generator=gen)
    opt = ttrain.sgd(0.1, momentum=0.5)
    params = pipe.init_params()
    state, step = opt.init(params), ttrain.make_train_step(pipe, opt)
    want = []
    for i in range(3):
        params, state, loss = step(params, state, x, y, 7 + i)
        want.append(float(loss))
    assert outs[0] == outs[1]
    np.testing.assert_allclose(outs[0], want, **F32)

