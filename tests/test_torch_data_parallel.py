"""Multi-process runs of the port against the JAX package's in-process mesh
of the same shape.

Each case is a ``(data x stage)`` mesh split over W processes: this file,
run as a script (``python tests/test_torch_data_parallel.py CASE RANK W
PORT DIR``), is one process of it — torch and the port only, no JAX — and
pytest launches W of them. Every process feeds only its own rows
(``data/sharding.py::host_rows``) and computes:

- loss and gradients (``deterministic=True``) under GPipe and, for the
  GPT, 1F1B;
- eval metrics over a masked batch;
- 4 steps of AdamW with global-norm clipping, replicated and ZeRO-1;
- a collective checkpoint save, and the restore of a JAX checkpoint;
- for LeNet, the loss with dropout on.

The JAX side runs ``Pipeline(stages, make_mesh(n_stages=S, n_data=D))`` on
``tests/conftest.py``'s virtual CPU devices from the same weights
(``interop``), and pytest also runs the port's own one-process mesh of the
same shape (the same function, in-process). Tolerances: against JAX, f32
loss and gradients within ``rtol 1e-5, atol 1e-6`` (as
``tests/test_torch_pipeline_stages.py``; the same
arithmetic, summed in another order), the correct count exact; against
the one-process port, bit-equal (D <= 2: a two-way sum is the same in any
order); ZeRO-1 against the replicated trajectory within ``rtol 1e-6``;
checkpoints bit-equal across packages.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from simple_distributed_machine_learning_tpu_torch import train as ttrain  # noqa: E402,E501
from simple_distributed_machine_learning_tpu_torch.data.sharding import (  # noqa: E402,E501
    host_rows,
)
from simple_distributed_machine_learning_tpu_torch.interop import (  # noqa: E402,E501
    params_from_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt as tgpt  # noqa: E402,E501
from simple_distributed_machine_learning_tpu_torch.models import (  # noqa: E402,E501
    lenet as tlenet,
)
from simple_distributed_machine_learning_tpu_torch.models import mlp as tmlp  # noqa: E402,E501
from simple_distributed_machine_learning_tpu_torch.parallel import (  # noqa: E402,E501
    Pipeline,
    bootstrap_distributed,
    make_mesh,
    param_leaves,
)
from simple_distributed_machine_learning_tpu_torch.parallel.staging import (  # noqa: E402,E501
    flatten_row,
)
from simple_distributed_machine_learning_tpu_torch.train import (  # noqa: E402,E501
    checkpoint as tck,
)

MLP_DIMS = [16, 32, 32, 10]
GPT = dict(vocab=32, seq_len=16, d_model=32, n_heads=2, n_layers=4)
BATCH = 8
STEPS = 4
F32 = dict(rtol=1e-5, atol=1e-6)
#: name -> (model, stages, data, processes, microbatches)
CASES = {
    "mlp-S2D1-W2": ("mlp", 2, 1, 2, 2),
    "mlp-S1D2-W2": ("mlp", 1, 2, 2, 2),
    "mlp-S2D2-W2": ("mlp", 2, 2, 2, 2),
    "mlp-S2D2-W4": ("mlp", 2, 2, 4, 2),
    "lenet-S2D1-W2": ("lenet", 2, 1, 2, 2),
    "gpt-S2D1-W2": ("gpt", 2, 1, 2, 4),
}


def _schedules(model: str) -> tuple[str, ...]:
    return ("gpipe", "1f1b") if model == "gpt" else ("gpipe",)


def _port_pipe(model, S, D, M, schedule, nparams):
    """The port's pipeline on the JAX weights over a ``D x S`` mesh of CPU
    coordinates (this process's share of it when there are several)."""
    if model == "mlp":
        st, wd, od = tmlp.make_mlp_stages(0, MLP_DIMS, S, device="cpu")
    elif model == "lenet":
        st, wd, od = tlenet.make_lenet_stages(0, S, device="cpu")
    else:
        st, wd, od = tgpt.make_gpt_stages(0, tgpt.GPTConfig(**GPT), S,
                                          device="cpu")
    st = [dataclasses.replace(s, params=p)
          for s, p in zip(st, params_from_numpy(nparams, "cpu"))]
    mesh = make_mesh(S, n_data=D, devices=["cpu"] * (S * D))
    return Pipeline(st, mesh, wd, od, n_microbatches=M, schedule=schedule)


def _rows(params, per_tensor) -> dict:
    """This process's stages' packed rows of per-parameter tensors."""
    order = tck._jax_order(params)
    out = {}
    for s, idx in enumerate(order):
        if params[s] is not None:
            vals = [per_tensor[i] for i in idx]
            out[s] = flatten_row(vals, sum(v.numel() for v in vals)).numpy()
    return out


def _work(case: str, workdir: str, tag: str) -> dict:
    """One process's share of a case (every process of the mesh calls
    it; in pytest's own process it is the one-process run)."""
    model, S, D, _, M = CASES[case]
    with open(os.path.join(workdir, "weights.pkl"), "rb") as f:
        nparams = pickle.load(f)
    z = np.load(os.path.join(workdir, "batch.npz"))
    res: dict = {}
    for sched in _schedules(model):
        pipe = _port_pipe(model, S, D, M, sched, nparams)
        lo, hi = host_rows(pipe.mesh, BATCH)
        x, t, w = (torch.from_numpy(z[k][lo:hi]) for k in ("x", "t", "w"))
        params = pipe.init_params()
        loss, grads = pipe.loss_and_grads(params, x, t, None, True, w)
        res[f"{sched}/loss"] = float(loss)
        res[f"{sched}/grads"] = _rows(params, grads)
    pipe = _port_pipe(model, S, D, M, "gpipe", nparams)
    mesh = pipe.mesh
    lo, hi = host_rows(mesh, BATCH)
    x, t, w = (torch.from_numpy(z[k][lo:hi]) for k in ("x", "t", "w"))
    num, den, correct = pipe.eval_metrics(pipe.init_params(), x, t,
                                          weights=w)
    res["metrics"] = (float(num), float(den), int(correct))
    if model == "lenet":
        with torch.no_grad():
            res["dropout/loss"] = float(pipe.loss(pipe.init_params(), x, t,
                                                  7, deterministic=False))
    opt = ttrain.clip_by_global_norm(ttrain.adamw(1e-2), 1.0)
    for mode in ("replicated", "zero1"):
        params = pipe.init_params()
        state = opt.init(params)
        if mode == "zero1":
            state = ttrain.shard_opt_state_zero1(state, mesh, pipe,
                                                 params=params)
        step = ttrain.make_train_step(pipe, opt)
        losses = []
        for i in range(STEPS):
            xi, ti = (torch.from_numpy(z[k][i, lo:hi]) for k in ("xs", "ts"))
            params, state, loss = step(params, state, xi, ti, i)
            losses.append(float(loss))
        res[f"{mode}/losses"] = losses
        res[f"{mode}/params"] = _rows(params, param_leaves(params))
    # the ZeRO-1 run's state, through the collective save
    tck.save_checkpoint(os.path.join(workdir, f"port-{tag}.npz"), params,
                        state, STEPS, extra={"epoch": 1})
    sgd = ttrain.sgd(0.1, momentum=0.5)
    params = pipe.init_params()
    like = ttrain.shard_opt_state_zero1(sgd.init(params), mesh, pipe,
                                        params=params)
    st = tck.restore_checkpoint(os.path.join(workdir, "jax.npz"), pipe=pipe,
                                opt_treedef_like=like)
    res["restored/params"] = _rows(st["params"], param_leaves(st["params"]))
    opt_state = st["opt_state"]
    res["restored/opt"] = (
        {s: t.numpy() for s, t in zip(opt_state.ranges, opt_state.inner)}
        if isinstance(opt_state, ttrain.Zero1State) else
        _rows(st["params"], opt_state))
    res["restored/ranges"] = getattr(opt_state, "ranges", None)
    return res


# -- pytest side ---------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_side(case: str, workdir: str):
    """Weights, batches and a JAX checkpoint into ``workdir``; the JAX
    mesh's loss, gradients, eval metrics (and 1F1B's)."""
    import jax
    import jax.numpy as jnp

    from simple_distributed_machine_learning_tpu import make_mesh as jmesh
    from simple_distributed_machine_learning_tpu.models import gpt as jgpt
    from simple_distributed_machine_learning_tpu.models import (
        lenet as jlenet,
    )
    from simple_distributed_machine_learning_tpu.models import mlp as jmlp
    from simple_distributed_machine_learning_tpu.parallel.pipeline import (
        Pipeline as JPipeline,
    )
    from simple_distributed_machine_learning_tpu.train import (
        checkpoint as jck,
    )
    from simple_distributed_machine_learning_tpu.train import (
        optimizer as jopt,
    )
    model, S, D, _, M = CASES[case]
    key = jax.random.key(0)
    if model == "mlp":
        jst, wd, od = jmlp.make_mlp_stages(key, MLP_DIMS, S)
    elif model == "lenet":
        jst, wd, od = jlenet.make_lenet_stages(key, S)
    else:
        jst, wd, od = jgpt.make_gpt_stages(key, jgpt.GPTConfig(**GPT), S)
    nparams = jax.tree.map(np.asarray, [s.params for s in jst])
    with open(os.path.join(workdir, "weights.pkl"), "wb") as f:
        pickle.dump(nparams, f)
    rng = np.random.default_rng(sum(map(ord, case)))

    def batch(n=None):
        shape = (BATCH,) if n is None else (n, BATCH)
        if model == "mlp":
            x = rng.standard_normal(shape + (MLP_DIMS[0],))
            t = rng.integers(0, 10, shape)
        elif model == "lenet":
            x = rng.standard_normal(shape + (28, 28, 1))
            t = rng.integers(0, 10, shape)
        else:
            x = rng.integers(0, GPT["vocab"], shape + (GPT["seq_len"],))
            t = rng.integers(0, GPT["vocab"], shape + (GPT["seq_len"],))
        return x.astype(np.float32), t.astype(np.int32)

    x, t = batch()
    xs, ts = batch(STEPS)
    w = np.array([1, 1, 0, 1, 1, 0, 1, 1], np.float32)
    np.savez(os.path.join(workdir, "batch.npz"), x=x, t=t, w=w, xs=xs,
             ts=ts)
    out = {}
    for sched in _schedules(model):
        jpipe = JPipeline(jst, jmesh(n_stages=S, n_data=D,
                                     devices=jax.devices()[:S * D]), wd, od,
                          n_microbatches=M, schedule=sched)
        buf = jpipe.init_params()
        loss, g = jax.jit(lambda b: jpipe.loss_and_grads(
            b, jnp.asarray(x), jnp.asarray(t), jax.random.key(0), True,
            jnp.asarray(w)))(buf)
        out[f"{sched}/loss"], out[f"{sched}/grads"] = float(loss), \
            np.asarray(g)
    n, d, c = jax.jit(lambda b: jpipe.eval_metrics(
        b, jnp.asarray(x), jnp.asarray(t), jax.random.key(0),
        jnp.asarray(w)))(buf)
    out["metrics"] = (float(n), float(d), int(c))
    # a JAX checkpoint the port restores: the buffer moved off its init
    # and a momentum buffer of its own
    jbuf = buf + 0.5
    jstate = jopt.sgd(0.1, momentum=0.5).init(jbuf)
    jstate = jax.tree.map(lambda a: a - 0.25, jstate)
    jck.save_checkpoint(os.path.join(workdir, "jax.npz"), jbuf, jstate, 3)
    out["jax_ckpt"] = (np.asarray(jbuf),
                       np.asarray(jax.tree.leaves(jstate)[0]))
    out["jpipe"], out["jck"] = jpipe, jck
    return out


def _launch(case: str, workdir: str) -> list[dict]:
    """The W processes of ``case``; their results, by rank."""
    W = CASES[case][3]
    for attempt in range(2):
        port = _free_port()
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), case, str(r), str(W),
             str(port), workdir], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(W)]
        errs = []
        try:
            for p in procs:
                _, err = p.communicate(timeout=240)
                errs.append((p.returncode, err))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if attempt == 0 and any("ddress already in use" in e for _, e in errs):
            continue
        for rc, err in errs:
            assert rc == 0, err[-3000:]
        out = []
        for r in range(W):
            with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _equal_rows(got: dict, want: dict) -> None:
    for s, row in got.items():
        assert np.array_equal(row, want[s]), s


@pytest.mark.parametrize("case", list(CASES))
def test_processes_match_jax_mesh_and_one_process(case, tmp_path):
    model, S, D, W, M = CASES[case]
    workdir = str(tmp_path)
    torch.set_num_threads(1)
    jx = _jax_side(case, workdir)
    ranks = _launch(case, workdir)
    one = _work(case, workdir, "one")
    for r, res in enumerate(ranks):
        for sched in _schedules(model):
            np.testing.assert_allclose(res[f"{sched}/loss"],
                                       jx[f"{sched}/loss"], rtol=1e-5)
            assert res[f"{sched}/loss"] == one[f"{sched}/loss"]
            jg = jx[f"{sched}/grads"]
            assert res[f"{sched}/grads"], f"rank {r} holds no stage"
            for s, row in res[f"{sched}/grads"].items():
                np.testing.assert_allclose(row, jg[s, 0, 0, :len(row)],
                                           **F32)
            _equal_rows(res[f"{sched}/grads"], one[f"{sched}/grads"])
        jn, jd, jc = jx["metrics"]
        np.testing.assert_allclose(res["metrics"][:2], (jn, jd), rtol=1e-5)
        assert res["metrics"][2] == jc
        assert res["metrics"] == one["metrics"]
        if model == "lenet":
            # dropout on: the masks cross the process boundary with the
            # generator state, so the loss is the one-process run's
            assert res["dropout/loss"] == one["dropout/loss"]
            assert res["dropout/loss"] != res["gpipe/loss"]
        np.testing.assert_allclose(res["zero1/losses"],
                                   res["replicated/losses"], rtol=1e-6)
        for s, row in res["zero1/params"].items():
            np.testing.assert_allclose(row, res["replicated/params"][s],
                                       rtol=1e-6, atol=1e-7)
        assert res["zero1/losses"] == one["zero1/losses"]
        _equal_rows(res["zero1/params"], one["zero1/params"])
        # the JAX checkpoint, restored into this process's rows and slices
        jbuf, jmom = jx["jax_ckpt"]
        for s, row in res["restored/params"].items():
            assert np.array_equal(row, jbuf[s, 0, 0, :len(row)])
        for s, row in res["restored/opt"].items():
            lo, hi = ((0, len(row)) if res["restored/ranges"] is None
                      else res["restored/ranges"][s])
            assert np.array_equal(row, jmom[s, 0, 0, lo:hi])
    # the processes' collective save: the one-process file, and it
    # restores into the JAX mesh
    port_w = np.load(os.path.join(workdir, "port-w.npz"))
    port_1 = np.load(os.path.join(workdir, "port-one.npz"))
    assert sorted(port_w.files) == sorted(port_1.files)
    for k in port_w.files:
        assert np.array_equal(port_w[k], port_1[k]), k
    st = jx["jck"].restore_checkpoint(os.path.join(workdir, "port-w.npz"),
                                      pipe=jx["jpipe"])
    jparams = np.asarray(st["params"])
    for s, row in one["zero1/params"].items():
        assert np.array_equal(jparams[s, 0, 0, :len(row)], row)


def _child(case: str, rank: int, world: int, port: int,
           workdir: str) -> None:
    torch.set_num_threads(1)
    bootstrap_distributed(rank, world, "localhost", port, timeout_s=120)
    res = _work(case, workdir, "w")
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
           int(sys.argv[4]), sys.argv[5])
