"""The program linter's claim on the model and expert axes
(``analysis/rules.py``, ``analysis/trace.py``), on the CPU.

Every replicated leaf of a stage sharded over the ``model`` axis (the
norms, ``w2.b``/``mlp_out.b``, ``embed``, ``head``), or over the ``expert``
axis (everything but the stacked experts), is stored once per shard, and
the copies must take the same gradient, or they drift apart. The linter
claims each such gradient replicated over the stage's axis
(``Pipeline._reduce_grads``) and flags ``unreduced-gradient.missing-reduce``
where it still varies there. The sharded leaves, their optimizer state and
the head-sharded pools of TP serving stay unclaimed. Each seeded defect
here stands next to its clean twin:

- the 2 x 2 x 2 (data x stage x model) TP MLP step under GPipe and 1F1B,
  the port's counterpart of ``tests/test_analysis.py::
  test_tp_pipeline_step_clean``; with ``model_sum`` cut to one shard's
  part, and with ``tie`` handing back shard 0's copy untied;
- a small GPT at tp 2 (the same two defects), and with 4 experts at ep 2
  (the replicated leaves left untied over ``expert``);
- two gloo processes, one coordinate each, that both drop the sum
  (``_ModelSum``'s all-reduce at tp 2, the ties at ep 2): ``check_ranks``
  sees the same sequence on both, so only each rank's own report can
  catch it;
- ``lint_serve`` at tp 2 stays clean.

The JAX side. ``_visit_shard_map`` (``simple_distributed_machine_learning_
tpu/analysis/rules.py``) flags every axis of size > 1 still in a value's
varying set where its ``out_specs`` claim replication, the model and
expert axes included. Under jax 0.9 the JAX linter cannot run on this
step: in its child interpreter (``tests/_jax_lint_reference.py``'s shim)
the TP pipeline step ends in ``unreduced-gradient.trace-error`` ("Custom
VJP bwd rule must produce an output with the same type ... varying manual
axes do not match"), for the clean step and the defect alike — the known
custom-VJP cause (``ROADMAP.md``, "Standing notes"). So the port is held
to that rule's code and to the contract ``test_tp_pipeline_step_clean``
records, as the off-contract fixtures of
``tests/test_torch_program_lint.py`` are. Trace-only: nothing launches.
"""

import json
import os
import re
import socket
import subprocess
import sys

import pytest
import torch

from simple_distributed_machine_learning_tpu_torch.analysis import (
    abstractify,
    analyze,
    spec,
)
from simple_distributed_machine_learning_tpu_torch.analysis import (
    trace as trace_lib,
)
from simple_distributed_machine_learning_tpu_torch.models import gpt
from simple_distributed_machine_learning_tpu_torch.parallel import (
    tensor as tensor_lib,
)
from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (
    make_mesh,
)
from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (
    Pipeline,
)
from simple_distributed_machine_learning_tpu_torch.train.optimizer import (
    adamw,
    sgd,
)
from simple_distributed_machine_learning_tpu_torch.train.step import (
    make_train_step,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")
SMALL = dict(vocab=32, seq_len=8, d_model=16, n_heads=2, n_layers=2)
MISSING = "unreduced-gradient.missing-reduce"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flagged(report) -> dict:
    """``{axis: [message, ...]}`` of the report's missing reductions."""
    out: dict = {}
    for f in report.findings:
        assert f.rule == MISSING, report.format()
        axes = re.search(r"mesh axis\(es\) \[([^\]]*)\]", f.message).group(1)
        for a in axes.replace("'", "").split(", "):
            out.setdefault(a, []).append(f.message)
    return out


def _mlp_step(schedule: str):
    """The 2 x 2 x 2 TP MLP train step of ``test_tp_pipeline_step_clean``:
    two column -> row pairs ``[16]*4 + [10]``, SGD with momentum, batch 8
    — its report, and the claims its trace noted."""
    stages, wire, out = tensor_lib.make_mlp_tp_stages(0, [16] * 4 + [10], 2,
                                                      2, device="cpu")
    mesh = make_mesh(2, n_data=2, n_model=2, devices=["cpu"] * 8)
    pipe = Pipeline(stages, mesh, wire, out, n_microbatches=2,
                    schedule=schedule)
    opt = sgd(0.1, momentum=0.5)
    live = pipe.init_params()
    args = (abstractify(live), abstractify(opt.init(live)),
            spec((8, 16), torch.float32), spec((8,), torch.int64, 0, 9), 0)
    step = make_train_step(pipe, opt)
    prog = trace_lib.trace_program(step, *args)
    return analyze(step, *args, mesh=mesh), prog


def _gpt_step(**kw):
    """A small GPT's train step (AdamW, batch 4) on a one-stage mesh of its
    ``n_tensor_parallel`` x ``n_expert_parallel`` coordinates."""
    cfg = gpt.GPTConfig(**SMALL, **kw)
    stages, wire, out = gpt.make_gpt_stages(0, cfg, 1, device="cpu")
    tp, ep = cfg.n_tensor_parallel, cfg.n_expert_parallel
    mesh = make_mesh(1, n_model=tp, n_expert=ep, devices=["cpu"] * (tp * ep))
    pipe = Pipeline(stages, mesh, wire, out)
    opt = adamw(1e-3)
    live = pipe.init_params()
    ids = spec((4, 8), torch.int64, 0, 31)
    return analyze(make_train_step(pipe, opt), abstractify(live),
                   abstractify(opt.init(live)), ids, ids, 0, mesh=mesh)


def _drop_model_sum(monkeypatch):
    """BUG: each model coordinate keeps only its own partial product."""
    monkeypatch.setattr(tensor_lib, "model_sum",
                        lambda parts, group=None, axis="model", size=None:
                        parts[0])


def _break_tie(monkeypatch):
    """BUG: the replicated leaf is shard 0's copy, untied — each copy keeps
    only the gradient its own uses give it (the others none)."""
    monkeypatch.setattr(tensor_lib, "tie",
                        lambda copies, axis="model": list(copies)[0])


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_tp_pipeline_step_clean(schedule):
    """The clean 2 x 2 x 2 step lints clean (the JAX contract), and only
    the replicated leaf of each pair, ``w2.b``, is claimed: once per stage
    and shard, over ``model``."""
    report, prog = _mlp_step(schedule)
    assert report.ok(fail_on="warning"), report.format()
    claims = [(axes, what) for _, axes, what in prog.claims]
    assert len(claims) == 4
    assert all(axes == frozenset({"model"}) and "'w2.b'" in what
               for axes, what in claims), claims


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("defect", [_drop_model_sum, _break_tie])
def test_tp_pipeline_step_defects_flagged_on_model(schedule, defect,
                                                   monkeypatch):
    """A dropped model sum and a broken tie are each an ERROR on the
    ``model`` axis, at the replicated leaf's gradient; nothing is flagged
    on the data axis, whose sum is still there."""
    defect(monkeypatch)
    report, _ = _mlp_step(schedule)
    flagged = _flagged(report)
    assert set(flagged) == {"model"}, report.format()
    assert all("replicated leaf 'w2.b'" in m for m in flagged["model"])


@pytest.mark.parametrize("defect", [None, _drop_model_sum, _break_tie])
def test_gpt_tp2_step(defect, monkeypatch):
    """A GPT at tp 2: clean as built; with the model sum dropped or the
    ties broken, the replicated leaves' gradients vary over ``model``."""
    if defect is not None:
        defect(monkeypatch)
    report = _gpt_step(n_tensor_parallel=2)
    if defect is None:
        assert report.ok(fail_on="warning"), report.format()
        return
    flagged = _flagged(report)
    assert set(flagged) == {"model"}, report.format()
    assert any("ln1" in m for m in flagged["model"])
    assert any("'head." in m for m in flagged["model"])


@pytest.mark.parametrize("untied", [False, True])
def test_gpt_ep2_step(untied, monkeypatch):
    """A GPT with 4 experts at ep 2: clean as built; with the replicated
    leaves left untied over ``expert`` (every leaf handled as a shard's
    own), their gradients vary over ``expert``. The stacked experts are
    never claimed."""
    if untied:
        orig = gpt._grad_sync_non_tp

        def untie(shards, axis, path=(), sharded=None):
            return orig(shards, axis, path, lambda p: True)
        monkeypatch.setattr(gpt, "_grad_sync_non_tp", untie)
    report = _gpt_step(n_experts=4, n_expert_parallel=2)
    if not untied:
        assert report.ok(fail_on="warning"), report.format()
        return
    flagged = _flagged(report)
    assert set(flagged) == {"expert"}, report.format()
    assert any("router" in m for m in flagged["expert"])
    assert not any("experts" in m for m in flagged["expert"])


def test_outside_a_trace_the_notes_change_nothing():
    """``grad_sync`` in one process and ``tie`` of one copy return their
    argument itself outside a trace: no node, no launch, the same bits."""
    x = torch.randn(3, requires_grad=True)
    assert tensor_lib.grad_sync(x) is x
    assert tensor_lib.grad_sync(x, axis="expert") is x
    assert tensor_lib.tie([x]) is x


_RANK_WORKER = """
import json, re, sys
import torch
from simple_distributed_machine_learning_tpu_torch.analysis import (
    abstractify, analyze, spec)
from simple_distributed_machine_learning_tpu_torch.models import gpt
from simple_distributed_machine_learning_tpu_torch.parallel import (
    Pipeline, bootstrap_distributed, make_mesh)
from simple_distributed_machine_learning_tpu_torch.parallel import (
    tensor as tensor_lib)
from simple_distributed_machine_learning_tpu_torch.train import (
    adamw, make_train_step, sgd)
rank, port, axis = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
bootstrap_distributed(rank, 2, "localhost", port)
if axis == "model":
    stages, wire, out = tensor_lib.make_mlp_tp_stages(0, [16, 16, 10], 1, 2,
                                                      device="cpu")
    mesh = make_mesh(1, n_model=2, devices=["cpu"] * 2)
    pipe = Pipeline(stages, mesh, wire, out, n_microbatches=2)
    opt = sgd(0.1, momentum=0.5)
    batch = (spec((8, 16), torch.float32), spec((8,), torch.int64, 0, 9))
else:
    cfg = gpt.GPTConfig(**json.loads(sys.argv[4]), n_experts=4,
                        n_expert_parallel=2)
    stages, wire, out = gpt.make_gpt_stages(0, cfg, 1, device="cpu")
    mesh = make_mesh(1, n_expert=2, devices=["cpu"] * 2)
    pipe = Pipeline(stages, mesh, wire, out)
    opt = adamw(1e-3)
    batch = (spec((4, 8), torch.int64, 0, 31),) * 2
live = pipe.init_params()


def lint():
    r = analyze(make_train_step(pipe, opt), abstractify(live),
                abstractify(opt.init(live)), *batch, 0, mesh=mesh)
    return [[f.rule, re.search(r"axis\\(es\\) (\\[[^\\]]*\\])",
                               f.message).group(1) if "axis(es)" in
             f.message else "", f.message] for f in r.findings]


out = {"clean": lint()}
if axis == "model":
    # BUG, on both ranks: the model sum's all-reduce is dropped, so each
    # process keeps its own shard's partial product
    tensor_lib._ModelSum.forward = staticmethod(
        lambda ctx, z, group, axis: z.view_as(z))
else:
    # BUG, on both ranks: the replicated leaves are left untied
    orig = gpt._grad_sync_non_tp
    gpt._grad_sync_non_tp = (lambda shards, axis, path=(), sharded=None:
                             orig(shards, axis, path, lambda p: True))
out["dropped"] = lint()
torch.distributed.destroy_process_group()
print(json.dumps(out))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("axis,leaf", [("model", "'w2.b'"),
                                       ("expert", "'head.")])
def test_a_sum_every_rank_drops_is_flagged_on_each_rank(axis, leaf):
    """Two gloo processes, one coordinate each, lint their own step — the
    TP MLP pair on ``model``, the MoE GPT on ``expert`` — clean as built
    (the expert stage's gradient sums are noted over ``expert``, not
    ``model``). With the sum dropped on both ranks — ``_ModelSum``'s
    all-reduce cut, or the replicated leaves untied — the collective
    sequences still match, so ``check_ranks`` has nothing to see; each
    rank's own report flags the replicated leaves' gradients on the
    axis."""
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_WORKER, str(r),
                               str(port), axis, json.dumps(SMALL)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=ENV, cwd=REPO)
             for r in range(2)]
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
    for got in outs:
        assert got["clean"] == [], got["clean"]
        assert got["dropped"], "a sum dropped on every rank passed"
        for rule, axes, message in got["dropped"]:
            assert (rule, axes) == (MISSING, f"['{axis}']"), message
        assert any(leaf in m for _, _, m in got["dropped"])


def test_lint_serve_tp2_stays_clean():
    """The TP serving programs write head-sharded pools in place (each
    coordinate's own, unclaimed) and sum the residual stream in
    ``_tp_attn_tail``: clean at tp 2, whose MLP pair ties ``mlp_out.b``."""
    from simple_distributed_machine_learning_tpu_torch.analysis.programs import (  # noqa: E501
        ServeSpec,
        lint_serve,
    )
    cfg = gpt.GPTConfig(**dict(SMALL, seq_len=24), n_tensor_parallel=2)
    stages = gpt.make_gpt_stages(0, gpt.GPTConfig(**dict(SMALL, seq_len=24)),
                                 1, device="cpu")[0]
    mesh = make_mesh(1, n_model=2, devices=["cpu"] * 2)
    s = ServeSpec(cfg, n_slots=3, max_len=16, kv_layout="paged",
                  block_size=4, prefill_chunk=3, prompt_lens=(4, 6),
                  attn_kernel="fused")
    report = lint_serve(stages, s, mesh=mesh, device="cpu")
    assert report.ok(fail_on="warning"), report.format()
