"""The static collective-bytes gauge (``telemetry/ici.py``,
``Telemetry.set_step_probe``) against the JAX package's, on the CPU.

``from_report`` and ``record`` read only a report's cost rows, and the
JAX module imports nothing of ``jax.core`` at its top: both run here in
process on the same rows, and must give the same record and the same
gauges. The gauge's number is then held to what the traced step really
sends: in one process the stage hops of a pipeline step (closed form),
across two gloo processes each rank's own sends — what the wire's
counter (``parallel/mesh.py::WIRE``) reads on a real step — plus the
loss sum over the world, named byte for byte.
"""

import os
import socket

import pytest
import torch

from simple_distributed_machine_learning_tpu import analysis as janalysis  # noqa: F401,E501 - report is stdlib
from simple_distributed_machine_learning_tpu.analysis.report import (
    CollectiveCost as JCost,
)
from simple_distributed_machine_learning_tpu.analysis.report import (
    Report as JReport,
)
from simple_distributed_machine_learning_tpu.telemetry import ici as jici
from simple_distributed_machine_learning_tpu.telemetry import (
    registry as jregistry,
)
from simple_distributed_machine_learning_tpu_torch.analysis import (
    analyze,
    spec,
)
from simple_distributed_machine_learning_tpu_torch.analysis.report import (
    CollectiveCost,
    Finding,
    Report,
    Severity,
)
from simple_distributed_machine_learning_tpu_torch.telemetry import ici
from simple_distributed_machine_learning_tpu_torch.telemetry import (
    registry as tregistry,
)

ROWS = [
    ("psum", ("data",), 4, 1024, 1536, 1, "grad sum"),
    ("ppermute", ("stage",), 2, 128, 128, 6, "stage hop"),
    ("all_gather", ("model",), 2, 64, 64, 2, "gather"),
    ("psum", ("model",), 2, 256, 256, 3, "model sum"),
    ("all_to_all", ("expert",), 4, 512, 384, 1, "dispatch"),
    ("ppermute", ("stage",), 2, 128, 128, 6, "stage hop back"),
    ("send", (), 2, 4096, 4096, 1, "wire"),
]


def _reports():
    ours = Report(costs=[CollectiveCost(*r) for r in ROWS])
    theirs = JReport(costs=[JCost(*r) for r in ROWS])
    return ours, theirs


@pytest.mark.parametrize("steps,top", [(1, 5), (2, 3), (3, 10)])
def test_from_report_equals_jax(steps, top):
    ours, theirs = _reports()
    assert ici.from_report(ours, steps, top) == jici.from_report(
        theirs, steps, top)


def test_record_sets_the_same_gauges():
    ours, theirs = _reports()
    treg, jreg = tregistry.MetricsRegistry(), jregistry.MetricsRegistry()
    ici.record(treg, ici.from_report(ours, top=10))
    jici.record(jreg, jici.from_report(theirs, top=10))

    def gauges(text):
        return sorted(ln for ln in text.splitlines()
                      if ln.startswith("ici_"))
    assert gauges(treg.prometheus_text()) == gauges(jreg.prometheus_text())
    assert "ici_bytes_per_step 8448" in treg.prometheus_text()


def test_failed_trace_and_empty_inputs():
    failed = Report(findings=[Finding("trace.failed", Severity.ERROR, "x")])
    assert ici.from_report(failed) is None
    assert ici.from_report(None) is None
    ici.record(None, {"ici_bytes_per_step": 1, "collectives": []})
    ici.record(tregistry.MetricsRegistry(), None)

    def broken(x):
        return x @ torch.zeros(3, 5)

    assert ici.expected_ici_bytes(broken, spec((4, 4), torch.float32)) \
        is None


def _mlp_pipe(S, D, M=2):
    from simple_distributed_machine_learning_tpu_torch.models.mlp import (
        make_mlp_stages,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (
        make_mesh,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (  # noqa: E501
        Pipeline,
    )
    stages, wire, out = make_mlp_stages(0, [16] * S + [10], S, device="cpu")
    mesh = make_mesh(S, n_data=D, devices=["cpu"] * (S * D))
    return Pipeline(stages, mesh, wire, out, n_microbatches=M)


@pytest.mark.parametrize("S,D", [(2, 1), (4, 1), (2, 2)])
def test_gauge_counts_every_stage_hop(S, D):
    """One GPipe step over S stages and D replicas in one process: D·M·
    (S-1) activation hops forward and as many cotangents back, each a
    microbatch of b rows of the 16-wide wire in f32."""
    from simple_distributed_machine_learning_tpu_torch.analysis.trace import (
        abstractify,
    )
    from simple_distributed_machine_learning_tpu_torch.train.optimizer import (
        sgd,
    )
    from simple_distributed_machine_learning_tpu_torch.train.step import (
        make_train_step,
    )
    M, b = 2, 3
    pipe = _mlp_pipe(S, D, M)
    opt = sgd(0.1)
    live = pipe.init_params()
    info = ici.expected_ici_bytes(
        make_train_step(pipe, opt), abstractify(live),
        abstractify(opt.init(live)), spec((D * M * b, 16), torch.float32),
        spec((D * M * b,), torch.int64, 0, 9), 0, mesh=pipe.mesh, top=50)
    hops = [c for c in info["collectives"] if c["prim"] == "ppermute"]
    assert len(hops) == 2 * D * M * (S - 1)
    assert {c["bytes_per_step"] for c in hops} == {b * 16 * 4}
    psum = sum(c["bytes_per_step"] for c in info["collectives"]
               if c["prim"] == "psum")
    assert info["ici_bytes_per_step"] == 2 * D * M * (S - 1) * b * 64 + psum


def test_probe_lands_in_the_epoch_record(tmp_path):
    """A 2-stage Trainer with a session: the run's first batch registers
    the probe, every epoch record carries the traced step's bytes."""
    from simple_distributed_machine_learning_tpu_torch.telemetry import (
        session as tm,
    )
    from simple_distributed_machine_learning_tpu_torch.train.trainer import (
        TrainConfig,
        Trainer,
    )
    from simple_distributed_machine_learning_tpu_torch.data.mnist import (
        Dataset,
    )
    import numpy as np
    rng = np.random.default_rng(0)
    x = rng.standard_normal((48, 16)).astype(np.float32)
    y = rng.integers(0, 10, 48).astype(np.int32)
    ds = Dataset(x, y)
    tele = tm.Telemetry(str(tmp_path / "tele"))
    Trainer(_mlp_pipe(2, 1), ds, ds,
            TrainConfig(epochs=2, batch_size=12, print_throughput=False),
            telemetry=tele).fit()
    import json
    with open(tmp_path / "tele" / tm.METRICS_FILE) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    epochs = [r for r in recs if r.get("kind") == "epoch"]
    assert len(epochs) == 2
    # M = 2 microbatches of 6 rows, one hop each way per microbatch
    want = 2 * 2 * 6 * 16 * 4
    assert [r["ici_bytes_per_step"] for r in epochs] == [want, want]
    assert epochs[0]["ici_top_collectives"][0]["prim"] == "ppermute"
    assert f"ici_bytes_per_step {want}" in open(
        tmp_path / "tele" / tm.PROM_FILE).read()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(rank, world, port, out):
    """One rank of a 2-stage gloo pipeline: its traced step's gauge, then
    one real step's wire bytes."""
    import json

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    from simple_distributed_machine_learning_tpu_torch.analysis.trace import (
        abstractify,
    )
    from simple_distributed_machine_learning_tpu_torch.models.mlp import (
        make_mlp_stages,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        mesh as mesh_lib,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (  # noqa: E501
        Pipeline,
    )
    from simple_distributed_machine_learning_tpu_torch.train.optimizer import (
        sgd,
    )
    from simple_distributed_machine_learning_tpu_torch.train.step import (
        make_train_step,
    )
    mesh_lib.bootstrap_distributed(rank, world, "localhost", port)
    stages, wire, o = make_mlp_stages(0, [16, 16, 10], 2, device="cpu")
    mesh = mesh_lib.make_mesh(2, devices=["cpu"] * 2)
    pipe = Pipeline(stages, mesh, wire, o, n_microbatches=2)
    opt = sgd(0.1)
    params = pipe.init_params()
    state = opt.init(params)
    step = make_train_step(pipe, opt)
    x = torch.randn(8, 16)
    t = torch.randint(0, 10, (8,))
    info = ici.expected_ici_bytes(step, abstractify(params),
                                  abstractify(state), x, t, 0, mesh=mesh,
                                  top=50)
    before = dict(mesh_lib.WIRE)
    step(params, state, x, t, 0)
    sent = mesh_lib.WIRE["bytes"] - before["bytes"]
    with open(out, "w") as f:
        json.dump({"info": info, "sent": sent}, f)
    torch.distributed.destroy_process_group()


def test_gauge_reconciles_with_the_wire_across_processes(tmp_path):
    """Two gloo processes, one stage each: each rank's gauge is its own
    sends — stage 0's activations and each microbatch's dropout-stream
    state, stage 1's cotangents, 2 microbatches x 4 rows x 16 x 4 B each —
    exactly the wire's count on the real step, plus the loss's two f64
    values summed over the world (a psum over 2, 16 B at 2·(n-1)/n),
    which the wire's point-to-point counter does not see."""
    import json

    import torch.multiprocessing as mp
    port = _free_port()
    outs = [str(tmp_path / f"r{r}.json") for r in range(2)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, 2, port, outs[r]))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
        assert p.exitcode == 0
    for r in range(2):
        with open(outs[r]) as f:
            got = json.load(f)
        info = got["info"]
        sends = sum(c["bytes_per_step"] for c in info["collectives"]
                    if c["prim"] == "send")
        state = torch.Generator().get_state().numel()
        assert sends == got["sent"] == 2 * 4 * 16 * 4 + (
            2 * state if r == 0 else 0)
        extra = info["ici_bytes_per_step"] - sends
        assert extra == 16
        assert [c for c in info["collectives"] if c["prim"] == "psum"
                and c["bytes_per_step"]] == [
            {"prim": "psum", "axes": [], "bytes_per_step": 16,
             "where": c["where"]} for c in info["collectives"]
            if c["prim"] == "psum" and c["bytes_per_step"]]


def test_analyze_costs_match_the_gauge():
    """``analyze``'s cost table and the gauge read the same rows."""
    from simple_distributed_machine_learning_tpu_torch.analysis.trace import (
        abstractify,
    )
    from simple_distributed_machine_learning_tpu_torch.train.optimizer import (
        sgd,
    )
    from simple_distributed_machine_learning_tpu_torch.train.step import (
        make_train_step,
    )
    pipe = _mlp_pipe(2, 2)
    opt = sgd(0.1)
    live = pipe.init_params()
    args = (abstractify(live), abstractify(opt.init(live)),
            spec((8, 16), torch.float32), spec((8,), torch.int64, 0, 9), 0)
    report = analyze(make_train_step(pipe, opt), *args, mesh=pipe.mesh)
    info = ici.expected_ici_bytes(make_train_step(pipe, opt), *args,
                                  mesh=pipe.mesh)
    assert info["ici_bytes_per_step"] == sum(c.total_bytes
                                             for c in report.costs)
