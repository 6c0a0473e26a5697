"""Serving across processes: ``--serve-sim`` and ``--scenario`` with
``--world_size > 1`` and the tensor-parallel engine over a model mesh
whose coordinates lie in several processes.

- The JAX pin. No JAX test serves across processes, so the JAX CLI runs
  here over two CPU processes (``tests/_jax_serve_ranks.py``, which sets
  the JAX engine's ``kv_drift`` to ``(0, 0)``: its analyzer module does
  not import under jax 0.9). ``--scenario steady`` prints the same lines
  on every rank of both packages; ``--serve-sim 4 --serve-tp 2`` completes
  the same requests and tokens and prints ``| serve: tp 2``.
- The engine over two gloo processes at a small width (2 layers, 4 heads,
  d_model 64): greedy streams equal on both ranks and equal to the
  one-process tp 2 and tp 1 engines'; sampled streams equal across the
  ranks; speculation and a LoRA tenant under the mesh; ``(T/W) x
  n_layers`` plain-K4 calls and ``2 x n_layers`` model sums per decode
  call in each process; T = 4 over W = 2 held to one process's log-probs
  (f32, ``rtol=atol=1e-5``, the local pair summed first).
- The lockstep: rank 1's clock runs slower and later, and the two ranks
  still admit, decode and retire the same requests on the same ticks.
- The program linter: each rank traces one TP decode tick, and
  ``rules.check_ranks`` over both traces finds every model sum matched.

Children run one torch thread on free ports with a timeout, and are
killed in a ``finally``. A child of this file runs it as a script
(``python tests/test_torch_serve_ranks.py engine RANK WORLD PORT TP
OUT``); it imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import socket
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from simple_distributed_machine_learning_tpu_torch.models import (  # noqa: E402,E501
    gpt as tgpt,
)

SMALL = dict(vocab=64, seq_len=32, d_model=64, n_heads=4, n_layers=2)
ENGINE = dict(n_slots=4, block_size=8, attn_kernel="fused")
SIM = dict(n_requests=6, rate=400.0, seed=5, prompt_lens=(3, 5, 8),
           max_new_tokens=6, sampled_fraction=0.5, temperature=0.9, top_k=12)
TIMEOUT = 240


# -- the weights and the reference engines (parent and children alike) ------

def _stages():
    """The small GPT with seeded noise (std 0.5) on every weight, so
    greedy streams are not one repeated token."""
    from simple_distributed_machine_learning_tpu_torch.interop import (
        params_from_numpy,
        params_to_numpy,
    )
    cfg = tgpt.GPTConfig(**SMALL)
    stages = tgpt.make_gpt_stages(0, cfg, 1, device="cpu")[0]
    rng = np.random.default_rng(0)

    def noisy(t):
        if isinstance(t, dict):
            return {k: noisy(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [noisy(v) for v in t]
        return (t + rng.normal(0.0, 0.5, t.shape)).astype(np.float32)

    return cfg, stages, params_from_numpy(
        noisy(params_to_numpy([s.params for s in stages])), "cpu")


def _draft():
    dcfg = tgpt.GPTConfig(**{**SMALL, "n_layers": 1})
    return dcfg, tgpt.make_gpt_stages(1, dcfg, 1, device="cpu")[0]


def _engine(tp, mesh, clock=time.monotonic, **kw):
    from simple_distributed_machine_learning_tpu_torch.serve import (
        InferenceEngine,
        ServeMetrics,
    )
    cfg, stages, params = _stages()
    cfg = dataclasses.replace(cfg, n_tensor_parallel=tp)
    return InferenceEngine(stages, cfg, params=params, mesh=mesh,
                           metrics=ServeMetrics(), clock=clock,
                           device="cpu", **{**ENGINE, **kw})


def _workload():
    from simple_distributed_machine_learning_tpu_torch.serve import (
        SimConfig,
    )
    from simple_distributed_machine_learning_tpu_torch.serve.simulator import (  # noqa: E501
        build_workload,
    )
    return build_workload(SimConfig(**SIM), SMALL["vocab"])[1]


def _spec_kw():
    dcfg, dst = _draft()
    return dict(draft_stages=dst, draft_cfg=dcfg, spec_k=3)


def _tenant(cfg):
    """A rank-4 tenant with A and B drawn from one seed (a fresh adapter's
    B is zero: the base model)."""
    gen = torch.Generator().manual_seed(11)
    L, d = cfg.n_layers, cfg.d_model
    return {k: 0.3 * torch.randn(shape, generator=gen) for k, shape in (
        ("aq", (L, d, 4)), ("bq", (L, 4, d)), ("av", (L, d, 4)),
        ("bv", (L, 4, d)))}


def _adapter_kw(tp):
    from simple_distributed_machine_learning_tpu_torch.serve import (
        AdapterStore,
    )
    cfg = dataclasses.replace(tgpt.GPTConfig(**SMALL), n_tensor_parallel=tp)
    return dict(adapters=AdapterStore(cfg, 4, ENGINE["n_slots"],
                                      device="cpu"))


def _greedy(specs):
    return [dict(s, temperature=0.0, top_k=None) for s in specs[:4]]


def _drain(eng, specs, adapter=None):
    if adapter is not None:
        eng.register_adapter("t0", _tenant(eng.cfg))
    hs = [eng.submit(**s, **({"adapter": "t0"} if adapter else {}))
          for s in specs]
    eng.drain()
    return [h.tokens for h in hs]


@torch.no_grad()
def _prefill_row(tp, mesh):
    """One prompt's last-position log-probs through the TP slot prefill
    forward (f32), over this process's coordinates of ``mesh``."""
    cfg, _, params = _stages()
    cfg = dataclasses.replace(cfg, n_tensor_parallel=tp)
    _, H, tail, shards = tgpt._serve_plan(cfg, mesh, torch.device("cpu"),
                                          "test")
    embed, blocks, head = tgpt._serve_trees(
        tgpt.pack_tp_serve_params(params, tp, shards.devices, shards.owned),
        tp)
    L, dh = SMALL["n_layers"], SMALL["d_model"] // SMALL["n_heads"]
    pools = [[torch.zeros(L, 1, H, SMALL["seq_len"], dh)
              for _ in shards.owned] for _ in range(2)]
    prompt = torch.from_numpy(
        np.random.default_rng(2).integers(0, SMALL["vocab"], (1, 9)))
    return tgpt._slot_prefill_fwd(blocks, embed, head, *pools, prompt, 0, H,
                                  tail=tail)[2]


# -- the child: one process of a two-process engine --------------------------

def _child(rank: int, world: int, port: int, tp: int, out: str) -> None:
    from simple_distributed_machine_learning_tpu_torch.analysis import (
        kernels,
        trace,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel import mesh
    from simple_distributed_machine_learning_tpu_torch.serve import (
        SimConfig,
        simulate,
    )
    torch.set_num_threads(1)
    mesh.bootstrap_distributed(rank, world, "localhost", port)
    tmesh = mesh.make_mesh(1, n_model=tp, devices=["cpu"] * tp)
    # rank 1's own clock starts 1000 s later and runs at 0.7 the rate
    t0 = time.monotonic()
    raw = ((lambda: time.monotonic()) if rank == 0 else
           (lambda: 1000.0 + t0 + 0.7 * (time.monotonic() - t0)))
    eng = _engine(tp, tmesh, clock=raw)
    res = {"rank": rank, "owned": list(tgpt.tp_serve_shards(tmesh)),
           "raw_clock": raw(), "k4": [], "sums": [], "sum_bytes": [],
           "drift": [], "ticks": []}
    decode = eng._decode

    def counted(*args):
        if "events" not in res:
            prog = trace.trace_program(decode, *args, name="paged_decode")
            res["events"] = [dict(prim=e.prim, axes=list(e.axes),
                                  payload=e.payload,
                                  ranks=list(e.ranks), peer=e.peer,
                                  tag=e.tag, site=e.site)
                             for e in prog.events]
        w0 = dict(mesh.WIRE)
        with kernels.record_launches() as log:
            result = decode(*args)
        res["k4"].append(len(log))
        res["sums"].append(mesh.WIRE["sums"] - w0["sums"])
        res["sum_bytes"].append(mesh.WIRE["sum_bytes"] - w0["sum_bytes"])
        return result

    eng._decode = counted
    step = eng.step

    def logged():
        n = step()
        live, predicted = eng.kv_drift()
        res["drift"].append([live, predicted])
        res["ticks"].append([eng._tick_count, sorted(
            (r.rid, r.slot, r.state) for r in eng.requests.values())])
        return n

    eng.step = logged
    report = simulate(eng, SimConfig(**SIM))
    res["completed"] = report["completed"]
    res["streams"] = [eng.requests[i].tokens for i in sorted(eng.requests)]
    res["ttft"] = [eng.requests[i].ttft_s for i in sorted(eng.requests)]
    if tp == 2:
        res["spec"] = _drain(_engine(tp, tmesh, **_spec_kw()),
                             _greedy(_workload()))
        res["lora"] = _drain(_engine(tp, tmesh, **_adapter_kw(tp)),
                             _workload()[:3], adapter=True)
    res["row"] = _prefill_row(tp, tmesh).tolist()
    res["wire"] = dict(mesh.WIRE)
    with open(out, "w") as f:
        json.dump(res, f)


# -- launching -------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1",
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


def _launch(cmds: list[list[str]]) -> list[subprocess.CompletedProcess]:
    """Run the commands together (one per rank), each with a timeout;
    kill whatever is left. Every rank must exit 0."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=_env(),
                              cwd=REPO) for c in cmds]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            results.append(subprocess.CompletedProcess(p.args, p.returncode,
                                                       out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r in results:
        assert r.returncode == 0, f"a rank failed:\n{r.stderr[-3000:]}"
    return results


def _ranks(*jobs, world: int = 2) -> list[list]:
    """Launches of a CLI over ``world`` processes each, all at once (each
    job ``(argv, entry)`` on ports of its own); the ranks' results per
    job. A rendezvous that lost its port to another test is relaunched
    once."""
    for attempt in range(2):
        cmds = []
        for argv, entry in jobs:
            port = _free_port()
            cmds += [[sys.executable, *entry, "--rank", str(r),
                      "--world_size", str(world), "--master_addr",
                      "localhost", "--master_port", str(port),
                      "--heartbeat-port", str(_free_port()), "--data-root",
                      "/nonexistent", *argv] for r in range(world)]
        try:
            res = _launch(cmds)
        except AssertionError as e:
            if attempt == 0 and "ddress already in use" in str(e):
                continue
            raise
        return [res[i * world:(i + 1) * world] for i in range(len(jobs))]


PORT_CLI = ["-m", "simple_distributed_machine_learning_tpu_torch.cli",
            "--device", "cpu"]
JAX_CLI = ["tests/_jax_serve_ranks.py"]


def _children(tmp_path) -> dict[int, list[dict]]:
    """Two-process engines at tp 2 and at tp 4, launched together; each
    rank's record by tp."""
    for attempt in range(2):
        cmds, outs = [], {}
        for tp in (2, 4):
            port = _free_port()
            outs[tp] = [str(tmp_path / f"tp{tp}-r{r}.json") for r in range(2)]
            cmds += [[sys.executable, os.path.abspath(__file__), "engine",
                      str(r), "2", str(port), str(tp), outs[tp][r]]
                     for r in range(2)]
        try:
            _launch(cmds)
        except AssertionError as e:
            if attempt == 0 and "ddress already in use" in str(e):
                continue
            raise
        return {tp: [json.load(open(o)) for o in paths]
                for tp, paths in outs.items()}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    return _children(tmp_path_factory.mktemp("engines"))


@pytest.fixture(scope="module")
def tp2(engines):
    return engines[2]


@pytest.fixture(scope="module")
def tp4(engines):
    return engines[4]


def _one_process(tp, **kw):
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        make_mesh,
    )
    return _engine(tp, make_mesh(1, n_model=tp, devices=["cpu"] * tp)
                   if tp > 1 else None, **kw)


# -- the engine across two processes ----------------------------------------

def test_greedy_and_sampled_streams_equal_one_process_tp2_and_tp1(tp2):
    """Both ranks serve the whole trace and emit the same streams; each
    stream, greedy or sampled, equals the one-process tp 2 engine's and
    the tp 1 engine's (a sum of two parts is the same bits either way
    round, and every rank samples from the same rows)."""
    r0, r1 = tp2
    assert r0["completed"] == r1["completed"] == SIM["n_requests"]
    assert r0["streams"] == r1["streams"]
    specs = _workload()
    one_tp2 = _drain(_one_process(2), specs)
    one_tp1 = _drain(_one_process(1), specs)
    assert r0["streams"] == one_tp2 == one_tp1
    greedy = [s for s, sp in zip(r0["streams"], specs)
              if sp["temperature"] == 0.0]
    sampled = [s for s, sp in zip(r0["streams"], specs)
               if sp["temperature"] > 0.0]
    assert greedy and sampled
    assert len({tuple(s) for s in greedy}) > 1


def test_speculation_and_a_lora_tenant_under_the_mesh(tp2):
    """A TP target's speculation (its two dispatches) and one LoRA tenant
    serve over the two-process mesh the streams of one process."""
    r0, r1 = tp2
    assert r0["spec"] == r1["spec"] == _drain(
        _one_process(2, **_spec_kw()), _greedy(_workload()))
    assert r0["lora"] == r1["lora"] == _drain(
        _one_process(2, **_adapter_kw(2)), _workload()[:3], adapter=True)
    assert r0["lora"] != _drain(_one_process(2), _workload()[:3])


@pytest.mark.parametrize("tp", [2, 4])
def test_k4_and_the_model_sums_per_decode_call_in_each_process(tp, tp2,
                                                              tp4):
    """Each process launches the plain K4 ``(T/W) x n_layers`` times per
    decode call, on its own coordinates, and puts ``2 x n_layers`` sums of
    ``[n_slots, 1, d_model]`` f32 rows on the wire (the attention output
    and the MLP pair of every layer); its pool's resident bytes equal the
    byte model's per-shard row on every tick."""
    L = SMALL["n_layers"]
    for r, res in enumerate(tp2 if tp == 2 else tp4):
        assert res["owned"] == list(range(r * tp // 2, (r + 1) * tp // 2))
        assert res["k4"] and set(res["k4"]) == {tp // 2 * L}
        assert set(res["sums"]) == {2 * L}
        assert set(res["sum_bytes"]) == {
            2 * L * ENGINE["n_slots"] * SMALL["d_model"] * 4}
        assert all(live == predicted for live, predicted in res["drift"])
        assert any(live > 0 for live, _ in res["drift"])
        assert res["wire"]["sends"] == 0


def test_tp4_over_two_processes_within_tolerance(tp4):
    """T = 4 over W = 2: each process sums its pair first, then the two
    partial sums cross the wire, where one process sums the four in a
    row; the log-probs agree in f32 to ``rtol=atol=1e-5``, and the ranks'
    streams are equal."""
    r0, r1 = tp4
    assert r0["row"] == r1["row"]
    want = _prefill_row(4, _one_process(4).mesh).numpy()
    np.testing.assert_allclose(np.asarray(r0["row"]), want, rtol=1e-5,
                               atol=1e-5)
    assert r0["streams"] == r1["streams"]
    assert r0["completed"] == SIM["n_requests"]


def test_ranks_stay_in_lockstep_under_skewed_clocks(tp2):
    """Rank 1's own clock reads 1000 s later and runs at 0.7 the rate;
    every read is rank 0's, broadcast, so the two ranks hold the same
    requests in the same slots and states after every tick, and stamp the
    same first-token times."""
    r0, r1 = tp2
    assert r1["raw_clock"] - r0["raw_clock"] > 900
    assert r0["ticks"] == r1["ticks"]
    assert len(r0["ticks"]) > SIM["max_new_tokens"]
    assert r0["ttft"] == r1["ttft"]
    assert r0["wire"]["broadcasts"] == r1["wire"]["broadcasts"] > 0
    assert r0["wire"]["broadcast_bytes"] == 8 * r0["wire"]["broadcasts"]


def test_check_ranks_finds_every_model_sum_matched(tp2):
    """Each rank traced its first TP decode tick; ``check_ranks`` over the
    two traces finds every model sum matched (``2 x n_layers`` psums over
    ranks (0, 1)), and flags a rank that drops one."""
    from simple_distributed_machine_learning_tpu_torch.analysis.rules import (
        check_ranks,
    )

    def program(res, drop=False):
        ev = [types.SimpleNamespace(**dict(e, ranks=tuple(e["ranks"]),
                                           axes=tuple(e["axes"]), where=""))
              for e in res["events"]]
        return types.SimpleNamespace(events=ev[:-1] if drop else ev)

    sums = [e for e in tp2[0]["events"] if e["prim"] == "psum"]
    assert len(sums) == 2 * SMALL["n_layers"]
    assert {tuple(e["ranks"]) for e in sums} == {(0, 1)}
    assert check_ranks([program(tp2[0]), program(tp2[1])]) == []
    bad = check_ranks([program(tp2[0]), program(tp2[1], drop=True)])
    assert [f.rule for f in bad] == ["ppermute-deadlock.branch-divergent"]


# -- the CLI across two processes, held to the JAX CLI's ---------------------

def _lines(out: str, prefix: str) -> list[str]:
    return [ln for ln in out.splitlines() if ln.startswith(prefix)]


def test_scenario_steady_lines_equal_the_jax_ranks():
    """``--scenario steady --world_size 2``: every rank of both packages
    prints the same scenario lines (the virtual clock makes them exact),
    and each port rank equals a one-process run."""
    argv = ["--scenario", "steady"]
    jax_ranks, port_ranks = _ranks((argv, JAX_CLI), (argv, PORT_CLI))
    want = _lines(jax_ranks[0].stdout, "| scenario")
    assert len(want) == 3 and want[-1] == "| scenario: SLO ATTAINED"
    for r in (*jax_ranks, *port_ranks):
        assert _lines(r.stdout, "| scenario") == want


def test_serve_sim_counts_equal_the_jax_ranks(tmp_path):
    """``--serve-sim 4 --serve-tp 2`` over two processes: both packages'
    ranks complete the same requests and tokens and print ``| serve: tp
    2``; the port's ranks, in lockstep, print equal TTFT and TPOT
    figures; at tp 1 each port rank serves the whole trace on its own."""
    argv = ["--model", "gpt", "--serve-sim", "4", "--serve-max-new", "4"]
    tp2 = argv + ["--serve-tp", "2"]
    jax_ranks, port_ranks, port_tp1 = _ranks((tp2, JAX_CLI), (tp2, PORT_CLI),
                                             (argv, PORT_CLI))
    done = re.compile(r"\| serve: (\d+/\d+) requests completed, (\d+) "
                      r"tokens")
    want = done.search(jax_ranks[0].stdout).groups()
    assert want == ("4/4", "16")
    for r in (*jax_ranks, *port_ranks):
        assert done.search(r.stdout).groups() == want
        assert "| serve: tp 2" in r.stdout
    # the request stamps come from the lockstep clock; tokens/s is each
    # process's own metrics clock
    stamps = [re.sub(r", [\d.]+ tok/s", "",
                     _lines(r.stdout, "| serve: 4/4")[0]) for r in port_ranks]
    assert stamps[0] == stamps[1] and "ttft p50/p95" in stamps[0]
    for r in port_tp1:
        assert done.search(r.stdout).groups() == want


def test_supervised_ranks_write_the_journal_from_rank_zero_alone(tmp_path):
    """``--serve-chaos`` behind the supervisor at ``--serve-tp 2`` with
    ``--telemetry-dir``: both ranks crash, rebuild and recover in
    lockstep; rank 0 alone journals into the directory (two writers
    corrupt a journal: a JAX rank recovers the other's tokens), each
    rank appends its own whole ``metrics.jsonl`` record."""
    tele = tmp_path / "tele"
    argv = ["--model", "gpt", "--serve-sim", "4", "--serve-max-new", "4",
            "--serve-tp", "2", "--serve-chaos", "engine-crash@serve.tick=2",
            "--serve-deadline-ms", "60000", "--telemetry-dir", str(tele)]
    r0, r1 = _ranks((argv, PORT_CLI))[0]
    for r in (r0, r1):
        assert "4/4 requests completed, 16 tokens" in r.stdout
        assert "supervisor running, 1 restart(s)" in r.stdout
    assert f"journal {tele}/journal.jsonl" in r0.stdout
    assert str(tele) not in _lines(r1.stdout, "| serve: supervised")[0]
    records = [json.loads(ln) for ln in open(tele / "journal.jsonl")]
    assert sum(rec["ev"] == "submit" for rec in records) == 4
    assert len(open(tele / "metrics.jsonl").read().splitlines()) == 2


@pytest.mark.parametrize("extra,line", [
    (["--serve-replicas", "2"], "| serve: fleet 2 alive (2 in rotation)"),
    (["--lint"], "| serve --lint: preflight clean"),
])
def test_fleet_and_lint_serve_over_the_two_process_mesh(extra, line):
    """``--serve-replicas 2`` (two supervised replicas, each a TP engine
    over the one two-process mesh) and ``--lint`` (each rank lints its
    own programs, then serves) at ``--serve-tp 2``: both ranks serve 4/4
    and print ``line``."""
    argv = ["--model", "gpt", "--serve-sim", "4", "--serve-max-new", "4",
            "--serve-tp", "2", *extra]
    for r in _ranks((argv, PORT_CLI))[0]:
        assert "| serve: 4/4 requests completed, 16 tokens" in r.stdout
        assert line in r.stdout and "| serve: tp 2" in r.stdout


@pytest.mark.parametrize("argv,text", [
    (["--serve-tp", "4"], "--serve-tp 4 needs 4 devices, have 2 (on CPU: "
     "XLA_FLAGS=--xla_force_host_platform_device_count=4)"),
    (["--serve-tp", "3"], "--serve-tp 3 must divide the model's head count "
     "(4)"),
])
def test_serve_tp_the_world_cannot_hold_exits_with_the_jax_text(argv, text):
    """Over two processes a T above the world's two devices exits with the
    JAX CLI's device-count text, and a T that does not divide the heads
    with its heads text — on every rank, before the rendezvous (so no
    rank waits for a peer, or is taken down by its watchdog)."""
    from simple_distributed_machine_learning_tpu_torch.cli import main
    for rank in (0, 1):
        with pytest.raises(SystemExit) as e:
            main(["--rank", str(rank), "--world_size", "2", "--device",
                  "cpu", "--model", "gpt", "--serve-sim", "4", *argv])
        assert str(e.value) == text


def test_a_mesh_the_processes_cannot_split_names_make_mesh():
    """T below the world size: ``make_mesh``'s split text, which the CLI
    checks before the rendezvous (``check_split`` needs no group)."""
    from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (
        check_split,
    )
    with pytest.raises(ValueError, match=r"^4 processes cannot split a "
                       r"1x1x2x1x1 \(data x stage x model x seq x expert\) "
                       r"mesh"):
        check_split(4, n_model=2)
    check_split(2, n_model=2)
    check_split(2, n_model=4)


def test_one_process_clock_is_not_wrapped():
    """Without a group (one process, or tp 1) the engine reads its own
    clock: nothing is broadcast."""
    from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (
        AxisView,
        LockstepClock,
        lockstep_clock,
    )

    def clock():
        return 1.5

    assert lockstep_clock(clock, None) is clock
    assert lockstep_clock(clock, AxisView.local("model", 2)) is clock
    assert _one_process(2)._clock is time.monotonic
    view = AxisView("model", 2, range(1), (0, 1), group=object())
    lock = lockstep_clock(clock, view)
    assert isinstance(lock, LockstepClock) and lock.src == 0
    assert lockstep_clock(lock, view) is lock


def test_serve_tp_restores_a_checkpoint(tmp_path, capsys):
    """``--serve-tp 2 --checkpoint-dir D`` with a checkpoint in D restores
    the trained weights into the stage layout and serves them over the
    TP mesh (the restore's stage mesh once took the serving mesh's name,
    leaving the TP engine without one)."""
    from simple_distributed_machine_learning_tpu_torch.cli import main
    base = ["--rank", "0", "--device", "cpu", "--data-root", "/nonexistent",
            "--model", "gpt", "--checkpoint-dir", str(tmp_path)]
    main(base + ["--dryrun", "1"])
    capsys.readouterr()
    main(base + ["--serve-sim", "2", "--serve-max-new", "3",
                 "--serve-tp", "2"])
    out = capsys.readouterr().out
    assert "| serve: restored params from" in out
    assert "| serve: 2/2 requests completed" in out
    assert "| serve: tp 2" in out


if __name__ == "__main__":
    mode, rank, world, port, tp, out = sys.argv[1:7]
    assert mode == "engine"
    _child(int(rank), int(world), int(port), int(tp), out)
