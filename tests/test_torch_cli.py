"""The port's training CLI on the CPU (``--device cpu``): the reference's
flags and defaults, its console lines, checkpoints and ``--eval-only``,
and a one-line exit naming the ROADMAP item for every flag whose path is
not ported."""

import json
import re

import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu.cli import (
    build_parser as jax_parser,
)
from simple_distributed_machine_learning_tpu_torch.cli import (
    build_parser,
    main,
)
from simple_distributed_machine_learning_tpu_torch.ops import (
    flash_attention as fa,
)

TRAIN_RE = re.compile(
    r"^Train Epoch: (\d+) \[(\d+)/(\d+) \((\d+)%\)\]\tLoss: (\d+\.\d{6})$")
TEST_RE = re.compile(
    r"^Test set: Average loss: (\d+\.\d{4}), Accuracy: (\d+)/(\d+) "
    r"\((\d+)%\)$")
EPOCH_RE = re.compile(r"^\| epoch (\d+): (\d+\.\d) samples/sec$")
BASE = ["--rank", "0", "--world_size", "1", "--device", "cpu",
        "--data-root", "/nonexistent"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread while this module runs: its models are
    tiny, and under a multi-process test run more threads only contend
    for the same cores. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_lines(out):
    lines = [l for l in out.split("\n") if l]
    assert all(TRAIN_RE.match(l) or TEST_RE.match(l) or EPOCH_RE.match(l)
               for l in lines), lines
    return lines


def test_ported_flags_and_defaults_equal_the_jax_parser():
    ours = vars(build_parser().parse_args(["--rank", "0"]))
    ref = vars(jax_parser().parse_args(["--rank", "0"]))
    assert ours.pop("device") is None        # the port's own flag
    assert ours == ref
    # the choices of every shared option are the reference's too
    theirs = {a.dest: a.choices for a in jax_parser()._actions}
    for a in build_parser()._actions:
        if a.dest in theirs:
            assert a.choices == theirs[a.dest], a.dest


@pytest.mark.parametrize("model,extra,n_train_lines", [
    ("lenet", ["--dryrun", "2"], 1),
    ("mlp", ["--mlp-dims", "784,32,10", "--dryrun", "12"], 2),
    ("mlp", ["--mlp-dims", "784,32,10", "--dryrun", "3", "--bf16"], 1),
    ("lenet", ["--dryrun", "2", "--bf16"], 1),
    ("mlp", ["--mlp-dims", "784,32,10", "--epochs", "2",
             "--max-steps-per-epoch", "3", "--optimizer", "adamw",
             "--lr", "1e-3", "--lr-schedule", "warmup-cosine",
             "--warmup-steps", "2", "--clip-norm", "1.0", "--zero1",
             "--shuffle"], 2),
])
def test_cli_runs_on_the_cpu(capsys, model, extra, n_train_lines):
    main(BASE + ["--model", model] + extra)
    lines = _reference_lines(capsys.readouterr().out)
    assert len([l for l in lines if TRAIN_RE.match(l)]) == n_train_lines
    assert lines[0] == "Train Epoch: 1 [0/6000 (0%)]" + lines[0][28:]
    tests = [TEST_RE.match(l) for l in lines if TEST_RE.match(l)]
    assert tests and tests[-1].group(3) == "1000"


def test_cli_mlp_learns(capsys):
    main(BASE + ["--model", "mlp", "--mlp-dims", "784,32,10", "--dryrun",
                 "40"])
    acc = int(re.findall(r"Accuracy: (\d+)/1000", capsys.readouterr().out)[0])
    assert acc > 500                             # chance is 100


def test_cli_gpt_flash_dryrun_goes_through_the_flash_wrappers(capsys):
    fa.flash_forward.launches = fa.flash_dq.launches = 0
    fa.flash_dkv.launches = 0
    main(BASE + ["--model", "gpt", "--attn", "flash", "--dryrun", "2",
                 "--generate", "4"])
    out = capsys.readouterr().out
    assert "Train Epoch: 1 [0/6000 (0%)]" in out
    assert "Test set: Average loss:" in out
    assert re.search(r"\| sample tokens \(prompt 16 \+ 4 generated\): "
                     r"\[(\d+, ){19}\d+\]", out)
    # on the CPU the wrappers run their plain versions and count nothing
    assert (fa.flash_forward.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == (0, 0, 0)


def test_cli_gpt_text_corpus(tmp_path, capsys):
    corpus = tmp_path / "c.txt"
    corpus.write_bytes(b"the quick brown fox jumps over the lazy dog. " * 40)
    main(BASE + ["--model", "gpt", "--text-corpus", str(corpus),
                 "--dryrun", "1", "--batch-size", "8", "--generate", "3"])
    out = capsys.readouterr().out
    assert "| sample (16-byte prompt + 3 generated):" in out


def test_cli_checkpoint_resume_and_eval_only(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    args = BASE + ["--model", "mlp", "--mlp-dims", "784,32,10",
                   "--max-steps-per-epoch", "5", "--checkpoint-dir", ck]
    main(args + ["--epochs", "1", "--async-checkpoint"])
    trained = capsys.readouterr().out
    main(args + ["--epochs", "2"])
    out = capsys.readouterr().out
    assert f"| resumed from {ck}/state.npz at epoch 2 (step 5)" in out
    assert "Train Epoch: 2 [0/6000 (0%)]" in out
    assert "Train Epoch: 1" not in out
    final = re.findall(r"Accuracy: (\d+)/", out)[-1]
    main(args + ["--epochs", "2", "--eval-only"])
    out = capsys.readouterr().out
    assert "Train Epoch" not in out
    assert re.findall(r"Accuracy: (\d+)/", out)[-1] == final
    assert re.findall(r"Accuracy: (\d+)/", trained)
    # --no-resume ignores the checkpoint, and --eval-only on an empty dir
    # says it evaluates fresh weights
    main(args + ["--epochs", "1", "--no-resume"])
    assert "resumed" not in capsys.readouterr().out
    main(BASE + ["--model", "mlp", "--mlp-dims", "784,32,10", "--eval-only",
                 "--checkpoint-dir", str(tmp_path / "empty")])
    assert "no checkpoint found" in capsys.readouterr().out


def test_cli_metrics_json(tmp_path):
    path = tmp_path / "m.jsonl"
    main(BASE + ["--model", "mlp", "--mlp-dims", "784,32,10", "--epochs",
                 "2", "--max-steps-per-epoch", "2", "--metrics-json",
                 str(path)])
    assert len(path.read_text().splitlines()) == 2


@pytest.mark.parametrize("flag,item", [
    # the overlapped collectives (6d.4) and tensor-parallel serving (6e)
    # are ported: each case runs, or exits with the JAX CLI's own text
    # where the JAX CLI refuses it
    (["--overlap", "ring", "--sp", "2", "--model", "mlp"], "jax"),
    # serving across processes (the rest of 6c) is ported: two ranks
    (["--serve-sim", "4", "--model", "gpt", "--world_size", "2"], "ranks"),
    (["--scenario", "list", "--world_size", "2"], "ranks"),
    (["--overlap", "ring", "--tp", "2"], "jax"),
    (["--overlap", "ring", "--sp", "2"], "jax"),
    (["--overlap", "ring", "--ep", "2"], "jax"),
    (["--overlap", "ring", "--experts", "4", "--dryrun", "1"], None),
    (["--overlap", "ring", "--model", "mlp", "--dryrun", "1"], None),
    (["--overlap", "ring", "--ep", "2", "--dp", "2", "--stages", "2"],
     "jax"),
    (["--lint", "--dryrun", "1"], "lint"),
    (["--lint-only"], "lint"),
    (["--serve-tp", "2", "--serve-sim", "4", "--model", "gpt"], None),
])
def test_unported_flags_exit_naming_their_item(flag, item, capsys):
    """Every path is ported. ``--overlap ring`` and ``--serve-tp`` run
    (``None``), or exit with the JAX CLI's text where it refuses the flags
    beside them (``"jax"``). The linter (7.4) is ported (``"lint"``):
    ``--lint`` prints the clean preflight and trains, ``--lint-only``
    stops after it. ``--serve-sim`` and ``--scenario`` with ``--world_size
    2`` (``"ranks"``) run on both ranks of a two-process launch, each
    printing what one process prints."""
    if item == "ranks":
        ranks = _two_ranks(flag)
        one = _two_ranks(flag, world=1)[0]
        if "--scenario" in flag:
            want = [ln for ln in one.stdout.splitlines()
                    if ln.startswith("| ")]
            assert len(want) == 13
        else:
            want = ["| serve: fresh-initialized params"]
        for r in ranks:
            assert r.returncode == 0, r.stderr[-2000:]
            assert [ln for ln in r.stdout.splitlines()
                    if ln in want] == want
            assert ("| serve: 4/4 requests completed" in r.stdout) == (
                "--serve-sim" in flag)
        return
    if item == "lint":
        main(BASE + flag)
        out = capsys.readouterr().out
        assert "analysis: train_step + eval_step" in out
        assert "| --lint: preflight clean" in out
        assert ("Test set:" in out) == ("--lint" in flag)
        return
    if item is None:
        main(BASE + flag)
        out = capsys.readouterr().out
        assert ("| serve: tp 2" in out if "--serve-tp" in flag
                else "Test set:" in out)
        return
    with pytest.raises(SystemExit) as e:
        main(BASE + flag)
    msg = str(e.value)
    if item == "jax":
        assert msg == _exit_text(_jax_train_cli, flag)
    else:
        assert f"ROADMAP.md, Queue A: {item}" in msg and flag[0] in msg
    assert "\n" not in msg


def _two_ranks(flag, world=2):
    """``flag`` on the CLI over ``world`` CPU processes (free ports, one
    torch thread, a timeout, killed in a ``finally``)."""
    import os
    import socket
    import subprocess
    import sys

    def free():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]

    port = free()
    argv = flag[:flag.index("--world_size")] + flag[
        flag.index("--world_size") + 2:]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "simple_distributed_machine_learning_tpu_torch"
         ".cli", "--rank", str(r), "--world_size", str(world),
         "--master_port", str(port), "--heartbeat-port", str(free()),
         "--device", "cpu", "--data-root", "/nonexistent", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        for r in range(world)]
    try:
        return [subprocess.CompletedProcess(p.args, p.returncode, *out)
                for p, out in ((p, p.communicate(timeout=180))
                               for p in procs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.mark.parametrize("argv", [
    ["--sp", "2"],
    ["--ep", "2"],
    ["--model", "gpt", "--ep", "2"],
    ["--ep", "2", "--dp", "2", "--stages", "2"],
    ["--model", "lenet", "--sp", "2", "--experts", "4"],
    ["--model", "gpt", "--experts", "4", "--serve-sim", "4"],
    ["--model", "gpt", "--sp", "2", "--attn", "ring", "--serve-sim", "4"],
    ["--model", "gpt", "--experts", "4", "--ep", "2", "--chaos",
     "host-kill@train.step=6", "--checkpoint-dir", "CK"],
    ["--model", "mlp", "--sp", "2", "--chaos", "host-kill@train.step=6",
     "--checkpoint-dir", "CK"],
])
def test_sp_and_ep_refusals_are_the_jax_clis(tmp_path, argv):
    """``--sp``, ``--experts`` and ``--ep`` train; what they are refused
    with is the JAX CLI's text, word for word."""
    argv = [str(tmp_path / "ck") if a == "CK" else a for a in argv]
    ours = _exit_text(lambda a: main(BASE + a), argv)
    theirs = _exit_text(_jax_train_cli, argv)
    assert ours == theirs and "\n" not in ours


@pytest.mark.parametrize("argv", [["--sp", "2"], ["--sp", "2", "--attn",
                                                  "flash"]])
def test_sp_with_a_dense_attention_is_the_jax_config_error(argv):
    """``--sp`` without ring or Ulysses: ``GPTConfig``'s ValueError, as the
    JAX CLI raises it."""
    argv = ["--model", "gpt"] + argv
    with pytest.raises(ValueError) as ours:
        main(BASE + argv)
    with pytest.raises(ValueError) as theirs:
        _jax_train_cli(argv)
    assert str(ours.value) == str(theirs.value)


def _metrics(tmp_path, argv, name):
    path = tmp_path / f"{name}.jsonl"
    main(BASE + ["--model", "gpt", "--dryrun", "2", "--batch-size", "8",
                 "--metrics-json", str(path)] + argv)
    [m] = [json.loads(ln) for ln in path.read_text().splitlines()]
    return [m["train_loss"], m["eval_loss"]]


@pytest.mark.parametrize("argv,twin", [
    (["--sp", "2", "--attn", "ring", "--stages", "2"], ["--stages", "2"]),
    (["--sp", "2", "--attn", "ulysses", "--stages", "2", "--schedule",
      "1f1b", "--microbatches", "2"],
     ["--stages", "2", "--microbatches", "2"]),
    (["--experts", "4", "--ep", "2", "--attn", "flash", "--stages", "2"],
     ["--experts", "4", "--attn", "flash", "--stages", "2"]),
])
def test_sp_and_ep_train_as_their_one_wide_twins(tmp_path, capsys, argv,
                                                 twin):
    """``--sp 2`` (ring under GPipe, Ulysses under 1F1B) and ``--experts 4
    --ep 2`` (flash attention: the CPU path of the kernels' wrappers) at 2
    stages: train and eval losses equal to the ``--sp 1`` / ``--ep 1``
    run's; the placement line names the axis; ``--generate`` skips with
    the JAX CLI's line."""
    got = _metrics(tmp_path, argv + ["--generate", "4"], "wide")
    out = capsys.readouterr().out
    want = _metrics(tmp_path, twin, "twin")
    np.testing.assert_allclose(got, want, rtol=1e-5)
    axis = "seq" if "--sp" in argv else "expert"
    assert f"| pipeline: 2 stages x 2 {axis} shards on cpu" in out
    assert ("| --generate: skipped (MoE/seq-/tensor-parallel builds decode "
            "via models.make_decoder)") in out


@pytest.mark.parametrize("argv,match", [
    (["--dryrun", "-1"], "non-negative"),
    (["--model", "mlp", "--generate", "3"], "only supported with"),
    (["--max-steps-per-epoch", "0"], ">= 1"),
    (["--model", "gpt", "--flash-blocks", "16,16"], "needs --attn flash"),
    (["--model", "gpt", "--attn", "flash", "--flash-blocks", "x"],
     "Q,K integers"),
    (["--model", "gpt", "--serve-sim", "4", "--serve-spec-k", "1"],
     r"^--serve-spec-k must be 0 \(plain decode\) or >= 2, got 1$"),
    (["--serve-sim", "4"], "only supported with --model=gpt"),
    (["--model", "gpt", "--serve-sim", "4", "--serve-slots", "0"],
     "--serve-slots must be >= 1, got 0"),
    (["--model", "gpt", "--serve-sim", "4", "--serve-deadline-ms", "-1"],
     r"^--serve-deadline-ms must be >= 0 \(0 = none\), got -1.0$"),
    (["--model", "gpt", "--serve-sim", "4", "--serve-max-restarts", "-1"],
     "^--serve-max-restarts must be >= 0, got -1$"),
    (["--model", "gpt", "--serve-sim", "4", "--serve-chaos",
      "engine-crash@serve.tock"], "^bad --serve-chaos spec: unknown fault "
                                  "site 'serve.tock'"),
    (["--model", "gpt", "--serve-sim", "4", "--serve-chaos",
      "replica-kill@fleet.tick=5"], "needs --serve-replicas"),
    (["--scenario", "nope"], "^unknown --scenario 'nope'; available: "
                             "burst-interactive, burst-slow-tick, "
                             "crash-serve, disagg-prefill-heavy, "
                             "fleet-autoscale-diurnal, fleet-replica-loss, "
                             "handoff-replica-loss, hot-adapter-churn, "
                             "hot-prefix-skew, multi-tenant, offload-churn, "
                             r"overload-shed, steady \(or 'list'\)$"),
    # the host tier's and the adapters' checks, in the JAX CLI's words
    (["--model", "gpt", "--serve-sim", "4", "--serve-host-blocks", "-1"],
     r"^--serve-host-blocks must be >= 0 \(0 = no host tier\), got -1$"),
    (["--model", "gpt", "--serve-sim", "4", "--serve-prefetch-ticks", "0"],
     "^--serve-prefetch-ticks must be >= 1, got 0$"),
    (["--model", "gpt", "--serve-sim", "4", "--serve-adapters", "-1"],
     r"^--serve-adapters must be >= 0 \(0 = base model only\), got -1$"),
    (["--model", "gpt", "--serve-sim", "4", "--serve-adapters", "2",
      "--serve-adapter-rank", "0"],
     "^--serve-adapter-rank must be >= 1, got 0$"),
    (["--model", "mlp", "--mlp-dims", "784,32,10", "--telemetry-dir",
      "never-made", "--telemetry-every", "0"],
     "^--telemetry-every must be >= 1, got 0$"),
])
def test_bad_values_exit_with_one_line(argv, match):
    with pytest.raises(SystemExit, match=match):
        main(BASE + argv)


SERVE_LINE = re.compile(
    r"^\| serve: 4/4 requests completed, 64 tokens, [0-9.]+ tok/s, ttft "
    r"p50/p95 [0-9.]+/[0-9.]+ ms, tpot p50/p95 [0-9.]+/[0-9.]+ ms, "
    r"occupancy [0-9.]+$")
SPEC_LINE = re.compile(
    r"^\| serve: tp 1, spec_k 3 accept_rate ([0-9.]+) \((\d+)/(\d+) "
    r"draft tokens\)$")


@pytest.mark.parametrize("spec_k", [0, 3])
def test_cli_serve_sim_prints_the_jax_summary_lines(capsys, spec_k):
    """``--model gpt --serve-sim 4`` serves every request and prints the
    JAX CLI's lines; with ``--serve-spec-k 3`` also its ``| serve: tp``
    line with the draft's accept rate (a fresh draft of half the layers:
    some of its 3 - 1 proposals per tick are verified, few accepted)."""
    main(BASE + ["--model", "gpt", "--serve-sim", "4", "--serve-spec-k",
                 str(spec_k)])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "| serve: fresh-initialized params"
    assert SERVE_LINE.match(out[1]), out[1]
    assert out[2] == ("| serve: kv drift 0 bytes vs the analyzer model "
                      "(predicted 0)")
    assert out[3].startswith("| serve: paged pool 0/16 blocks in use")
    spec = [ln for ln in out if ln.startswith("| serve: tp")]
    if not spec_k:
        assert spec == [] and len(out) == 4
        return
    m = SPEC_LINE.match(spec[0])
    assert m, spec
    rate, accepted, proposed = float(m[1]), int(m[2]), int(m[3])
    assert 0 < proposed and 0 <= accepted <= proposed
    assert rate == round(accepted / proposed, 4)


@pytest.mark.parametrize("argv,placement", [
    (["--dp", "2", "--stages", "2", "--microbatches", "2"],
     "| pipeline: 2 stages x 2 data replicas on cpu, cpu, cpu, cpu"),
    (["--dp", "2"], "| pipeline: 1 stages x 2 data replicas on cpu, cpu"),
    (["--peer-timeout", "30", "--heartbeat-port", "1"], None),
])
def test_data_axis_and_watchdog_flags_now_run(capsys, argv, placement):
    """``--dp`` runs a data axis in one process (each replica's rows, the
    gradients summed over replicas), printing the mesh; the watchdog's
    flags are accepted, and start no watchdog for one process."""
    where, lines = _run_lines(capsys, ["--model", "mlp", "--mlp-dims",
                                       "784,32,10", "--dryrun", "4"] + argv)
    assert where == placement
    assert any(TRAIN_RE.match(ln) for ln in lines)
    assert any(TEST_RE.match(ln) for ln in lines)


def test_chaos_across_processes_is_the_jax_clis_refusal():
    """``--world_size 2`` runs the reference's launch line
    (``tests/test_torch_multiprocess.py``); ``--chaos`` keeps the JAX
    CLI's refusal across processes, before any rendezvous."""
    with pytest.raises(SystemExit, match="--chaos supervises in-process"):
        main(BASE[:2] + ["--world_size", "2", "--device", "cpu",
                         "--chaos", "host-kill@train.step=1"])


def test_rank_required_for_multiprocess():
    with pytest.raises(SystemExit, match="Must provide rank"):
        main(["--world_size", "2", "--device", "cpu"])


def test_without_device_and_without_cuda_the_cli_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--rank", "0", "--world_size", "1", "--model", "lenet",
              "--dryrun", "2", "--data-root", "/nonexistent"])


def _skeleton(lines):
    """Console lines with their numbers, paths and dict contents masked:
    what the two CLIs must share on a wall-clock run."""
    out = []
    for line in lines:
        line = re.sub(r"\(journal [^,)]*", "(journal J", line)
        line = re.sub(r"\{[^}]*\}", "{...}", line)
        out.append(re.sub(r"\d+(\.\d+)?", "N", line))
    return out


def test_cli_serve_chaos_prints_the_jax_lines(capsys, monkeypatch, tmp_path):
    """``--model gpt --serve-sim 8 --serve-chaos engine-crash@serve.tick=6``
    serves every request through one restart and prints the JAX CLI's
    lines, its kv-drift line included; ``--telemetry-dir`` gets the
    journal, the serve record and the restart's post-mortem bundle."""
    from simple_distributed_machine_learning_tpu import cli as jcli
    from simple_distributed_machine_learning_tpu.serve.engine import (
        InferenceEngine as JaxEngine,
    )
    monkeypatch.setattr(JaxEngine, "kv_drift", lambda self: (0, 0))
    argv = ["--model", "gpt", "--serve-sim", "8", "--serve-chaos",
            "engine-crash@serve.tick=6"]
    main(BASE + argv + ["--telemetry-dir", str(tmp_path / "t")])
    ours = capsys.readouterr().out.splitlines()
    jcli.main(["--rank", "0", "--stages", "1", "--telemetry-dir",
               str(tmp_path / "j")] + argv)
    ref = capsys.readouterr().out.splitlines()
    assert _skeleton(ours) == _skeleton(ref)
    assert re.match(r"^\| serve: 8/8 requests completed", ours[2])
    assert ours[3].startswith("| serve: supervisor running, 1 restart(s), ")
    assert "1 post-mortem bundle(s): ['postmortem-000-restart.json']" in (
        ours[4])
    files = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert files == ["journal.jsonl", "metrics.jsonl", "metrics.prom",
                     "postmortem-000-restart.json"]
    rec = json.loads((tmp_path / "t" / "metrics.jsonl").read_text())
    assert rec["kind"] == "serve" and rec["restarts"] == 1
    assert rec["recovered_requests"] >= 1 and rec["completed"] == 8


def test_cli_scenario_prints_the_jax_lines(capsys, monkeypatch):
    """``--scenario crash-serve`` and ``overload-shed`` print exactly the
    JAX CLI's lines: the virtual clock makes every number equal."""
    from simple_distributed_machine_learning_tpu import cli as jcli
    from simple_distributed_machine_learning_tpu.serve.engine import (
        InferenceEngine as JaxEngine,
    )
    monkeypatch.setattr(JaxEngine, "kv_drift", lambda self: (0, 0))
    for name in ("crash-serve", "overload-shed"):
        main(BASE + ["--scenario", name])
        ours = capsys.readouterr().out
        jcli.main(["--rank", "0", "--scenario", name])
        assert ours == capsys.readouterr().out
        assert ours.splitlines()[-1] == "| scenario: SLO ATTAINED"
        assert ("ttft p95 23.16 vms" in ours) == (name == "crash-serve")
    main(BASE + ["--scenario", "list"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "| steady", "| burst-interactive", "| multi-tenant",
        "| burst-slow-tick", "| crash-serve", "| overload-shed",
        "| fleet-replica-loss", "| hot-prefix-skew",
        "| fleet-autoscale-diurnal", "| disagg-prefill-heavy",
        "| offload-churn", "| hot-adapter-churn", "| handoff-replica-loss"]
    jcli.main(["--rank", "0", "--scenario", "list"])
    assert set(lines) <= set(capsys.readouterr().out.splitlines())


def test_should_stop_drains_in_process(capsys, monkeypatch):
    """SIGTERM mid-run stops admission, drains what was submitted and
    exits 0 with the graceful-shutdown line; ``simulate``'s hook is what
    the handler drives."""
    import signal

    from simple_distributed_machine_learning_tpu_torch import serve

    inner = serve.simulate

    def simulate(engine, sim, should_stop=None, **kw):
        def stop():
            # the signal lands once the first arrival was submitted (the
            # next arrival is ~1/8 s away), and only once the CLI's handler
            # is in place: a default SIGTERM would end the test process
            if engine.requests and callable(signal.getsignal(
                    signal.SIGTERM)):
                signal.raise_signal(signal.SIGTERM)
            return should_stop()

        return inner(engine, sim, should_stop=stop, **kw)

    monkeypatch.setattr(serve, "simulate", simulate)
    main(BASE + ["--model", "gpt", "--serve-sim", "8",
                 "--serve-deadline-ms", "5000"])
    out = capsys.readouterr().out.splitlines()
    stop = [ln for ln in out if "graceful shutdown" in ln]
    assert len(stop) == 1 and "on signal 15" in stop[0]
    m = re.search(r"(\d+) submitted request\(s\) drained", stop[0])
    assert 0 < int(m[1]) < 8
    # every submitted request completed (none shed: the deadline is far)
    assert out[2].startswith(f"| serve: {m[1]}/8 requests completed")
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL


# -- the fleet and tracing flags --------------------------------------------


def _jax_cli(monkeypatch):
    from simple_distributed_machine_learning_tpu import cli as jcli
    from simple_distributed_machine_learning_tpu.serve.engine import (
        InferenceEngine as JaxEngine,
    )
    monkeypatch.setattr(JaxEngine, "kv_drift", lambda self: (0, 0))
    return jcli


@pytest.mark.parametrize("extra,files", [
    (["--serve-replicas", "2", "--serve-trace"],
     ["journal-r0.jsonl", "journal-r1.jsonl", "metrics.jsonl",
      "metrics.prom", "request_timeline.jsonl", "serve_trace.json"]),
    (["--serve-replicas", "3", "--serve-prefill-replicas", "1"],
     ["journal-r0.jsonl", "journal-r1.jsonl", "journal-r2.jsonl",
      "metrics.jsonl", "metrics.prom"]),
], ids=["replicas-trace", "disaggregated"])
def test_cli_fleet_prints_the_jax_lines(capsys, monkeypatch, tmp_path,
                                        extra, files):
    """``--serve-sim 8`` through a fleet prints the JAX CLI's lines, its
    kv-drift line included, and leaves the journals, the records and,
    traced, the trace and timeline files."""
    jcli = _jax_cli(monkeypatch)
    argv = ["--model", "gpt", "--serve-sim", "8"] + extra
    main(BASE + argv + ["--telemetry-dir", str(tmp_path / "t")])
    ours = capsys.readouterr().out.splitlines()
    jcli.main(["--rank", "0", "--stages", "1", "--telemetry-dir",
               str(tmp_path / "j")] + argv)
    ref = capsys.readouterr().out.splitlines()

    def mask(lines):
        return _skeleton([ln.replace(str(tmp_path / "t"), "D")
                          .replace(str(tmp_path / "j"), "D")
                          for ln in lines])

    assert mask(ours) == mask(ref)
    assert any(re.match(r"^\| serve: 8/8 requests completed", ln)
               for ln in ours)
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == files
    rec = json.loads((tmp_path / "t" / "metrics.jsonl").read_text())
    assert rec["completed"] == 8 and "fleet_replicas" in rec
    if "--serve-trace" in extra:
        from simple_distributed_machine_learning_tpu_torch.telemetry import (
            report,
        )
        assert report.main(["--dir", str(tmp_path / "t")]) == 0
        out = capsys.readouterr().out
        assert "timeline request_timeline.jsonl:" in out
        assert "8 request(s)" in out
    else:
        assert rec["fleet_handoffs"] == 8


@pytest.mark.parametrize("extra,want", [
    (["--serve-replicas", "1", "--serve-host-blocks", "8",
      "--serve-prefetch-ticks", "2"], r"^\| serve: host tier \d+ block"),
    (["--serve-adapters", "2"], r"^\| serve: adapters — \d+ bank bytes"),
    (["--serve-adapters", "2", "--serve-adapter-rank", "2",
      "--serve-replicas", "2"], r"^\| serve: adapters — \d+ bank bytes"),
], ids=["host-tier", "adapters", "adapters-fleet"])
def test_cli_host_tier_and_adapters_print_the_jax_lines(capsys, monkeypatch,
                                                        extra, want):
    """``--serve-sim 8`` with the host tier (through a fleet: the JAX CLI
    prints its line there) or with LoRA tenants prints the JAX CLI's
    lines, every request completed, the tenants' completions summing to
    the trace."""
    jcli = _jax_cli(monkeypatch)
    argv = ["--model", "gpt", "--serve-sim", "8"] + extra
    main(BASE + argv)
    ours = capsys.readouterr().out.splitlines()
    jcli.main(["--rank", "0", "--stages", "1"] + argv)
    ref = capsys.readouterr().out.splitlines()

    def mask(lines):        # each run's own temporary journal directory
        return _skeleton([re.sub(r"\(journals \S+/", "(journals T/", ln)
                          for ln in lines])

    assert mask(ours) == mask(ref)
    assert any(re.match(r"^\| serve: 8/8 requests completed", ln)
               for ln in ours)
    line = next(ln for ln in ours if re.match(want, ln))
    if "--serve-adapters" in extra:
        assert "| serve: 2 LoRA tenant(s) rank" in "\n".join(ours)
        done = re.search(r"per-tenant completed (\{.*\})", line)[1]
        assert sum(eval(done).values()) == 8


@pytest.mark.parametrize("name,want", [
    ("offload-churn", "24/24 completed"),
    ("hot-adapter-churn", "18/18 completed"),
])
def test_cli_host_tier_and_adapter_scenarios_print_the_jax_lines(
        capsys, monkeypatch, name, want):
    """The two scenarios through the CLI print exactly the JAX CLI's
    lines (the virtual clock makes every number equal)."""
    jcli = _jax_cli(monkeypatch)
    main(BASE + ["--scenario", name])
    ours = capsys.readouterr().out
    jcli.main(["--rank", "0", "--scenario", name])
    assert ours == capsys.readouterr().out
    assert want in ours
    assert ours.splitlines()[-1] == "| scenario: SLO ATTAINED"


def test_cli_fleet_scenario_prints_the_jax_lines(capsys, monkeypatch):
    """``--scenario hot-prefix-skew`` (with ``--serve-trace``: the
    attribution lines too) prints exactly the JAX CLI's lines."""
    jcli = _jax_cli(monkeypatch)
    for extra in ([], ["--serve-trace"]):
        main(BASE + ["--scenario", "hot-prefix-skew"] + extra)
        ours = capsys.readouterr().out
        jcli.main(["--rank", "0", "--scenario", "hot-prefix-skew"] + extra)
        assert ours == capsys.readouterr().out
        assert "17 affinity hit(s)" in ours
        assert ("slow rid 3 (interactive) ttft 42.62 vms" in ours) == bool(
            extra)
        assert ours.splitlines()[-1] == "| scenario: SLO ATTAINED"


@pytest.mark.parametrize("extra", [
    ["--serve-replicas", "-1"],
    ["--serve-route", "round-robin"],
    ["--serve-autoscale", "1,3"],
    ["--serve-replicas", "2", "--serve-autoscale", "x"],
    ["--serve-replicas", "5", "--serve-autoscale", "1,3"],
    ["--serve-prefill-replicas", "1"],
    ["--serve-replicas", "2", "--serve-prefill-replicas", "2"],
    ["--serve-replicas", "3", "--serve-autoscale", "2,4",
     "--serve-prefill-replicas", "1"],
    ["--serve-chaos", "replica-kill@fleet.tick=5"],
])
def test_fleet_flag_errors_are_the_jax_clis(monkeypatch, extra):
    jcli = _jax_cli(monkeypatch)
    argv = ["--model", "gpt", "--serve-sim", "2"] + extra
    with pytest.raises(SystemExit) as ours:
        main(BASE + argv)
    with pytest.raises(SystemExit) as ref:
        jcli.main(["--rank", "0", "--stages", "1"] + argv)
    assert str(ours.value) == str(ref.value)
    assert "\n" not in str(ours.value) and str(ours.value)


def test_serve_trace_needs_a_telemetry_dir(monkeypatch):
    jcli = _jax_cli(monkeypatch)
    argv = ["--model", "gpt", "--serve-sim", "2", "--serve-trace"]
    with pytest.raises(SystemExit, match="needs --telemetry-dir") as ours:
        main(BASE + argv)
    with pytest.raises(SystemExit) as ref:
        jcli.main(["--rank", "0", "--stages", "1"] + argv)
    assert str(ours.value) == str(ref.value)


# ---------------------------------------------------------------------------
# training resilience: --sentinel and --chaos


def _jax_train_cli(argv):
    from simple_distributed_machine_learning_tpu.cli import main as jmain
    jmain(["--rank", "0", "--world_size", "1", "--stages", "1",
           "--data-root", "/nonexistent"] + argv)


def _exit_text(run, argv):
    with pytest.raises(SystemExit) as e:
        run(argv)
    return str(e.value)


@pytest.mark.parametrize("argv", [
    ["--model", "mlp", "--sentinel", "--sentinel-window", "1"],
    ["--model", "mlp", "--sentinel", "--sentinel-snapshot-every", "0"],
    ["--model", "mlp", "--chaos", "nan-grad@train.grad=5",
     "--checkpoint-dir", "CK"],
    ["--model", "mlp", "--chaos", "host-kill@train.step=6"],
    ["--model", "lenet", "--chaos", "host-kill@train.step=6",
     "--checkpoint-dir", "CK"],
    ["--model", "mlp", "--chaos", "host-kill@train.steps=6",
     "--checkpoint-dir", "CK"],
    ["--model", "mlp", "--chaos", "host-kill@train.step=6",
     "--checkpoint-dir", "CK", "--chaos-max-restarts", "-1"],
    ["--model", "gpt", "--serve-sim", "4", "--chaos",
     "host-kill@train.step=6", "--checkpoint-dir", "CK"],
    ["--model", "mlp", "--chaos", "host-kill@train.step=6",
     "--checkpoint-dir", "CK", "--chaos-stages", "2,x"],
    ["--model", "mlp", "--chaos", "host-kill@train.step=6",
     "--checkpoint-dir", "CK", "--chaos-stages", "2,0"],
])
def test_chaos_and_sentinel_errors_are_the_jax_clis(tmp_path, argv):
    """Every refusal of the training-resilience flags exits with the JAX
    CLI's text, word for word."""
    argv = [str(tmp_path / "ck") if a == "CK" else a for a in argv]
    ours = _exit_text(lambda a: main(BASE + a), argv)
    theirs = _exit_text(_jax_train_cli, argv)
    assert ours == theirs and "\n" not in ours


def _chaos_lines(out):
    return [ln for ln in out.split("\n")
            if ln.startswith(("| chaos:", "| sentinel:", "| elastic:"))]


def test_cli_sentinel_chaos_drill_prints_the_jax_lines(tmp_path, capsys):
    """``--sentinel --chaos nan-grad@train.grad=5``: absorbed in memory
    (0 supervisor restarts), the quarantine journal in the store's
    directory, and the same summary lines as the JAX CLI's."""
    argv = ["--model", "mlp", "--mlp-dims", "784,16,10", "--epochs", "2",
            "--max-steps-per-epoch", "4", "--sentinel", "--chaos",
            "nan-grad@train.grad=5"]
    main(BASE + argv + ["--checkpoint-dir", str(tmp_path / "port")])
    ours = _chaos_lines(capsys.readouterr().out)
    _jax_train_cli(argv + ["--checkpoint-dir", str(tmp_path / "jax")])
    theirs = _chaos_lines(capsys.readouterr().out)
    assert ours == theirs == [
        "| sentinel: nan at step 5 (epoch 2 batch 1) — rolled back to step "
        "4, batch quarantined, replaying",
        "| chaos: completed after 0 restart(s); attempts: 1st/completed; "
        "faults fired: 1",
        "| chaos: sentinel absorbed 1 anomaly (1 rollback(s), 1 quarantined "
        "batch(es))"]
    q = [json.loads(line) for line in
         open(tmp_path / "port" / "quarantine.jsonl")]
    assert q == [json.loads(line) for line in
                 open(tmp_path / "jax" / "quarantine.jsonl")]
    assert [r["step"] for r in q] == [5]


def test_cli_chaos_never_fired_plan_is_vacuous(tmp_path):
    with pytest.raises(SystemExit, match="never fired"):
        main(BASE + ["--model", "mlp", "--mlp-dims", "784,16,10",
                     "--epochs", "1", "--max-steps-per-epoch", "2",
                     "--checkpoint-dir", str(tmp_path / "store"),
                     "--chaos", "host-kill@train.step=999"])


def test_cli_gpt_flash_host_kill_restarts_once(tmp_path, capsys):
    """``--model gpt --attn flash --chaos host-kill@train.step=6``: the
    elastic supervisor restores the epoch-1 generation and completes
    after one restart; the flash kernels' wrappers run their plain
    versions on the CPU."""
    main(BASE + ["--model", "gpt", "--attn", "flash", "--epochs", "2",
                 "--max-steps-per-epoch", "4", "--batch-size", "30",
                 "--checkpoint-dir", str(tmp_path / "g"), "--chaos",
                 "host-kill@train.step=6"])
    assert _chaos_lines(capsys.readouterr().out) == [
        "| elastic: restored ckpt-00000004.npz (step 4, written at 1 "
        "stage); resuming at epoch 2",
        "| chaos: completed after 1 restart(s); attempts: 1st/fault"
        "(HostLost) -> 1st/completed; faults fired: 1"]


def test_cli_preempt_then_rerun_resumes_bit_exact(tmp_path, capsys):
    """An injected ``preempt@train.sigterm=6`` stops the CLI's run
    gracefully mid-epoch 2; the rerun resumes at the cursor and ends on
    the parameters of an uninterrupted run, bit for bit."""
    from simple_distributed_machine_learning_tpu_torch.resilience import (
        faults,
    )
    from simple_distributed_machine_learning_tpu_torch.train import (
        checkpoint,
    )
    argv = BASE + ["--model", "mlp", "--mlp-dims", "784,16,10", "--epochs",
                   "2", "--max-steps-per-epoch", "4", "--sentinel"]
    main(argv + ["--checkpoint-dir", str(tmp_path / "straight")])
    faults.install(faults.FaultPlan.parse("preempt@train.sigterm=6"))
    try:
        main(argv + ["--checkpoint-dir", str(tmp_path / "cut")])
    finally:
        faults.uninstall()
    out = capsys.readouterr().out
    assert ("| preempt: graceful stop on preempt notice at step 6 (batch 2 "
            "of epoch 2)") in out
    assert "| train: graceful shutdown complete" in out
    main(argv + ["--checkpoint-dir", str(tmp_path / "cut")])
    assert (f"| resumed from {tmp_path / 'cut'}/state.npz at epoch 2 "
            f"(step 6) (batch 2)") in capsys.readouterr().out
    a = checkpoint.restore_checkpoint(str(tmp_path / "straight/state.npz"))
    b = checkpoint.restore_checkpoint(str(tmp_path / "cut/state.npz"))
    assert a["step"] == b["step"] == 8
    np.testing.assert_array_equal(a["params"], b["params"])
    for x, y in zip(a["opt_state"], b["opt_state"]):
        np.testing.assert_array_equal(x, y)


# -- training telemetry and the profiler ---------------------------------------


#: what the port's epoch record adds to the JAX CLI's here: the static
#: collective-bytes gauge of its step probe (the JAX probe is patched out)
ICI_KEYS = {"ici_bytes_per_step", "ici_top_collectives"}


def _jax_telemetry_cli(monkeypatch):
    """The JAX CLI with the two in-process patches its Trainer needs to run
    a telemetry session on this tree (``tests/test_torch_telemetry.py``).
    The second is its step probe (no ``ici_*`` keys in its records): the
    port's epoch record carries :data:`ICI_KEYS` beside the JAX keys."""
    from simple_distributed_machine_learning_tpu import analysis
    from simple_distributed_machine_learning_tpu import cli as jcli
    from simple_distributed_machine_learning_tpu import telemetry as jtm
    monkeypatch.setattr(analysis, "abstractify", lambda a: a, raising=False)
    monkeypatch.setattr(jtm.Telemetry, "set_step_probe",
                        lambda self, *a, **k: None)
    return jcli


def _jsonl(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f]


def test_cli_dryrun_telemetry_matches_the_jax_cli(tmp_path, monkeypatch,
                                                  capsys):
    """--dryrun 2 --telemetry-dir on one stage: one epoch record (2
    batches, the first the compile window) with the JAX CLI's key set and
    step accounting, and the trace and exposition beside it."""
    jcli = _jax_telemetry_cli(monkeypatch)
    argv = ["--rank", "0", "--world_size", "1", "--model", "mlp",
            "--mlp-dims", "784,32,10", "--stages", "1", "--epochs", "5",
            "--dryrun", "2", "--data-root", "/nonexistent"]
    jcli.main(argv + ["--telemetry-dir", str(tmp_path / "jax")])
    main(argv + ["--device", "cpu", "--telemetry-dir",
                 str(tmp_path / "port")])
    capsys.readouterr()
    [ours] = _jsonl(tmp_path / "port" / "metrics.jsonl")
    [theirs] = _jsonl(tmp_path / "jax" / "metrics.jsonl")
    assert set(ours) == set(theirs) | ICI_KEYS
    # one stage: the step has no collective
    assert ours["ici_bytes_per_step"] == 0
    for key in ("schema", "epoch", "step", "steps", "n_stages",
                "n_microbatches", "schedule", "bubble_fraction", "n_eval"):
        assert ours[key] == theirs[key], key
    assert ours["steps"] == 1 and ours["step_time_ms_p50"] > 0
    assert ours["examples_per_sec"] > 0 and ours["live_array_bytes"] > 0
    with open(tmp_path / "port" / "trace.json") as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"feed", "step", "eval", "epoch_end"} <= names
    assert (tmp_path / "port" / "metrics.prom").exists()


def test_cli_profile_writes_a_chrome_trace(tmp_path, capsys):
    main(BASE + ["--model", "mlp", "--mlp-dims", "784,32,10", "--dryrun",
                 "2", "--profile", str(tmp_path / "prof"),
                 "--telemetry-dir", str(tmp_path / "tele")])
    assert TEST_RE.match([ln for ln in capsys.readouterr().out.split("\n")
                          if ln.startswith("Test set")][0])
    [name] = [f.name for f in (tmp_path / "prof").iterdir()]
    assert name.endswith(".pt.trace.json")
    with open(tmp_path / "prof" / name) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    # the session's spans land on the capture under their own names
    assert {"feed", "step", "eval"} <= names and "aten::mm" in names


def test_cli_generate_telemetry_decode_record_matches_the_jax_cli(
        tmp_path, monkeypatch, capsys):
    jcli = _jax_telemetry_cli(monkeypatch)
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(b"xyzxyzxyz " * 400)
    argv = ["--rank", "0", "--world_size", "1", "--model", "gpt",
            "--text-corpus", str(corpus), "--stages", "1", "--epochs", "1",
            "--dryrun", "2", "--batch-size", "12", "--generate", "16"]
    jcli.main(argv + ["--telemetry-dir", str(tmp_path / "jax")])
    capsys.readouterr()
    main(argv + ["--device", "cpu", "--telemetry-dir",
                 str(tmp_path / "port")])
    assert "| sample (16-byte prompt + 16 generated):" \
        in capsys.readouterr().out
    recs = _jsonl(tmp_path / "port" / "metrics.jsonl")
    jrecs = _jsonl(tmp_path / "jax" / "metrics.jsonl")
    assert [r["kind"] for r in recs] == [r["kind"] for r in jrecs] \
        == ["epoch", "decode"]
    ours, theirs = recs[1], jrecs[1]
    assert set(ours) == set(theirs)
    assert (ours["batch"], ours["n_new"], ours["steps"]) \
        == (theirs["batch"], theirs["n_new"], theirs["steps"]) == (1, 16, 1)
    assert ours["compile_time_s"] > 0 and ours["step_time_ms_p50"] > 0
    assert ours["tokens_per_sec"] > 0
    assert set(recs[0]) == set(jrecs[0]) | ICI_KEYS
    assert recs[0]["tokens_per_sec"] > 0           # an LM: tokens/sec too
    with open(tmp_path / "port" / "metrics.prom") as f:
        assert "decode_time_ms" in f.read()


# -- several pipeline stages ----------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A small byte corpus for the GPT runs (a small test split)."""
    path = tmp_path_factory.mktemp("corpus") / "corpus.txt"
    path.write_bytes(b"the quick brown fox jumps over the lazy dog. " * 60)
    return str(path)


def _model_argv(model, corpus):
    return {"mlp": ["--model", "mlp", "--mlp-dims", "784,32,32,10"],
            "lenet": ["--model", "lenet"],
            "gpt": ["--model", "gpt", "--attn", "flash", "--text-corpus",
                    corpus, "--batch-size", "8"]}[model]


def _run_lines(capsys, argv):
    """The port's CLI on ``argv``: its placement line (or None) and the
    reference's console lines."""
    main(BASE + argv)
    lines = [ln for ln in capsys.readouterr().out.split("\n") if ln]
    placement = [ln for ln in lines if ln.startswith("| pipeline:")]
    rest = [ln for ln in lines if not ln.startswith("| pipeline:")
            and not EPOCH_RE.match(ln)]
    return (placement or [None])[0], rest


@pytest.mark.parametrize("model", ["mlp", "lenet", "gpt"])
def test_cli_two_stages_equal_one_stage(capsys, corpus, model):
    """``--stages 2`` (every stage on the CPU; LeNet conv | fc) prints the
    placement, then the one-stage run's console lines: the same weights,
    and one microbatch draws the fused model's dropout masks."""
    argv = _model_argv(model, corpus) + ["--dryrun", "3"]
    where, two = _run_lines(capsys, argv + ["--stages", "2"])
    assert where == "| pipeline: 2 stages on cpu, cpu"
    one_where, one = _run_lines(capsys, argv + ["--stages", "1"])
    assert one_where is None
    assert two == one and any(TEST_RE.match(ln) for ln in two)


def test_cli_gpt_two_stages_losses_near_the_jax_clis(capsys, corpus):
    """The JAX CLI's ``--model gpt --stages 2``: each package draws its own
    weights from the seed, so the printed losses agree only as the same
    untrained model's: the first step's (at init, near ln(256) = 5.545)
    within 2% relative; two steps later both test losses lie below it."""
    from simple_distributed_machine_learning_tpu.cli import main as jmain
    argv = ["--model", "gpt", "--text-corpus", corpus, "--batch-size", "8",
            "--stages", "2", "--dryrun", "2"]
    _, ours = _run_lines(capsys, argv)
    jmain(["--rank", "0", "--world_size", "1", "--data-root",
           "/nonexistent"] + argv)
    theirs = [ln for ln in capsys.readouterr().out.split("\n")
              if TRAIN_RE.match(ln) or TEST_RE.match(ln)]
    ours = [ln for ln in ours if TRAIN_RE.match(ln) or TEST_RE.match(ln)]
    assert len(ours) == len(theirs) == 2

    def losses(lines):
        return (float(TRAIN_RE.match(lines[0]).group(5)),
                float(TEST_RE.match(lines[1]).group(1)))
    (first, test), (jfirst, jtest) = losses(ours), losses(theirs)
    np.testing.assert_allclose(first, jfirst, rtol=2e-2)
    assert test < first and jtest < jfirst


@pytest.mark.parametrize("model", ["mlp", "gpt"])
def test_cli_microbatches_1f1b_equal_gpipe(capsys, corpus, model):
    """``--microbatches 4 --schedule 1f1b`` gives GPipe's console lines
    (the test loss to its 4 printed decimals)."""
    argv = _model_argv(model, corpus) + ["--stages", "2", "--microbatches", "4",
                                "--dryrun", "3"]
    _, gpipe = _run_lines(capsys, argv)
    _, onefb = _run_lines(capsys, argv + ["--schedule", "1f1b"])
    assert onefb == gpipe


def test_cli_remat_equals_no_remat(capsys, corpus):
    argv = _model_argv("gpt", corpus) + ["--stages", "2", "--microbatches", "2",
                                "--dryrun", "3"]
    assert _run_lines(capsys, argv + ["--remat"]) == _run_lines(capsys,
                                                                argv)


def test_cli_generate_at_two_stages_decodes_stage_by_stage(capsys, corpus):
    """``--generate`` at S = 2 goes through ``make_pp_decoder``: the
    one-stage run's sample, token for token."""
    argv = _model_argv("gpt", corpus) + ["--dryrun", "2", "--generate", "6"]
    samples = []
    for s in ("2", "1"):
        main(BASE + argv + ["--stages", s])
        samples.append([ln for ln in capsys.readouterr().out.split("\n")
                        if ln.startswith("| sample")])
    assert samples[0] == samples[1] and len(samples[0]) == 1


def test_cli_eval_only_from_a_two_stage_checkpoint(tmp_path, capsys):
    argv = _model_argv("mlp", None) + ["--stages", "2", "--epochs", "1",
                                "--max-steps-per-epoch", "3",
                                "--checkpoint-dir", str(tmp_path)]
    _, trained = _run_lines(capsys, argv)
    _, evaluated = _run_lines(capsys, argv + ["--eval-only"])
    assert evaluated[0] == (f"| resumed from {tmp_path}/state.npz at epoch "
                            f"2 (step 3)")
    assert evaluated[1:] == [ln for ln in trained if TEST_RE.match(ln)]


def test_cli_chaos_stages_ladder_prints_the_jax_lines(tmp_path, capsys):
    """``tests/test_cli.py::test_cli_chaos_elastic_restart_end_to_end``'s
    drill: a host-kill mid-epoch 2 on 2 stages, restored and repacked onto
    1, with the JAX CLI's two pinned lines."""
    main(BASE + ["--model", "mlp", "--mlp-dims", "784,32,10", "--stages",
                 "2", "--epochs", "3", "--max-steps-per-epoch", "4",
                 "--checkpoint-dir", str(tmp_path / "store"), "--chaos",
                 "host-kill@train.step=6", "--chaos-stages", "2,1"])
    out = capsys.readouterr().out
    assert ("restored ckpt-00000004.npz (step 4, written at 2 stages, "
            "repacked onto 1); resuming at epoch 2") in out
    assert ("chaos: completed after 1 restart(s); attempts: "
            "2st/fault(HostLost) -> 1st/completed") in out
    assert "MANIFEST.jsonl" in {p.name for p in (tmp_path / "store").iterdir()}


def test_placement_wraps_the_stages_over_the_cards(monkeypatch):
    """Stage s on card s mod n; every stage on the CPU with --device cpu;
    the default stage count is 1 without two cards."""
    from simple_distributed_machine_learning_tpu_torch import cli
    from simple_distributed_machine_learning_tpu_torch.parallel import mesh
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    monkeypatch.setattr(mesh, "visible_devices", lambda: cards)
    assert cli._placement(torch.device("cuda"), 3) == [cards[0], cards[1],
                                                        cards[0]]
    assert cli._placement(torch.device("cpu"), 2) == [torch.device("cpu")] * 2
    assert build_parser().parse_args(["--rank", "0"]).stages is None


def test_cli_sentinel_drill_at_two_stages(tmp_path, capsys):
    """The sentinel's snapshot ring over two stages' tensors: the
    ``nan-grad@train.grad=5`` drill rolls back and prints the one-stage
    run's (and the JAX CLI's) lines."""
    main(BASE + ["--model", "mlp", "--mlp-dims", "784,16,10", "--stages",
                 "2", "--epochs", "2", "--max-steps-per-epoch", "4",
                 "--sentinel", "--chaos", "nan-grad@train.grad=5",
                 "--checkpoint-dir", str(tmp_path)])
    assert _chaos_lines(capsys.readouterr().out) == [
        "| sentinel: nan at step 5 (epoch 2 batch 1) — rolled back to step "
        "4, batch quarantined, replaying",
        "| chaos: completed after 0 restart(s); attempts: 2st/completed; "
        "faults fired: 1",
        "| chaos: sentinel absorbed 1 anomaly (1 rollback(s), 1 quarantined "
        "batch(es))"]
