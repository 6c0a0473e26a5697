"""The reference's own launch line on the port: real OS processes.

The reference's one documented way to run is two processes launched with
``--rank {0,1} --world_size 2 --master_addr localhost``
(``README.txt:19``; ``simple_distributed.py:169-186``). These tests run
the port's CLI that way on the CPU (``--device cpu``): separate OS
processes that meet in a gloo process group over TCP, the pipeline's hops
and the data group's reductions crossing a process boundary. They hold the
asserts of ``tests/test_multiprocess.py`` (the JAX package's, a slow test
outside tier 1) — a completed train and eval epoch with process-0-only
printing, the 1F1B ring, resume across a restart bit for bit (with and
without ZeRO-1), the 4-process data x pipeline mesh with its per-host
rows, a dead and a frozen peer — and, beyond them, hold process 0's
console to the one-process run of the same mesh, line for line.

Every launch is cut with ``--max-steps-per-epoch``; each child runs one
torch thread; ports are picked free per launch and retried once on a
collision; children are killed in a ``finally``.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = ["-m", "simple_distributed_machine_learning_tpu_torch.cli"]
MLP = ["--model", "mlp", "--mlp-dims", "784,64,10"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(extra: dict | None = None) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")
    env.update(extra or {})
    return env


def _cmd(rank: int, world: int, port: int, hb_port: int, extra, data):
    return [sys.executable, *CLI, "--rank", str(rank), "--world_size",
            str(world), "--master_addr", "localhost", "--master_port",
            str(port), "--heartbeat-port", str(hb_port), "--device", "cpu",
            "--data-root", str(data), *extra]


def run_ranks(extra: list[str], data, world: int = 2, timeout: int = 180,
              env_extra: dict | None = None
              ) -> tuple[subprocess.CompletedProcess, ...]:
    """One launch of ``world`` processes; a rendezvous that lost its port
    to another test (gloo's "address already in use") is relaunched once
    on fresh ports."""
    for attempt in range(2):
        port, hb_port = _free_port(), _free_port()
        procs = [subprocess.Popen(_cmd(r, world, port, hb_port, extra, data),
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True,
                                  env=_env(env_extra), cwd=REPO)
                 for r in range(world)]
        results = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=timeout)
                results.append(subprocess.CompletedProcess(
                    p.args, p.returncode, out, err))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if attempt == 0 and any("ddress already in use" in r.stderr
                                for r in results):
            continue
        return tuple(results)


def run_one(extra: list[str], data) -> subprocess.CompletedProcess:
    """The one-process run of the same mesh."""
    return subprocess.run([sys.executable, *CLI, "--rank", "0", "--device",
                           "cpu", "--data-root", str(data), *extra],
                          capture_output=True, text=True, env=_env(),
                          cwd=REPO, timeout=180)


def _console(out: str) -> list[str]:
    """The console lines a one-process run prints too (not the
    distributed line, not the throughput, which is a wall-clock rate)."""
    return [ln for ln in out.splitlines()
            if not ln.startswith(("| distributed:", "| epoch "))]


def _ok(*rs):
    for r in rs:
        assert r.returncode == 0, f"a rank failed:\n{r.stderr[-3000:]}"


def test_two_process_launch_trains_and_rank0_prints(tmp_path):
    extra = MLP + ["--epochs", "1", "--max-steps-per-epoch", "12"]
    r0, r1 = run_ranks(extra, tmp_path / "nodata")
    _ok(r0, r1)
    assert "Train Epoch: 1" in r0.stdout
    assert "Test set: Average loss:" in r0.stdout
    assert ("| distributed: 2 processes, gloo over the host, rank 0 on cpu"
            in r0.stdout)
    last = [ln for ln in r0.stdout.splitlines() if "Loss:" in ln][-1]
    assert "nan" not in last.lower()
    # the reference's master-only console: process 1 prints nothing of it
    assert "Train Epoch" not in r1.stdout and "Test set" not in r1.stdout
    one = run_one(extra + ["--stages", "2"], tmp_path / "nodata")
    assert _console(r0.stdout) == _console(one.stdout)


def test_two_process_launch_reference_workload_lenet(tmp_path):
    """The reference's own model (conv | fc across the two processes),
    with its dropout: the masks travel with the hop, so process 0's
    console equals the one-process two-stage run's."""
    extra = ["--epochs", "1", "--max-steps-per-epoch", "11"]
    r0, r1 = run_ranks(extra, tmp_path / "nodata")
    _ok(r0, r1)
    assert "Train Epoch: 1" in r0.stdout
    assert "Test set: Average loss:" in r0.stdout
    assert "Train Epoch" not in r1.stdout
    one = run_one(extra + ["--stages", "2"], tmp_path / "nodata")
    assert _console(r0.stdout) == _console(one.stdout)


def test_two_process_launch_gpt(tmp_path):
    """The GPT across the boundary (embedding stage on process 0, head
    stage on process 1, GPipe over 2 microbatches, the flash kernels'
    plain versions), then ``--generate`` through the stage-sharded decoder
    over the same boundary: the sample on process 0 only, equal to the
    one-process run's."""
    extra = ["--model", "gpt", "--attn", "flash", "--epochs", "1",
             "--microbatches", "2", "--batch-size", "32",
             "--max-steps-per-epoch", "3", "--generate", "8"]
    r0, r1 = run_ranks(extra, tmp_path / "nodata")
    _ok(r0, r1)
    assert "Train Epoch: 1" in r0.stdout
    assert "Test set: Average loss:" in r0.stdout
    assert "Train Epoch" not in r1.stdout
    assert "| sample tokens" in r0.stdout
    assert "| sample tokens" not in r1.stdout
    one = run_one(extra + ["--stages", "2"], tmp_path / "nodata")
    assert _console(r0.stdout) == _console(one.stdout)


def test_two_process_launch_1f1b(tmp_path):
    """1F1B across the boundary: both rings (activations forward,
    cotangents back) cross the wire every tick, with a warmup-cosine
    schedule and global-norm clipping (each stage's norm counted once)."""
    extra = MLP + ["--epochs", "1", "--microbatches", "4", "--schedule",
                   "1f1b", "--lr-schedule", "warmup-cosine",
                   "--warmup-steps", "3", "--clip-norm", "1.0",
                   "--max-steps-per-epoch", "11"]
    r0, r1 = run_ranks(extra, tmp_path / "nodata")
    _ok(r0, r1)
    assert "Test set: Average loss:" in r0.stdout
    last = [ln for ln in r0.stdout.splitlines() if "Loss:" in ln][-1]
    assert "nan" not in last.lower()
    one = run_one(extra + ["--stages", "2"], tmp_path / "nodata")
    assert _console(r0.stdout) == _console(one.stdout)


@pytest.mark.parametrize("zero1", [False, True], ids=["replicated",
                                                      "zero1_dp2"])
def test_checkpoint_resume_across_restart_bit_exact(tmp_path, zero1):
    """A two-process run stopped after epoch 1 and relaunched resumes (not
    restarts) and lands on the straight two-epoch run's state bit for bit
    — the save is a collective, the restore puts each process's rows (and
    ZeRO-1 slices) back. With ``--zero1 --dp 2 --stages 1`` the state is
    sharded over the process boundary; its file equals the one-process
    replicated run's."""
    common = MLP + ["--max-steps-per-epoch", "5"]
    if zero1:
        common += ["--stages", "1", "--dp", "2", "--zero1"]
    data = tmp_path / "nodata"
    dir_a, dir_b = str(tmp_path / "straight"), str(tmp_path / "resumed")
    _ok(*run_ranks(common + ["--epochs", "2", "--checkpoint-dir", dir_a],
                   data))
    _ok(*run_ranks(common + ["--epochs", "1", "--checkpoint-dir", dir_b],
                   data))
    r0, r1 = run_ranks(common + ["--epochs", "2", "--checkpoint-dir", dir_b],
                       data)
    _ok(r0, r1)
    assert "resumed from" in r0.stdout
    assert "Train Epoch: 2" in r0.stdout
    assert "Train Epoch: 1" not in r0.stdout
    za = np.load(os.path.join(dir_a, "state.npz"))
    zb = np.load(os.path.join(dir_b, "state.npz"))
    assert np.array_equal(za["params"], zb["params"])
    assert np.array_equal(za["opt_0"], zb["opt_0"])
    if zero1:
        dir_c = str(tmp_path / "one_process")
        one = run_one([c for c in common if c != "--zero1"]
                      + ["--epochs", "2", "--checkpoint-dir", dir_c], data)
        assert one.returncode == 0, one.stderr[-3000:]
        zc = np.load(os.path.join(dir_c, "state.npz"))
        assert np.array_equal(za["params"], zc["params"])
        assert np.array_equal(za["opt_0"], zc["opt_0"])


def test_four_process_dp_pp(tmp_path):
    """``--world_size 4``: a dp=2 x pp=2 mesh over four processes, one
    coordinate each, with process-0-only printing and per-host rows: each
    process feeds only its replica's half of the 60-row batch (the
    ``SDML_DEBUG_SHARDING`` line on stderr), and process 0's console
    equals the one-process run of the same mesh."""
    extra = MLP + ["--epochs", "1", "--stages", "2", "--dp", "2",
                   "--microbatches", "2", "--max-steps-per-epoch", "6"]
    rs = run_ranks(extra, tmp_path / "nodata", world=4,
                   env_extra={"SDML_DEBUG_SHARDING": "1"})
    _ok(*rs)
    for r in rs[1:]:
        assert "Train Epoch" not in r.stdout
    assert "Train Epoch: 1" in rs[0].stdout
    assert "Test set: Average loss:" in rs[0].stdout
    for rank, want in [(0, "[0,30) of 60"), (1, "[0,30) of 60"),
                       (2, "[30,60) of 60"), (3, "[30,60) of 60")]:
        assert f"| host {rank}: input rows {want}" in rs[rank].stderr, (
            rank, rs[rank].stderr[-1500:])
    one = run_one(extra, tmp_path / "nodata")
    assert _console(rs[0].stdout) == _console(one.stdout)


def _peer_drill(tmp_path, sig, peer_timeout: str) -> tuple[int, str, float]:
    """Two processes training for far longer than allowed; once process 0
    trains, ``sig`` hits process 1. Returns process 0's exit code, its log
    and the seconds from the signal to its exit."""
    port, hb_port = _free_port(), _free_port()
    extra = MLP + ["--epochs", "500", "--peer-timeout", peer_timeout]
    log = tmp_path / "r0.log"
    with open(log, "w") as f0:
        # each rank in a session of its own: when a group holding a stopped
        # process is orphaned, the kernel hangs it up, and that must not
        # reach the test runner's group
        p0 = subprocess.Popen(_cmd(0, 2, port, hb_port, extra,
                                   tmp_path / "nodata"),
                              stdout=f0, stderr=subprocess.STDOUT,
                              env=_env(), cwd=REPO, start_new_session=True)
        p1 = subprocess.Popen(_cmd(1, 2, port, hb_port, extra,
                                   tmp_path / "nodata"),
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL, env=_env(),
                              cwd=REPO, start_new_session=True)
        try:
            deadline = time.monotonic() + 60
            while "Train Epoch" not in log.read_text():
                if p0.poll() is not None:
                    raise AssertionError(
                        f"rank0 exited early:\n{log.read_text()[-3000:]}")
                if time.monotonic() > deadline:
                    raise AssertionError("training never started")
                time.sleep(0.2)
            t0 = time.monotonic()
            p1.send_signal(sig)
            rc = p0.wait(timeout=30)
            took = time.monotonic() - t0
        finally:
            for p in (p0, p1):
                if p.poll() is None:
                    try:
                        p.send_signal(signal.SIGCONT)
                    except ProcessLookupError:
                        pass
                    p.kill()
                p.wait()
    return rc, log.read_text(), took


def test_dead_peer_aborts_rank0(tmp_path):
    """SIGKILL process 1 mid-run: process 0 exits non-zero promptly instead
    of hanging inside a receive (the reference hangs: rpc_timeout=0). The
    winner of the race is gloo's connection reset or the watchdog's EOF
    reader; either is a correct prompt abort."""
    rc, log, took = _peer_drill(tmp_path, signal.SIGKILL, "5")
    assert rc not in (0, None), "rank 0 must fail once its peer is gone"
    assert ("aborting run" in log or "Connection reset by peer" in log
            or "Connection closed by peer" in log), log[-2000:]
    assert took < 30


def test_frozen_peer_aborts_run(tmp_path):
    """A SIGSTOPped (frozen, not dead) process is caught by its own monitor
    subprocess through ``/proc`` within about ``--peer-timeout`` and turned
    into a run abort — what neither a socket EOF nor gloo's 300 s timeout
    catches quickly."""
    rc, log, took = _peer_drill(tmp_path, signal.SIGSTOP, "3")
    assert rc not in (0, None), "rank 0 must fail once its peer is frozen"
    assert took < 30
