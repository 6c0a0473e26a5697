"""The port's watchdog (``simple_distributed_machine_learning_tpu_torch/
utils/failure.py``) held to the ten pins of ``tests/test_failure.py``.

The OS-process integration path (actually SIGKILLing a rank) lives in
tests/test_torch_multiprocess.py::test_dead_peer_aborts_rank0; these cover the
protocol edges cheaply: goodbye-vs-crash disambiguation in both directions
(including through the spawned monitor subprocess's quit-byte protocol),
staleness detection — natural and via an injected frozen-peer fault
(resilience/faults.py) — the heartbeat port-collision bind fallback, and
the monitor's parent-state logic (surviving a parent re-exec, killing a
SIGSTOPped parent), with an injected fail handler instead of os._exit.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import threading
import time

from simple_distributed_machine_learning_tpu_torch.resilience import faults
from simple_distributed_machine_learning_tpu_torch.utils.failure import (
    EXIT_PEER_LOST,
    HeartbeatWatchdog,
    monitor_command,
    spawn_watchdog,
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def _pair(port, **kw):
    fails0, fails1 = [], []
    w0 = HeartbeatWatchdog(0, 2, "localhost", port, fail_handler=fails0.append,
                           **kw).start()
    w1 = HeartbeatWatchdog(1, 2, "localhost", port, fail_handler=fails1.append,
                           **kw).start()
    return w0, w1, fails0, fails1


def test_clean_shutdown_no_spurious_failure():
    """Either side stopping cleanly (goodbye byte) must not trip the other —
    including rank 0 exiting FIRST while rank 1 keeps heartbeating."""
    w0, w1, fails0, fails1 = _pair(_free_port(), interval=0.1, timeout=5.0)
    assert _wait(lambda: w1._client is not None)
    w0.stop()                      # master leaves first
    time.sleep(0.5)                # several heartbeat intervals
    w1.stop()
    assert fails0 == [] and fails1 == []


def test_peer_socket_death_detected():
    """A peer whose socket dies without goodbye is reported on rank 0."""
    w0, w1, fails0, _ = _pair(_free_port(), interval=0.1, timeout=5.0)
    assert _wait(lambda: w1._client is not None)
    w1._client.close()             # simulate a killed process (no goodbye)
    assert _wait(lambda: len(fails0) > 0)
    assert "vanished" in fails0[0]
    w0.stop()


def test_master_death_detected():
    """Rank 0's socket dying without goodbye is reported on the peer."""
    w0, w1, fails0, fails1 = _pair(_free_port(), interval=0.1, timeout=5.0)
    assert _wait(lambda: len(w0._conns) == 1)
    for c in w0._conns:            # kill the server side without goodbye
        c.close()
    try:
        w0._server.close()
    except OSError:
        pass
    assert _wait(lambda: len(fails1) > 0)
    assert "rank 0" in fails1[0]
    w1.stop()


def test_stale_peer_detected():
    """A connected-but-frozen peer (open socket, no heartbeats) trips the
    staleness monitor within ~timeout."""
    port = _free_port()
    fails0 = []
    w0 = HeartbeatWatchdog(0, 2, "localhost", port, interval=0.1, timeout=0.8,
                           fail_handler=fails0.append).start()
    assert _wait(lambda: w0._server is not None)
    # a raw socket that connects and then goes silent — no watchdog client
    frozen = socket.create_connection(("localhost", port))
    assert _wait(lambda: len(fails0) > 0, timeout=10.0)
    assert "heartbeat" in fails0[0] or "stopped" in fails0[0]
    frozen.close()
    w0.stop()


def test_injected_frozen_peer_fault_trips_staleness():
    """The deterministic frozen-peer drill (resilience/faults.py): rank 1's
    client fires the scheduled fault, keeps its socket open but never
    heartbeats — rank 0's staleness monitor must call it frozen. This is
    the detection half of the frozen-peer recovery path (the supervisor
    handles the restart half; tests/test_resilience.py)."""
    faults.install(faults.FaultPlan.parse(
        "frozen-peer@watchdog.heartbeat,rank=1"))
    try:
        w0, w1, fails0, fails1 = _pair(_free_port(), interval=0.1,
                                       timeout=0.8)
        assert _wait(lambda: len(fails0) > 0, timeout=10.0)
        assert "stopped heartbeating" in fails0[0]
        assert fails1 == []
        w0.stop()
        w1.stop()
    finally:
        faults.uninstall()


def test_heartbeat_port_collision_retries_until_free():
    """The port-collision fallback: rank 0 finds its heartbeat port held by
    another process, retries binding, and the run proceeds normally once
    the holder exits — no unhandled OSError, no spurious abort."""
    port = _free_port()
    # bind WITHOUT listen: w0's bind collides, but clients are refused
    # (not silently accepted by the impostor) and retry on their own
    holder = socket.socket()
    holder.bind(("localhost", port))
    threading.Timer(0.5, holder.close).start()
    w0, w1, fails0, fails1 = _pair(port, interval=0.1, timeout=8.0)
    assert _wait(lambda: w1._client is not None and w0._server is not None)
    w0.stop()
    time.sleep(0.3)
    w1.stop()
    assert fails0 == [] and fails1 == []


def test_heartbeat_port_collision_timeout_fails_loudly():
    """A port held past the timeout fails through _fail with an actionable
    message instead of an OSError lost on a daemon thread."""
    port = _free_port()
    holder = socket.socket()
    holder.bind(("localhost", port))
    fails0: list[str] = []
    w0 = HeartbeatWatchdog(0, 2, "localhost", port, interval=0.1,
                           timeout=0.7, fail_handler=fails0.append).start()
    assert _wait(lambda: len(fails0) > 0, timeout=10.0)
    assert "could not bind heartbeat port" in fails0[0]
    w0.stop()
    holder.close()


# ---------------------------------------------------------------------------
# spawned-monitor subprocess: goodbye-vs-crash + parent-state edge cases


def test_monitor_goodbye_vs_crash_disambiguation():
    """The spawn_watchdog quit-byte protocol end to end: a monitor stopped
    with the goodbye protocol must NOT trip rank 0, while an aborted
    monitor (no goodbye — crash semantics) MUST read as a vanished peer."""
    # clean: handle.stop() sends 'q' first
    port = _free_port()
    fails0: list[str] = []
    w0 = HeartbeatWatchdog(0, 2, "localhost", port, interval=0.2,
                           timeout=15.0, fail_handler=fails0.append).start()
    h = spawn_watchdog(1, 2, "localhost", port, interval=0.2, timeout=15.0)
    assert _wait(lambda: len(w0._conns) == 1, timeout=20.0)
    h.stop()
    time.sleep(0.5)
    assert fails0 == []
    w0.stop()

    # crash: handle.abort() kills without goodbye
    port = _free_port()
    fails0 = []
    w0 = HeartbeatWatchdog(0, 2, "localhost", port, interval=0.2,
                           timeout=15.0, fail_handler=fails0.append).start()
    h = spawn_watchdog(1, 2, "localhost", port, interval=0.2, timeout=15.0)
    assert _wait(lambda: len(w0._conns) == 1, timeout=20.0)
    h.abort()
    assert _wait(lambda: len(fails0) > 0, timeout=20.0)
    assert "vanished" in fails0[0]
    w0.stop()


def _spawn_monitor(parent_pid: int, timeout: float) -> subprocess.Popen:
    """A world-size-1 monitor: no heartbeat protocol, pure parent babysitter
    — exactly the parent-state loop under test. It runs as the CLI's does
    (``monitor_command``: the file as a script, no torch import)."""
    return subprocess.Popen(
        monitor_command() + [
            "--rank", "0", "--world-size", "1", "--addr", "localhost",
            "--port", "1", "--interval", "0.1", "--timeout", str(timeout),
            "--parent-pid", str(parent_pid)],
        stdin=subprocess.PIPE)


def test_monitor_survives_parent_reexec():
    """A trainer that re-execs itself (the elastic-restart shape: same pid,
    fresh program) must NOT be killed by its monitor — the pid stays alive
    and running, so the monitor keeps protecting it and exits quietly when
    the parent finally finishes."""
    parent = subprocess.Popen(
        [sys.executable, "-c",
         "import os, sys, time; time.sleep(0.4); "
         "os.execv(sys.executable, [sys.executable, '-c', "
         "'import time; time.sleep(1.2)'])"])
    mon = _spawn_monitor(parent.pid, timeout=0.6)
    # parent re-execs at 0.4s and lives until ~1.6s; a monitor that
    # misread the exec as death/stop would have killed it by 1.2s
    time.sleep(1.2)
    assert parent.poll() is None, "monitor killed a live re-exec'd parent"
    assert mon.poll() is None
    assert parent.wait(timeout=15) == 0      # exits on its own
    assert mon.wait(timeout=15) == 0         # parent gone -> quiet exit
    mon.stdin.close()


def test_monitor_kills_stopped_parent():
    """A SIGSTOPped trainer (frozen from the outside world's view) is
    SIGKILLed once it overstays the timeout, and the monitor exits with
    EXIT_PEER_LOST — the frozen-trainer half of the watchdog design."""
    parent = subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(60)"])
    mon = _spawn_monitor(parent.pid, timeout=0.5)
    time.sleep(0.3)                       # let the monitor start watching
    os.kill(parent.pid, signal.SIGSTOP)
    try:
        assert mon.wait(timeout=20) == EXIT_PEER_LOST
        # the parent was SIGKILLed (negative return code = signal)
        assert parent.wait(timeout=10) == -signal.SIGKILL
    finally:
        try:
            os.kill(parent.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        parent.wait()
        mon.stdin.close()


def test_monitor_imports_neither_torch_nor_the_package():
    """The monitor must heartbeat within its deadline: run as a script it
    loads only the stdlib and the stdlib-only fault module (by path), so
    it starts in a fraction of a second where importing torch takes
    seconds."""
    code = ("import runpy, sys; sys.argv = ['failure.py', '--help']; "
            "sys.path.pop(0)\n"
            "try:\n"
            f"    runpy.run_path({monitor_command()[-1]!r}, "
            "run_name='__main__')\n"
            "except SystemExit:\n"
            "    pass\n"
            "print(sorted(m for m in sys.modules if m == 'torch' or "
            "m.startswith('simple_distributed')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
