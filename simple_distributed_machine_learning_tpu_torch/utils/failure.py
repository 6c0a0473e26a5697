"""Failure detection: the dead-peer watchdog (port of ``utils/failure.py``).

The reference sets ``rpc_timeout=0`` and hangs forever when a peer dies
(``simple_distributed.py:36,:167``). A gloo collective or receive shares
that failure mode: one whose counterpart is stopped never completes (gloo's
own timeout is 300 s here), and the Python main thread is blocked inside
the runtime where no exception can reach it. The watchdog runs BESIDE the
training loop:

- rank 0 listens on a TCP port; every other rank connects and streams
  heartbeat bytes at ``interval``;
- a crash is detected two ways: the kernel closes a dead process's socket
  (EOF without the goodbye byte — immediate), or heartbeats go stale for
  ``timeout`` seconds (frozen process / severed network);
- on detection every surviving rank writes a diagnostic to stderr and
  hard-exits (``os._exit``) with :data:`EXIT_PEER_LOST` — the only reliable
  way out, since the main thread may be parked inside a collective that will
  never complete;
- clean shutdown is protocol-distinguished: :meth:`HeartbeatWatchdog.stop`
  sends a goodbye byte first, so a peer that finishes earlier never trips
  the others.

This turns the reference's infinite hang into a prompt, scriptable, nonzero
exit (``tests/test_torch_multiprocess.py``).

**Why a subprocess** (:func:`spawn_watchdog`, what the CLI uses): a Python
thread only runs when it can take the GIL, and a rank whose main thread is
parked inside a native collective that blocks WITH the GIL held freezes
every in-process thread — the watchdog included. The spawned monitor is a
separate stdlib-only process: it runs this file as a script and loads the
stdlib-only ``resilience/faults.py`` by its path, so it never imports the
package (whose ``__init__`` imports torch) and is heartbeating within a
fraction of a second. It keeps running no matter what the trainer process
is doing, and on failure it SIGTERMs (then SIGKILLs) the trainer.
In-process :class:`HeartbeatWatchdog` remains the protocol engine and is
what the subprocess runs internally.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time

# deterministic chaos hook: a scheduled frozen-peer fault at the
# "watchdog.heartbeat" site makes a rank stop heartbeating with its socket
# open, the frozen-process signature the staleness monitor must catch
# (resilience/faults.py)
if __package__:
    from simple_distributed_machine_learning_tpu_torch.resilience.faults import (  # noqa: E501
        check as _check_fault,
        install_from_env as _install_from_env,
    )
else:
    # run as a script (the monitor subprocess): the stdlib-only fault module
    # by its path, so the monitor never imports the package (or torch)
    import importlib.util as _ilu

    _spec = _ilu.spec_from_file_location(
        "_sdml_monitor_faults",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
            __file__))), "resilience", "faults.py"))
    _faults = _ilu.module_from_spec(_spec)
    sys.modules[_spec.name] = _faults
    _spec.loader.exec_module(_faults)
    _check_fault, _install_from_env = _faults.check, _faults.install_from_env

EXIT_PEER_LOST = 13
_HB = b"h"      # heartbeat byte
_BYE = b"b"     # clean-shutdown byte


def _abort_message(rank: int, what: str) -> str:
    """The one diagnostic format both the in-process and subprocess paths
    emit — tests/test_torch_multiprocess.py greps for 'aborting run'."""
    return (f"[watchdog] rank {rank}: {what} — aborting run "
            f"(the reference would hang forever here; SURVEY §5.3)\n")


class HeartbeatWatchdog:
    """Dead-peer detector over a star TCP topology (rank 0 at the center).

    ``start()`` after the collective rendezvous (all processes exist by
    then); ``stop()`` before process exit. All threads are daemons; a
    watchdog failure calls ``os._exit(EXIT_PEER_LOST)``.
    """

    def __init__(self, rank: int, world_size: int, master_addr: str,
                 port: int, interval: float = 1.0, timeout: float = 30.0,
                 fail_handler=None):
        self.rank = rank
        self.world_size = world_size
        self.addr = master_addr
        self.port = int(port)
        self.interval = float(interval)
        self.timeout = float(timeout)
        # tests inject a recorder; production hard-exits (os._exit is the
        # only way out of a main thread parked inside a dead collective)
        self._fail_handler = fail_handler
        self._stopping = False
        self._threads: list[threading.Thread] = []
        self._server: socket.socket | None = None
        self._client: socket.socket | None = None
        self._last_seen: dict[int, float] = {}
        self._said_bye: set[int] = set()
        self._master_bye = False
        self._conns: list[socket.socket] = []
        self._lock = threading.Lock()

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "HeartbeatWatchdog":
        if self.world_size <= 1:
            return self
        sys.stderr.write(f"[watchdog] rank {self.rank}: started "
                         f"({self.addr}:{self.port}, timeout "
                         f"{self.timeout:.0f}s)\n")
        sys.stderr.flush()
        if self.rank == 0:
            self._spawn(self._accept_loop)
            self._spawn(self._staleness_loop)
        else:
            self._spawn(self._client_loop)
        return self

    def stop(self, goodbye: bool = True) -> None:
        """``goodbye=False`` closes abruptly (no _BYE): used when the
        process being monitored CRASHED — peers must read the disconnect as
        a failure, not a clean exit."""
        self._stopping = True
        try:
            if self._client is not None:
                if goodbye:
                    self._client.sendall(_BYE)
                self._client.close()
        except OSError:
            pass
        # rank 0: tell every peer this is a clean exit before closing, so a
        # peer still mid-training doesn't read the EOF as a master crash
        for conn in self._conns:
            try:
                if goodbye:
                    conn.sendall(_BYE)
                conn.close()
            except OSError:
                pass
        try:
            if self._server is not None:
                self._server.close()
        except OSError:
            pass

    # -- failure ----------------------------------------------------------

    def _fail(self, what: str) -> None:
        if self._stopping:
            return
        if self._fail_handler is not None:
            self._fail_handler(what)
            return
        sys.stderr.write(_abort_message(self.rank, what))
        sys.stderr.flush()
        os._exit(EXIT_PEER_LOST)

    # -- rank 0: server side ----------------------------------------------

    def _spawn(self, fn) -> None:
        t = threading.Thread(target=fn, daemon=True)
        t.start()
        self._threads.append(t)

    def _bind_server(self) -> bool:
        """Bind + listen with retry: a port still held by a previous run's
        dying watchdog (or an unrelated process) is retried until
        ``timeout`` — the port-collision fallback — then reported through
        ``_fail`` with a clear message instead of an unhandled thread
        OSError. SO_REUSEADDR already covers plain TIME_WAIT; the retry
        covers a LIVE holder that exits shortly."""
        deadline = time.monotonic() + self.timeout
        last_err: OSError | None = None
        while not self._stopping:
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                srv.bind((self.addr, self.port))
                srv.listen(self.world_size)
                self._server = srv
                return True
            except OSError as e:
                srv.close()
                last_err = e
                if time.monotonic() > deadline:
                    break
                time.sleep(0.2)
        if not self._stopping:
            self._fail(
                f"could not bind heartbeat port {self.addr}:{self.port} "
                f"within {self.timeout:.0f}s ({last_err}) — is another "
                f"run's watchdog still holding it? (pass a different "
                f"--heartbeat-port)")
        return False

    def _accept_loop(self) -> None:
        if not self._bind_server():
            return
        next_id = 0
        while not self._stopping and next_id < self.world_size - 1:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return      # server closed by stop()
            next_id += 1
            peer = next_id  # connection order stands in for rank identity
            with self._lock:
                self._last_seen[peer] = time.monotonic()
                self._conns.append(conn)
            self._spawn(lambda c=conn, p=peer: self._reader(c, p))

    def _reader(self, conn: socket.socket, peer: int) -> None:
        try:
            while True:
                data = conn.recv(64)
                if not data:
                    break               # EOF: peer's socket closed
                with self._lock:
                    self._last_seen[peer] = time.monotonic()
                    if _BYE in data:
                        self._said_bye.add(peer)
        except OSError:
            pass
        with self._lock:
            graceful = peer in self._said_bye
        if not graceful:
            self._fail(f"peer {peer} vanished (socket closed without "
                       f"goodbye — killed or crashed)")

    def _staleness_loop(self) -> None:
        deadline_first = None
        while not self._stopping:
            time.sleep(self.interval)
            now = time.monotonic()
            if self._server is None:
                # bind still retrying (_bind_server owns that deadline):
                # clients cannot have connected yet, so the first-connect
                # clock starts only once the server is actually listening
                continue
            if deadline_first is None:
                deadline_first = now + self.timeout
            with self._lock:
                n_connected = len(self._last_seen)
                stale = [p for p, ts in self._last_seen.items()
                         if p not in self._said_bye
                         and now - ts > self.timeout]
            if stale:
                self._fail(f"peer(s) {stale} stopped heartbeating for "
                           f">{self.timeout:.0f}s (frozen or unreachable)")
            if (n_connected < self.world_size - 1
                    and now > deadline_first):
                self._fail(
                    f"only {n_connected}/{self.world_size - 1} peers "
                    f"connected their heartbeat within {self.timeout:.0f}s")

    # -- rank > 0: client side --------------------------------------------

    def _client_loop(self) -> None:
        deadline = time.monotonic() + self.timeout
        sock = None
        while not self._stopping:
            try:
                sock = socket.create_connection((self.addr, self.port),
                                                timeout=self.interval)
                break
            except OSError:
                if time.monotonic() > deadline:
                    self._fail(f"could not reach rank 0's heartbeat port "
                               f"{self.addr}:{self.port} within "
                               f"{self.timeout:.0f}s")
                    return
                time.sleep(0.2)
        if sock is None:
            return
        self._client = sock
        # rank 0 never writes; a recv returning EOF means its socket died.
        # Watch for that in a side thread while the main loop heartbeats.
        self._spawn(lambda: self._watch_master(sock))
        frozen = False
        while not self._stopping:
            # injected frozen-peer: stop heartbeating, keep the socket open
            # (exactly what a GIL-wedged or SIGSTOPped rank looks like from
            # the outside); rank 0's staleness monitor must trip
            if frozen or any(f.kind == "frozen-peer" for f in
                             _check_fault("watchdog.heartbeat",
                                          rank=self.rank)):
                frozen = True
                time.sleep(self.interval)
                continue
            try:
                sock.sendall(_HB)
            except OSError:
                # a send failure AFTER rank 0's goodbye is just the socket
                # draining post-exit — not a peer loss
                if not self._master_bye:
                    self._fail("rank 0 unreachable (heartbeat send failed)")
                return
            time.sleep(self.interval)

    def _watch_master(self, sock: socket.socket) -> None:
        while True:
            try:
                data = sock.recv(64)
            except OSError:
                return
            if _BYE in data:
                self._master_bye = True   # clean exit: sends may now fail
                return
            if not data:
                if not self._stopping:
                    self._fail("rank 0 closed the heartbeat channel "
                               "without goodbye")
                return


class _WatchdogHandle:
    """Parent-side handle for the spawned monitor; ``stop()`` on success,
    ``abort()`` on a crash path that still wants the monitor gone."""

    def __init__(self, proc: subprocess.Popen):
        self._proc = proc
        self._closing = False
        # visibility thread: a monitor that dies on its own (OOM-kill,
        # operator mistake) leaves this rank unprotected AND its abrupt
        # socket close makes the PEERS read this rank as crashed — log it
        # loudly so the resulting run teardown is attributable. (Best
        # effort: this thread needs the GIL; the monitor exists precisely
        # because the trainer may hold it. The log is diagnosis, not the
        # protection mechanism.)
        t = threading.Thread(target=self._watch_monitor, daemon=True)
        t.start()

    def _watch_monitor(self) -> None:
        while not self._closing:
            if self._proc.poll() is not None:
                if not self._closing:
                    sys.stderr.write(
                        f"[watchdog] monitor subprocess exited unexpectedly "
                        f"(rc={self._proc.returncode}): dead-peer protection "
                        f"is OFF for this rank, and peers may read this "
                        f"rank's heartbeat loss as a crash\n")
                    sys.stderr.flush()
                return
            time.sleep(2.0)

    def stop(self) -> None:
        self._closing = True
        try:
            # the explicit quit byte marks a CLEAN stop; a bare EOF (this
            # process dying with the pipe open) reads as a crash
            self._proc.stdin.write(b"q")
            self._proc.stdin.flush()
            self._proc.stdin.close()
        except (OSError, ValueError):
            pass
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()          # reap: no zombie in long-lived hosts

    def abort(self) -> None:
        """Kill the monitor WITHOUT the goodbye protocol: its abrupt socket
        close tells the peers this rank failed (crash semantics preserved),
        and the host process is released from the armed kill_parent."""
        self._closing = True
        try:
            self._proc.kill()
            self._proc.wait()
        except OSError:
            pass


def spawn_watchdog(rank: int, world_size: int, master_addr: str, port: int,
                   interval: float = 1.0, timeout: float = 30.0
                   ) -> _WatchdogHandle:
    """Launch the dead-peer monitor as a GIL-independent subprocess.

    The child runs :class:`HeartbeatWatchdog` with a fail handler that
    SIGTERMs (grace 5 s, then SIGKILLs) this process, so a vanished peer
    turns into a prompt nonzero exit even while the trainer's main thread is
    wedged inside a native collective holding the GIL. The child exits on
    its own when this process dies or closes the handle's stdin pipe.
    """
    proc = subprocess.Popen(
        monitor_command() + [
            "--rank", str(rank), "--world-size", str(world_size),
            "--addr", master_addr, "--port", str(port),
            "--interval", str(interval), "--timeout", str(timeout),
            "--parent-pid", str(os.getpid())],
        stdin=subprocess.PIPE)
    return _WatchdogHandle(proc)


def monitor_command() -> list[str]:
    """The monitor's command line, flags to follow: this file as a script
    (``-P``: its directory stays off ``sys.path``), not ``-m`` — which
    would import the package and torch first."""
    return [sys.executable, "-P", os.path.abspath(__file__)]


def _monitor_main(argv=None) -> None:
    """Child-process entry: run the watchdog protocol, kill the parent on
    peer loss, exit quietly when the parent stops or disappears."""
    import argparse
    import signal

    _install_from_env()     # SDML_CHAOS reaches the monitor subprocess too

    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--addr", required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--timeout", type=float, default=30.0)
    ap.add_argument("--parent-pid", type=int, required=True)
    args = ap.parse_args(argv)

    # pidfd (Linux): an unforgeable handle to THIS parent — immune to pid
    # recycling between the SIGTERM grace and the SIGKILL
    try:
        parent_fd = os.pidfd_open(args.parent_pid)
    except (AttributeError, OSError):
        parent_fd = None

    def _signal_parent(sig) -> bool:
        try:
            if parent_fd is not None:
                signal.pidfd_send_signal(parent_fd, sig)
            else:
                os.kill(args.parent_pid, sig)
            return True
        except (ProcessLookupError, OSError):
            return False

    aborting = threading.Event()

    def kill_parent(what: str) -> None:
        aborting.set()
        sys.stderr.write(_abort_message(args.rank, what))
        sys.stderr.flush()
        if _signal_parent(signal.SIGTERM):
            # grace: poll for exit rather than one blind sleep, so SIGKILL
            # is only sent while the (pidfd-pinned) parent still runs
            for _ in range(50):
                time.sleep(0.1)
                if not _parent_alive():
                    break
            else:
                _signal_parent(signal.SIGKILL)
        os._exit(EXIT_PEER_LOST)

    def _parent_alive() -> bool:
        try:
            if parent_fd is not None:
                # a pidfd polls readable once the process exits
                import select as _select
                r, _, _ = _select.select([parent_fd], [], [], 0)
                return not r
            os.kill(args.parent_pid, 0)
            return True
        except (ProcessLookupError, OSError):
            return False

    def _parent_state() -> str:
        """One-char /proc state of the trainer ('T' stopped, 'Z' zombie,
        '?' unknown/non-Linux)."""
        try:
            with open(f"/proc/{args.parent_pid}/stat", "rb") as f:
                # field 3, after the parenthesised comm (which may contain
                # spaces): split on the LAST ')'
                return f.read().rsplit(b")", 1)[1].split()[0].decode()
        except (OSError, IndexError):
            return "?"

    wd = HeartbeatWatchdog(args.rank, args.world_size, args.addr, args.port,
                           interval=args.interval, timeout=args.timeout,
                           fail_handler=kill_parent)
    wd.start()
    # clean-shutdown signal: parent writes 'q' then closes our stdin; a bare
    # EOF or a vanished parent pid means the parent CRASHED — close without
    # goodbye so the peers abort instead of treating it as a clean exit.
    # A trainer stuck in 'T' (SIGSTOPped) or 'Z' for > timeout counts as
    # frozen: this monitor stays healthy and keeps heartbeating on the
    # trainer's behalf, so ONLY this check preserves the frozen-peer
    # abort the in-process design had (a GIL-wedged-but-running trainer is
    # indistinguishable from a long native block and is left to gloo's own
    # timeout).
    import select
    clean = False
    stopped_since = None
    while True:
        if aborting.is_set():
            # the trainer may exit gracefully on this monitor's SIGTERM and
            # send its quit byte: that exit is the abort's, not a clean
            # stop, and kill_parent ends this process with EXIT_PEER_LOST
            time.sleep(args.interval)
            continue
        r, _, _ = select.select([sys.stdin], [], [], args.interval)
        if r:
            data = os.read(sys.stdin.fileno(), 64)
            if b"q" in data:
                clean = True
            if not data or b"q" in data:
                break
        if not _parent_alive():
            break                       # parent already gone (crash path)
        state = _parent_state()
        if state in ("T", "Z"):
            now = time.monotonic()
            stopped_since = stopped_since or now
            if now - stopped_since > args.timeout:
                sys.stderr.write(_abort_message(
                    args.rank, f"trainer pid {args.parent_pid} has been in "
                               f"state '{state}' for >{args.timeout:.0f}s"))
                sys.stderr.flush()
                _signal_parent(signal.SIGKILL)
                wd.stop(goodbye=False)  # peers must see this as a failure
                os._exit(EXIT_PEER_LOST)
        else:
            stopped_since = None
    wd.stop(goodbye=clean)


if __name__ == "__main__":
    _monitor_main()
