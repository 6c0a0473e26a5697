"""Host-side spans exported as Chrome-trace JSON (port of
``telemetry/tracing.py``).

The spans are recorded host-side with wall-clock durations and written in
the ``chrome://tracing`` / Perfetto JSON format, so a run is
timeline-inspectable with nothing but a browser. Each :meth:`Tracer.span`
also enters ``torch.profiler.record_function``, so when a
``torch.profiler`` capture is active the host spans land on its timeline
too, under the same names.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time


class Tracer:
    """Collects completed spans; thread-safe; ``write`` emits Chrome JSON.

    Two event families:

    - :meth:`span` — a synchronous host interval on the calling thread's
      track (``ph: "X"``), stamped from this process's wall clock, and
      :meth:`instant`, a zero-duration marker on the same track;
    - :meth:`async_begin` / :meth:`async_end` / :meth:`async_instant` —
      Chrome *async* events (``ph: "b"``/``"e"``/``"n"``) keyed by an
      explicit ``(cat, id)`` pair, so overlapping timelines (concurrent
      serving requests) render as separate tracks instead of nesting by
      ts containment. Async events accept an explicit ``ts_us``, so a
      caller with its own clock (the serve engine's, possibly a
      ``VirtualClock``) stamps events without this tracer reading a clock.

    ``pid`` overrides the recorded process id (``ServeTrace`` pins it to 0
    so virtual-clock traces are byte-identical across runs and machines).
    """

    def __init__(self, process_name: str = "sdml",
                 pid: int | None = None) -> None:
        self._t0_ns = time.perf_counter_ns()
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._pid = os.getpid() if pid is None else int(pid)
        self._process_name = process_name

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0_ns) / 1e3

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """``with tracer.span("step", epoch=3): ...`` — one complete event;
        an exception still closes the span."""
        import torch

        t0 = self._now_us()
        with torch.profiler.record_function(name):
            try:
                yield self
            finally:
                t1 = self._now_us()
                ev = {"name": name, "ph": "X", "ts": t0, "dur": t1 - t0,
                      "pid": self._pid, "tid": threading.get_ident()}
                if attrs:
                    ev["args"] = {k: _jsonable(v) for k, v in attrs.items()}
                with self._lock:
                    self._events.append(ev)

    def instant(self, name: str, **attrs) -> None:
        """A zero-duration marker (``ph: "i"``) — epoch boundaries etc."""
        ev = {"name": name, "ph": "i", "s": "t", "ts": self._now_us(),
              "pid": self._pid, "tid": threading.get_ident()}
        if attrs:
            ev["args"] = {k: _jsonable(v) for k, v in attrs.items()}
        with self._lock:
            self._events.append(ev)

    # -- async (overlapping) spans ----------------------------------------

    def _async_event(self, ph: str, name: str, aid, ts_us, cat: str,
                     attrs: dict) -> None:
        ev = {"name": name, "ph": ph, "cat": cat, "id": str(aid),
              "ts": self._now_us() if ts_us is None else float(ts_us),
              "pid": self._pid, "tid": 0}
        if attrs:
            ev["args"] = {k: _jsonable(v) for k, v in attrs.items()}
        with self._lock:
            self._events.append(ev)

    def async_begin(self, name: str, aid, ts_us: float | None = None,
                    cat: str = "async", **attrs) -> None:
        """Open one async span keyed by ``(cat, aid, name)`` (Chrome ``b``
        phase)."""
        self._async_event("b", name, aid, ts_us, cat, attrs)

    def async_end(self, name: str, aid, ts_us: float | None = None,
                  cat: str = "async", **attrs) -> None:
        """Close the matching ``async_begin`` (Chrome ``e`` phase)."""
        self._async_event("e", name, aid, ts_us, cat, attrs)

    def async_instant(self, name: str, aid, ts_us: float | None = None,
                      cat: str = "async", **attrs) -> None:
        """A zero-duration marker on an async track (Chrome ``n`` phase)."""
        self._async_event("n", name, aid, ts_us, cat, attrs)

    def to_chrome_trace(self) -> dict:
        meta = [{"name": "process_name", "ph": "M", "pid": self._pid,
                 "tid": 0, "args": {"name": self._process_name}}]
        with self._lock:
            return {"traceEvents": meta + list(self._events),
                    "displayTimeUnit": "ms"}

    def write(self, path: str) -> str:
        """Write the Chrome-trace JSON to ``path`` (atomic rename) and
        return the path."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        os.replace(tmp, path)
        return path


def _jsonable(v):
    return v if isinstance(v, (int, float, str, bool, type(None))) else str(v)
