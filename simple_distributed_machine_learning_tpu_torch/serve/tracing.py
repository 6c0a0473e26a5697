"""Request-scoped serve tracing: async span timelines keyed by rid (port
of ``serve/tracing.py``, a module without JAX; the port keeps its own
copy, event for event).

Aggregate serving telemetry (``serve/metrics.py``) answers "how is the
fleet doing"; this module answers "where did *this request's* time go" —
submit/journal, queue wait, each prefill chunk, every decode/speculative
tick (tokens emitted, spec accept counts), preemption and resume, deadline
or backpressure shedding, crash re-admission, completion. Two artifacts per
run, one recorder:

- a Chrome-trace JSON (``serve_trace.json``) of *async* begin/end events
  (:meth:`Tracer.async_begin`/``async_end``, ``b``/``e`` phases) keyed by
  the request id, so arbitrarily overlapping request timelines render as
  parallel tracks in Perfetto instead of nesting wrongly;
- a per-request JSONL timeline (``request_timeline.jsonl``): one line per
  event, ``{"ev": ..., "rid": ..., "t": ..., "inc": ...}`` — the joinable,
  greppable form the report CLI (``python -m ...telemetry.report``) and
  post-mortem tooling consume.

**The rid is the trace id.** The journal assigns rids once per request and
recovery preserves them, so spans JOIN across supervisor restarts (the
recorder outlives the engine: the crash ends the open sub-span with
``crashed``, re-admission opens a fresh ``queue`` span under the same id,
and ``inc`` — the engine incarnation — tells the two apart) and across
cold restarts (the timeline file opens in append mode when
``fresh=False``; a recovered rid's new events land after its previous
process's, same key).

**The recorder never reads a clock.** Every event is stamped with a
timestamp the engine ALREADY read for its own accounting (TTFT endpoints,
chunk timing, retirement). Under ``resilience/scenarios.py``'s
``VirtualClock`` — where every read advances simulated time — that is what
keeps the exact-pinned scenario numbers and byte-identical reports
unchanged whether tracing is on or off; it is also why tracing-off costs
literally nothing on the hot path (one ``is None`` test per site).
Events with no clock read of their own (paged admission, preemption,
crash) are stamped with the engine's *most recent* read
(``InferenceEngine._now``) — at-most-one-tick-stale by construction.
"""

from __future__ import annotations

import json
import os

from simple_distributed_machine_learning_tpu_torch.telemetry.tracing import (  # noqa: E501
    Tracer,
)

TRACE_FILE = "serve_trace.json"
TIMELINE_FILE = "request_timeline.jsonl"


class ServeTrace:
    """One serving run's request-scoped trace recorder; see module
    docstring. Attach via ``InferenceEngine(trace=...)`` or
    ``ServeSupervisor(trace=...)`` (the supervisor re-attaches it to every
    rebuilt engine, which is what joins spans across restarts).

    ``outdir=None`` keeps everything in memory (tests);
    ``fresh=False`` appends to an existing timeline file — the cold-restart
    join — instead of truncating it.
    """

    def __init__(self, outdir: str | None = None, *, fresh: bool = True,
                 suffix: str = "",
                 process_name: str = "sdml-serve") -> None:
        # pid pinned to 0: a virtual-clock trace must be byte-identical
        # across runs AND machines, so no real pid may leak into it
        self.tracer = Tracer(process_name=process_name, pid=0)
        self.outdir = outdir
        # per-run artifact names: `suffix` keeps several traced runs (the
        # scenario catalog) apart inside one telemetry dir
        self.trace_file = TRACE_FILE.replace(".json", f"{suffix}.json")
        self.timeline_file = TIMELINE_FILE.replace(".jsonl",
                                                   f"{suffix}.jsonl")
        self.incarnation = 0
        self.n_events = 0
        self._rows: list[dict] = []
        self._phase: dict[int, str] = {}     # rid -> open sub-span name
        self._open: set[int] = set()         # rids with an open request span
        self._tl = None
        if outdir:
            os.makedirs(outdir, exist_ok=True)
            path = os.path.join(outdir, self.timeline_file)
            self._tl = open(path, "w" if fresh else "a")

    # -- event plumbing ----------------------------------------------------

    def _row(self, ev: str, rid, t: float, **fields) -> None:
        row = {"ev": ev, "rid": rid, "t": round(float(t), 6),
               "inc": self.incarnation, **fields}
        self.n_events += 1
        if self._tl is not None:
            # streaming mode: the file IS the timeline — rows are not also
            # retained in memory, so a long-running serve loop's footprint
            # stays flat (the Chrome tracer's event list is the one
            # unavoidable accumulation: its single-file format needs every
            # event at write time)
            self._tl.write(json.dumps(row, separators=(",", ":")) + "\n")
        else:
            self._rows.append(row)

    def _begin(self, rid: int, name: str, t: float, **attrs) -> None:
        self.tracer.async_begin(name, rid, ts_us=t * 1e6, cat="req",
                                inc=self.incarnation, **attrs)

    def _end(self, rid: int, name: str, t: float, **attrs) -> None:
        self.tracer.async_end(name, rid, ts_us=t * 1e6, cat="req",
                              inc=self.incarnation, **attrs)

    def _close_phase(self, rid: int, t: float, **attrs) -> None:
        """End ``rid``'s open sub-span, if any — the no-orphan-ends
        invariant: an ``e`` event exists only where a ``b`` preceded it."""
        phase = self._phase.pop(rid, None)
        if phase is not None:
            self._end(rid, phase, t, **attrs)

    def _open_phase(self, rid: int, name: str, t: float, **attrs) -> None:
        self._close_phase(rid, t)
        self._phase[rid] = name
        self._begin(rid, name, t, **attrs)

    # -- engine-driven events ---------------------------------------------

    def on_submit(self, r, t: float) -> None:
        """A request entered the system (possibly journaled first): open
        its request span and its ``queue`` sub-span at the submit/arrival
        timestamp."""
        self._open.add(r.rid)
        self._begin(r.rid, "request", t, cls=r.cls, priority=r.priority,
                    prompt_len=int(r.prompt.shape[0]),
                    max_new=r.max_new_tokens)
        self._open_phase(r.rid, "queue", t)
        self._row("submit", r.rid, t, cls=r.cls,
                  prompt_len=int(r.prompt.shape[0]))

    def on_admit(self, r, t: float, slot: int) -> None:
        """Boarded a slot: queue wait ends, prefill begins. Paged admission
        performs no clock read of its own, so ``t`` is the engine's most
        recent read (at most one tick stale — documented imprecision, not
        a perturbation)."""
        self._open_phase(r.rid, "prefill", t, slot=slot)
        self._row("admit", r.rid, t, slot=slot)

    def on_prefill_chunk(self, r, t0: float, t1: float, p0: int,
                         n: int) -> None:
        self.tracer.async_instant("prefill_chunk", r.rid, ts_us=t1 * 1e6,
                                  cat="req", p0=p0, n=n)
        self._row("prefill_chunk", r.rid, t1, p0=p0, n=n,
                  ms=round((t1 - t0) * 1e3, 3))

    def on_first_token(self, r, t: float) -> None:
        """The TTFT endpoint: prefill ends, decode begins."""
        ttft = r.ttft_s
        self._open_phase(r.rid, "decode", t)
        self._row("first_token", r.rid, t,
                  ttft_ms=None if ttft is None else round(ttft * 1e3, 3))

    def on_resume(self, r, t: float) -> None:
        """A preempted/recovered request reseated on its stored newest
        token — K/V rebuilt, decode continues."""
        self._open_phase(r.rid, "decode", t, resumed=True)
        self._row("resume", r.rid, t, tokens=len(r.tokens))

    def on_tick_tokens(self, r, t: float, n: int, proposed: int = 0,
                       accepted: int = 0) -> None:
        """One decode/speculative tick's emissions for one request."""
        attrs = {"tokens": n}
        if proposed:
            attrs.update(proposed=proposed, accepted=accepted)
        self.tracer.async_instant("tick", r.rid, ts_us=t * 1e6, cat="req",
                                  **attrs)
        self._row("tick", r.rid, t, **attrs)

    def on_preempt(self, r, t: float) -> None:
        self._open_phase(r.rid, "queue", t, preempted=True)
        self._row("preempt", r.rid, t, tokens=len(r.tokens))

    def on_finish(self, r, t: float, reason: str) -> None:
        self._close_phase(r.rid, t)
        if r.rid in self._open:
            self._open.discard(r.rid)
            self._end(r.rid, "request", t, reason=reason,
                      tokens=len(r.tokens))
        self._row("done", r.rid, t, reason=reason, tokens=len(r.tokens))

    def on_shed(self, r, t: float, reason: str) -> None:
        """A structured rejection (deadline / backpressure / class): the
        request span closes with the shed reason; an admission-time shed
        that never opened a span just logs the row."""
        self._close_phase(r.rid, t)
        if r.rid in self._open:
            self._open.discard(r.rid)
            self._end(r.rid, "request", t, shed=reason)
        self._row("shed", r.rid, t, reason=reason)

    # -- supervisor-driven events -----------------------------------------

    def on_crash(self, t: float, rids, cause: str) -> None:
        """The engine died: every in-flight request's open sub-span ends
        NOW with ``crashed`` (no orphan begins survive the incarnation),
        the request spans stay open — they join across the rebuild."""
        for rid in sorted(rids):
            self._close_phase(rid, t, crashed=True)
            self._row("crash", rid, t, cause=cause)

    def on_restart(self, t: float, n: int, degraded: bool,
                   cause: str) -> None:
        self.incarnation = int(n)
        self.tracer.async_instant("restart", "supervisor", ts_us=t * 1e6,
                                  cat="supervisor", n=n, degraded=degraded,
                                  cause=cause)
        self._row("restart", None, t, n=n, degraded=degraded, cause=cause)

    def on_migrate(self, r, t: float, src: int, dst: int) -> None:
        """Cross-replica migration (``serve/fleet.py``): ``r`` left dead
        replica ``src`` and is being adopted by replica ``dst``. The rid
        is fleet-unique, so the same recorder — attached to EVERY
        replica's supervisor — joins the request's spans across replicas
        exactly as it joins them across one supervisor's restarts; the
        adopting engine's ``restore`` fires ``on_readmit`` right after
        this row."""
        self.tracer.async_instant("migrate", r.rid, ts_us=t * 1e6,
                                  cat="req", src=src, dst=dst)
        self._row("migrate", r.rid, t, src=src, dst=dst,
                  tokens=len(r.tokens))

    def on_readmit(self, r, t: float) -> None:
        """Journal recovery re-enqueued ``r`` into the rebuilt engine. On a
        cold restart this recorder never saw the submit, so the request
        span opens here (``recovered``) — pairing stays well-formed within
        every trace file."""
        if r.rid not in self._open:
            self._open.add(r.rid)
            self._begin(r.rid, "request", t, cls=r.cls,
                        priority=r.priority, recovered=True,
                        prompt_len=int(r.prompt.shape[0]),
                        max_new=r.max_new_tokens)
        self._open_phase(r.rid, "queue", t, readmitted=True)
        self._row("readmit", r.rid, t, tokens=len(r.tokens))

    # -- artifacts ---------------------------------------------------------

    @property
    def rows(self) -> list[dict]:
        """The timeline rows: read back from the streamed file when one
        exists (memory holds nothing in streaming mode), else the
        in-memory list."""
        if self._tl is None:
            return list(self._rows)
        if not self._tl.closed:
            self._tl.flush()
        path = os.path.join(self.outdir, self.timeline_file)
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]

    def to_chrome_trace(self) -> dict:
        return self.tracer.to_chrome_trace()

    def flush(self) -> None:
        """Rewrite the Chrome trace and flush the timeline stream."""
        if self._tl is not None and not self._tl.closed:
            self._tl.flush()
        if self.outdir:
            self.tracer.write(os.path.join(self.outdir, self.trace_file))

    def close(self) -> None:
        self.flush()
        if self._tl is not None and not self._tl.closed:
            self._tl.close()
