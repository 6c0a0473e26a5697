"""The append-only request journal: serving's crash-durable source of truth.

Port of ``serve/journal.py`` (a module without JAX; the port keeps its own
copy, record for record). One fsync'd JSONL line per submission, per
emitted token (carrying the request's live key data, so a recovered decode
continues on the exact key stream), per completion and per shed; the
serve supervisor (``serve/supervisor.py``) writes it on the way in and
rebuilds the in-flight picture from it after a crash — nothing of a dead
engine's memory is trusted.

Record grammar (one JSON object per line; short field names because a
line is written per token)::

    {"ev":"submit","rid":3,"prompt":[...],"max_new":8,"temp":0.0,
     "top_k":null,"top_p":null,"eos":null,"seed":3,"cls":"interactive",
     "prio":2,"ttft_dl":0.08,"dl":0.4,"t":12.5}
    {"ev":"tok","rid":3,"tok":17,"kd":[123,456],"dkd":null,"t":13.1}
    {"ev":"done","rid":3,"reason":"length","t":14.0}
    {"ev":"shed","rid":5,"reason":"deadline","t":14.2}
    {"ev":"restart","n":1,"degraded":false,"cause":"EngineCrash"}
    {"ev":"snap","rid":3,...,"state":"queued","toks":[17,4],...}
    {"ev":"handoff","rid":3,"dst":2,"tick":7}

``kd``/``dkd`` are the port's key data (``ops/random.py``: the JAX
package's uint32[2] layout), so a recovered *sampled* stream continues the
port's own generator; greedy streams consume no key and read the same in
both packages. A ``snap`` is one request's whole folded state (written by
:meth:`RequestJournal.rotate`, and by the fleet's migration in a later
slice); a ``handoff`` drops the rid from this journal; ``adp`` (the LoRA
adapter) and ``tick`` are absent when the writer supplies none.

Corruption tolerance: a crash can tear at most the tail, so
:func:`read_journal` keeps the longest prefix of fully valid lines and
reopening for append truncates the file to it. :func:`recover_state`
folds the valid events into per-request :class:`Request` snapshots,
including the journaled-but-not-acked corner: a request whose last
journaled token already finished it is marked DONE instead of being
re-admitted, so its stream is identical whether or not the ``done``
record made it to disk.
"""

from __future__ import annotations

import json
import os

import numpy as np

from simple_distributed_machine_learning_tpu_torch.serve.request import (
    DONE,
    QUEUED,
    SHED,
    Request,
)


def read_journal(path: str) -> tuple[list[dict], int]:
    """``(events, valid_bytes)`` of the longest valid prefix of ``path``
    (``([], 0)`` when the file does not exist).  Scanning stops at the
    FIRST invalid line — everything after a torn write is suspect, exactly
    like the checkpoint store falling back past a corrupt generation."""
    if not os.path.exists(path):
        return [], 0
    events: list[dict] = []
    valid = 0
    with open(path, "rb") as f:
        raw = f.read()
    for line in raw.split(b"\n"):
        # the final segment of a newline-terminated file is b"": stop
        # cleanly; a non-empty segment without its newline is a torn tail
        if not line:
            break
        if valid + len(line) + 1 > len(raw):
            break                      # no trailing newline: torn mid-write
        try:
            ev = json.loads(line)
        except json.JSONDecodeError:
            break
        if not isinstance(ev, dict) or "ev" not in ev:
            break
        events.append(ev)
        valid += len(line) + 1
    return events, valid


def _request_from(ev: dict) -> Request:
    """The journaled request identity (submit and snap records share it):
    one constructor, so a field added to the journal grammar cannot silently
    diverge between the fresh-submission fold and the rotation/migration
    fold recovery is pinned byte-identical across."""
    r = Request(
        rid=int(ev["rid"]),
        prompt=np.asarray(ev["prompt"], np.int32),
        max_new_tokens=int(ev["max_new"]),
        temperature=float(ev["temp"]),
        top_k=ev["top_k"],
        top_p=ev["top_p"],
        eos_id=ev["eos"],
        seed=int(ev["seed"]),
        cls=ev["cls"],
        priority=int(ev["prio"]),
        ttft_deadline_s=ev["ttft_dl"],
        deadline_s=ev["dl"],
        # adapter identity: key absent = base model, which is also how
        # every pre-adapter journal reads (module docstring)
        adapter=ev.get("adp"))
    r.submit_time = ev["t"]
    return r


def recover_state(events: list[dict]) -> dict[int, Request]:
    """Fold journal events into per-request snapshots, keyed by rid.

    Each snapshot is a :class:`Request` carrying the journaled prompt,
    sampling params, deadlines, emitted tokens and the LIVE key state
    (``key_data``/``draft_key_data`` from the last token record — what
    makes the continued decode bit-exact).  ``state`` is ``DONE``/``SHED``
    for acknowledged requests, ``QUEUED`` for in-flight ones — including a
    request that crashed mid-prefill (no tokens yet: its stream restarts
    from the prompt on the seed's own key).  A request whose last journaled
    token already finished it is promoted to ``DONE`` here (the ``done``
    record died with the crash; the stream is complete and identical)."""
    reqs: dict[int, Request] = {}
    for ev in events:
        kind = ev["ev"]
        if kind == "submit":
            r = _request_from(ev)
            reqs[r.rid] = r
        elif kind == "tok":
            r = reqs[int(ev["rid"])]
            r.tokens.append(int(ev["tok"]))
            r.key_data = np.asarray(ev["kd"], np.uint32)
            if ev.get("dkd") is not None:
                r.draft_key_data = np.asarray(ev["dkd"], np.uint32)
            if r.first_token_time is None and ev.get("t") is not None:
                r.first_token_time = ev["t"]
        elif kind == "done":
            r = reqs[int(ev["rid"])]
            r.state = DONE
            r.finish_reason = ev["reason"]
            r.done_time = ev.get("t")
        elif kind == "shed":
            r = reqs[int(ev["rid"])]
            r.state = SHED
            r.finish_reason = ev["reason"]
            r.done_time = ev.get("t")
        elif kind == "snap":
            # one request's whole folded state (rotation / migration):
            # REPLACES any earlier state for the rid — the writer already
            # folded everything the replaced records said
            r = _request_from(ev)
            r.state = ev["state"]
            r.finish_reason = ev["reason"]
            r.tokens[:] = [int(t) for t in ev["toks"]]
            if ev["kd"] is not None:
                r.key_data = np.asarray(ev["kd"], np.uint32)
            if ev.get("dkd") is not None:
                r.draft_key_data = np.asarray(ev["dkd"], np.uint32)
            r.first_token_time = ev["ftt"]
            r.done_time = ev["dt"]
            # migration cause: absent in pre-disaggregation journals (the
            # pinned tolerance), and distinct from the "reason" key above
            # (finish_reason — see module docstring)
            r.snap_reason = ev.get("why")
            reqs[r.rid] = r
        elif kind == "handoff":
            # the request moved to another replica's journal: drop it here
            # so a source-replica loss can never re-adopt (double-serve) it
            reqs.pop(int(ev["rid"]), None)
        # "restart" records are observability only
    for r in reqs.values():
        if r.state == QUEUED and r.tokens:
            reason = r.finished_by(r.tokens[-1])
            if reason is not None:
                # the not-acked corner: finished at the crash boundary
                r.state = DONE
                r.finish_reason = reason
    return reqs


class RequestJournal:
    """One serving run's journal file, opened for durable appends.

    Opening an existing path first truncates it to its longest valid
    prefix (:func:`read_journal`) — the previous process's torn tail is
    discarded BEFORE anything new lands after it.  ``sync=True`` (default)
    fsyncs every append: a record the supervisor acted on is on disk, the
    property the recovery guarantees rest on.  ``sync=False`` keeps the
    write-ordering guarantees (flush per append) without the disk round
    trip — for tests and virtual-clock scenario runs where the OS page
    cache is durability enough.
    """

    def __init__(self, path: str, sync: bool = True) -> None:
        self.path = path
        self.sync = sync
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        events, valid = read_journal(path)
        self._recovered_events = events
        if os.path.exists(path) and os.path.getsize(path) != valid:
            with open(path, "r+b") as f:
                f.truncate(valid)
        self._f = open(path, "ab")
        self.bytes = valid

    # -- write side --------------------------------------------------------

    def append(self, ev: dict) -> None:
        line = (json.dumps(ev, separators=(",", ":")) + "\n").encode()
        self._f.write(line)
        self._f.flush()
        if self.sync:
            os.fsync(self._f.fileno())
        self.bytes += len(line)

    @staticmethod
    def _tick_field(tick) -> dict:
        """The monotonic ``tick`` rider (the supervisor's restart-surviving
        counter): present when the writer supplies one, absent otherwise —
        which is also the backward-compat story: :func:`recover_state`
        never reads it, so journals written before the field existed (and
        writers that never pass it) stay cold-restartable unchanged. Its
        purpose is the FORENSIC join — post-mortem bundle flight-recorder
        rows carry the same tick, so journal lines and engine snapshots
        line up exactly."""
        return {} if tick is None else {"tick": int(tick)}

    def log_submit(self, *, rid: int, prompt, max_new: int, temp: float,
                   top_k, top_p, eos, seed: int, cls, prio: int,
                   ttft_dl, dl, t, tick=None, adapter=None) -> None:
        self.append({"ev": "submit", "rid": rid,
                     "prompt": [int(x) for x in np.asarray(prompt)],
                     "max_new": int(max_new), "temp": float(temp),
                     "top_k": top_k, "top_p": top_p, "eos": eos,
                     "seed": int(seed), "cls": cls, "prio": int(prio),
                     "ttft_dl": ttft_dl, "dl": dl, "t": t,
                     **({} if adapter is None else {"adp": adapter}),
                     **self._tick_field(tick)})

    def log_token(self, request: Request, token: int, tick=None) -> None:
        """One emitted token WITH the request's post-emit key state (the
        engine updates ``key_data`` before ``emit`` fires the callback, so
        at call time the fields are exactly what the continuation needs).
        ``t`` rides only on the first token — it restores
        ``first_token_time`` (the TTFT endpoint) across a recovery.

        Speculative-tick caveat: a tick that accepts several tokens emits
        them all under the tick's single post-verify key state, so those
        records share one ``kd`` — a SAMPLED speculative stream is
        therefore recoverable at tick granularity only.  Every in-process
        recovery path (the injected faults fire at tick boundaries) and
        every greedy stream (greedy consumes no key splits at all) stays
        exactly bit-exact; the one exposure is a hard process kill landing
        BETWEEN two fsyncs of the same sampled speculative tick, where a
        cold restart resumes that request deterministically but off the
        tick-atomic key sequence."""
        dkd = request.draft_key_data
        self.append({
            "ev": "tok", "rid": request.rid, "tok": int(token),
            "kd": [int(x) for x in np.asarray(request.key_data)],
            "dkd": None if dkd is None else [int(x) for x in
                                             np.asarray(dkd)],
            **({"t": request.first_token_time}
               if len(request.tokens) == 1 else {}),
            **self._tick_field(tick)})

    def log_done(self, *, rid: int, reason: str, t=None, tick=None) -> None:
        self.append({"ev": "done", "rid": rid, "reason": reason, "t": t,
                     **self._tick_field(tick)})

    def log_shed(self, *, rid: int, reason: str, t=None, tick=None) -> None:
        self.append({"ev": "shed", "rid": rid, "reason": reason, "t": t,
                     **self._tick_field(tick)})

    def log_restart(self, n: int, degraded: bool, cause: str,
                    tick=None) -> None:
        self.append({"ev": "restart", "n": int(n),
                     "degraded": bool(degraded), "cause": cause,
                     **self._tick_field(tick)})

    def log_snapshot(self, request: Request, tick=None,
                     reason: str | None = None) -> None:
        """One request's ENTIRE state as a single ``snap`` record (module
        docstring grammar) — what :meth:`rotate` compacts to and what
        cross-replica migration writes into the adopting replica's
        journal so it alone can recover the adoptee. ``reason`` is the
        migration cause (``"failure"``/``"handoff"``), journaled under
        the ``why`` key and absent when None — see the module docstring
        for why it cannot ride the ``reason`` key."""
        kd, dkd = request.key_data, request.draft_key_data
        self.append({
            "ev": "snap", "rid": request.rid,
            "prompt": [int(x) for x in np.asarray(request.prompt)],
            "max_new": int(request.max_new_tokens),
            "temp": float(request.temperature),
            "top_k": request.top_k, "top_p": request.top_p,
            "eos": request.eos_id, "seed": int(request.seed),
            "cls": request.cls, "prio": int(request.priority),
            "ttft_dl": request.ttft_deadline_s, "dl": request.deadline_s,
            **({} if getattr(request, "adapter", None) is None
               else {"adp": request.adapter}),
            "t": request.submit_time, "state": request.state,
            "reason": request.finish_reason,
            "toks": [int(t) for t in request.tokens],
            "kd": None if kd is None else [int(x) for x in np.asarray(kd)],
            "dkd": (None if dkd is None
                    else [int(x) for x in np.asarray(dkd)]),
            "ftt": request.first_token_time, "dt": request.done_time,
            **({} if reason is None else {"why": reason}),
            **self._tick_field(tick)})

    def log_handoff(self, *, rid: int, dst=None, tick=None) -> None:
        """The rid moved to replica ``dst``'s journal (a prefill->decode
        handoff): terminal for THIS journal — recovery drops the rid."""
        self.append({"ev": "handoff", "rid": int(rid),
                     "dst": None if dst is None else int(dst),
                     **self._tick_field(tick)})

    def rotate(self, tick=None) -> int:
        """Compact the journal in place: fold everything durable into
        per-request snapshots and rewrite the file as ONE ``snap`` record
        per rid (rid order), atomically (write-then-rename, the checkpoint
        store's discipline — a crash mid-rotation leaves either the old
        journal or the new one, never a hybrid). Returns bytes reclaimed.

        The pinned contract: ``recover_state`` over the rotated journal
        yields byte-identical snapshots to recovery from the unrotated one — rotation changes the replay COST of a
        cold restart (no more re-reading the full token history), never
        its result. Restart records are observability-only and dropped."""
        self._f.flush()
        events, old_bytes = read_journal(self.path)
        snaps = recover_state(events)
        tmp = self.path + ".rotate"
        writer = RequestJournal.__new__(RequestJournal)
        writer.path, writer.sync, writer.bytes = tmp, self.sync, 0
        writer._recovered_events = []
        writer._f = open(tmp, "wb")
        try:
            for rid in sorted(snaps):
                # a recovered migration cause survives compaction (None for
                # never-migrated rids and pre-field journals: key absent,
                # so rotation stays byte-identical for them)
                writer.log_snapshot(snaps[rid], tick=tick,
                                    reason=snaps[rid].snap_reason)
        finally:
            writer.close()
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "ab")
        self.bytes = os.path.getsize(self.path)
        return old_bytes - self.bytes

    def tail(self, n: int = 64) -> list[dict]:
        """The last ``n`` valid journal events, re-read from disk — the
        post-mortem bundle's journal block (bundles are rare; the re-read
        keeps this as honest as :meth:`recovered_state`)."""
        self._f.flush()
        events, _ = read_journal(self.path)
        return events[-n:]

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            if self.sync:
                os.fsync(self._f.fileno())
            self._f.close()

    # -- read side ---------------------------------------------------------

    @property
    def recovered_events(self) -> list[dict]:
        """The valid events found on disk when this journal was OPENED —
        the cold-start recovery input (empty for a fresh file)."""
        return self._recovered_events

    def recovered_state(self) -> dict[int, Request]:
        """Re-read the file from disk and fold it into request snapshots —
        the crash-recovery entry point.  Deliberately NOT served from
        in-process memory: recovery must believe only what an fsync made
        durable, or the bit-exactness claim is about the wrong state."""
        self._f.flush()
        events, _ = read_journal(self.path)
        return recover_state(events)
