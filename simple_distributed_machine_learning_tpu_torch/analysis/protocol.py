"""Bounded model checking of the serve fleet protocol.

Port of ``analysis/protocol.py`` (pure stdlib, no torch: the port keeps
its own copy, and its reports are byte-identical to the JAX package's).
The journal snap/adopt/handoff protocol (``serve/journal.py``,
``serve/supervisor.py``, ``serve/fleet.py``) argues its safety story in
prose: the terminal ``handoff`` tombstone prevents double-serve, the
adopting replica's ``snap`` makes its journal self-sufficient, refcounts
conserve, boarding blocks until a host-tier upload lands. The chaos drills
sample that story — one fault at one tick; this module PROVES it (to a
depth bound) by exhaustive interleaving exploration over a small-step
abstraction of the fleet:

- abstract replicas with a pool role, a free-block counter and an
  append-only journal of event tuples mirroring the real grammar
  (``submit``/``tok``/``done``/``shed``/``snap``/``handoff``);
- per-request lifecycle ``q``/``a``/``d``/``s`` (queued/active/done/shed)
  plus ghost fields — tokens delivered to the caller, completions seen —
  that make double-serve an observable state property;
- transitions for every interleaving point the real fleet has: the
  journaled-but-not-admitted submit corner, boarding, token emission,
  shedding, the three-step handoff (release / adopt / seal), single-replica
  crash with journal-only migration (including the replica-kill-racing-
  adopt point between adopt and seal — the ``fleet.handoff`` fault site),
  whole-host crash with cold recovery from every journal, host-upload
  landing, and drain-then-retire.

Fidelity note: single-replica crashes are generated only at the points the
real fleet can observe one (the ``fleet.tick`` probe, and ``fleet.handoff``
between adopt and seal); the whole-host crash (``crash_host``) can land
between ANY two journal appends — that is the transition that found the
tombstone-before-copy ordering bug the copy-then-tombstone fix in
``ServeFleet._handoff_step`` closes.

Every violation renders as a finite counterexample trace and exports as a
``resilience/faults.py`` FaultPlan schedule (:func:`export_fault_plan`),
so a failing model run becomes a replayable chaos drill — closing the loop
with ``drill_coverage``. Pure stdlib: no torch, no numpy —
``python -m simple_distributed_machine_learning_tpu_torch.analysis
--serve-protocol`` runs in well under a second on a CPU.
"""

from __future__ import annotations

import dataclasses

from simple_distributed_machine_learning_tpu_torch.analysis.report import (
    Finding,
    Report,
    Severity,
)
from simple_distributed_machine_learning_tpu_torch.analysis.statespace import (  # noqa: E501
    Violation,
    explore,
)

#: abstract request lifecycle (the model's compressed spelling of
#: serve/request.py's QUEUED/ACTIVE/DONE/SHED)
Q, A, D, S = "q", "a", "d", "s"

#: the safety invariants the checker proves, in report order
INVARIANTS = ("double-serve", "lost-request", "refcount", "boarding-gate",
              "journal-grammar")


@dataclasses.dataclass(frozen=True)
class ProtocolConfig:
    """One model-checking run's fleet shape, fault budgets and protocol
    variant. The defect knobs exist for the seeded fixtures: each flips
    the abstraction to a protocol the real code must never implement, and
    the checker must produce the counterexample proving why."""

    n_prefill: int = 1
    n_decode: int = 1
    n_requests: int = 2
    need_tokens: int = 2          # tokens to finish a request
    blocks_per_replica: int = 2
    crash_budget: int = 1
    handoff_budget: int = 1
    shed_budget: int = 1
    upload_rids: tuple = (1,)     # rids with an in-flight host->HBM upload
    depth: int = 8
    allow_retire: bool = True
    # -- protocol variant / defect knobs ----------------------------------
    #: "copy-then-tombstone" is the fixed ordering (adopt journals the snap
    #: on the destination BEFORE the source journals the terminal handoff);
    #: "tombstone-then-copy" is the pre-fix ordering, kept as the seeded
    #: defect that loses a request to a host crash between the two appends
    handoff_order: str = "copy-then-tombstone"
    drop_tombstone: bool = False  # defect: terminal handoff never journaled
    refund_on_shed: bool = True   # defect False: shed skips block refund
    recovery_dedup: bool = True   # the _lose_replica live-elsewhere guard
    gate_uploads: bool = True     # boarding blocked until upload lands

    def __post_init__(self):
        if self.n_prefill < 1 or self.n_decode < 1:
            raise ValueError("a disaggregated model needs >= 1 replica "
                             "per pool")
        if self.need_tokens < 1 or self.n_requests < 0:
            raise ValueError("need_tokens >= 1 and n_requests >= 0")
        if self.handoff_order not in ("copy-then-tombstone",
                                      "tombstone-then-copy"):
            raise ValueError(f"unknown handoff_order "
                             f"{self.handoff_order!r}")

    @property
    def n_replicas(self) -> int:
        return self.n_prefill + self.n_decode

    def summary(self) -> str:
        knobs = [k for k, bad in (
            ("tombstone-first", self.handoff_order == "tombstone-then-copy"),
            ("drop-tombstone", self.drop_tombstone),
            ("skip-refund", not self.refund_on_shed),
            ("no-recovery-dedup", not self.recovery_dedup),
            ("ungated-uploads", not self.gate_uploads)) if bad]
        return (f"{self.n_prefill}p+{self.n_decode}d replicas, "
                f"{self.n_requests} reqs x {self.need_tokens} toks, "
                f"budgets crash={self.crash_budget} "
                f"handoff={self.handoff_budget} shed={self.shed_budget}, "
                f"depth {self.depth}"
                + (f", defects: {'+'.join(knobs)}" if knobs else ""))


# -- state ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Rep:
    """One abstract replica. ``live`` entries are ``(rid, state, ntok,
    blocks)`` sorted by rid (finished requests stay, like the real
    ``supervisor.requests`` dict); ``pending`` rids are journaled but not
    yet admitted (the mid-submit crash corner)."""

    idx: int
    role: str                  # "prefill" | "decode"
    alive: bool
    journal: tuple             # event tuples, see _fold
    live: tuple
    pending: tuple
    free: int


@dataclasses.dataclass(frozen=True)
class _State:
    """The whole fleet plus ghost observables. ``limbo`` holds the one
    in-memory mid-handoff handle: ``(rid, ntok, src, dst, stage)`` with
    stage ``released`` (detached from the source) or ``adopted`` (snap
    journaled on the destination, tombstone not yet sealed)."""

    reps: tuple
    limbo: tuple
    uploads: tuple             # rids whose host->HBM upload is in flight
    submitted: int             # rids 0..submitted-1 have journaled submits
    delivered: tuple           # ghost: tokens handed to the caller, per rid
    done_ct: tuple             # ghost: completions observed, per rid
    shed_ct: tuple             # ghost: sheds observed, per rid
    crash_budget: int
    handoff_budget: int
    shed_budget: int


def _initial(cfg: ProtocolConfig) -> _State:
    reps = tuple(
        _Rep(idx=i, role=("prefill" if i < cfg.n_prefill else "decode"),
             alive=True, journal=(), live=(), pending=(),
             free=cfg.blocks_per_replica)
        for i in range(cfg.n_replicas))
    zeros = (0,) * cfg.n_requests
    return _State(reps=reps, limbo=(), uploads=tuple(sorted(
                      r for r in cfg.upload_rids if r < cfg.n_requests)),
                  submitted=0, delivered=zeros, done_ct=zeros,
                  shed_ct=zeros, crash_budget=cfg.crash_budget,
                  handoff_budget=cfg.handoff_budget,
                  shed_budget=cfg.shed_budget)


# -- journal fold (the model's recover_state) -------------------------------

def _fold(journal, need: int):
    """Fold one abstract journal into ``{rid: (state, ntok)}`` plus a list
    of grammar-discipline errors — the model twin of
    ``serve/journal.py::recover_state``, including the terminal-tombstone
    drop, snap replacement (which resurrects a rid adopted BACK after its
    handoff) and the journaled-but-not-acked DONE promotion."""
    reqs: dict = {}
    dropped: set = set()
    errs: list[str] = []
    for ev in journal:
        kind, rid = ev[0], ev[1]
        if kind == "snap":
            dropped.discard(rid)
            reqs[rid] = [ev[3] if len(ev) > 4 else Q, ev[2]]
            continue
        if rid in dropped:
            errs.append(f"'{kind}' for rid {rid} after its handoff "
                        f"tombstone — the journal grammar marks the rid "
                        f"as moved out")
            continue
        if kind == "submit":
            reqs[rid] = [Q, 0]
        elif kind == "tok":
            if rid not in reqs:
                errs.append(f"'tok' for rid {rid} with no submit/snap")
            elif reqs[rid][0] in (D, S):
                errs.append(f"'tok' for rid {rid} after it finished")
            else:
                reqs[rid][1] += 1
        elif kind == "done":
            if rid not in reqs:
                errs.append(f"'done' for rid {rid} with no submit/snap")
            elif reqs[rid][0] == D:
                errs.append(f"double 'done' for rid {rid}")
            else:
                reqs[rid][0] = D
        elif kind == "shed":
            if rid not in reqs:
                errs.append(f"'shed' for rid {rid} with no submit/snap")
            else:
                reqs[rid][0] = S
        elif kind == "handoff":
            reqs.pop(rid, None)
            dropped.add(rid)
        else:
            errs.append(f"unknown journal event kind {kind!r}")
    for st in reqs.values():
        if st[0] == Q and st[1] >= need:
            st[0] = D               # the not-acked promotion
    return {rid: tuple(st) for rid, st in reqs.items()}, errs


def abstract_recover(events: list) -> dict:
    """The model's fold over REAL journal records (dicts straight from
    ``read_journal``): ``{rid: (state, n_tokens)}`` with the same
    discipline ``recover_state`` implements — what the old-grammar
    regression test pins the two against. Tick-less and ``why``-less
    records (pre-field journals) fold identically: neither key is read."""
    model_evs = []
    budgets: dict = {}               # per-rid max_new rides submit/snap
    for ev in events:
        kind = ev.get("ev")
        if kind == "submit":
            budgets[int(ev["rid"])] = int(ev["max_new"])
            model_evs.append(("submit", int(ev["rid"])))
        elif kind in ("tok", "done", "shed", "handoff"):
            model_evs.append((kind, int(ev["rid"])))
        elif kind == "snap":
            st = {"queued": Q, "active": Q, "done": D, "shed": S}.get(
                ev.get("state"), Q)
            budgets[int(ev["rid"])] = int(ev["max_new"])
            model_evs.append(("snap", int(ev["rid"]),
                              len(ev.get("toks", ())), st, ev.get("why")))
        # "restart" records are observability-only, exactly like the real
        # fold — the journal-grammar hostlint rule pins that every other
        # kind a writer emits lands in one of these branches
    reqs, _errs = _fold(tuple(model_evs), need=1 << 30)
    out = {}
    for rid, (st, ntok) in reqs.items():
        if st == Q and rid in budgets and ntok >= budgets[rid]:
            st = D
        out[rid] = (st, ntok)
    return out


# -- transitions ------------------------------------------------------------

def _rep_replace(s: _State, rep: _Rep, **kw) -> _State:
    reps = tuple(dataclasses.replace(r, **kw) if r.idx == rep.idx else r
                 for r in s.reps)
    return dataclasses.replace(s, reps=reps)


def _live_get(rep: _Rep, rid: int):
    for e in rep.live:
        if e[0] == rid:
            return e
    return None


def _live_set(live: tuple, entry) -> tuple:
    return tuple(sorted([e for e in live if e[0] != entry[0]] + [entry]))


def _live_del(live: tuple, rid: int) -> tuple:
    return tuple(e for e in live if e[0] != rid)


def _bump(t: tuple, i: int, by: int = 1) -> tuple:
    return t[:i] + (t[i] + by,) + t[i + 1:]


def _alive(s: _State):
    return [r for r in s.reps if r.alive]


def _adopt_target(s: _State, ntok: int, exclude=()):
    """Deterministic loss-migration routing: the degradation chain
    ``_role_candidates`` implements, collapsed to lowest-idx (the model
    has no affinity state to break ties with)."""
    role = "decode" if ntok > 0 else "prefill"
    cands = ([r for r in _alive(s) if r.role == role
              and r.idx not in exclude]
             or [r for r in _alive(s) if r.idx not in exclude])
    return cands[0] if cands else None


def _adopt_onto(s: _State, rep: _Rep, rid: int, ntok: int,
                why: str) -> _State:
    """Journal the snap FIRST, then restore — the ``adopt`` discipline."""
    s = _rep_replace(
        s, rep,
        journal=rep.journal + (("snap", rid, ntok, Q, why),),
        live=_live_set(rep.live, (rid, Q, ntok, 0)))
    return s


def _crash_rep(cfg: ProtocolConfig, s: _State, rep: _Rep) -> _State:
    """One replica dies; the fleet migrates off its journal alone —
    ``ServeFleet._lose_replica`` with (when ``recovery_dedup``) the
    live-elsewhere guard. The dead journal is cleared afterwards: it is
    never read again, and normalizing it collapses equivalent states."""
    folded, _errs = _fold(rep.journal, cfg.need_tokens)
    s = _rep_replace(s, rep, alive=False, journal=(), live=(),
                     pending=(), free=0)
    for rid in sorted(folded):
        st, ntok = folded[rid]
        if st in (D, S):
            continue                       # handle-only adoption
        if cfg.recovery_dedup and any(
                _live_get(r, rid) is not None or rid in r.pending
                for r in _alive(s)):
            continue                       # live elsewhere: never re-adopt
        target = _adopt_target(s, ntok)
        if target is None:                 # no survivor (model boundary)
            continue
        s = _adopt_onto(s, target, rid, ntok, "failure")
    return s


def _crash_host(cfg: ProtocolConfig, s: _State) -> _State:
    """The whole fleet process dies between any two journal appends: every
    in-memory structure (limbo included) is gone; each alive replica cold-
    restarts from its own journal; rids live in several journals (a
    mid-handoff crash without the tombstone) dedup to the copy with the
    most progress, lowest idx first — the deterministic recovery rule."""
    terminal: set = set()                   # a done/shed record anywhere
    for r in _alive(s):                     # proves completion: never
        folded, _errs = _fold(r.journal, cfg.need_tokens)
        terminal.update(rid for rid, (st, _n) in folded.items()
                        if st in (D, S))    # re-serve such a rid
    winners: dict = {}                      # rid -> (ntok, idx)
    for r in _alive(s):
        folded, _errs = _fold(r.journal, cfg.need_tokens)
        for rid, (st, ntok) in folded.items():
            if st in (D, S) or rid in terminal:
                continue
            best = winners.get(rid)
            if best is None or ntok > best[0]:
                winners[rid] = (ntok, r.idx)
    reps = []
    for r in s.reps:
        if not r.alive:
            reps.append(r)
            continue
        folded, _errs = _fold(r.journal, cfg.need_tokens)
        # recover_state keeps finished handles too — the post-restart
        # requests dict is what the replica-loss dedup guard consults
        live = tuple(sorted(
            (rid, st, ntok, 0) for rid, (st, ntok) in folded.items()
            if (st in (D, S)) or (st == Q and winners.get(
                rid, (None, None))[1] == r.idx)))
        reps.append(dataclasses.replace(
            r, live=live, pending=(), free=cfg.blocks_per_replica))
    return dataclasses.replace(s, reps=tuple(reps), limbo=())


def _transitions(cfg: ProtocolConfig):
    def gen(s: _State):
        out = []
        alive = _alive(s)
        limbo_released = any(e[4] == "released" for e in s.limbo)
        # -- submit (journal, then admit: the mid-submit crash corner) ----
        if s.submitted < cfg.n_requests:
            rid = s.submitted
            cands = ([r for r in alive if r.role == "prefill"] or alive)
            if cands:
                t = cands[0]
                out.append((("submit_journal", rid), dataclasses.replace(
                    _rep_replace(s, t,
                                 journal=t.journal + (("submit", rid),),
                                 pending=t.pending + (rid,)),
                    submitted=rid + 1)))
        for r in alive:
            for rid in r.pending:
                out.append((("submit_admit", r.idx, rid), _rep_replace(
                    s, r, pending=tuple(p for p in r.pending if p != rid),
                    live=_live_set(r.live, (rid, Q, 0, 0)))))
        # -- board / tok / shed ------------------------------------------
        for r in alive:
            for (rid, st, ntok, blocks) in r.live:
                if st == Q and r.free > 0:
                    if (rid in s.uploads and r.role == "decode"
                            and cfg.gate_uploads):
                        continue    # boarding blocked until upload lands
                    out.append((("board", r.idx, rid), _rep_replace(
                        s, r, free=r.free - 1,
                        live=_live_set(r.live, (rid, A, ntok, blocks + 1)))))
        for r in alive:
            for (rid, st, ntok, blocks) in r.live:
                if st != A:
                    continue
                n2 = ntok + 1
                if n2 >= cfg.need_tokens:       # finishing token + done ack
                    s2 = _rep_replace(
                        s, r, free=r.free + blocks,
                        journal=r.journal + (("tok", rid), ("done", rid)),
                        live=_live_set(r.live, (rid, D, n2, 0)))
                    s2 = dataclasses.replace(
                        s2, delivered=_bump(s2.delivered, rid),
                        done_ct=_bump(s2.done_ct, rid))
                else:
                    s2 = _rep_replace(
                        s, r, journal=r.journal + (("tok", rid),),
                        live=_live_set(r.live, (rid, A, n2, blocks)))
                    s2 = dataclasses.replace(
                        s2, delivered=_bump(s2.delivered, rid))
                out.append((("tok", r.idx, rid), s2))
                if s.shed_budget > 0:
                    refund = blocks if cfg.refund_on_shed else 0
                    s3 = _rep_replace(
                        s, r, free=r.free + refund,
                        journal=r.journal + (("shed", rid),),
                        live=_live_set(r.live, (rid, S, ntok, 0)))
                    s3 = dataclasses.replace(
                        s3, shed_ct=_bump(s3.shed_ct, rid),
                        shed_budget=s.shed_budget - 1)
                    out.append((("shed", r.idx, rid), s3))
        # -- the three-step handoff --------------------------------------
        if s.handoff_budget > 0 and not s.limbo:
            for src in alive:
                if src.role != "prefill":
                    continue
                for (rid, st, ntok, blocks) in src.live:
                    if st != A or not 0 < ntok < cfg.need_tokens:
                        continue
                    dsts = [r for r in alive if r.role == "decode"
                            and r.idx != src.idx]
                    if not dsts:
                        continue
                    dst = dsts[0]
                    jr = src.journal
                    if (cfg.handoff_order == "tombstone-then-copy"
                            and not cfg.drop_tombstone):
                        jr = jr + (("handoff", rid, dst.idx),)
                    s2 = _rep_replace(s, src, free=src.free + blocks,
                                      live=_live_del(src.live, rid),
                                      journal=jr)
                    s2 = dataclasses.replace(
                        s2, handoff_budget=s.handoff_budget - 1,
                        limbo=s2.limbo + ((rid, ntok, src.idx, dst.idx,
                                           "released"),))
                    out.append((("handoff_begin", src.idx, rid), s2))
        for e in s.limbo:
            rid, ntok, src_i, dst_i, stage = e
            if stage == "released":
                dst = next((r for r in s.reps
                            if r.idx == dst_i and r.alive), None)
                if dst is None:             # original target died: re-route
                    dst = _adopt_target(s, ntok, exclude=(src_i,))
                if dst is None:
                    continue
                s2 = _adopt_onto(s, dst, rid, ntok, "handoff")
                if cfg.handoff_order == "tombstone-then-copy":
                    new_limbo = tuple(x for x in s.limbo if x != e)
                else:
                    new_limbo = tuple(
                        (rid, ntok, src_i, dst.idx, "adopted")
                        if x == e else x for x in s.limbo)
                s2 = dataclasses.replace(s2, limbo=new_limbo)
                out.append((("handoff_adopt", dst.idx, rid), s2))
            else:                           # "adopted": seal the tombstone
                src = next((r for r in s.reps
                            if r.idx == src_i and r.alive), None)
                s2 = dataclasses.replace(
                    s, limbo=tuple(x for x in s.limbo if x != e))
                if src is not None and not cfg.drop_tombstone:
                    s2 = _rep_replace(
                        s2, src,
                        journal=src.journal + (("handoff", rid, dst_i),))
                out.append((("handoff_seal", src_i, rid), s2))
        # -- crashes ------------------------------------------------------
        if s.crash_budget > 0:
            for r in alive:
                if len(alive) < 2:
                    break       # the fleet replaces its last replica; the
                    #             model keeps a fixed set (boundary)
                mid = next((e for e in s.limbo
                            if e[2] == r.idx and e[4] == "adopted"), None)
                if limbo_released or (s.limbo and mid is None):
                    # the real fleet's replica-kill interleaving points are
                    # fleet.tick (limbo empty) and fleet.handoff (between
                    # adopt and seal, source only)
                    continue
                label = (("crash", r.idx, "mid-handoff") if mid
                         else ("crash", r.idx))
                s2 = dataclasses.replace(_crash_rep(cfg, s, r),
                                         crash_budget=s.crash_budget - 1)
                out.append((label, s2))
            out.append((("crash_host",), dataclasses.replace(
                _crash_host(cfg, s), crash_budget=s.crash_budget - 1)))
        # -- upload landing / retire --------------------------------------
        for rid in s.uploads:
            out.append((("upload_lands", rid), dataclasses.replace(
                s, uploads=tuple(u for u in s.uploads if u != rid))))
        if cfg.allow_retire and not s.limbo:
            for r in alive:
                if len(alive) < 2:
                    break
                if r.pending or any(st in (Q, A) for _, st, _, _ in r.live):
                    continue    # drain-then-retire: only observed-idle
                out.append((("retire", r.idx), _rep_replace(
                    s, r, alive=False, journal=(), live=(), free=0)))
        return out
    return gen


# -- invariants -------------------------------------------------------------

def _invariants(cfg: ProtocolConfig):
    def double_serve(s: _State):
        homes: dict = {}
        for r in _alive(s):
            for (rid, st, ntok, _b) in r.live:
                if st in (Q, A):
                    if rid in homes:
                        return (f"rid {rid} is live on replicas "
                                f"{homes[rid]} and {r.idx} at once")
                    homes[rid] = r.idx
            for rid in r.pending:
                homes.setdefault(rid, r.idx)
        for rid in range(cfg.n_requests):
            if s.done_ct[rid] > 1:
                return f"rid {rid} completed {s.done_ct[rid]} times"
            if s.done_ct[rid] and (rid in homes or any(
                    e[0] == rid and e[4] == "released" for e in s.limbo)):
                return (f"rid {rid} already completed once yet is live "
                        f"again (re-adopted after done) — it will be "
                        f"served twice")
            if s.delivered[rid] > cfg.need_tokens:
                return (f"rid {rid} delivered {s.delivered[rid]} tokens, "
                        f"budget {cfg.need_tokens}")
        return None

    def lost_request(s: _State):
        for rid in range(s.submitted):
            if s.done_ct[rid] or s.shed_ct[rid]:
                continue
            if any(e[0] == rid for e in s.limbo):
                continue
            present = False
            for r in _alive(s):
                if rid in r.pending or _live_get(r, rid) is not None:
                    present = True
                    break
                folded, _errs = _fold(r.journal, cfg.need_tokens)
                if rid in folded:
                    present = True
                    break
            if not present and not any(e[0] == rid for e in s.limbo):
                return (f"rid {rid} was submitted, never finished, and is "
                        f"recoverable from no alive replica's journal — "
                        f"the request is lost")
        return None

    def refcount(s: _State):
        for r in _alive(s):
            held = sum(b for (_rid, _st, _n, b) in r.live)
            if r.free + held != cfg.blocks_per_replica or r.free < 0:
                return (f"replica {r.idx}: free={r.free} + held={held} != "
                        f"capacity={cfg.blocks_per_replica} — block "
                        f"refcounts do not conserve")
        return None

    def boarding_gate(s: _State):
        for r in _alive(s):
            if r.role != "decode":
                continue
            for (rid, st, _n, _b) in r.live:
                if st == A and rid in s.uploads:
                    return (f"rid {rid} is ACTIVE on decode replica "
                            f"{r.idx} while its host->HBM upload is still "
                            f"in flight — boarding read half-uploaded "
                            f"rows")
        return None

    def journal_grammar(s: _State):
        for r in _alive(s):
            _folded, errs = _fold(r.journal, cfg.need_tokens)
            if errs:
                return f"replica {r.idx} journal: {errs[0]}"
        return None

    return {"double-serve": double_serve, "lost-request": lost_request,
            "refcount": refcount, "boarding-gate": boarding_gate,
            "journal-grammar": journal_grammar}


# -- counterexample -> chaos drill ------------------------------------------

def export_fault_plan(violation: Violation) -> tuple:
    """``(plan_text, note)`` for a counterexample trace. ``plan_text`` is
    a ``FaultPlan.parse``-able schedule (the ``--chaos``/``SDML_CHAOS``
    grammar) covering every crash in the trace: plain crashes map to
    ``replica-kill@fleet.tick`` (the k-th crash carries ``after=k``, so a
    replay fires them in trace order, one fleet tick apart) and
    mid-handoff crashes to ``replica-kill@fleet.handoff``. ``None`` when
    the trace needs a whole-host crash — no real injection site can lose
    the fleet process's memory, which is exactly why that failure mode
    must be model-checked rather than drilled."""
    specs = []
    tick_crashes = 0
    for lab in violation.trace:
        if lab[0] == "crash_host":
            return None, ("counterexample requires a whole-host crash "
                          "between two journal appends; model-only (no "
                          "schedulable injection site)")
        if lab[0] != "crash":
            continue
        if len(lab) > 2:                    # mid-handoff: adopt/seal race
            specs.append(f"replica-kill@fleet.handoff,rank={lab[1]}")
        else:
            spec = f"replica-kill@fleet.tick,rank={lab[1]}"
            if tick_crashes:
                spec += f",after={tick_crashes}"
            specs.append(spec)
            tick_crashes += 1
    if not specs:
        return None, "counterexample contains no crash transitions"
    return ";".join(specs), f"{len(specs)} scheduled fault(s)"


def render_drill(violation: Violation, cfg: ProtocolConfig) -> str:
    """The exportable ``.chaos`` artifact: the abstract counterexample as
    comments, the replayable FaultPlan schedule as the payload line.
    ``load_drill`` reads it back; ``drill_coverage`` scans these files as
    a coverage source."""
    lines = ["# chaos drill exported by analysis/protocol.py "
             "(bounded model checker)",
             f"# invariant violated: {violation.invariant}",
             f"# model config: {cfg.summary()}",
             "# abstract counterexample (shortest trace):"]
    for i, lab in enumerate(violation.trace):
        head, *rest = lab
        lines.append(f"#   {i + 1}. {head}"
                     + (f"({', '.join(str(x) for x in rest)})"
                        if rest else ""))
    plan, note = export_fault_plan(violation)
    lines.append(f"# {note}")
    lines.append(plan if plan is not None else "# (no schedule)")
    return "\n".join(lines) + "\n"


def load_drill(path: str) -> str | None:
    """The FaultPlan schedule text inside an exported ``.chaos`` file
    (comment and blank lines stripped), or None for a model-only drill."""
    plans = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                plans.append(line)
    return ";".join(plans) if plans else None


# -- the checker entry point ------------------------------------------------

def check_protocol(cfg: ProtocolConfig | None = None,
                   max_states: int = 500_000) -> Report:
    """Explore every interleaving of the abstract fleet to ``cfg.depth``
    and render violations as ERROR findings (rule family ``protocol``),
    each carrying its counterexample trace and exported chaos schedule.
    The returned :class:`Report` additionally exposes ``exploration``
    (the :class:`~.statespace.Exploration`) and ``verdict`` (the
    depth-honest summary line) as attributes."""
    cfg = cfg or ProtocolConfig()
    result = explore(_initial(cfg), _transitions(cfg), _invariants(cfg),
                     depth=cfg.depth, max_states=max_states)
    findings = []
    for v in sorted(result.violations, key=lambda v: v.invariant):
        plan, note = export_fault_plan(v)
        hint = (f"replay the exported chaos schedule: SDML_CHAOS='{plan}'"
                if plan is not None else f"model-only: {note}")
        findings.append(Finding(
            rule=f"protocol.{v.invariant}", severity=Severity.ERROR,
            message=v.render(), where=f"model[{cfg.summary()}]",
            hint=hint))
    if result.truncated:
        findings.append(Finding(
            rule="protocol.state-cap", severity=Severity.ERROR,
            message=f"state cap {max_states} hit after {result.states} "
                    f"states — the run proves nothing at this bound",
            where=f"model[{cfg.summary()}]",
            hint="raise max_states or shrink the model"))
    report = Report(name="serve-protocol", findings=findings)
    report.exploration = result
    report.verdict = result.verdict(INVARIANTS)
    return report


# -- the clean config and the four seeded-defect configs --------------------

#: the fleet as shipped: copy-then-tombstone handoff, recovery dedup,
#: gated uploads — must prove every invariant to depth 8 (the acceptance
#: bar: 2-pool fleet, 1 crash + 1 handoff budget)
CLEAN = ProtocolConfig()

#: the terminal handoff event dropped: a later source loss re-adopts a
#: request the decode pool already completed — double-serve
DROPPED_TOMBSTONE = ProtocolConfig(
    n_decode=2, n_requests=1, upload_rids=(), crash_budget=2,
    shed_budget=0, allow_retire=False, depth=11, drop_tombstone=True)

#: the pre-fix ordering: tombstone journaled on the source BEFORE the
#: destination's snap — a host crash between the appends loses the request
LEGACY_ORDER = ProtocolConfig(
    n_requests=1, upload_rids=(), shed_budget=0, allow_retire=False,
    depth=6, handoff_order="tombstone-then-copy")

#: shed skips the block refund — refcount conservation breaks
SKIPPED_REFUND = ProtocolConfig(
    n_requests=1, upload_rids=(), crash_budget=0, handoff_budget=0,
    allow_retire=False, depth=4, refund_on_shed=False)

#: boarding not gated on the in-flight host upload — a decode replica
#: reads half-uploaded K/V rows
UNGATED_BOARDING = ProtocolConfig(
    n_requests=1, upload_rids=(0,), crash_budget=0, shed_budget=0,
    allow_retire=False, depth=8, gate_uploads=False)
