"""Deterministic fault injection: seeded, reproducible failure schedules.

Port of ``resilience/faults.py`` (a module without JAX; the port keeps its
own copy). A :class:`FaultPlan` is a list of :class:`FaultSpec` entries —
"fire fault KIND at injection SITE when the context matches".
Instrumented code calls :func:`maybe_fire` at named sites; with no plan
installed that is one global ``is None`` check.

The kinds, the sites and the grammar are the JAX package's, so one
``--serve-chaos`` or ``--chaos`` string means one schedule in both
packages. The port instruments the training sites:

- ``train.step`` (``train/trainer.py``, before each step, ctx: ``step``):
  host-kill, slow-tick, wedged-device; loss-spike with the sentinel
- ``train.grad`` / ``data.batch`` (the same point): nan-grad /
  corrupt-batch, applied to the raw batch by the sentinel
- ``train.sigterm`` (before the snapshot): ``preempt``, a graceful stop
- ``ckpt.write`` (``train/checkpoint.py``, after the bytes, before the
  rename, ctx: ``path``, ``tmp``): ckpt-write-crash

and the serving sites:

- ``serve.tick``  (``serve/engine.py::step``, ctx: ``step`` = tick index)
- ``serve.admit`` (``serve/engine.py::submit``, ctx: ``step`` = rid — a
  crash while a request is being accepted, journaled but never admitted)
- ``fleet.tick`` (``serve/fleet.py::step``, ctx: ``step`` = fleet tick,
  ``rank`` = replica index) and ``fleet.handoff`` (the adopt->seal
  window of the disaggregated handoff): ``replica-kill`` only, read with
  :func:`check` and interpreted by the fleet

The other sites (the watchdog, the bench probe) are accepted by the
grammar and instrumented by the slices that port those layers (ROADMAP.md,
Queue A, item 6).

Standard effects (:meth:`FaultPlan.fire`): ``slow-tick`` and
``frozen-peer`` sleep ``dur`` seconds through ``plan.sleep`` (a virtual
clock's ``sleep`` in the scenario suite), ``engine-crash`` raises
:class:`EngineCrash`, ``wedged-device`` :class:`DeviceWedged`,
``host-kill`` :class:`HostLost`, ``ckpt-write-crash`` (after halving the
temp file) :class:`CheckpointWriteCrash`; the serve supervisor recovers
from the first three, the elastic supervisor from the last three. Grammar: entries separated by ``;``, each
``kind@site[=step][,key=val...]`` with keys ``dur`` (seconds), ``after``
(skip the first N matching calls), ``times`` (fire at most N times; 0 =
unlimited; default 1), ``rank`` and ``step``::

    engine-crash@serve.tick=6
    slow-tick@serve.tick,dur=0.004,after=5,times=10
    engine-crash@serve.tick,after=3,times=2
"""

from __future__ import annotations

import dataclasses
import os
import re
import time

KINDS = ("host-kill", "frozen-peer", "slow-tick", "ckpt-write-crash",
         "wedged-device", "engine-crash", "replica-kill", "nan-grad",
         "corrupt-batch", "loss-spike", "preempt")

SITES = ("train.step", "train.grad", "data.batch", "train.sigterm",
         "ckpt.write", "serve.tick", "serve.admit", "fleet.tick",
         "fleet.handoff", "watchdog.heartbeat", "bench.probe")

#: kinds the numeric-anomaly sentinel interprets itself (a bare
#: :func:`maybe_fire` raises :class:`NumericFault` for them)
SENTINEL_KINDS = ("nan-grad", "corrupt-batch", "loss-spike")

#: the kinds whose standard effect the serving stack acts on: the three
#: the serve supervisor recovers from, and the stall — the default kinds
#: :func:`drill_coverage` requires the port's tests to drill
SERVE_KINDS = ("engine-crash", "wedged-device", "host-kill", "slow-tick")

#: kinds meaningful at ONE site, and sites that accept only one kind: any
#: crossed pair would match and count without ever taking effect
_KIND_SITE = {"replica-kill": "fleet.tick", "nan-grad": "train.grad",
              "corrupt-batch": "data.batch", "preempt": "train.sigterm",
              "loss-spike": "train.step"}
_KIND_EXTRA_SITES = {"replica-kill": ("fleet.handoff",)}
_SITE_KINDS = {"fleet.tick": ("replica-kill",),
               "fleet.handoff": ("replica-kill",),
               "train.grad": ("nan-grad",),
               "data.batch": ("corrupt-batch",),
               "train.sigterm": ("preempt",)}

ENV_VAR = "SDML_CHAOS"


class FaultInjected(RuntimeError):
    """Base of every exception an injected fault raises; carries the spec."""

    def __init__(self, spec: "FaultSpec", site: str):
        super().__init__(
            f"injected fault {spec.kind!r} fired at site {site!r} "
            f"(deterministic chaos schedule — resilience/faults.py)")
        self.spec = spec
        self.site = site


class HostLost(FaultInjected):
    """A host died mid-run (injected): in-memory state is gone."""


class DeviceWedged(FaultInjected):
    """The accelerator stopped responding (injected)."""


class CheckpointWriteCrash(FaultInjected):
    """The process crashed mid-checkpoint-write (injected)."""


class EngineCrash(FaultInjected):
    """The inference engine died mid-tick or mid-admission (injected): the
    serve supervisor rebuilds it and recovers in-flight requests from the
    request journal."""


class ReplicaLost(FaultInjected):
    """A whole serving replica died (injected; the fleet interprets it)."""


class NumericFault(FaultInjected):
    """A numeric fault fired at a site nothing interprets."""


class Preempted(FaultInjected):
    """A graceful-preemption notice fired at a site nothing interprets."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault; see the module docstring for field semantics."""

    kind: str
    site: str
    step: int | None = None     # fire only when ctx["step"] == step
    rank: int | None = None     # fire only when ctx["rank"] == rank
    after: int = 0              # skip the first N matching calls
    times: int = 1              # max firings (0 = unlimited)
    dur: float = 0.05           # hold/sleep seconds (slow-tick, frozen-peer)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; known: {KINDS}")
        if self.site not in SITES:
            # strict: a typo'd site would never fire and the drill would
            # pass vacuously
            raise ValueError(
                f"unknown fault site {self.site!r}; instrumented sites: "
                f"{SITES}")
        pinned = _KIND_SITE.get(self.kind)
        if (pinned is not None and self.site != pinned
                and self.site not in _KIND_EXTRA_SITES.get(self.kind, ())):
            allowed = (pinned,) + _KIND_EXTRA_SITES.get(self.kind, ())
            raise ValueError(
                f"kind {self.kind!r} at site {self.site!r}: this kind only "
                f"pairs with {allowed} (its interpreting sites)")
        allowed = _SITE_KINDS.get(self.site)
        if allowed is not None and self.kind not in allowed:
            raise ValueError(
                f"kind {self.kind!r} at site {self.site!r}: this site only "
                f"interprets {allowed} (any other kind would never take "
                f"effect there)")
        if self.after < 0 or self.times < 0 or self.dur < 0:
            raise ValueError(
                f"after/times/dur must be >= 0, got {self.after}/"
                f"{self.times}/{self.dur}")


class FaultPlan:
    """A deterministic schedule of faults plus its firing state.

    ``check(site, **ctx)`` matches and counts without side effects;
    ``fire(site, **ctx)`` also applies each fired fault's standard effect
    — raise, or sleep through ``self.sleep`` (injectable, so a
    virtual-clock scenario advances simulated time instead of stalling).
    """

    def __init__(self, specs, sleep=time.sleep):
        self.specs = list(specs)
        self.sleep = sleep
        self._seen = [0] * len(self.specs)    # matching calls per spec
        self._fired = [0] * len(self.specs)   # firings per spec

    @classmethod
    def parse(cls, text: str, sleep=time.sleep) -> "FaultPlan":
        """Parse the ``--chaos`` / ``--serve-chaos`` grammar."""
        specs = []
        for raw in text.split(";"):
            raw = raw.strip()
            if not raw:
                continue
            head, *fields = raw.split(",")
            if "@" not in head:
                raise ValueError(
                    f"bad fault entry {raw!r}: expected kind@site[=step]"
                    f"[,key=val...]")
            kind, site = head.split("@", 1)
            kw: dict = {"kind": kind.strip()}
            site = site.strip()
            if "=" in site:
                site, step = site.split("=", 1)
                kw["step"] = int(step)
            kw["site"] = site
            for field in fields:
                if "=" not in field:
                    raise ValueError(
                        f"bad fault field {field!r} in {raw!r}: expected "
                        f"key=val")
                k, v = (s.strip() for s in field.split("=", 1))
                if k == "dur":
                    kw[k] = float(v)
                elif k in ("after", "times", "rank", "step"):
                    kw[k] = int(v)
                else:
                    raise ValueError(
                        f"unknown fault field {k!r} in {raw!r}; known: "
                        f"dur, after, times, rank, step")
            specs.append(FaultSpec(**kw))
        if not specs:
            raise ValueError(f"fault plan {text!r} contains no entries")
        return cls(specs, sleep=sleep)

    @classmethod
    def random(cls, seed: int, n: int = 3, sites=("train.step",),
               kinds=("host-kill", "slow-tick"), max_step: int = 100,
               sleep=time.sleep) -> "FaultPlan":
        """A seeded random schedule: same seed, same faults (numpy's
        generator, drawn in the JAX package's order)."""
        import numpy as np

        rng = np.random.default_rng(seed)
        steps = sorted(int(s) for s in
                       rng.choice(max_step, size=n, replace=False))
        specs = []
        for step in steps:
            kind = str(rng.choice(list(kinds)))
            # site-pinned kinds land on their interpreting site, so a
            # random schedule is always a valid one
            pinned = _KIND_SITE.get(kind)
            site = pinned if pinned else str(rng.choice(list(sites)))
            specs.append(FaultSpec(kind=kind, site=site, step=step))
        return cls(specs, sleep=sleep)

    def check(self, site: str, only=None, exclude=(),
              **ctx) -> list[FaultSpec]:
        """Specs firing for this call (matching + occurrence accounting,
        no effects). ``only``/``exclude`` filter by kind before any
        accounting: a filtered-out spec is not "seen"."""
        fired = []
        for i, spec in enumerate(self.specs):
            if spec.site != site:
                continue
            if only is not None and spec.kind not in only:
                continue
            if spec.kind in exclude:
                continue
            if spec.rank is not None and ctx.get("rank") != spec.rank:
                continue
            if spec.step is not None and ctx.get("step") != spec.step:
                continue
            seen = self._seen[i]
            self._seen[i] = seen + 1
            if seen < spec.after:
                continue
            if spec.times and self._fired[i] >= spec.times:
                continue
            self._fired[i] += 1
            fired.append(spec)
        return fired

    def fire(self, site: str, only=None, exclude=(),
             **ctx) -> list[FaultSpec]:
        """``check`` + standard effects. Sleeping faults apply first, so a
        site scheduled with a stall and a crash stalls, then dies."""
        fired = self.check(site, only=only, exclude=exclude, **ctx)
        for spec in fired:
            if spec.kind in ("slow-tick", "frozen-peer"):
                self.sleep(spec.dur)
        for spec in fired:
            if spec.kind == "host-kill":
                raise HostLost(spec, site)
            if spec.kind == "wedged-device":
                raise DeviceWedged(spec, site)
            if spec.kind == "engine-crash":
                raise EngineCrash(spec, site)
            if spec.kind == "replica-kill":
                raise ReplicaLost(spec, site)
            if spec.kind in SENTINEL_KINDS:
                raise NumericFault(spec, site)
            if spec.kind == "preempt":
                raise Preempted(spec, site)
            if spec.kind == "ckpt-write-crash":
                tmp = ctx.get("tmp")
                if tmp:
                    try:  # leave a half-written temp, like a real crash
                        with open(tmp, "r+b") as f:
                            f.truncate(max(0, os.path.getsize(tmp) // 2))
                    except OSError:
                        pass
                raise CheckpointWriteCrash(spec, site)
        return fired

    def stats(self) -> dict:
        """Per-spec firing counts (scenario reports embed this, so a run
        proves its faults actually happened)."""
        return {
            "specs": [dataclasses.asdict(s) for s in self.specs],
            "fired": list(self._fired),
            "total_fired": sum(self._fired),
        }


# -- the process-active plan (the one global the hot paths check) -----------

_ACTIVE: FaultPlan | None = None


def install(plan: FaultPlan) -> FaultPlan:
    """Make ``plan`` the process-active fault schedule (replacing any)."""
    global _ACTIVE
    _ACTIVE = plan
    return plan


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> FaultPlan | None:
    return _ACTIVE


def install_from_env(var: str = ENV_VAR) -> FaultPlan | None:
    """Install a plan from the ``SDML_CHAOS`` environment variable; None
    when it is unset."""
    text = os.environ.get(var)
    if not text:
        return None
    return install(FaultPlan.parse(text))


def maybe_fire(site: str, only=None, exclude=(), **ctx) -> list[FaultSpec]:
    """The instrumented-code entry point: a no-op unless a plan is active."""
    if _ACTIVE is None:
        return []
    return _ACTIVE.fire(site, only=only, exclude=exclude, **ctx)


def check(site: str, only=None, exclude=(), **ctx) -> list[FaultSpec]:
    """Match without effects; a no-op unless a plan is active."""
    if _ACTIVE is None:
        return []
    return _ACTIVE.check(site, only=only, exclude=exclude, **ctx)


# -- drill coverage lint ----------------------------------------------------

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SITE_CALL = re.compile(r"""\b(?:maybe_fire|check)\(\s*["']([a-z.]+)["']""")


def instrumented_sites(pkg: str | None = None) -> tuple[str, ...]:
    """The sites the port instruments: every literal site a
    ``maybe_fire("...")`` / ``check("...")`` call names in the port's
    own sources (``pkg``, default this package's directory), in
    :data:`SITES` order."""
    pkg = _PKG if pkg is None else pkg
    found = set()
    for dirpath, _dirs, files in os.walk(pkg):
        for fname in files:
            if fname.endswith(".py"):
                with open(os.path.join(dirpath, fname),
                          encoding="utf-8") as fh:
                    found.update(_SITE_CALL.findall(fh.read()))
    return tuple(s for s in SITES if s in found)


def drill_coverage(root: str | None = None, kinds=None, sites=None,
                   pairs=None) -> list[str]:
    """The chaos-coverage lint: every site the port instruments
    (:func:`instrumented_sites`) and every kind of :data:`SERVE_KINDS`
    must be FIRED by at least one drill in the port's tests
    (``tests/test_torch_*.py`` under ``root``, the repo root by default)
    or in the model checker's exported counterexample schedules
    (``tests/data/protocol_drills/*.chaos``, ``analysis/protocol.py``'s
    ``render_drill`` artifacts), and every pinned kind<->site pair whose
    site is instrumented must be drilled as that pair. Drills are
    ``kind@site`` schedule strings and keyword ``FaultSpec(...)``
    constructions. Returns human-readable gaps (empty = covered)."""
    kinds = tuple(kinds if kinds is not None else SERVE_KINDS)
    sites = tuple(sites if sites is not None else instrumented_sites())
    if pairs is not None:
        required_pairs = set(dict(pairs).items())
    else:
        required_pairs = {(k, s) for k, s in _KIND_SITE.items()
                          if s in sites} | {
            (k, s) for k, extra in _KIND_EXTRA_SITES.items()
            for s in extra if s in sites}
    if root is None:
        root = os.path.dirname(_PKG)
    texts = []
    for sub, prefix, suffix in (("tests", "test_torch_", ".py"),
                                (os.path.join("tests", "data",
                                              "protocol_drills"), "",
                                 ".chaos")):
        d = os.path.join(root, sub)
        if not os.path.isdir(d):
            continue
        for fname in sorted(os.listdir(d)):
            if fname.startswith(prefix) and fname.endswith(suffix):
                with open(os.path.join(d, fname), encoding="utf-8") as fh:
                    texts.append(fh.read())
    blob = "\n".join(texts)
    fired: set[tuple[str, str]] = set()
    for m in re.finditer(r"([a-z][a-z0-9-]*)@([a-z][a-z0-9.]*)", blob):
        k, s = m.group(1), m.group(2)
        if k in KINDS and s in SITES:
            fired.add((k, s))
    for m in re.finditer(r"FaultSpec\(([^)]*)\)", blob):
        body = m.group(1)
        km = re.search(r"kind\s*=\s*['\"]([a-z0-9-]+)['\"]", body)
        sm = re.search(r"site\s*=\s*['\"]([a-z0-9.]+)['\"]", body)
        if km and sm and km.group(1) in KINDS and sm.group(1) in SITES:
            fired.add((km.group(1), sm.group(1)))
    gaps: list[str] = []
    fired_kinds = {k for k, _ in fired}
    fired_sites = {s for _, s in fired}
    for k in kinds:
        if k not in fired_kinds:
            gaps.append(f"fault kind {k!r} is registered but no test "
                        f"drill ever fires it")
    for s in sites:
        if s not in fired_sites:
            gaps.append(f"fault site {s!r} is instrumented but no test "
                        f"drill ever fires it")
    for k, s in sorted(required_pairs):
        if (k, s) not in fired:
            gaps.append(f"pinned pair {k}@{s} (one of the kind's "
                        f"interpreting sites) is never drilled as that "
                        f"pair")
    return gaps
