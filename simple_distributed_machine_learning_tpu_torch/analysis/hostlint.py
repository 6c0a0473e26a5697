"""Host-side AST lint over the port's Python (port of
``analysis/hostlint.py``; pure ``ast``, the port keeps its own copy).

The program linter sees what runs on the card; this pass sees the Python
that builds and drives it. The rules keep the JAX rule ids. Two are the
JAX rules as they are; four police what the JAX rules police, retargeted
at the port's own serve path, whose decode builders are eager closures
(memoized on their static config, with no ``jit``):

- ``hostlint.unmemoized-builder`` — ``models/gpt.py``'s
  ``DECODE_BUILDERS`` table must name the JAX package's twelve decode
  builders (:data:`DECODE_BUILDER_NAMES`), and every name in it must be a
  top-level function of ``models/gpt.py``: the table is the registry of
  serving programs, so a stale or short table drops a program from every
  check keyed on it;
- ``hostlint.builder-bypass`` — a call, outside ``models/gpt.py``, to one
  of its private ``_*_fwd`` forward programs: the public ``make_*``
  builder around it validates the shapes, the attention kernel and the
  tensor-parallel serving mesh, and the caller skips all of it. The
  port's package and ``chip_smoke.py`` are checked; the
  ``tests/test_torch_*.py`` parity tests call the private forwards on
  purpose, against the JAX package's own;
- ``hostlint.cache-poke`` — a reference, outside the module that defines
  it, to a kernel wrapper's ``_library`` (the memo that builds and binds a
  CUDA source once per process): code that reaches the bound library
  launches kernels past the wrapper's launch count, and a
  ``cache_clear()`` from a distance rebinds under live launches;
- ``hostlint.raw-jit-in-serve`` — ``torch.compile``, ``torch.jit.script``
  or ``trace``, or a CUDA graph (``torch.cuda.CUDAGraph``, ``graph``,
  ``graphs``, ``make_graphed_callables``) created inside ``serve/``, in
  any import spelling: serving programs come from the ``models/gpt.py``
  builders, and a graph captured in ``serve/`` bakes in pool addresses
  that a rebuild or a fleet migration moves;
- ``hostlint.wall-clock-in-serve`` (as JAX) — a wall-clock or RNG CALL in
  ``serve/`` or ``telemetry/{slo,alerts,attribution}.py``: the pinned
  scenarios and journal replay are deterministic only because every clock
  read goes through the injectable ``clock=`` plumbing;
- ``metric-catalog.undocumented`` (as JAX) — a ``serve_*``/``train_*``
  metric name in ``serve/metrics.py`` or ``telemetry/{slo,attribution}.py``
  that the port's ``telemetry/catalog.py`` has no HELP text for;
- ``journal-grammar.unread-event`` (as JAX) — a journal event kind some
  ``serve/`` writer emits that no reader dispatches on.

Torch-free: the package's ``__init__`` imports torch, so the lint runs as
a script that loads ``report.py`` and ``telemetry/catalog.py`` by path::

    python simple_distributed_machine_learning_tpu_torch/analysis/hostlint.py

(exit 0 clean, 1 on an ERROR finding; ``SDML_LINT_INJECT=<tag>`` seeds
one). ``python -m simple_distributed_machine_learning_tpu_torch.analysis
--hostlint`` runs the same lint through the package.
"""

from __future__ import annotations

import ast
import importlib.util
import os
import re
import sys

if __package__:
    from simple_distributed_machine_learning_tpu_torch.analysis.report import (  # noqa: E501
        Finding,
        Report,
        Severity,
    )
else:
    # run as a script: the stdlib-only report module by its path, so the
    # lint never imports the package (or torch)
    _spec = importlib.util.spec_from_file_location(
        "_sdml_hostlint_report",
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "report.py"))
    _report = importlib.util.module_from_spec(_spec)
    sys.modules[_spec.name] = _report
    _spec.loader.exec_module(_report)
    Finding, Report, Severity = (_report.Finding, _report.Report,
                                 _report.Severity)

#: the JAX package's decode builders (its ``hostlint.py:66-79`` and
#: ``models/gpt.py::DECODE_BUILDERS``); the port's table must name these
DECODE_BUILDER_NAMES = (
    "make_cached_decoder",
    "make_slot_prefill",
    "make_slot_decode_step",
    "make_paged_prefill_chunk",
    "make_paged_decode_step",
    "make_paged_block_copy",
    "make_adapter_bank_update",
    "make_slot_propose",
    "make_slot_verify_step",
    "make_paged_verify_step",
    "make_slot_spec_tick",
    "make_paged_spec_tick",
)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)
_PKG_NAME = os.path.basename(_PKG)
GPT_PATH = os.path.join(_PKG, "models", "gpt.py")
JOURNAL_PATH = os.path.join(_PKG, "serve", "journal.py")
TELEMETRY_REPORT_PATH = os.path.join(_PKG, "telemetry", "report.py")


def _parse(path: str):
    with open(path) as f:
        return ast.parse(f.read(), filename=path)


def _call_name(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def _where(path: str, node, repo: str = _REPO) -> str:
    rel = os.path.relpath(path, repo)
    return f"{rel}:{getattr(node, 'lineno', '?')}"


# -- the decode-builder table -------------------------------------------------

def _builder_table(tree):
    """``(names, node)`` of the module's ``DECODE_BUILDERS = {...}`` dict
    display (its constant string keys), or ``(None, None)``."""
    for node in tree.body:
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "DECODE_BUILDERS"
                        for t in node.targets)):
            return [k.value for k in node.value.keys
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)], node
    return None, None


def lint_builder_definitions(gpt_path: str = GPT_PATH,
                             repo: str = _REPO) -> list[Finding]:
    """``hostlint.unmemoized-builder``: the table names exactly the JAX
    package's decode builders, and ``gpt_path`` defines each at top
    level."""
    tree = _parse(gpt_path)
    table, node = _builder_table(tree)
    base = os.path.basename(gpt_path)
    if table is None:
        return [Finding(
            rule="hostlint.unmemoized-builder", severity=Severity.ERROR,
            message=f"{base} has no DECODE_BUILDERS table — the serving "
                    f"programs' registry is gone",
            where=_where(gpt_path, tree, repo),
            hint="restore the DECODE_BUILDERS dict of the decode builders")]
    findings: list[Finding] = []
    for name in DECODE_BUILDER_NAMES:
        if name not in table:
            findings.append(Finding(
                rule="hostlint.unmemoized-builder", severity=Severity.ERROR,
                message=f"DECODE_BUILDERS does not name the decode builder "
                        f"'{name}' — the table has drifted from the JAX "
                        f"package's builders",
                where=_where(gpt_path, node, repo),
                hint="add the builder to DECODE_BUILDERS"))
    defs = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    for name in table:
        if name not in defs:
            findings.append(Finding(
                rule="hostlint.unmemoized-builder", severity=Severity.ERROR,
                message=f"decode builder '{name}' is in DECODE_BUILDERS but "
                        f"not defined at the top level of {base} — the "
                        f"table is stale or the builder was removed",
                where=_where(gpt_path, node, repo),
                hint="update DECODE_BUILDERS alongside the builder"))
        elif name not in DECODE_BUILDER_NAMES:
            findings.append(Finding(
                rule="hostlint.unmemoized-builder", severity=Severity.ERROR,
                message=f"DECODE_BUILDERS names '{name}', which is not one "
                        f"of the JAX package's decode builders",
                where=_where(gpt_path, node, repo),
                hint="keep the table equal to DECODE_BUILDER_NAMES"))
    return findings


def _private_programs(gpt_path: str = GPT_PATH) -> dict:
    """The private forward programs the builders wrap: ``gpt_path``'s
    top-level ``_*_fwd`` functions, each with the first table builder
    that calls it (None when no builder does)."""
    tree = _parse(gpt_path)
    defs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    out = {name: None for name in defs
           if name.startswith("_") and name.endswith("_fwd")}
    for builder in _builder_table(tree)[0] or ():
        for node in ast.walk(defs.get(builder, ast.Module(body=[]))):
            if isinstance(node, ast.Call) and out.get(_call_name(node),
                                                      1) is None:
                out[_call_name(node)] = builder
    return out


def _library_owners(pkg: str = _PKG) -> set:
    """The modules that define a kernel wrapper's ``_library`` memo."""
    owners = set()
    for root, _dirs, files in os.walk(pkg):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(root, fname)
            if any(isinstance(n, ast.FunctionDef) and n.name == "_library"
                   for n in _parse(path).body):
                owners.add(os.path.abspath(path))
    return owners


# -- compiled programs and CUDA graphs ----------------------------------------

_JIT_FNS = ("script", "trace", "trace_module", "script_if_tracing")
_GRAPH_FNS = ("CUDAGraph", "graph", "graphs", "make_graphed_callables")


def _compile_bindings(tree) -> dict:
    """Names a module binds to torch, to ``torch.jit``, ``torch.cuda``,
    ``torch.cuda.graphs`` and to compile/graph callables themselves, so
    every spelling is caught: ``torch.compile``, ``import torch as t;
    t.compile``, ``from torch import compile [as q]``, ``from torch.jit
    import script``, ``import torch.cuda as tc; tc.CUDAGraph``, ..."""
    b = {"torch": {"torch"}, "jit": set(), "cuda": set(), "graphs": set(),
         "direct": set()}
    sub = {"torch.jit": "jit", "torch.cuda": "cuda",
           "torch.cuda.graphs": "graphs"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch":
                    b["torch"].add(a.asname or "torch")
                elif a.name in sub and a.asname:
                    b[sub[a.name]].add(a.asname)
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                name = a.asname or a.name
                if node.module == "torch":
                    if a.name == "compile":
                        b["direct"].add(name)
                    elif a.name in ("jit", "cuda"):
                        b[a.name].add(name)
                elif node.module == "torch.jit" and a.name in _JIT_FNS:
                    b["direct"].add(name)
                elif node.module == "torch.cuda":
                    if a.name == "graphs":
                        b["graphs"].add(name)
                    elif a.name in _GRAPH_FNS:
                        b["direct"].add(name)
                elif (node.module == "torch.cuda.graphs"
                        and a.name in _GRAPH_FNS):
                    b["direct"].add(name)
    return b


def _dotted(node) -> list | None:
    """``a.b.c`` as ``["a", "b", "c"]``; None for anything else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    return [node.id] + parts[::-1]


def _compile_ref(node, b: dict) -> str | None:
    """The dotted name of a compile/script/trace/CUDA-graph reference in
    any spelling, or None."""
    if isinstance(node, ast.Name):
        return node.id if node.id in b["direct"] else None
    parts = _dotted(node) if isinstance(node, ast.Attribute) else None
    if not parts:
        return None
    root, rest = parts[0], parts[1:]
    if root in b["torch"]:
        if rest == ["compile"] or (len(rest) == 2 and rest[0] == "jit"
                                   and rest[1] in _JIT_FNS):
            return ".".join(parts)
        if len(rest) == 2 and rest[0] == "cuda" and rest[1] in _GRAPH_FNS:
            return ".".join(parts)
    if root in b["jit"] and len(rest) == 1 and rest[0] in _JIT_FNS:
        return ".".join(parts)
    if root in b["cuda"] and len(rest) == 1 and rest[0] in _GRAPH_FNS:
        return ".".join(parts)
    if root in b["graphs"] and len(rest) == 1 and rest[0] in _GRAPH_FNS:
        return ".".join(parts)
    return None


# -- wall clocks and RNG (as the JAX rule) ------------------------------------

#: wall-clock readers in the ``time`` module (sleep excluded: it consumes
#: time rather than reads it, and the simulator injects it explicitly)
_WALLCLOCK_TIME_FNS = ("time", "monotonic", "perf_counter", "time_ns",
                       "monotonic_ns", "perf_counter_ns")
_WALLCLOCK_DT_FNS = ("now", "utcnow", "today")


def _clock_bindings(tree) -> tuple[set, set, set, set]:
    """Names a module binds to the time/datetime/random modules and to
    wall-clock functions imported from them."""
    time_a, dt_a, rand_a, direct = set(), set(), set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "time":
                    time_a.add(a.asname or "time")
                elif a.name == "datetime":
                    dt_a.add(a.asname or "datetime")
                elif a.name == "random":
                    rand_a.add(a.asname or "random")
        elif isinstance(node, ast.ImportFrom):
            if node.module == "time":
                for a in node.names:
                    if a.name in _WALLCLOCK_TIME_FNS:
                        direct.add(a.asname or a.name)
            elif node.module == "datetime":
                for a in node.names:
                    if a.name in ("datetime", "date"):
                        dt_a.add(a.asname or a.name)
            elif node.module == "random":
                for a in node.names:
                    direct.add(a.asname or a.name)
    return time_a, dt_a, rand_a, direct


def _wallclock_call(call: ast.Call, bindings) -> str | None:
    """The dotted name of a wall-clock/RNG read this Call performs, or
    None. Only CALLS count — ``clock=time.monotonic`` default-arg
    REFERENCES are the sanctioned injection points."""
    time_a, dt_a, rand_a, direct = bindings
    f = call.func
    if isinstance(f, ast.Name) and f.id in direct:
        return f.id
    if isinstance(f, ast.Attribute):
        root = f.value
        if isinstance(root, ast.Name):
            if root.id in time_a and f.attr in _WALLCLOCK_TIME_FNS:
                return f"{root.id}.{f.attr}"
            if root.id in rand_a:
                return f"{root.id}.{f.attr}"
            if root.id in dt_a and f.attr in _WALLCLOCK_DT_FNS:
                return f"{root.id}.{f.attr}"
        if (isinstance(root, ast.Attribute)
                and isinstance(root.value, ast.Name)
                and root.value.id in dt_a
                and f.attr in _WALLCLOCK_DT_FNS):
            return f"{root.value.id}.{root.attr}.{f.attr}"
    return None


def _lint_call_sites(path: str, allow_jit: bool, repo: str = _REPO,
                     check_clock: bool | None = None,
                     check_bypass: bool = True,
                     programs: dict | None = None,
                     library_owner: bool = False) -> list[Finding]:
    """The call-site rules over one file: ``raw-jit-in-serve`` unless
    ``allow_jit``; ``wall-clock-in-serve`` under ``check_clock`` (default:
    where raw jits are not allowed, as in the JAX package);
    ``builder-bypass`` under ``check_bypass`` (``programs``: the private
    forwards, default ``models/gpt.py``'s); ``cache-poke`` unless the file
    owns a ``_library``."""
    if check_clock is None:
        check_clock = not allow_jit
    if programs is None:
        programs = _private_programs()
    tree = _parse(path)
    findings: list[Finding] = []
    binds = _compile_bindings(tree)
    clock_bindings = _clock_bindings(tree)
    compiled = []
    for node in ast.walk(tree):
        if (not library_owner
                and ((isinstance(node, ast.Name) and node.id == "_library")
                     or (isinstance(node, ast.Attribute)
                         and node.attr == "_library"))):
            findings.append(Finding(
                rule="hostlint.cache-poke", severity=Severity.ERROR,
                message="a kernel wrapper's _library memo touched outside "
                        "its module — launches through the bound library "
                        "escape the wrapper's launch count, and a "
                        "cache_clear() rebinds under live launches",
                where=_where(path, node, repo),
                hint="call the public kernel wrapper instead"))
        if isinstance(node, ast.Call):
            name = _call_name(node)
            if check_bypass and name in programs:
                public = programs[name] or "make_*"
                findings.append(Finding(
                    rule="hostlint.builder-bypass", severity=Severity.ERROR,
                    message=(f"direct call to the private forward program "
                             f"'{name}' skips its builder's checks (shapes, "
                             f"attention kernel, the tensor-parallel "
                             f"serving mesh)"),
                    where=_where(path, node, repo),
                    hint=f"build the program through the public "
                         f"{public} builder in models/gpt.py"))
            if check_clock:
                clock = _wallclock_call(node, clock_bindings)
                if clock is not None:
                    findings.append(Finding(
                        rule="hostlint.wall-clock-in-serve",
                        severity=Severity.ERROR,
                        message=(f"'{clock}()' called inside a "
                                 f"determinism-pinned module (serve/ and "
                                 f"the telemetry SLO pipeline) — the "
                                 f"exact-pinned scenarios and journal "
                                 f"replay are deterministic ONLY because "
                                 f"every clock/RNG read goes through the "
                                 f"injectable plumbing"),
                        where=_where(path, node, repo),
                        hint="take the clock as an injectable default arg "
                             "(clock=time.monotonic) or use the "
                             "simulator's VirtualClock; seed randomness "
                             "explicitly"))
        if not allow_jit and isinstance(node, (ast.Name, ast.Attribute)):
            ref = _compile_ref(node, binds)
            if ref is not None:
                compiled.append((node, ref))
    # one finding per reference: torch.cuda.graphs.CUDAGraph names graphs
    # on its way to CUDAGraph
    inner = {id(n.value) for n, _ in compiled
             if isinstance(n, ast.Attribute)}
    for node, ref in compiled:
        if id(node) in inner:
            continue
        findings.append(Finding(
            rule="hostlint.raw-jit-in-serve", severity=Severity.ERROR,
            message=f"'{ref}' created inside serve/ — serving programs "
                    f"come from the models/gpt.py builders, and a compiled "
                    f"program or CUDA graph made here captures pool "
                    f"addresses a rebuild or a migration moves",
            where=_where(path, node, repo),
            hint="add (or extend) a make_* builder in models/gpt.py and "
                 "call that"))
    return findings


# -- the journal grammar (as the JAX rule) ------------------------------------

def _is_ev_load(expr) -> bool:
    """``<x>["ev"]`` or ``<x>.get("ev", ...)`` — the two spellings the
    journal readers use to pull a record's event kind. Keyed on the
    literal ``"ev"`` so ``r.get("kind")`` dispatches (metrics records)
    never count as journal reads."""
    if (isinstance(expr, ast.Subscript)
            and isinstance(expr.slice, ast.Constant)
            and expr.slice.value == "ev"):
        return True
    return (isinstance(expr, ast.Call)
            and isinstance(expr.func, ast.Attribute)
            and expr.func.attr == "get" and expr.args
            and isinstance(expr.args[0], ast.Constant)
            and expr.args[0].value == "ev")


def _event_writes(path: str, repo: str = _REPO) -> list:
    """``(kind, where)`` for every journal record literal in a module: a
    dict display carrying a constant ``"ev"`` key with a constant string
    value — the shape every ``RequestJournal.log_*`` writer uses."""
    out = []
    for node in ast.walk(_parse(path)):
        if not isinstance(node, ast.Dict):
            continue
        for k, v in zip(node.keys, node.values):
            if (isinstance(k, ast.Constant) and k.value == "ev"
                    and isinstance(v, ast.Constant)
                    and isinstance(v.value, str)):
                out.append((v.value, _where(path, node, repo)))
    return out


def _event_reads(path: str) -> set:
    """Every event kind a reader module dispatches on: string constants
    compared (``==`` or ``in (...)``) against a value that came from the
    ``"ev"`` key — directly (``ev.get("ev") == "restart"``) or through a
    variable (``kind = ev["ev"]; ... kind == "submit"``)."""
    tree = _parse(path)
    kind_vars: set = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and _is_ev_load(node.value):
            kind_vars.update(t.id for t in node.targets
                             if isinstance(t, ast.Name))
    kinds: set = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Compare) or len(node.ops) != 1:
            continue
        if not (_is_ev_load(node.left)
                or (isinstance(node.left, ast.Name)
                    and node.left.id in kind_vars)):
            continue
        comp = node.comparators[0]
        if (isinstance(node.ops[0], ast.Eq)
                and isinstance(comp, ast.Constant)
                and isinstance(comp.value, str)):
            kinds.add(comp.value)
        elif (isinstance(node.ops[0], ast.In)
                and isinstance(comp, (ast.Tuple, ast.List, ast.Set))):
            kinds.update(e.value for e in comp.elts
                         if isinstance(e, ast.Constant)
                         and isinstance(e.value, str))
    return kinds


def lint_journal_grammar(writer_paths=None, reader_paths=None,
                         repo: str = _REPO) -> list[Finding]:
    """The writer/reader cross-check: every event kind any ``serve/``
    writer of the port emits must have a dispatching reader in
    ``recover_state`` or the telemetry report. Paths are parameterizable
    so the tests can lint seeded-defect modules."""
    if writer_paths is None:
        serve_dir = os.path.join(_PKG, "serve")
        writer_paths = [os.path.join(serve_dir, f)
                        for f in sorted(os.listdir(serve_dir))
                        if f.endswith(".py")]
    if reader_paths is None:
        reader_paths = [JOURNAL_PATH, TELEMETRY_REPORT_PATH]
    read: set = set()
    for p in reader_paths:
        read |= _event_reads(p)
    findings: list[Finding] = []
    for p in writer_paths:
        for kind, where in _event_writes(p, repo):
            if kind not in read:
                findings.append(Finding(
                    rule="journal-grammar.unread-event",
                    severity=Severity.ERROR,
                    message=(f"journal event kind '{kind}' is written "
                             f"here but NO reader dispatches on it — "
                             f"neither recover_state nor the telemetry "
                             f"report compares the 'ev' field against "
                             f"'{kind}', so the record silently vanishes "
                             f"on recovery/replay"),
                    where=where,
                    hint="add a recover_state branch (or a report reader) "
                         "for the new kind, and a transition for it in "
                         "the protocol model (analysis/protocol.py)"))
    return findings


# -- the metric catalog (as the JAX rule) -------------------------------------

#: modules whose full-string ``serve_*``/``train_*`` constants are metric
#: names; the catalog rule scans exactly these
_METRIC_FILES = (("serve", "metrics.py"), ("telemetry", "slo.py"),
                 ("telemetry", "attribution.py"))
_METRIC_NAME_RE = re.compile(r"^(serve|train)_[a-z0-9_]+$")


def _metric_constants(path: str) -> list[tuple]:
    """``(name, node)`` for every full-string constant in ``path`` that
    matches the metric-name grammar."""
    return [(node.value, node) for node in ast.walk(_parse(path))
            if isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and _METRIC_NAME_RE.match(node.value)]


def lint_metric_catalog(metric_files=None,
                        repo: str = _REPO) -> list[Finding]:
    """``metric-catalog.undocumented``: every metric name in the
    registering modules must resolve through the port's
    ``telemetry/catalog.py::metric_help``, loaded by file path (the
    ``telemetry`` package imports torch). ``metric_files`` parameterizes
    the scanned modules for seeded-defect tests."""
    pkg = os.path.join(repo, _PKG_NAME)
    spec = importlib.util.spec_from_file_location(
        "_sdml_torch_hostlint_catalog",
        os.path.join(pkg, "telemetry", "catalog.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    help_map = mod.metric_help()
    if metric_files is None:
        metric_files = [os.path.join(pkg, *rel) for rel in _METRIC_FILES]
    findings: list[Finding] = []
    for path in metric_files:
        for name, node in _metric_constants(path):
            if name not in help_map:
                findings.append(Finding(
                    rule="metric-catalog.undocumented",
                    severity=Severity.ERROR,
                    message=(f"metric '{name}' is registered but "
                             f"telemetry/catalog.py has no HELP text for "
                             f"it — the Prometheus exposition renders "
                             f"'(undocumented)' and operators fly blind"),
                    where=_where(path, node, repo),
                    hint="add a ``{name}`` — help bullet to the owning "
                         "module's docstring (catalog.py parses the "
                         "bullet grammar) or an EXTRA_HELP entry"))
    return findings


# -- the whole suite ----------------------------------------------------------

def _injected_findings() -> list[Finding]:
    """The ``SDML_LINT_INJECT`` gate drill: one seeded ERROR."""
    tag = os.environ.get("SDML_LINT_INJECT")
    if not tag:
        return []
    return [Finding(
        rule=f"injected.{tag}", severity=Severity.ERROR,
        message="seeded ERROR finding injected via SDML_LINT_INJECT — the "
                "gate drill proving --lint preflights actually fail",
        where="SDML_LINT_INJECT", hint="unset SDML_LINT_INJECT")]


def lint_repo(repo: str = _REPO) -> Report:
    """The whole hostlint suite over the port's package,
    ``tests/test_torch_*.py`` and ``chip_smoke.py``: the builder table;
    the journal grammar and the metric catalog; cache-poke everywhere but
    the ``_library`` owners; builder-bypass everywhere but
    ``models/gpt.py`` and the tests; raw-jit in ``serve/``; the wall-clock
    rule in ``serve/`` and the SLO pipeline."""
    pkg = os.path.join(repo, _PKG_NAME)
    gpt = os.path.abspath(os.path.join(pkg, "models", "gpt.py"))
    findings = lint_builder_definitions(gpt, repo)
    findings.extend(lint_journal_grammar(repo=repo))
    findings.extend(lint_metric_catalog(repo=repo))
    programs = _private_programs(gpt)
    owners = _library_owners(pkg)
    serve_dir = os.path.abspath(os.path.join(pkg, "serve")) + os.sep
    clock_paths = {os.path.abspath(os.path.join(pkg, "telemetry", f))
                   for f in ("slo.py", "alerts.py", "attribution.py")}
    paths: list[tuple[str, bool]] = []        # (path, is a test)
    for root, _dirs, files in sorted(os.walk(pkg)):
        paths.extend((os.path.join(root, f), False) for f in sorted(files)
                     if f.endswith(".py"))
    tests = os.path.join(repo, "tests")
    if os.path.isdir(tests):
        paths.extend((os.path.join(tests, f), True)
                     for f in sorted(os.listdir(tests))
                     if f.startswith("test_torch_") and f.endswith(".py"))
    smoke = os.path.join(repo, "chip_smoke.py")
    if os.path.exists(smoke):
        paths.append((smoke, False))
    for path, is_test in paths:
        ap = os.path.abspath(path)
        in_serve = ap.startswith(serve_dir)
        findings.extend(_lint_call_sites(
            path, allow_jit=not in_serve, repo=repo,
            check_clock=in_serve or ap in clock_paths,
            check_bypass=not is_test and ap != gpt, programs=programs,
            library_owner=ap in owners))
    return Report(name="hostlint", findings=findings)


def main(argv=None) -> int:
    """The torch-free entry point: lint the tree, print the report, exit 0
    when it has no finding at ``--fail-on`` (default ``error``)."""
    import argparse

    p = argparse.ArgumentParser(
        prog="hostlint.py", description="the port's host-side AST lint")
    p.add_argument("--fail-on", choices=("error", "warning"),
                   default="error")
    args = p.parse_args(argv)
    report = lint_repo()
    report.findings.extend(_injected_findings())
    print(report.format(costs=False))
    ok = report.ok(args.fail_on)
    print(f"analysis --hostlint: {'clean' if ok else 'FLAGGED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
