"""Host-side AST lint: the journal writer/reader grammar cross-check.

Port of ``analysis/hostlint.py``'s ``journal-grammar.unread-event`` rule
(pure ``ast``; the port keeps its own copy). A journal event kind some
writer in the port's ``serve/`` emits (a dict display with a constant
``"ev"`` key) that NO reader dispatches on — neither
``serve/journal.py::recover_state`` (the crash-recovery fold) nor the
telemetry report reader compares the ``"ev"`` field against it — is an
ERROR: a record type nobody reads silently vanishes on recovery, the
failure mode the protocol model checker (``analysis/protocol.py``)
assumes away.

The JAX module's other rules (the decode-builder memo, builder bypass,
cache pokes, raw jit and wall-clock reads in ``serve/``, the metric
catalog) are not ported: they police names the port does not have and
wait for ROADMAP.md, Queue A, item 7.2.
"""

from __future__ import annotations

import ast
import os

from simple_distributed_machine_learning_tpu_torch.analysis.report import (
    Finding,
    Severity,
)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)
JOURNAL_PATH = os.path.join(_PKG, "serve", "journal.py")
TELEMETRY_REPORT_PATH = os.path.join(_PKG, "telemetry", "report.py")


def _where(path: str, node, repo: str = _REPO) -> str:
    rel = os.path.relpath(path, repo)
    return f"{rel}:{getattr(node, 'lineno', '?')}"


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
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    out = []
    for node in ast.walk(tree):
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
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
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
