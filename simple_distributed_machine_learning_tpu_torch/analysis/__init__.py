"""Analysis (port of ``analysis/``): the program linter over traced
programs, the bounded model checker of the serve fleet protocol, the
host-side AST lint, the kernel linter and the serving byte model.

- :mod:`.statespace` — the generic bounded explicit-state explorer (BFS,
  state-hash dedup, shortest counterexamples, depth-honest verdicts);
- :mod:`.protocol` — the fleet's snap/adopt/handoff protocol as a
  transition system, its five invariants, the clean config and four
  seeded-defect configs, and the export of a counterexample as a
  ``resilience/faults.py`` chaos drill;
- :mod:`.hostlint` — the host-side AST lint (``lint_repo``): the
  decode-builder table, private forwards called past their builders,
  kernel build memos touched from a distance, compiled programs or CUDA
  graphs made in ``serve/``, wall-clock reads in ``serve/`` and the SLO
  pipeline, undocumented metrics, unread journal events; torch-free as a
  script;
- :mod:`.preflight` — ``validate_tp_overlap``, the tensor-parallel spec
  check, and the training preflights (``lint_trainer``,
  ``dryrun_reports``);
- :mod:`.bounds` — the interval lattice, ``spec(...)`` contracts and the
  ``scatter-bounds`` walk over a traced graph;
- :mod:`.kernels` — ``LaunchSpec``, the port's declaration of what a
  kernel launch reads and writes, and the ``kernel-*`` checks over it
  (index-map bounds, grid write races, 16-byte access waste, low-precision
  scratch), the HBM rows derived from it, and ``record_launches``;
- :mod:`.programs` — the serve-program registry (``lint_serve``,
  ``lint_engine``), the HBM-bytes-per-tick model and the ``predict_*``
  functions behind the KV-drift gauges, and the kernel half of the
  registry (``kernel_registry_reports``);
- :mod:`.fixtures` — seeded-defect programs, launch specs and protocol
  models, and the grid fixture's kernel F1 (``grid_scratch``, CUDA);
- :mod:`.report` — ``Severity``, ``Finding``, ``CollectiveCost``,
  ``HBMCost``, ``Report``.

The protocol checker and hostlint are stdlib; the rest imports torch.
CLI::

    python -m simple_distributed_machine_learning_tpu_torch.analysis \\
        --serve-protocol [--depth N] [--fail-on error|warning]
    python -m simple_distributed_machine_learning_tpu_torch.analysis \\
        --hostlint
    python simple_distributed_machine_learning_tpu_torch/analysis/hostlint.py
    python -m simple_distributed_machine_learning_tpu_torch.analysis \\
        --serve-kernel | --fixtures | --fixture NAME | --list

The program linter traces the EXACT function a launch is about to run —
a train step, a serving builder's program — to an aten graph on fake
tensors (zero FLOPs, no device buffers, no kernel launched) and lints it:

- :mod:`.trace` — ``trace_program``, ``abstractify``, the recorder the
  collective sites note into;
- :mod:`.rules` — the rule families ``ppermute-deadlock``,
  ``unreduced-gradient``/``sharded-state``, ``mesh-axis``,
  ``dtype-drift`` and ``donation``, and the bytes-between-coordinates
  cost table;
- :mod:`.bounds` — the ``scatter-bounds`` interval pass;
- :mod:`.programs` — the serving registry (``lint_serve``,
  ``lint_engine``), :mod:`.preflight` — the training preflights
  (``lint_trainer``, ``dryrun_reports``).

Library API::

    from simple_distributed_machine_learning_tpu_torch import analysis
    report = analysis.analyze(step, params, state, x, t, 0, mesh=mesh)
    print(report.format())
    if not report.ok():          # any ERROR finding
        raise SystemExit(1)

More CLI modes: ``--dryrun N`` and ``--serve``.
"""

from __future__ import annotations

from simple_distributed_machine_learning_tpu_torch.analysis.report import (
    CollectiveCost,
    Finding,
    HBMCost,
    Report,
    Severity,
)

__all__ = [
    "ArgSpec", "CollectiveCost", "Finding", "HBMCost", "Report", "Severity",
    "abstractify", "analyze", "analyze_program", "shape_dtype", "spec",
]

# report.py is pure stdlib; the rest imports torch, so those symbols
# resolve lazily (PEP 562) — the parallel modules import .trace from here
_LAZY = {
    "ArgSpec": "bounds", "spec": "bounds",
    "run_rules": "rules",
    "abstractify": "trace", "shape_dtype": "trace",
    "trace_program": "trace",
}


def __getattr__(name: str):
    import importlib

    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)


def analyze_program(program, mesh=None, name: str = "", arg_ranges=None,
                    arg_vary=None, arg_positions=None) -> Report:
    """Run the lint suite over an already-traced program (the counterpart
    of the JAX ``analyze_jaxpr``)."""
    from simple_distributed_machine_learning_tpu_torch.analysis.kernels import (  # noqa: E501
        kernel_hbm_costs,
    )
    from simple_distributed_machine_learning_tpu_torch.analysis.rules import (
        run_rules,
    )
    findings, costs = run_rules(program, active_mesh=mesh,
                                arg_ranges=arg_ranges, arg_vary=arg_vary,
                                arg_positions=arg_positions)
    return Report(name=name or program.name, findings=findings, costs=costs,
                  hbm=kernel_hbm_costs(program.launches,
                                       program=name or program.name))


def _unwrap_specs(abstract_args, abstract_kwargs):
    """Split ``ArgSpec`` annotations out of the arguments: fake stand-ins
    for tracing, plus per-placeholder (range, vary) lists aligned with the
    traced program's placeholders, and the argument positions of any
    tensor passed more than once (placeholder index -> positions)."""
    from simple_distributed_machine_learning_tpu_torch.analysis.bounds import (
        ArgSpec,
    )
    from simple_distributed_machine_learning_tpu_torch.analysis.trace import (
        abstractify,
        flat_tensors,
        shape_dtype,
    )
    contracts: dict = {}

    def unspec(obj):
        if isinstance(obj, ArgSpec):
            fake = shape_dtype(obj)
            contracts[id(fake)] = obj
            return fake
        if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields") \
                and type(obj) in (list, tuple):
            return type(obj)(unspec(v) for v in obj)
        if isinstance(obj, dict) and type(obj) is dict:
            return {k: unspec(v) for k, v in obj.items()}
        return obj

    tree = abstractify(unspec((list(abstract_args), dict(abstract_kwargs))))
    leaves = flat_tensors(tree)
    ranges = [contracts[id(t)].interval if id(t) in contracts else None
              for t in leaves]
    vary = [frozenset(contracts[id(t)].vary) if id(t) in contracts
            else frozenset() for t in leaves]
    index = {id(t): i for i, t in enumerate(leaves)}
    positions: dict = {}
    for pos, t in enumerate(flat_tensors(tree, once=False)):
        positions.setdefault(index[id(t)], []).append(pos)
    positions = {k: v for k, v in positions.items() if len(v) > 1}
    args, kwargs = tree
    if not any(r is not None for r in ranges):
        ranges = None
    if not any(vary):
        vary = None
    return args, kwargs, ranges, vary, positions


def trace_failure(e: Exception, name: str) -> Report:
    """A trace error as a report with one finding (the JAX ``analyze``'s
    mapping): an unknown mesh axis is ``mesh-axis.unknown-axis``,
    anything else ``trace.failed``."""
    msg = str(e)
    rule, hint = "trace.failed", (
        "the program could not even be traced on these shapes; the error "
        "above is torch's own diagnosis")
    low = msg.lower()
    if "axis" in low and ("unknown" in low or "no axis" in low
                          or "unbound" in low or "not bind" in low):
        rule = "mesh-axis.unknown-axis"
        hint = ("a collective names an axis the mesh does not bind — fix "
                "the axis name or the mesh")
    first = msg.splitlines()[0] if msg.strip() else "<no message>"
    return Report(name=name, findings=[Finding(
        rule=rule, severity=Severity.ERROR,
        message=f"tracing failed: {type(e).__name__}: {first}",
        where=name, hint=hint)])


def analyze(fn, *abstract_args, mesh=None, name: str = "",
            **abstract_kwargs) -> Report:
    """Trace ``fn`` on fake stand-ins of its arguments and lint the
    result.

    ``abstract_args`` are tensors, fake tensors (:func:`abstractify` of
    live buffers: nothing is copied) or trees of them, ``nn.Module``
    parameter trees included; only shapes and dtypes are read. Any
    argument may instead be an :func:`analysis.spec <bounds.spec>` — a
    shape and dtype carrying a declared value range (the scatter-bounds
    rule's input contract) and/or declared coordinate-varying mesh axes
    (the sharded-state rule's seed). Python values (ints, seeds) are
    passed as they are. ``mesh`` is the ACTIVE launch mesh: the axes and
    widths of every noted collective are checked against it.

    Trace failures become findings rather than exceptions, so a preflight
    can always print one report.
    """
    from simple_distributed_machine_learning_tpu_torch.analysis.trace import (
        trace_program,
    )
    name = name or getattr(fn, "__name__", "") or "step"
    args, kwargs, ranges, vary, positions = _unwrap_specs(abstract_args,
                                                          abstract_kwargs)
    try:
        program = trace_program(fn, *args, name=name, **kwargs)
    except Exception as e:  # noqa: BLE001 - any trace error is a finding
        return trace_failure(e, name)
    return analyze_program(program, mesh=mesh, name=name, arg_ranges=ranges,
                           arg_vary=vary, arg_positions=positions)
