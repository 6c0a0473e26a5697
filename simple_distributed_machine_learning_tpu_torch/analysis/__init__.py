"""Analysis (port of ``analysis/``): the bounded model checker of the
serve fleet protocol, the host-side AST lint, the kernel linter and the
serving byte model.

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
  check;
- :mod:`.bounds` — the interval lattice and ``spec(...)`` contracts;
- :mod:`.kernels` — ``LaunchSpec``, the port's declaration of what a
  kernel launch reads and writes, and the ``kernel-*`` checks over it
  (index-map bounds, grid write races, 16-byte access waste, low-precision
  scratch), the HBM rows derived from it, and ``record_launches``;
- :mod:`.programs` — the HBM-bytes-per-tick model and the ``predict_*``
  functions behind the KV-drift gauges, and the kernel half of the
  serve-program registry (``kernel_registry_reports``);
- :mod:`.fixtures` — seeded-defect launch specs and protocol models, and
  the grid fixture's kernel F1 (``grid_scratch``, CUDA);
- :mod:`.report` — ``Severity``, ``Finding``, ``HBMCost``, ``Report``.

The protocol checker and hostlint are stdlib; the kernel modules import
torch. CLI::

    python -m simple_distributed_machine_learning_tpu_torch.analysis \\
        --serve-protocol [--depth N] [--fail-on error|warning]
    python -m simple_distributed_machine_learning_tpu_torch.analysis \\
        --hostlint
    python simple_distributed_machine_learning_tpu_torch/analysis/hostlint.py
    python -m simple_distributed_machine_learning_tpu_torch.analysis \\
        --serve-kernel | --fixtures | --fixture NAME | --list

The program linter over traced programs (``--dryrun``, ``--serve``, the
jaxpr fixtures, ``lint=True``) is ROADMAP.md, Queue A, item 7.4: its
flags refuse, naming the item.
"""

from __future__ import annotations

from simple_distributed_machine_learning_tpu_torch.analysis.report import (
    Finding,
    HBMCost,
    Report,
    Severity,
)

__all__ = ["Finding", "HBMCost", "Report", "Severity"]
