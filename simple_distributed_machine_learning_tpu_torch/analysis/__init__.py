"""Analysis (port of ``analysis/``): the bounded model checker of the
serve fleet protocol, the journal-grammar lint, the kernel linter and the
serving byte model.

- :mod:`.statespace` — the generic bounded explicit-state explorer (BFS,
  state-hash dedup, shortest counterexamples, depth-honest verdicts);
- :mod:`.protocol` — the fleet's snap/adopt/handoff protocol as a
  transition system, its five invariants, the clean config and four
  seeded-defect configs, and the export of a counterexample as a
  ``resilience/faults.py`` chaos drill;
- :mod:`.hostlint` — ``lint_journal_grammar``: every journal event kind
  a ``serve/`` writer emits has a dispatching reader;
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

The protocol checker is stdlib; the kernel modules import torch. CLI::

    python -m simple_distributed_machine_learning_tpu_torch.analysis \\
        --serve-protocol [--depth N] [--fail-on error|warning]
    python -m simple_distributed_machine_learning_tpu_torch.analysis \\
        --serve-kernel | --fixtures | --fixture NAME | --list

The program linter over traced programs (``--dryrun``, ``--serve``, the
jaxpr fixtures, ``lint=True``) is ROADMAP.md, Queue A, item 7.4, and the
rest of hostlint item 7.2: their flags refuse, naming the item.
"""

from __future__ import annotations

from simple_distributed_machine_learning_tpu_torch.analysis.report import (
    Finding,
    HBMCost,
    Report,
    Severity,
)

__all__ = ["Finding", "HBMCost", "Report", "Severity"]
