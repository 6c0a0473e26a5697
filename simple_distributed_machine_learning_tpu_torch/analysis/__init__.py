"""Analysis (port of ``analysis/``): the bounded model checker of the
serve fleet protocol and the journal-grammar lint.

- :mod:`.statespace` — the generic bounded explicit-state explorer (BFS,
  state-hash dedup, shortest counterexamples, depth-honest verdicts);
- :mod:`.protocol` — the fleet's snap/adopt/handoff protocol as a
  transition system, its five invariants, the clean config and four
  seeded-defect configs, and the export of a counterexample as a
  ``resilience/faults.py`` chaos drill;
- :mod:`.hostlint` — ``lint_journal_grammar``: every journal event kind
  a ``serve/`` writer emits has a dispatching reader;
- :mod:`.report` — ``Severity``, ``Finding``, ``Report``.

All of it is stdlib: nothing here imports torch. CLI::

    python -m simple_distributed_machine_learning_tpu_torch.analysis \\
        --serve-protocol [--depth N] [--fail-on error|warning]

The program linter over traced programs (``--dryrun``, ``--serve``,
``--serve-kernel``, the fixtures) is ROADMAP.md, Queue A, item 7.4, and
the rest of hostlint item 7.2: their flags refuse, naming the item.
"""

from __future__ import annotations

from simple_distributed_machine_learning_tpu_torch.analysis.report import (
    Finding,
    Report,
    Severity,
)

__all__ = ["Finding", "Report", "Severity"]
