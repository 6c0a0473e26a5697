"""CLI of the port's analysis package: the serve-protocol model checker.

Examples::

    # prove the fleet protocol's invariants to the pinned depth 8
    python -m simple_distributed_machine_learning_tpu_torch.analysis \\
        --serve-protocol

    # a shallower bound; the gate drill (a seeded ERROR finding)
    SDML_LINT_INJECT=drill python -m \\
        simple_distributed_machine_learning_tpu_torch.analysis \\
        --serve-protocol --depth 6

Exit code: 0 when the report satisfies ``--fail-on`` (default ``error``),
2 when a protocol invariant is violated (or the gate drill is on), as
the JAX package's CLI. The JAX CLI's other modes keep their flags here
and exit naming the ROADMAP.md item that ports them.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from simple_distributed_machine_learning_tpu_torch import _roadmap

# the JAX CLI's modes this package does not run yet: dest -> ROADMAP item
_UNPORTED = {"hostlint": _roadmap.HOSTLINT,
             "serve": _roadmap.PROGRAM_LINTER,
             "serve_kernel": _roadmap.PROGRAM_LINTER,
             "dryrun": _roadmap.PROGRAM_LINTER,
             "fixture": _roadmap.PROGRAM_LINTER,
             "fixtures": _roadmap.PROGRAM_LINTER,
             "list": _roadmap.PROGRAM_LINTER,
             "costs": _roadmap.PROGRAM_LINTER}


def build_parser() -> argparse.ArgumentParser:
    """The JAX CLI's arguments (``analysis/__main__.py``), same names and
    defaults."""
    p = argparse.ArgumentParser(
        prog="python -m simple_distributed_machine_learning_tpu_torch."
             "analysis",
        description="bounded model checking of the serve fleet protocol")
    p.add_argument("--dryrun", type=int, default=None, metavar="N",
                   help="not ported (ROADMAP.md, Queue A, item 7.4)")
    p.add_argument("--serve", action="store_true",
                   help="not ported (ROADMAP.md, Queue A, item 7.4)")
    p.add_argument("--serve-kernel", action="store_true",
                   help="not ported (ROADMAP.md, Queue A, item 7.4)")
    p.add_argument("--hostlint", action="store_true",
                   help="not ported (ROADMAP.md, Queue A, item 7.2)")
    p.add_argument("--serve-protocol", action="store_true",
                   help="bounded model checking of the serve fleet "
                        "protocol: exhaustively explore every "
                        "tick/crash/handoff/adopt/shed/prefetch/retire "
                        "interleaving of an abstract 2-pool fleet to "
                        "--depth and prove the no-double-serve / "
                        "no-lost-request / refcount-conservation / "
                        "boarding-gate invariants (exit 2 on a violated "
                        "invariant, each violation prints its "
                        "counterexample + exported chaos schedule)")
    p.add_argument("--depth", type=int, default=None, metavar="N",
                   help="--serve-protocol exploration depth bound "
                        "(default: the clean model's pinned depth 8)")
    p.add_argument("--fixture", default=None, metavar="NAME",
                   help="not ported (ROADMAP.md, Queue A, item 7.4)")
    p.add_argument("--fixtures", action="store_true",
                   help="not ported (ROADMAP.md, Queue A, item 7.4)")
    p.add_argument("--list", action="store_true",
                   help="not ported (ROADMAP.md, Queue A, item 7.4)")
    p.add_argument("--fail-on", choices=("error", "warning"), default=None,
                   help="finding severity that makes the exit code non-zero "
                        "(default: error)")
    p.add_argument("--costs", action="store_true",
                   help="not ported (ROADMAP.md, Queue A, item 7.4)")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    for dest, item in _UNPORTED.items():
        value = getattr(args, dest)
        if value != p.get_default(dest):
            flag = "--" + dest.replace("_", "-")
            raise SystemExit(str(_roadmap.not_ported(
                f"analysis {flag}", item)))
    if not args.serve_protocol:
        p.error("nothing to do: pass --serve-protocol")

    from simple_distributed_machine_learning_tpu_torch.analysis.protocol import (  # noqa: E501
        CLEAN,
        INVARIANTS,
        check_protocol,
    )
    from simple_distributed_machine_learning_tpu_torch.analysis.report import (  # noqa: E501
        Finding,
        Severity,
    )
    cfg = CLEAN if args.depth is None else dataclasses.replace(
        CLEAN, depth=args.depth)
    report = check_protocol(cfg)
    # the SDML_LINT_INJECT gate drill: a seeded ERROR finding proves the
    # gate fails when it should
    tag = os.environ.get("SDML_LINT_INJECT")
    if tag:
        report.findings.append(Finding(
            rule=f"injected.{tag}", severity=Severity.ERROR,
            message="seeded ERROR finding injected via "
                    "SDML_LINT_INJECT — the gate drill proving "
                    "--lint preflights actually fail",
            where="SDML_LINT_INJECT", hint="unset SDML_LINT_INJECT"))
    print(report.format())
    print(f"model: {cfg.summary()}")
    print(f"invariants: {', '.join(INVARIANTS)}")
    print(f"verdict: {report.verdict}")
    ok = report.ok(args.fail_on or "error")
    print(f"analysis --serve-protocol: {'clean' if ok else 'FLAGGED'}")
    # a violated protocol invariant has its own exit code (2), distinct
    # from ordinary lint findings (1)
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
