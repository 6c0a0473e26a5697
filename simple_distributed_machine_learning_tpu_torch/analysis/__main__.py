"""CLI of the port's analysis package: the serve-protocol model checker,
the kernel linter's registry sweep and the seeded fixtures.

Examples::

    # prove the fleet protocol's invariants to the pinned depth 8
    python -m simple_distributed_machine_learning_tpu_torch.analysis \\
        --serve-protocol

    # the kernel-only preflight: every fused layout's recorded launches
    # lint clean and their K/V bytes equal the byte model's
    python -m simple_distributed_machine_learning_tpu_torch.analysis \\
        --serve-kernel

    # one seeded fixture (exits non-zero when it flags, which a defect
    # fixture always must); every fixture against its contract
    python -m simple_distributed_machine_learning_tpu_torch.analysis \\
        --fixture kernel_grid_race
    python -m simple_distributed_machine_learning_tpu_torch.analysis \\
        --fixtures

Exit code: 0 when every requested mode satisfies ``--fail-on`` (default
``warning`` for fixtures, ``error`` otherwise; ``--serve-kernel`` gates on
any kernel finding), 1 on a lint failure, 2 when a protocol invariant is
violated, as the JAX package's CLI. ``SDML_LINT_INJECT=<tag>`` seeds one
ERROR finding (the gate drill). ``--serve-kernel`` and the fixtures run
kernels on ``--device`` (default CUDA; raises without it unless
``--device cpu``), the port's one flag of its own. ``--serve`` and
``--dryrun`` (the jaxpr linter) and ``--hostlint`` exit naming the
ROADMAP.md item that ports them.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from simple_distributed_machine_learning_tpu_torch import _roadmap

# the JAX CLI's modes this package does not run yet: dest -> ROADMAP item
_UNPORTED = {"hostlint": _roadmap.HOSTLINT,
             "serve": _roadmap.PROGRAM_LINTER,
             "dryrun": _roadmap.PROGRAM_LINTER}

#: the rule families the port's passes emit
RULE_FAMILIES = ("journal-grammar", "protocol", "kernel-oob",
                 "kernel-unproven", "kernel-race", "kernel-tile",
                 "kernel-dtype-drift", "kernel-hbm")


def build_parser() -> argparse.ArgumentParser:
    """The JAX CLI's arguments (``analysis/__main__.py``), same names and
    defaults, and ``--device``."""
    p = argparse.ArgumentParser(
        prog="python -m simple_distributed_machine_learning_tpu_torch."
             "analysis",
        description="serve-protocol model checking, the kernel linter "
                    "and its seeded fixtures")
    p.add_argument("--dryrun", type=int, default=None, metavar="N",
                   help="not ported (ROADMAP.md, Queue A, item 7.4)")
    p.add_argument("--serve", action="store_true",
                   help="not ported (ROADMAP.md, Queue A, item 7.4)")
    p.add_argument("--serve-kernel", action="store_true",
                   help="kernel-only preflight over the registry sweep: "
                        "every fused layout's recorded paged-attention "
                        "launches must lint clean — zero kernel-family "
                        "findings at ANY severity — and their derived K/V "
                        "bytes must equal the byte model's")
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
                   help="run one seeded fixture (see --list)")
    p.add_argument("--fixtures", action="store_true",
                   help="self-test every fixture against its contract")
    p.add_argument("--list", action="store_true",
                   help="list fixtures and rule families")
    p.add_argument("--fail-on", choices=("error", "warning"), default=None,
                   help="finding severity that makes the exit code non-zero "
                        "(default: warning for fixtures, error otherwise)")
    p.add_argument("--costs", action="store_true",
                   help="print a fixture's HBM bytes-per-tick table")
    p.add_argument("--device", default=None,
                   help="where --serve-kernel and the fixtures run their "
                        "kernels: cuda (the default; raises without CUDA) "
                        "or cpu")
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

    if args.list:
        from simple_distributed_machine_learning_tpu_torch.analysis.fixtures import (  # noqa: E501
            FIXTURES,
        )
        print("rule families: " + " ".join(RULE_FAMILIES))
        print("fixtures:")
        for fx in FIXTURES.values():
            kind = "defect" if fx.defect else "clean"
            print(f"  {fx.name:<24} [{kind:>6}] {fx.description}")
        return 0

    if not (args.serve_kernel or args.fixtures or args.serve_protocol
            or args.fixture is not None):
        p.error("nothing to do: pass --serve-kernel, --serve-protocol, "
                "--fixture NAME, --fixtures or --list")

    # modes compose: every requested mode runs and the exit code ANDs them
    ok = True
    protocol_violated = False

    if args.serve_kernel:
        from simple_distributed_machine_learning_tpu_torch.analysis.kernels import (  # noqa: E501
            KERNEL_FAMILIES,
        )
        from simple_distributed_machine_learning_tpu_torch.analysis.programs import (  # noqa: E501
            kernel_registry_reports,
        )
        reports = kernel_registry_reports(args.device)
        gating = [f for r in reports for f in r.findings
                  if f.family in KERNEL_FAMILIES]
        for f in gating:
            print("\n".join("  " + ln for ln in f.format().splitlines()))
        for r in reports:
            rows = [h for h in r.hbm if h.op.startswith("kernel.")]
            if rows:
                print(f"{r.name}: "
                      + ", ".join(f"{h.program} {h.op}="
                                  f"{h.bytes_per_tick}B" for h in rows))
        # kernel paths gate at ANY severity (zero unproven is the
        # contract), and the whole report must still be ERROR-free so the
        # SDML_LINT_INJECT drill trips this preflight too
        kern_ok = (not gating
                   and all(r.ok(args.fail_on or "error") for r in reports))
        print(f"analysis --serve-kernel: {len(reports)} layouts "
              f"{'kernel-clean' if kern_ok else 'FLAGGED'}")
        ok &= kern_ok

    if args.serve_protocol:
        from simple_distributed_machine_learning_tpu_torch.analysis.protocol import (  # noqa: E501
            CLEAN,
            INVARIANTS,
            check_protocol,
        )
        from simple_distributed_machine_learning_tpu_torch.analysis.programs import (  # noqa: E501
            _injected_findings,
        )
        cfg = CLEAN if args.depth is None else dataclasses.replace(
            CLEAN, depth=args.depth)
        report = check_protocol(cfg)
        # the SDML_LINT_INJECT gate drill: a seeded ERROR finding proves
        # the gate fails when it should
        report.findings.extend(_injected_findings())
        print(report.format(costs=False))
        print(f"model: {cfg.summary()}")
        print(f"invariants: {', '.join(INVARIANTS)}")
        print(f"verdict: {report.verdict}")
        proto_ok = report.ok(args.fail_on or "error")
        print(f"analysis --serve-protocol: "
              f"{'clean' if proto_ok else 'FLAGGED'}")
        ok &= proto_ok
        # a violated protocol invariant has its own exit code (2),
        # distinct from ordinary lint findings (1)
        protocol_violated |= not proto_ok

    if args.fixtures:
        from simple_distributed_machine_learning_tpu_torch.analysis.fixtures import (  # noqa: E501
            self_test,
        )
        fx_ok, text = self_test(args.device)
        print(text)
        print(f"fixture self-test: {'OK' if fx_ok else 'FAILED'}")
        ok &= fx_ok

    if args.fixture is not None:
        from simple_distributed_machine_learning_tpu_torch.analysis.fixtures import (  # noqa: E501
            FIXTURES,
        )
        if args.fixture not in FIXTURES:
            p.error(f"unknown fixture {args.fixture!r} (see --list)")
        report = FIXTURES[args.fixture].build(args.device)
        print(report.format(costs=args.costs))
        ok &= report.ok(args.fail_on or "warning")

    return 0 if ok else (2 if protocol_violated else 1)


if __name__ == "__main__":
    sys.exit(main())
