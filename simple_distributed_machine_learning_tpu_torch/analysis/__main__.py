"""CLI of the port's analysis package: the program linter's preflights
(``--dryrun N``, ``--serve``), the serve-protocol model checker, the
kernel linter's registry sweep, hostlint and the seeded fixtures.

Examples::

    # the training steps of an N-coordinate dryrun and the serving
    # registry, traced and linted (nothing runs on the card)
    python -m simple_distributed_machine_learning_tpu_torch.analysis \\
        --dryrun 8
    python -m simple_distributed_machine_learning_tpu_torch.analysis \\
        --serve

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
ERROR finding (the gate drill). ``--dryrun``, ``--serve``,
``--serve-kernel`` and the fixtures build on ``--device`` (default CUDA;
raises without it unless ``--device cpu``), the port's one flag of its
own: ``--serve-kernel`` and the grid fixtures launch kernels there, the
program linter only traces for it. ``--hostlint`` (pure ``ast``) imports
the package and so torch; ``python
simple_distributed_machine_learning_tpu_torch/analysis/hostlint.py`` runs
the same lint without it.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

#: the rule families the port's passes emit
RULE_FAMILIES = ("ppermute-deadlock", "unreduced-gradient", "mesh-axis",
                 "dtype-drift", "donation", "scatter-bounds",
                 "retrace-explosion", "sharded-state", "hostlint",
                 "journal-grammar", "metric-catalog", "protocol",
                 "kernel-oob", "kernel-unproven", "kernel-race",
                 "kernel-tile", "kernel-dtype-drift", "kernel-hbm")


def build_parser() -> argparse.ArgumentParser:
    """The JAX CLI's arguments (``analysis/__main__.py``), same names and
    defaults, and ``--device``."""
    p = argparse.ArgumentParser(
        prog="python -m simple_distributed_machine_learning_tpu_torch."
             "analysis",
        description="serve-protocol model checking, the kernel linter "
                    "and its seeded fixtures")
    p.add_argument("--dryrun", type=int, default=None, metavar="N",
                   help="trace and lint the train/eval/ZeRO-1/1F1B steps of "
                        "an N-coordinate dryrun mesh (dp x pp x tp as "
                        "dryrun_multichip picks it)")
    p.add_argument("--serve", action="store_true",
                   help="trace and lint every serving program over the "
                        "registry's layouts (scatter bounds, donation flow "
                        "through the tick, retrace policy, HBM bytes/tick)")
    p.add_argument("--serve-kernel", action="store_true",
                   help="kernel-only preflight over the registry sweep: "
                        "every fused layout's recorded paged-attention "
                        "launches must lint clean — zero kernel-family "
                        "findings at ANY severity — and their derived K/V "
                        "bytes must equal the byte model's")
    p.add_argument("--hostlint", action="store_true",
                   help="host-side AST lint (no torch needed): the "
                        "decode-builder table, private forwards called "
                        "past their builders, kernel build memos touched "
                        "from a distance, compiled programs or CUDA graphs "
                        "made in serve/, wall-clock/RNG calls in serve/ "
                        "and the SLO pipeline, undocumented metrics, "
                        "unread journal events")
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
                   help="print the cost tables (bytes between coordinates "
                        "per step, HBM bytes per serve tick)")
    p.add_argument("--device", default=None,
                   help="where --serve-kernel and the fixtures run their "
                        "kernels: cuda (the default; raises without CUDA) "
                        "or cpu")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)

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

    if not (args.hostlint or args.serve_kernel or args.fixtures
            or args.serve_protocol or args.fixture is not None
            or args.serve or args.dryrun is not None):
        p.error("nothing to do: pass --dryrun N, --serve, --hostlint, "
                "--serve-kernel, --serve-protocol, --fixture NAME, "
                "--fixtures or --list")

    # modes compose: every requested mode runs and the exit code ANDs them
    ok = True
    protocol_violated = False

    if args.hostlint:
        from simple_distributed_machine_learning_tpu_torch.analysis.hostlint import (  # noqa: E501
            _injected_findings,
            lint_repo,
        )
        report = lint_repo()
        # the SDML_LINT_INJECT gate drill
        report.findings.extend(_injected_findings())
        print(report.format(costs=False))
        host_ok = report.ok(args.fail_on or "error")
        print(f"analysis --hostlint: {'clean' if host_ok else 'FLAGGED'}")
        ok &= host_ok

    if args.serve:
        from simple_distributed_machine_learning_tpu_torch.analysis.programs import (  # noqa: E501
            default_registry_reports,
        )
        reports = default_registry_reports(args.device)
        for r in reports:
            print(r.format(costs=args.costs))
        fail_on = args.fail_on or "error"
        serve_ok = all(r.ok(fail_on) for r in reports)
        print(f"analysis --serve: {len(reports)} layouts "
              f"{'clean' if serve_ok else 'FLAGGED'}")
        ok &= serve_ok

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

    if args.dryrun is not None:
        from simple_distributed_machine_learning_tpu_torch.analysis.preflight import (  # noqa: E501
            all_ok,
            dryrun_reports,
        )
        from simple_distributed_machine_learning_tpu_torch.analysis.programs import (  # noqa: E501
            _injected_findings,
        )
        reports = dryrun_reports(args.dryrun, args.device)
        # the SDML_LINT_INJECT gate drill
        if reports:
            reports[0].findings.extend(_injected_findings())
        for r in reports:
            print(r.format(costs=args.costs))
        fail_on = args.fail_on or "error"
        dry_ok = all_ok(reports, fail_on)
        print(f"analysis --dryrun {args.dryrun}: "
              f"{len(reports)} steps {'clean' if dry_ok else 'FLAGGED'}")
        ok &= dry_ok

    return 0 if ok else (2 if protocol_violated else 1)


if __name__ == "__main__":
    sys.exit(main())
