"""Static collective-traffic gauge: expected bytes between coordinates per
step (port of ``telemetry/ici.py``).

Read-only reuse of ``analysis``'s cost table: the step about to run is
traced (fake tensors: zero FLOPs, no device buffers, no kernel launched)
and every noted collective's ring-traffic estimate is summed, so the
metrics stream carries *bytes/step* next to *ms/step*. This is the STATIC
expected traffic — what the program asks the wire to move — not a
hardware counter: across processes it is what this process's traced step
sends (a stage hop's activations and dropout state, a cotangent, a
gradient or loss sum), which the wire's own counter
(``parallel/mesh.py::WIRE``, the host-staged sends) reads back on a real
run; in one process it is what would cross between its coordinates.
The name keeps the JAX package's ("ICI": the TPU's interconnect).
"""

from __future__ import annotations


def expected_ici_bytes(fn, *abstract_args, mesh=None, name: str = "step",
                       steps: int = 1, top: int = 5, **abstract_kwargs
                       ) -> dict | None:
    """Expected collective bytes moved per step by ``fn``.

    ``abstract_args`` as for ``analysis.analyze`` (fake stand-ins:
    ``analysis.abstractify`` on live buffers copies nothing). ``steps``
    divides the total for a program that runs several steps.

    Returns ``{"ici_bytes_per_step": int, "collectives": [{prim, axes,
    bytes_per_step, where}, ...]}`` (top-``top`` ranked), or ``None`` when
    the step cannot be traced — telemetry must never turn a runnable
    program into a crash.
    """
    try:
        from simple_distributed_machine_learning_tpu_torch.analysis import (
            analyze,
        )

        report = analyze(fn, *abstract_args, mesh=mesh, name=name,
                         **abstract_kwargs)
        return from_report(report, steps=steps, top=top)
    except Exception:  # noqa: BLE001 - strictly best-effort introspection
        return None


def from_report(report, steps: int = 1, top: int = 5) -> dict | None:
    """Summarize an already-computed ``analysis.Report``'s cost table into
    the :func:`expected_ici_bytes` record shape — for callers that have
    just analyzed the exact same step and must not pay the trace twice."""
    if report is None or (report.errors and not report.costs):
        return None                          # trace failed: no table to sum
    total = sum(c.total_bytes for c in report.costs)
    ranked = sorted(report.costs, key=lambda c: -c.total_bytes)[:top]
    return {
        "ici_bytes_per_step": total // max(1, steps),
        "collectives": [
            {"prim": c.prim, "axes": list(c.axes),
             "bytes_per_step": c.total_bytes // max(1, steps),
             "where": c.where}
            for c in ranked],
    }


def record(registry, info: dict | None) -> None:
    """Mirror an :func:`expected_ici_bytes` result into registry gauges."""
    if not info or registry is None:
        return
    registry.gauge("ici_bytes_per_step").set(info["ici_bytes_per_step"])
    grouped: dict[tuple[str, str], int] = {}
    for c in info["collectives"]:
        k = (c["prim"], ",".join(c["axes"]) or "-")
        grouped[k] = grouped.get(k, 0) + c["bytes_per_step"]
    for (prim, axes), nbytes in grouped.items():
        registry.gauge("ici_collective_bytes_per_step",
                       labels={"prim": prim, "axes": axes}).set(nbytes)
