"""Seeded-defect fixtures: launches the kernel linter MUST flag (and clean
twins it must not), the protocol checker's seeded models, and the grid
fixture's kernel F1 (port of ``analysis/fixtures.py``).

Each kernel fixture is a :class:`~.kernels.LaunchSpec` of one of the
port's own kernels with one defect:

- the paged-attention kernel K4's spec (``ops/paged_attention.py::
  launch_spec``) under a block-table contract one past the pool
  (``kernel-oob``) or within it (clean); with an int8 head dim of 4 in the
  contiguous slot (``kernel-tile``: 4 bytes of each 16-byte vector used)
  or transposed (clean) — plain specs, never launched;
- the grid kernel F1 (:func:`grid_scratch`, CUDA in
  ``ops/csrc/grid_scratch.cu``): ``o = cast(cast(x, scratch) * 2)``
  through an f32 or f16 scratch, one grid cell per row. Its fixtures RUN
  it, on the given device, and lint the spec it recorded: the racing
  variant maps every cell's output to row 0 (``kernel-race``), the f16
  scratch drifts (``kernel-dtype-drift``).

``tests/test_torch_kernel_lint.py`` holds every fixture to the verdict
the JAX tests record; the CLI's ``--fixtures`` re-runs the same contract
(non-zero exit when any fixture misbehaves), plus the chaos drill
coverage lint and the replay of the checker's exported counterexample on
a real fleet. The jaxpr fixtures of the JAX module (collectives,
donation, scatter bounds, retraces, sharded state) come with the rest of
the program linter (ROADMAP.md, Queue A, item 7.4).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from simple_distributed_machine_learning_tpu_torch._device import (
    resolve_device,
)
from simple_distributed_machine_learning_tpu_torch.analysis import (
    kernels as _kernels,
)
from simple_distributed_machine_learning_tpu_torch.analysis.report import (
    Report,
)


@dataclasses.dataclass(frozen=True)
class Fixture:
    name: str
    family: str              # rule family expected in the findings
    defect: bool             # True: must flag; False: must be clean
    description: str
    build: Callable[..., Report]      # build(device=None) -> Report


# -- F1: the grid kernel --------------------------------------------------

#: scratch dtypes the kernel is instantiated for -> its code
_SCRATCH = {torch.float32: 0, torch.float16: 1}


def grid_scratch_spec(rows: int, cols: int, *, racing: bool,
                      scratch_dtype=torch.float32):
    """F1's :class:`~.kernels.LaunchSpec`: grid ``(rows,)`` parallel, the
    input block ``(1, cols)`` at ``(i, 0)``, the output block at
    ``(i, 0)`` — or ``(0, 0)`` for every cell when ``racing`` (what an
    autotuner mutation that drops the output index silently does) — and
    the scratch row's dtype."""

    def at_row(i):
        return (i, 0)

    def at_first_row(i):
        return (0, 0)

    return _kernels.LaunchSpec(
        kernel="grid_scratch",
        where=f"{__name__}.grid_scratch (ops/csrc/grid_scratch.cu)",
        grid=(int(rows),),
        operands=(
            _kernels.Operand("x", (rows, cols), (1, cols), torch.float32,
                             at_row),
            _kernels.Operand("out", (rows, cols), (1, cols), torch.float32,
                             at_first_row if racing else at_row,
                             output=True)),
        scratch=(scratch_dtype,))


def _out_rows(spec) -> list[int]:
    """The output row of each grid cell, from the spec's own index map."""
    return [_kernels.concrete(spec, "out", i)[0] for i in range(spec.grid[0])]


def grid_scratch_reference(x: torch.Tensor, *, racing: bool,
                           scratch_dtype=torch.float32) -> torch.Tensor:
    """The plain torch version: the grid walked in order, each cell's row
    cast to the scratch dtype, doubled there, cast back and stored at the
    row its index map gives (a later cell overwrites an earlier one, as on
    the TPU's sequential grid). Rows no cell maps to stay NaN."""
    spec = grid_scratch_spec(*x.shape, racing=racing,
                             scratch_dtype=scratch_dtype)
    out = torch.full(x.shape, float("nan"), dtype=torch.float32,
                     device=x.device)
    for i, r in enumerate(_out_rows(spec)):
        out[r] = (x[i].to(scratch_dtype) * 2).to(torch.float32)
    return out


@functools.lru_cache(maxsize=None)
def _library():
    """Build (first use only) and bind ``csrc/grid_scratch.cu``."""
    from simple_distributed_machine_learning_tpu_torch.ops._cuda_build import (
        build,
    )
    built = build("sdml_grid_scratch", ["grid_scratch.cu"])
    fn = built.lib.sdml_grid_scratch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    built.lib.sdml_grid_scratch_error_string.argtypes = [ctypes.c_int]
    built.lib.sdml_grid_scratch_error_string.restype = ctypes.c_char_p
    return built


def build_kernel():
    """Build and load F1's library now; returns the ``BuiltLibrary``."""
    return _library()


def grid_scratch(x: torch.Tensor, *, racing: bool,
                 scratch_dtype=torch.float32, device=None) -> torch.Tensor:
    """F1: ``out[row(i)] = cast(cast(x[i], scratch_dtype) * 2)`` for each
    grid cell ``i`` of the ``[R, C]`` f32 ``x``, through a scratch row of
    ``scratch_dtype`` (f32 or f16). ``row(i)`` is the spec's output index
    map: ``i``, or 0 for every cell when ``racing``. The output starts as
    NaN, so rows no cell writes read NaN on both paths.

    ``device`` (None = ``"cuda"``) is where the call runs: ``x`` must lie
    there. CUDA launches the kernel (counted in ``grid_scratch.launches``)
    or raises; the CPU computes :func:`grid_scratch_reference`."""
    dev = resolve_device(device)
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be a [R, C] float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if scratch_dtype not in _SCRATCH:
        raise ValueError(f"scratch_dtype must be one of "
                         f"{sorted(map(str, _SCRATCH))}, got {scratch_dtype}")
    if x.device.type != dev.type:
        raise ValueError(f"grid_scratch: x lies on {x.device}, expected "
                         f"{dev}")
    spec = grid_scratch_spec(*x.shape, racing=racing,
                             scratch_dtype=scratch_dtype)
    _kernels.note(lambda: spec)
    if dev.type == "cpu":
        return grid_scratch_reference(x, racing=racing,
                                      scratch_dtype=scratch_dtype)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    out = torch.full(x.shape, float("nan"), dtype=torch.float32,
                     device=x.device)
    out_row = torch.tensor(_out_rows(spec), dtype=torch.int32).to(x.device)
    launch(x, out, out_row, scratch_dtype)
    return out


grid_scratch.launches = 0


def launch(x, out, out_row, scratch_dtype) -> None:
    """One launch of the kernel on prepared CUDA buffers (``x`` and
    ``out`` [R, C] f32 contiguous, ``out_row`` [R] int32)."""
    built = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = built.lib.sdml_grid_scratch(
        x.data_ptr(), out.data_ptr(), out_row.data_ptr(), x.shape[0],
        x.shape[1], _SCRATCH[scratch_dtype], stream)
    if rc != 0:
        msg = built.lib.sdml_grid_scratch_error_string(rc).decode()
        raise RuntimeError(f"grid_scratch kernel launch failed: {msg} "
                           f"(cudaError {rc})")
    grid_scratch.launches += 1


#: the numpy seed of :func:`grid_input`
_GRID_SEED = 0


def grid_input(device=None) -> torch.Tensor:
    """The grid fixture's input: a (4, 128) f32 array from a numpy seed."""
    x = np.random.default_rng(_GRID_SEED).standard_normal((4, 128))
    return torch.from_numpy(x.astype(np.float32)).to(resolve_device(device))


# -- kernel-*: seeded defects in launch specs -----------------------------

def _paged_spec(table_hi_slack: int, *, dh: int, bs: int,
                dtype=torch.float32, layout: str = "natural"):
    """K4's launch spec on synthetic shapes (the JAX fixture's: 2 slots, 2
    heads, 1 query, 3 logical blocks, a 5-block pool), with a block-table
    contract reaching ``n_blocks + table_hi_slack`` — slack 0 is the
    pool's invariant (clean), slack 1 a table that can point one block
    past the pool (kernel-oob). ``layout="packed"`` transposes the K/V
    blocks' trailing dims (a layout K4 does not run: a spec only)."""
    from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (  # noqa: E501
        launch_spec,
    )
    S, H, K, NB, n_blocks = 2, 2, 1, 3, 5

    def meta(shape, dt=torch.float32):
        return torch.empty(shape, dtype=dt, device="meta")

    kv = meta((n_blocks + 1, H, bs, dh), dtype)
    scale = (meta((n_blocks + 1, H, bs))
             if dtype.itemsize == 1 else None)
    spec = launch_spec(meta((S, H, K, dh)), kv, kv,
                       meta((S, NB), torch.int32), meta((S, K), torch.int32),
                       block_size=bs, kscale=scale, vscale=scale)
    if layout == "packed":
        spec = dataclasses.replace(spec, operands=tuple(
            dataclasses.replace(op, shape=op.shape[:2] + op.shape[:1:-1],
                                block=op.block[:2] + op.block[:1:-1])
            if op.name in ("k", "v") else op for op in spec.operands))
    return spec.with_contracts(tables=(0, n_blocks + table_hi_slack),
                               qpos=(0, NB * bs - 1))


def _spec_report(spec, name: str) -> Report:
    return _kernels.lint_report([spec], name=f"fixture:{name}")


def kernel_oob_index_map(device=None) -> Report:
    """K4's K/V index map fed a block-table contract that can reach one
    past the pool: the launch would read a block outside the buffer."""
    return _spec_report(_paged_spec(1, dh=8, bs=4), "kernel_oob_index_map")


def kernel_clean_paged(device=None) -> Report:
    """The same spec under the pool's table invariant — every index map
    proves in bounds (must be fully clean)."""
    return _spec_report(_paged_spec(0, dh=8, bs=4), "kernel_clean_paged")


def kernel_bad_tile(device=None) -> Report:
    """An int8 pool with head dim 4 in the contiguous slot at block size
    128: each row's 4 bytes take a 16-byte vector, 4x the bytes (the card's
    form of the small-head-dim hazard)."""
    return _spec_report(_paged_spec(0, dh=4, bs=128, dtype=torch.int8),
                        "kernel_bad_tile")


def kernel_packed_tile(device=None) -> Report:
    """The same blocks transposed: block positions contiguous, the small
    head dim strided (must be clean)."""
    return _spec_report(_paged_spec(0, dh=4, bs=128, dtype=torch.int8,
                                    layout="packed"), "kernel_packed_tile")


def _grid_kernel_report(racing: bool, scratch_dtype, name: str,
                        device=None) -> Report:
    """Run F1 once on ``device`` and lint the spec its launch recorded."""
    with _kernels.record_launches() as log:
        grid_scratch(grid_input(device), racing=racing,
                     scratch_dtype=scratch_dtype, device=device)
    return _kernels.lint_report(log, name=f"fixture:{name}")


def kernel_grid_race(device=None) -> Report:
    return _grid_kernel_report(True, torch.float32, "kernel_grid_race",
                               device)


def kernel_clean_grid(device=None) -> Report:
    return _grid_kernel_report(False, torch.float32, "kernel_clean_grid",
                               device)


def kernel_f16_accumulator(device=None) -> Report:
    """The grid kernel's scratch in f16: state carried below f32 drifts
    from the dense path's f32 math (the bit-exactness contract)."""
    return _grid_kernel_report(False, torch.float16,
                               "kernel_f16_accumulator", device)


def kernel_f32_accumulator(device=None) -> Report:
    return _grid_kernel_report(False, torch.float32,
                               "kernel_f32_accumulator", device)


# -- protocol: seeded defects in the abstract fleet model -----------------

def _protocol(name: str):
    def build(device=None) -> Report:
        from simple_distributed_machine_learning_tpu_torch.analysis import (
            protocol,
        )
        return protocol.check_protocol(getattr(protocol, name))
    build.__name__ = f"protocol_{name.lower()}"
    return build


protocol_dropped_handoff = _protocol("DROPPED_TOMBSTONE")
protocol_legacy_handoff_order = _protocol("LEGACY_ORDER")
protocol_skipped_refund = _protocol("SKIPPED_REFUND")
protocol_ungated_boarding = _protocol("UNGATED_BOARDING")
protocol_clean_fleet = _protocol("CLEAN")


FIXTURES: dict[str, Fixture] = {f.name: f for f in [
    Fixture("kernel_oob_index_map", "kernel-oob", True,
            "fused paged kernel with a block-table contract past the pool",
            kernel_oob_index_map),
    Fixture("kernel_grid_race", "kernel-race", True,
            "grid kernel output map collapsing a parallel grid axis",
            kernel_grid_race),
    Fixture("kernel_bad_tile", "kernel-tile", True,
            "int8 head dim 4 in the contiguous slot (4x 16-byte vectors)",
            kernel_bad_tile),
    Fixture("kernel_f16_accumulator", "kernel-dtype-drift", True,
            "f16 scratch accumulator carried across grid iterations",
            kernel_f16_accumulator),
    Fixture("protocol_dropped_handoff", "protocol", True,
            "handoff sealed without journaling the source tombstone",
            protocol_dropped_handoff),
    Fixture("protocol_legacy_handoff_order", "protocol", True,
            "tombstone-then-copy handoff (pre-fix ordering, loses the rid)",
            protocol_legacy_handoff_order),
    Fixture("protocol_skipped_refund", "protocol", True,
            "shed/preempt path that never refunds the KV block refcounts",
            protocol_skipped_refund),
    Fixture("protocol_ungated_boarding", "protocol", True,
            "decode boarding not gated on the prefetch upload landing",
            protocol_ungated_boarding),
    Fixture("kernel_clean_paged", "", False,
            "the fused paged kernel under the slots.py table invariant",
            kernel_clean_paged),
    Fixture("kernel_clean_grid", "", False,
            "the grid kernel with its output indexed by the parallel axis",
            kernel_clean_grid),
    Fixture("kernel_packed_tile", "", False,
            "the small-head-dim blocks transposed (positions contiguous)",
            kernel_packed_tile),
    Fixture("kernel_f32_accumulator", "", False,
            "the grid kernel with its scratch accumulator in f32",
            kernel_f32_accumulator),
    Fixture("protocol_clean_fleet", "", False,
            "the 2-pool fleet model with every defect knob off (proves)",
            protocol_clean_fleet),
]}


def _replay_exported_drill(device=None) -> tuple[bool, list[str]]:
    """The model checker's export must have teeth: the FaultPlan exported
    from the dropped-tombstone model's double-serve counterexample must
    replay as a REAL failure (more tokens streamed than the request asked
    for) on a live 3-replica disaggregated fleet carrying the same seeded
    defect (``log_handoff`` suppressed), and the intact twin must stay
    exactly-once under the identical kill schedule."""
    import os
    import tempfile

    from simple_distributed_machine_learning_tpu_torch.analysis.protocol import (  # noqa: E501
        DROPPED_TOMBSTONE,
        check_protocol,
        export_fault_plan,
    )
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        GPTConfig,
        make_gpt_stages,
    )
    from simple_distributed_machine_learning_tpu_torch.resilience import (
        faults,
    )
    from simple_distributed_machine_learning_tpu_torch.serve import (
        RequestJournal,
        ServeFleet,
        engine_factory,
    )
    from simple_distributed_machine_learning_tpu_torch.serve.request import (
        DONE,
    )

    lines = []
    report = check_protocol(DROPPED_TOMBSTONE)
    viol = next((v for v in report.exploration.violations
                 if v.invariant == "double-serve"), None)
    if viol is None:
        return False, ["== exported-drill replay: model found no "
                       "double-serve counterexample -> FAILED"]
    plan_text, note = export_fault_plan(viol)
    if plan_text is None:
        return False, [f"== exported-drill replay: counterexample not "
                       f"expressible as a FaultPlan ({note}) -> FAILED"]
    lines.append(f"  exported plan: {plan_text}")

    dev = resolve_device(device)
    cfg = GPTConfig(vocab=32, seq_len=48, d_model=32, n_heads=2, n_layers=2)
    stages = make_gpt_stages(0, cfg, 2, device=dev)[0]
    prompt = np.random.default_rng(7).integers(0, cfg.vocab, 4).astype(
        np.int32)
    max_new = 3

    def run(drop_tombstone: bool) -> int:
        """Drive the model's scenario (submit -> prefill -> handoff ->
        DONE), then install the exported plan and keep ticking; returns
        total tokens streamed to the caller over the whole run."""
        faults.uninstall()
        orig = RequestJournal.log_handoff
        if drop_tombstone:
            RequestJournal.log_handoff = lambda self, **kw: None
        try:
            with tempfile.TemporaryDirectory() as td:
                fleet = ServeFleet(
                    engine_factory(stages, cfg, n_slots=2, block_size=4,
                                   prefill_chunk=3, device=dev),
                    os.path.join(td, "j"), n_replicas=3,
                    prefill_replicas=1, journal_sync=False)
                got = []
                h = fleet.submit(prompt, max_new_tokens=max_new, seed=11,
                                 on_token=lambda req, tok: got.append(tok))
                for _ in range(60):
                    fleet.step()
                    if h.state == DONE and fleet.handoffs >= 1:
                        break
                faults.install(faults.FaultPlan.parse(plan_text))
                for _ in range(len(plan_text.split(";")) + 1):
                    fleet.step()
                faults.uninstall()
                for _ in range(60):
                    if h.state == DONE:
                        break
                    fleet.step()
                fleet.close()
                return len(got)
        finally:
            RequestJournal.log_handoff = orig
            faults.uninstall()

    defect_tokens = run(drop_tombstone=True)
    clean_tokens = run(drop_tombstone=False)
    defect_good = defect_tokens > max_new
    clean_good = clean_tokens == max_new
    lines.append(f"  defect twin (log_handoff dropped): streamed "
                 f"{defect_tokens}/{max_new} tokens -> "
                 f"{'double-served as predicted' if defect_good else 'NO REAL FAILURE (vacuous export)'}")  # noqa: E501
    lines.append(f"  clean twin (tombstone intact):     streamed "
                 f"{clean_tokens}/{max_new} tokens -> "
                 f"{'exactly-once' if clean_good else 'UNEXPECTED FAILURE'}")
    ok = defect_good and clean_good
    lines.insert(0, f"== exported-drill replay: counterexample must fail a "
                    f"real fleet -> {'OK' if ok else 'FAILED'}")
    return ok, lines


def self_test(device=None) -> tuple[bool, str]:
    """Run every fixture against its contract (on ``device`` where it
    launches a kernel), plus the chaos drill coverage lint
    (``resilience.faults.drill_coverage``) and the exported drill's
    replay. Returns (ok, report_text) — the CLI ``--fixtures`` mode prints
    the text and exits 0 iff ok."""
    lines = []
    ok = True
    for fx in FIXTURES.values():
        report = fx.build(device)
        flagged = not report.ok(fail_on="warning")
        family_hit = (not fx.defect or
                      any(f.family == fx.family for f in report.findings))
        good = (flagged and family_hit) if fx.defect else not flagged
        ok = ok and good
        verdict = "OK" if good else "FIXTURE CONTRACT VIOLATED"
        want = (f"must flag [{fx.family}]" if fx.defect else "must be clean")
        lines.append(f"== {fx.name}: {want} -> {verdict}")
        lines.append(report.format(costs=False))
    from simple_distributed_machine_learning_tpu_torch.resilience.faults import (  # noqa: E501
        drill_coverage,
    )
    gaps = drill_coverage()
    verdict = "OK" if not gaps else "COVERAGE GAPS"
    lines.append(f"== fault drill coverage: every kind x site fired "
                 f"-> {verdict}")
    for g in gaps:
        lines.append(f"  MISSING: {g}")
        ok = False
    replay_ok, replay_lines = _replay_exported_drill(device)
    ok = ok and replay_ok
    lines.extend(replay_lines)
    return ok, "\n".join(lines)
