"""Static verification of the port's kernel launches — the ``kernel-*`` rule
family (port of ``analysis/kernels.py``).

The JAX linter reads each ``pallas_call``'s own metadata: its grid, its
BlockSpec index maps, block shapes and scratch. A CUDA kernel has no
BlockSpec: it computes its offsets from ``blockIdx`` itself. So each of
the port's kernel wrappers declares what its launch reads and writes as a
:class:`LaunchSpec` — the grid, any loop inside the block, and per operand
its shape, block, dtype and an **index map** from the grid (and loop)
indices to the block it touches — and this module checks that
declaration:

- **index-map bounds** (``kernel-oob.index-map`` ERROR /
  ``kernel-unproven.index-map`` WARNING): every index map is evaluated
  over the interval lattice (:mod:`.bounds`) with each axis seeded
  ``[0, n-1]`` and each table operand seeded from the caller's declared
  ``spec(...)`` contract (block-table entries <= n_blocks). A block index
  that can escape ``[0, ceil(dim/block)-1]`` is an out-of-bounds window;
- **grid write races** (``kernel-race.parallel-overwrite`` ERROR /
  ``kernel-race.unproven-map`` WARNING): every CUDA grid axis is
  parallel, so each output block must be written by at most one cell of
  it. The output map is evaluated as an affine form in the axes: a
  component with a nonzero coefficient in axis ``g`` is injective along
  ``g``; an axis no component reaches means every cell of it writes the
  same block. A loop inside the block is sequential (``arbitrary``) and
  may revisit a block, as an online softmax accumulates;
- **access lint** (``kernel-tile.pad-waste`` WARNING): retargeted from
  the TPU's tile to the card's unit of access. The JAX rule pads each
  block's trailing two dims to Mosaic's minimum tile; the card reads a
  block's contiguous (last) dim in 16-byte vectors (4 f32, 8 bf16/f16,
  16 int8/fp8 values), so a contiguous dim shorter than a vector wastes
  the rest of it. JAX's thresholds are kept: flagged at >= 4x waste when
  the transposed block would waste less than half that;
- **dtype lint** (``kernel-dtype-drift.low-precision-scratch`` WARNING):
  floating scratch below f32 carried across the grid or loop loses the
  accumulation precision of the dense path's f32 math.

:func:`kernel_hbm_costs` derives HBM traffic rows from the specs (block
bytes x the grid cells and loop trips behind each map), tagged
``kernel.kv_stream`` for table-indexed streams and ``kernel.io`` for the
rest. Where Mosaic elides a window that consecutive grid steps revisit,
CUDA thread blocks share nothing: every grid axis multiplies, and only an
in-block loop axis that a map ignores is read once (before the loop).
``programs.kernel_registry_reports`` reconciles the kv_stream bytes with
the byte model's ``decode.kv_gather``/``verify.kv_gather`` rows exactly.

Index maps are plain Python callables ``map(*grid, *loop, *tables)``
returning one block index per dim. They are called with symbolic values
(:class:`Sym`: an interval, an affine form and the axes it depends on at
once), with Python ints (the wrapper's own concrete evaluation: F1 takes
its output rows from its spec) — so they may use ``+ - * // %``,
:func:`minimum`, :func:`maximum`, a table lookup ``tbl[i]`` or
``tbl[i, j]`` and :func:`cast`. Everything here is metadata only: no
kernel runs, and the checks are the same on the CPU as on the card.

:func:`record_launches` collects the spec of every launch a wrapper makes
inside it (kernel path and plain CPU path alike; each wrapper calls
:func:`note`): the registry and the chip smoke lint what a real tick
launched.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable

import torch

from simple_distributed_machine_learning_tpu_torch.analysis.bounds import (
    TOP,
    ArgSpec,
    Interval,
    _floordiv_iv,
    _index_verdict,
    _mod_iv,
    _mul_iv,
)
from simple_distributed_machine_learning_tpu_torch.analysis.report import (
    Finding,
    HBMCost,
    Report,
    Severity,
)

_INF = math.inf

#: the rule families this module emits — CLI gates and CI drills key off it
KERNEL_FAMILIES = ("kernel-oob", "kernel-unproven", "kernel-race",
                   "kernel-tile", "kernel-dtype-drift", "kernel-hbm")

#: access-lint thresholds: flag when the contiguous dim's vector padding
#: wastes >= 4x the block's bytes AND the transposed block would waste
#: less than half that
_WASTE_FLAG = 4.0
_WASTE_RATIO = 2.0
#: the card's widest load a thread issues: one 16-byte vector
VECTOR_BYTES = 16


# -- symbolic index values -------------------------------------------------

class Sym:
    """A symbolic index: its interval, its affine form ``(const, {axis:
    coef})`` (None where the value is not affine in the axes), the axes it
    depends on, and whether a table lookup feeds it."""

    __slots__ = ("iv", "aff", "deps", "reads_table")

    def __init__(self, iv: Interval, aff, deps=frozenset(),
                 reads_table: bool = False):
        self.iv = iv
        self.aff = aff
        self.deps = frozenset(deps)
        self.reads_table = reads_table

    def _join(self, other: "Sym", iv: Interval, aff) -> "Sym":
        return Sym(iv, aff, self.deps | other.deps,
                   self.reads_table or other.reads_table)

    def __add__(self, other):
        o = _lift(other)
        return self._join(o, Interval(self.iv.lo + o.iv.lo,
                                      self.iv.hi + o.iv.hi),
                          _comb(self.aff, o.aff, 1.0))

    __radd__ = __add__

    def __sub__(self, other):
        o = _lift(other)
        return self._join(o, Interval(self.iv.lo - o.iv.hi,
                                      self.iv.hi - o.iv.lo),
                          _comb(self.aff, o.aff, -1.0))

    def __mul__(self, other):
        o = _lift(other)
        aff = None
        for a, b in ((self.aff, o.aff), (o.aff, self.aff)):
            if a is not None and b is not None and not b[1]:
                aff = (a[0] * b[0], {k: v * b[0] for k, v in a[1].items()
                                     if v * b[0]})
                break
        return self._join(o, _mul_iv(self.iv, o.iv), aff)

    __rmul__ = __mul__

    def __floordiv__(self, other):
        o = _lift(other)
        return self._join(o, _floordiv_iv(self.iv, o.iv), None)

    def __mod__(self, other):
        o = _lift(other)
        return self._join(o, _mod_iv(self.iv, o.iv), None)

    def __repr__(self) -> str:
        return f"Sym({self.iv}, {self.aff}, deps={sorted(self.deps)})"


def _comb(x, y, sy: float):
    if x is None or y is None:
        return None
    coefs = dict(x[1])
    for k, v in y[1].items():
        coefs[k] = coefs.get(k, 0.0) + sy * v
    return (x[0] + sy * y[0], {k: v for k, v in coefs.items() if v})


def _lift(x) -> Sym:
    if isinstance(x, Sym):
        return x
    if isinstance(x, bool) or not isinstance(x, int):
        raise TypeError(f"an index map may combine axes with ints only, "
                        f"got {type(x).__name__}")
    return Sym(Interval(x, x), (float(x), {}))


def minimum(a, b):
    """``min`` in an index map (the past-the-end clamp)."""
    if not isinstance(a, Sym) and not isinstance(b, Sym):
        return min(a, b)
    a, b = _lift(a), _lift(b)
    return a._join(b, Interval(min(a.iv.lo, b.iv.lo),
                               min(a.iv.hi, b.iv.hi)), None)


def maximum(a, b):
    """``max`` in an index map."""
    if not isinstance(a, Sym) and not isinstance(b, Sym):
        return max(a, b)
    a, b = _lift(a), _lift(b)
    return a._join(b, Interval(max(a.iv.lo, b.iv.lo),
                               max(a.iv.hi, b.iv.hi)), None)


def cast(x, dtype: torch.dtype):
    """An integer cast in an index map. A narrow type wraps a value past
    its range, so the interval survives only where the whole range fits;
    otherwise the value is unknown (the proof degrades to unproven)."""
    info = torch.iinfo(dtype)
    if not isinstance(x, Sym):
        span = info.max - info.min + 1
        return (int(x) - info.min) % span + info.min
    fits = x.iv.lo >= info.min and x.iv.hi <= info.max
    return Sym(x.iv if fits else TOP, x.aff, x.deps, x.reads_table)


class _SymTable:
    """A table operand inside an index map: a lookup yields the caller's
    declared contract (TOP without one) and depends on its indices."""

    def __init__(self, argspec: ArgSpec):
        self._iv = argspec.interval or TOP

    def __getitem__(self, idx):
        idx = idx if isinstance(idx, tuple) else (idx,)
        parts = [_lift(i) for i in idx]
        return Sym(self._iv, None,
                   frozenset().union(*(p.deps for p in parts)), True)


# -- the launch declaration ------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Operand:
    """One blocked operand of a launch: the whole array's ``shape``, the
    ``block`` one cell (or loop trip) touches, and ``index_map`` from the
    axes (grid, then loop) and tables to the block's index per dim."""
    name: str
    shape: tuple
    block: tuple
    dtype: torch.dtype
    index_map: Callable
    output: bool = False


@dataclasses.dataclass(frozen=True)
class LaunchSpec:
    """What one kernel launch reads and writes.

    ``grid``: the CUDA grid's axes, each ``parallel``; ``loop``: axes of a
    loop inside each block, each ``arbitrary`` (sequential); ``operands``
    the blocked operands; ``tables`` the operands index maps look up,
    each ``(name, spec(...))`` with its declared contract; ``scratch`` the
    dtypes of state carried across the grid or loop."""
    kernel: str
    where: str
    grid: tuple
    operands: tuple
    loop: tuple = ()
    tables: tuple = ()
    scratch: tuple = ()

    @property
    def axes(self) -> tuple:
        return tuple(self.grid) + tuple(self.loop)

    def with_contracts(self, **ranges) -> "LaunchSpec":
        """This spec with table ``name=(lo, hi)`` contracts declared."""
        unknown = set(ranges) - {n for n, _ in self.tables}
        if unknown:
            raise ValueError(f"{self.kernel} has no table {sorted(unknown)}")
        tables = tuple(
            (n, dataclasses.replace(a, lo=ranges[n][0], hi=ranges[n][1])
             if n in ranges else a) for n, a in self.tables)
        return dataclasses.replace(self, tables=tables)

    def operand(self, name: str) -> Operand:
        return next(o for o in self.operands if o.name == name)


def _symbolic(spec: LaunchSpec, op: Operand) -> list[Sym]:
    axes = [Sym(Interval(0, max(0, n - 1)), (0.0, {k: 1.0}), {k})
            for k, n in enumerate(spec.axes)]
    tables = [_SymTable(a) for _, a in spec.tables]
    comps = [_lift(c) for c in op.index_map(*axes, *tables)]
    if len(comps) != len(op.shape) or len(op.block) != len(op.shape):
        raise ValueError(f"{spec.kernel}: operand {op.name} has shape "
                         f"{op.shape}, block {op.block} and a "
                         f"{len(comps)}-component index map")
    return comps


# -- the checks ------------------------------------------------------------

def lint(spec: LaunchSpec) -> list[Finding]:
    """The four kernel checks on one launch spec."""
    out: list[Finding] = []
    src = spec.where
    n_grid = len(spec.grid)
    for op in spec.operands:
        what = f"output {op.name}" if op.output else f"input {op.name}"
        comps = _symbolic(spec, op)

        # (1) index-map bounds proof
        for k, c in enumerate(comps):
            allowed_hi = max(1, -(-op.shape[k] // max(1, op.block[k]))) - 1
            verdict = _index_verdict(c.iv, allowed_hi)
            if verdict == "ok":
                continue
            lo = "-inf" if c.iv.lo == -_INF else int(c.iv.lo)
            hi = "inf" if c.iv.hi == _INF else int(c.iv.hi)
            if verdict == "oob":
                out.append(Finding(
                    rule="kernel-oob.index-map", severity=Severity.ERROR,
                    message=(f"kernel {spec.kernel} {what} index map "
                             f"component {k} has range [{lo}, {hi}] but the "
                             f"backing buffer (shape {op.shape}, block "
                             f"{op.block}) only addresses block indices "
                             f"[0, {allowed_hi}] — the kernel would read or "
                             f"write a window outside the buffer"),
                    where=src,
                    hint="clamp the index map (minimum(...)) or tighten "
                         "the declared spec(...) contract on the table "
                         "feeding it"))
            else:
                out.append(Finding(
                    rule="kernel-unproven.index-map",
                    severity=Severity.WARNING,
                    message=(f"kernel {spec.kernel} {what} index map "
                             f"component {k} could not be bounded (range "
                             f"[{lo}, {hi}] vs addressable [0, "
                             f"{allowed_hi}]) — the block stream is only as "
                             f"safe as the undeclared operand feeding it"),
                    where=src,
                    hint="declare the table's range via analysis.bounds."
                         "spec (block tables <= n_blocks, positions < "
                         "max_len) so the proof closes"))

        # (2) grid write races (outputs only; loop axes are sequential)
        if op.output:
            for g in range(n_grid):
                if spec.grid[g] <= 1:
                    continue
                if any(c.aff is not None and c.aff[1].get(g) for c in comps):
                    continue
                if any(g in c.deps for c in comps):
                    out.append(Finding(
                        rule="kernel-race.unproven-map",
                        severity=Severity.WARNING,
                        message=(f"kernel {spec.kernel} {what} index map "
                                 f"depends on parallel grid axis {g} "
                                 f"non-affinely — injectivity (each output "
                                 f"block written by one cell) could not be "
                                 f"proven"),
                        where=src,
                        hint="make the output map affine in the grid axis, "
                             "or move the axis into the block's loop if it "
                             "deliberately accumulates"))
                else:
                    out.append(Finding(
                        rule="kernel-race.parallel-overwrite",
                        severity=Severity.ERROR,
                        message=(f"kernel {spec.kernel} {what} index map "
                                 f"ignores parallel grid axis {g} (size "
                                 f"{spec.grid[g]}): every cell of that axis "
                                 f"writes the SAME output block concurrently "
                                 f"— last writer wins, nondeterministically"),
                        where=src,
                        hint="index the output block by the grid axis, or "
                             "walk the axis in a loop inside one block for "
                             "an accumulate discipline"))

        # (3) access lint: the contiguous dim in 16-byte vectors
        if len(op.block) >= 2:
            other, cont = op.block[-2], op.block[-1]
            if other > 0 and cont > 0:
                item = op.dtype.itemsize
                vec = max(1, VECTOR_BYTES // item)
                waste = _roundup(cont, vec) / cont
                waste_t = _roundup(other, vec) / other
                if waste >= _WASTE_FLAG and waste >= _WASTE_RATIO * waste_t:
                    out.append(Finding(
                        rule="kernel-tile.pad-waste",
                        severity=Severity.WARNING,
                        message=(f"kernel {spec.kernel} {what} block "
                                 f"{op.block} ({_dtype_name(op.dtype)}) "
                                 f"reads its contiguous dim of {cont} in "
                                 f"{VECTOR_BYTES}-byte vectors of {vec} at "
                                 f"{waste:.0f}x its bytes — transposing the "
                                 f"trailing dims would waste only "
                                 f"{waste_t:.0f}x (the small head dim in the "
                                 f"contiguous slot)"),
                        where=src,
                        hint="swap the trailing block dims: the long dim "
                             "contiguous, the small one strided"))

    # (4) dtype lint: floating scratch below f32
    for dt in spec.scratch:
        if dt.is_floating_point and torch.finfo(dt).bits < 32:
            out.append(Finding(
                rule="kernel-dtype-drift.low-precision-scratch",
                severity=Severity.WARNING,
                message=(f"kernel {spec.kernel} carries "
                         f"{_dtype_name(dt)} scratch across its grid — "
                         f"state accumulated below f32 drifts from the "
                         f"dense path's f32 math (the bit-exactness "
                         f"contract)"),
                where=src,
                hint="keep the accumulator in f32 and cast only on the "
                     "final store"))
    return out


def lint_report(specs, name: str = "") -> Report:
    """A :class:`Report` of :func:`lint` over ``specs``."""
    return Report(name=name, findings=[f for s in specs for f in lint(s)])


def _roundup(x: int, q: int) -> int:
    return -(-x // q) * q


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


# -- kernel-derived HBM cost rows -----------------------------------------

def _operand_bytes(spec: LaunchSpec, op: Operand) -> int:
    """Bytes one launch moves for ``op``: block bytes x every grid cell x
    the loop trips of the loop axes its map depends on."""
    comps = _symbolic(spec, op)
    deps = frozenset().union(*(c.deps for c in comps))
    trips = math.prod(spec.grid)
    for j, n in enumerate(spec.loop):
        if len(spec.grid) + j in deps:
            trips *= n
    item = op.dtype.itemsize
    return math.prod(op.block) * item * trips


def kernel_hbm_costs(specs, program: str = "") -> list[HBMCost]:
    """HBM bytes-per-run rows of the launches ``specs`` (one tick's): each
    operand's :func:`_operand_bytes`. Inputs whose index map looks up a
    table (the block-table signature) are ``kernel.kv_stream``; every
    other operand ``kernel.io``."""
    specs = list(specs)
    if not specs:
        return []
    kv = io = 0
    for spec in specs:
        for op in spec.operands:
            n = _operand_bytes(spec, op)
            if not op.output and any(c.reads_table
                                     for c in _symbolic(spec, op)):
                kv += n
            else:
                io += n
    rows = [HBMCost(
        op="kernel.kv_stream", program=program, bytes_per_tick=kv,
        note=f"{len(specs)} launch(es): table-indexed K/V blocks x the "
             f"grid cells and loop trips behind them — derived from the "
             f"launches' own LaunchSpecs")]
    if io:
        rows.append(HBMCost(
            op="kernel.io", program=program, bytes_per_tick=io,
            note="non-table kernel operand/output blocks x grid cells"))
    return rows


# -- recording launches ----------------------------------------------------

#: the active recorder's log, or None; :func:`note` tests it once per call
_recording: list | None = None


def note(make_spec: Callable[[], LaunchSpec]) -> None:
    """A kernel wrapper's hook into the recorder, called once per launch:
    appends ``make_spec()`` to the open :func:`record_launches` log.
    Outside a recorder it returns at once and builds no spec."""
    if _recording is not None:
        _recording.append(make_spec())


@contextlib.contextmanager
def record_launches():
    """``with record_launches() as log:`` — every kernel wrapper called
    inside appends its launch's :class:`LaunchSpec` to ``log``, on the
    kernel path and the plain CPU path alike. Nests: the inner recorder
    takes the launches while it is open."""
    global _recording
    outer, log = _recording, []
    _recording = log
    try:
        yield log
    finally:
        _recording = outer


def concrete(spec: LaunchSpec, name: str, *axes, tables=()) -> tuple:
    """``name``'s index map at concrete axis values (ints)."""
    return tuple(int(c) for c in spec.operand(name).index_map(*axes, *tables))


__all__ = ["KERNEL_FAMILIES", "LaunchSpec", "Operand", "Sym", "cast",
           "concrete", "kernel_hbm_costs", "lint", "lint_report",
           "maximum", "minimum", "note", "record_launches"]
