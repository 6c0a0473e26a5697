"""The interval lattice of the bounds analysis (port of the lattice half of
``analysis/bounds.py``).

An index is the serving path's one irreducible hazard: a block-table entry
that picks a K/V block, a position that picks a row. A kernel on the card
never raises on an out-of-range index; it reads or writes someone else's
memory. The kernel linter (:mod:`.kernels`) proves every block index a
launch can form inside its operand, given the value ranges the caller
declares for its index-bearing inputs (:func:`spec`): this module holds
the inclusive-interval arithmetic it propagates them with, and the verdict
on a result.

The jaxpr walk (``BoundsWalker``, ``check_bounds``) of the JAX module
walks traced XLA programs, which the port has none of; it stays with the
rest of the program linter (ROADMAP.md, Queue A, item 7.4).

The propagation is deliberately conservative: unknown values are
``[-inf, inf]`` and an operation it cannot bound gives the unknown, so it
can miss a proof (a WARNING at worst) but never claims safety it did not
derive. Pure stdlib.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

_INF = math.inf


@dataclasses.dataclass(frozen=True)
class Interval:
    """Inclusive value bounds; ``[-inf, inf]`` is the unknown (TOP)."""
    lo: float
    hi: float

    @property
    def known(self) -> bool:
        return self.lo > -_INF or self.hi < _INF

    def __or__(self, other: "Interval") -> "Interval":
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi))


TOP = Interval(-_INF, _INF)
BOOL = Interval(0, 1)


@dataclasses.dataclass(frozen=True)
class ArgSpec:
    """An argument's shape and dtype plus its declared value contract:
    ``lo``/``hi`` are the inclusive bounds the CALLER guarantees for every
    element (the host-side discipline being machine-checked). The JAX
    ``vary`` (mesh axes of a sharded state) belongs to the jaxpr rules of
    item 7.4."""
    shape: tuple
    dtype: Any
    lo: float | None = None
    hi: float | None = None

    @property
    def interval(self) -> Interval | None:
        if self.lo is None and self.hi is None:
            return None
        return Interval(-_INF if self.lo is None else self.lo,
                        _INF if self.hi is None else self.hi)


def spec(shape, dtype, lo=None, hi=None) -> ArgSpec:
    """A shape and dtype carrying a value contract (see :class:`ArgSpec`)."""
    return ArgSpec(tuple(int(d) for d in shape), dtype, lo=lo, hi=hi)


def _mul_iv(a: Interval, b: Interval) -> Interval:
    prods = []
    for x in (a.lo, a.hi):
        for y in (b.lo, b.hi):
            if (x in (0, -0.0) or y in (0, -0.0)):
                prods.append(0.0)
            elif abs(x) == _INF or abs(y) == _INF:
                prods.append(_INF if (x > 0) == (y > 0) else -_INF)
            else:
                prods.append(x * y)
    return Interval(min(prods), max(prods))


def _div_iv(a: Interval, b: Interval) -> Interval:
    # only the shape the index programs use: a known nonneg dividend over a
    # positive constant divisor (pos // block_size)
    if b.lo == b.hi and b.lo > 0 and a.lo >= 0 and a.known:
        c = b.lo
        hi = a.hi if a.hi == _INF else float(int(a.hi // c))
        return Interval(float(int(a.lo // c)), hi)
    return TOP


def _floordiv_iv(a: Interval, b: Interval) -> Interval:
    # any-sign dividend over a positive constant divisor
    if b.lo == b.hi and b.lo > 0 and a.known:
        c = b.lo
        lo = a.lo if a.lo == -_INF else float(math.floor(a.lo / c))
        hi = a.hi if a.hi == _INF else float(math.floor(a.hi / c))
        return Interval(lo, hi)
    return TOP


def _mod_iv(a: Interval, b: Interval) -> Interval:
    # Python-semantics mod (sign follows the divisor)
    if b.lo == b.hi and b.lo > 0:
        return Interval(0, b.lo - 1)
    return TOP


def _cmp_iv(prim: str, a: Interval, b: Interval) -> Interval:
    """Comparison result interval: [0,0]/[1,1] when the operand intervals
    decide it, else the unknown bool [0,1]."""
    if prim == "lt":
        if a.hi < b.lo:
            return Interval(1, 1)
        if a.lo >= b.hi:
            return Interval(0, 0)
    elif prim == "le":
        if a.hi <= b.lo:
            return Interval(1, 1)
        if a.lo > b.hi:
            return Interval(0, 0)
    elif prim == "gt":
        if a.lo > b.hi:
            return Interval(1, 1)
        if a.hi <= b.lo:
            return Interval(0, 0)
    elif prim == "ge":
        if a.lo >= b.hi:
            return Interval(1, 1)
        if a.hi < b.lo:
            return Interval(0, 0)
    elif prim == "eq":
        if a.lo == a.hi == b.lo == b.hi:
            return Interval(1, 1)
        if a.hi < b.lo or b.hi < a.lo:
            return Interval(0, 0)
    elif prim == "ne":
        if a.lo == a.hi == b.lo == b.hi:
            return Interval(0, 0)
        if a.hi < b.lo or b.hi < a.lo:
            return Interval(1, 1)
    return BOOL


def _rem_iv(a: Interval, b: Interval) -> Interval:
    # a truncating remainder's sign follows the dividend
    if b.lo == b.hi and b.lo > 0:
        c = b.lo
        hi = min(a.hi, c - 1) if a.hi < _INF else c - 1
        if a.lo >= 0:
            return Interval(0.0, max(0.0, hi))
        return Interval(-(c - 1), c - 1)
    return TOP


def _index_verdict(iv: Interval, allowed_hi: int) -> str:
    """Classify an index interval against ``[0, allowed_hi]``.

    ``"ok"`` — provably in bounds. ``"oob"`` — the violation is carried by
    a FINITE bound (a declared/derived range that genuinely reaches outside
    the operand). ``"unproven"`` — the only violating side is infinite:
    nothing was proven either way, so a half-declared contract (only ``lo``
    or only ``hi``) degrades to the same not-proven treatment as no
    contract at all instead of escalating to a gating ERROR."""
    if iv.lo >= 0 and iv.hi <= allowed_hi:
        return "ok"
    if iv.lo > allowed_hi or iv.hi < 0:
        return "oob"                    # EVERY possible value is outside
    if (iv.lo < 0 and iv.lo > -_INF) or (allowed_hi < iv.hi < _INF):
        return "oob"                    # a finite declared bound reaches out
    return "unproven"
